"""AutoML-lite (paper §3.3): train a model pool, select/ensemble by MRE.

AutoGluon's recipe at our scale: fit every candidate (RF / Extra-Trees /
GBDT / Ridge / kNN across a small hyperparameter grid) on a train split,
score MRE on a validation split, then build a greedy weighted ensemble
(Caruana-style forward selection with replacement) over the candidates.
The single best model is kept when the ensemble does not improve MRE.

Targets are modeled in log space (times/bytes span orders of magnitude;
relative error in the original space is ~absolute error in log space).

A copy of ``repro.core.automl.search`` (the port imports nothing of the reference).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.automl.models import (ExtraTreesRegressor,
                                      GradientBoostingRegressor,
                                      KNNRegressor, RandomForestRegressor,
                                      RidgeRegressor, model_from_dict)


def default_candidates(seed: int = 0):
    return [
        RandomForestRegressor(n_trees=60, max_depth=14, max_features=0.5,
                              seed=seed),
        RandomForestRegressor(n_trees=40, max_depth=20, max_features=0.8,
                              seed=seed + 1),
        ExtraTreesRegressor(n_trees=80, max_depth=16, seed=seed + 2),
        GradientBoostingRegressor(n_stages=200, learning_rate=0.08,
                                  max_depth=5, seed=seed + 3),
        GradientBoostingRegressor(n_stages=350, learning_rate=0.05,
                                  max_depth=3, seed=seed + 4),
        RidgeRegressor(alpha=1.0),
        KNNRegressor(k=3),
    ]


_EPS = 1e-12


def _mre_log(pred_log, true_log):
    pred = np.exp(np.minimum(pred_log, 46.0))  # clip extrapolation overflow
    true = np.exp(true_log)
    return float(np.mean(np.abs(pred - true) / np.maximum(np.abs(true), _EPS)))


@dataclasses.dataclass
class FittedEnsemble:
    models: List[object]
    weights: np.ndarray
    val_mre: float
    leaderboard: List[Tuple[str, float]]

    def predict_log(self, x) -> np.ndarray:
        preds = np.stack([m.predict(x) for m in self.models])
        return (self.weights[:, None] * preds).sum(0)

    def predict(self, x) -> np.ndarray:
        return np.exp(np.minimum(self.predict_log(x), 46.0))

    def to_dict(self):
        return {"weights": self.weights.tolist(), "val_mre": self.val_mre,
                "leaderboard": self.leaderboard,
                "models": [m.to_dict() for m in self.models]}

    @classmethod
    def from_dict(cls, d):
        return cls(models=[model_from_dict(m) for m in d["models"]],
                   weights=np.array(d["weights"]),
                   val_mre=d["val_mre"],
                   leaderboard=[tuple(e) for e in d["leaderboard"]])


def fit_automl(x: np.ndarray, y: np.ndarray, val_frac: float = 0.2,
               seed: int = 0, candidates=None,
               ensemble_rounds: int = 12) -> FittedEnsemble:
    """y in ORIGINAL units (seconds / bytes); modeling in log space
    (absolute log error ~ relative error at every scale)."""
    rng = np.random.default_rng(seed)
    n = len(y)
    idx = rng.permutation(n)
    nv = max(1, int(val_frac * n))
    vi, ti = idx[:nv], idx[nv:]
    ylog = np.log(np.maximum(np.asarray(y, np.float64), _EPS))

    cands = candidates if candidates is not None else default_candidates(seed)
    fitted, scores = [], []
    for m in cands:
        m.fit(x[ti], ylog[ti])
        s = _mre_log(m.predict(x[vi]), ylog[vi])
        fitted.append(m)
        scores.append(s)
    leaderboard = sorted(
        [(type(m).KIND, s) for m, s in zip(fitted, scores)], key=lambda e: e[1])

    # Caruana forward selection with replacement on the validation split.
    val_preds = np.stack([m.predict(x[vi]) for m in fitted])
    counts = np.zeros(len(fitted))
    counts[int(np.argmin(scores))] = 1
    best = min(scores)
    for _ in range(ensemble_rounds):
        cur = (counts[:, None] * val_preds).sum(0) / counts.sum()
        trial_scores = []
        for j in range(len(fitted)):
            mix = (cur * counts.sum() + val_preds[j]) / (counts.sum() + 1)
            trial_scores.append(_mre_log(mix, ylog[vi]))
        j = int(np.argmin(trial_scores))
        if trial_scores[j] >= best - 1e-6:
            break
        counts[j] += 1
        best = trial_scores[j]

    keep = counts > 0
    models = [m for m, k in zip(fitted, keep) if k]
    weights = counts[keep] / counts.sum()
    # refit the kept models on ALL data (standard AutoGluon finale)
    for m in models:
        m.fit(x, ylog)
    return FittedEnsemble(models=models, weights=weights, val_mre=best,
                          leaderboard=leaderboard)
