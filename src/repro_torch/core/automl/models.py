"""Shallow regressor pool: RF, Extra-Trees, GBDT, Ridge, kNN.

All models share fit(x, y) / predict(x) / to_dict() / from_dict() so the
AutoML search (``repro_torch.core.automl.search``) can treat them uniformly.
A copy of ``repro.core.automl.models`` (the port imports nothing of the
reference): the same seeds give the same models and ``to_dict`` JSON.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.automl.tree import DecisionTreeRegressor, TreeConfig


class RandomForestRegressor:
    KIND = "random_forest"

    def __init__(self, n_trees: int = 60, max_depth: int = 14,
                 max_features: float = 0.5, min_samples_leaf: int = 1,
                 extra: bool = False, seed: int = 0):
        self.n_trees = n_trees
        self.extra = extra
        self.cfg = TreeConfig(max_depth=max_depth,
                              min_samples_leaf=min_samples_leaf,
                              max_features=max_features,
                              random_splits=extra)
        self.seed = seed
        self.trees: List[DecisionTreeRegressor] = []

    def fit(self, x, y):
        rng = np.random.default_rng(self.seed)
        n = len(y)
        self.trees = []
        for t in range(self.n_trees):
            idx = (np.arange(n) if self.extra
                   else rng.integers(0, n, size=n))  # ET: no bootstrap
            tree = DecisionTreeRegressor(self.cfg, seed=self.seed * 1000 + t)
            tree.fit(x[idx], y[idx])
            self.trees.append(tree)
        return self

    def predict(self, x):
        return np.mean([t.predict(x) for t in self.trees], axis=0)

    def to_dict(self):
        return {"kind": self.KIND, "n_trees": self.n_trees,
                "extra": self.extra, "seed": self.seed,
                "cfg": dataclasses.asdict(self.cfg),
                "trees": [t.to_dict() for t in self.trees]}

    @classmethod
    def from_dict(cls, d):
        m = cls(n_trees=d["n_trees"], extra=d["extra"], seed=d["seed"])
        m.cfg = TreeConfig(**d["cfg"])
        m.trees = [DecisionTreeRegressor.from_dict(t) for t in d["trees"]]
        return m


class ExtraTreesRegressor(RandomForestRegressor):
    KIND = "extra_trees"

    def __init__(self, n_trees: int = 80, max_depth: int = 16,
                 max_features: float = 0.7, min_samples_leaf: int = 1,
                 seed: int = 0):
        super().__init__(n_trees=n_trees, max_depth=max_depth,
                         max_features=max_features,
                         min_samples_leaf=min_samples_leaf,
                         extra=True, seed=seed)

    @classmethod
    def from_dict(cls, d):
        m = cls(n_trees=d["n_trees"], seed=d["seed"])
        m.cfg = TreeConfig(**d["cfg"])
        m.trees = [DecisionTreeRegressor.from_dict(t) for t in d["trees"]]
        return m


class GradientBoostingRegressor:
    KIND = "gbdt"

    def __init__(self, n_stages: int = 200, learning_rate: float = 0.08,
                 max_depth: int = 5, subsample: float = 0.9,
                 max_features: float = 0.8, seed: int = 0):
        self.n_stages = n_stages
        self.lr = learning_rate
        self.subsample = subsample
        self.cfg = TreeConfig(max_depth=max_depth, min_samples_leaf=2,
                              max_features=max_features)
        self.seed = seed
        self.base = 0.0
        self.trees: List[DecisionTreeRegressor] = []

    def fit(self, x, y):
        rng = np.random.default_rng(self.seed)
        self.base = float(np.mean(y))
        resid = y - self.base
        self.trees = []
        n = len(y)
        k = max(2, int(self.subsample * n))
        for t in range(self.n_stages):
            idx = rng.choice(n, size=k, replace=False)
            tree = DecisionTreeRegressor(self.cfg, seed=self.seed * 997 + t)
            tree.fit(x[idx], resid[idx])
            pred = tree.predict(x)
            resid = resid - self.lr * pred
            self.trees.append(tree)
        return self

    def predict(self, x):
        out = np.full(len(x), self.base, np.float64)
        for t in self.trees:
            out += self.lr * t.predict(x)
        return out

    def to_dict(self):
        return {"kind": self.KIND, "n_stages": self.n_stages, "lr": self.lr,
                "subsample": self.subsample, "seed": self.seed,
                "base": self.base, "cfg": dataclasses.asdict(self.cfg),
                "trees": [t.to_dict() for t in self.trees]}

    @classmethod
    def from_dict(cls, d):
        m = cls(n_stages=d["n_stages"], learning_rate=d["lr"],
                subsample=d["subsample"], seed=d["seed"])
        m.cfg = TreeConfig(**d["cfg"])
        m.base = d["base"]
        m.trees = [DecisionTreeRegressor.from_dict(t) for t in d["trees"]]
        return m


class RidgeRegressor:
    KIND = "ridge"

    def __init__(self, alpha: float = 1.0, seed: int = 0):
        self.alpha = alpha
        self.w: Optional[np.ndarray] = None
        self.mu = None
        self.sd = None

    def _norm(self, x):
        return (x - self.mu) / self.sd

    def fit(self, x, y):
        self.mu = x.mean(0)
        self.sd = x.std(0) + 1e-9
        xn = np.concatenate([self._norm(x), np.ones((len(x), 1))], axis=1)
        a = xn.T @ xn + self.alpha * np.eye(xn.shape[1])
        # the intercept must NOT be regularized: shrinking it biases every
        # prediction by ~exp(-mean(y)*alpha/(n+alpha)) in log-target space,
        # a large systematic error for small-n (online refit) fits on
        # big-magnitude targets like log-bytes.
        a[-1, -1] -= self.alpha
        self.w = np.linalg.solve(a, xn.T @ y)
        return self

    def predict(self, x):
        xn = np.concatenate([self._norm(x), np.ones((len(x), 1))], axis=1)
        return xn @ self.w

    def to_dict(self):
        return {"kind": self.KIND, "alpha": self.alpha,
                "w": self.w.tolist(), "mu": self.mu.tolist(),
                "sd": self.sd.tolist()}

    @classmethod
    def from_dict(cls, d):
        m = cls(alpha=d["alpha"])
        m.w = np.array(d["w"])
        m.mu = np.array(d["mu"])
        m.sd = np.array(d["sd"])
        return m


class KNNRegressor:
    KIND = "knn"

    def __init__(self, k: int = 5, seed: int = 0):
        self.k = k
        self.x = None
        self.y = None
        self.mu = None
        self.sd = None

    def fit(self, x, y):
        self.mu = x.mean(0)
        self.sd = x.std(0) + 1e-9
        self.x = (x - self.mu) / self.sd
        self.y = np.asarray(y, np.float64)
        return self

    def predict(self, x):
        xn = (x - self.mu) / self.sd
        d = ((xn[:, None, :] - self.x[None, :, :]) ** 2).sum(-1)
        idx = np.argsort(d, axis=1)[:, : self.k]
        return self.y[idx].mean(axis=1)

    def to_dict(self):
        return {"kind": self.KIND, "k": self.k, "x": self.x.tolist(),
                "y": self.y.tolist(), "mu": self.mu.tolist(),
                "sd": self.sd.tolist()}

    @classmethod
    def from_dict(cls, d):
        m = cls(k=d["k"])
        m.x = np.array(d["x"])
        m.y = np.array(d["y"])
        m.mu = np.array(d["mu"])
        m.sd = np.array(d["sd"])
        return m


MODEL_KINDS = {c.KIND: c for c in
               (RandomForestRegressor, ExtraTreesRegressor,
                GradientBoostingRegressor, RidgeRegressor, KNNRegressor)}


def model_from_dict(d):
    return MODEL_KINDS[d["kind"]].from_dict(d)


def clone_unfitted(model):
    """Fresh unfitted copy with the same hyperparameters.

    The online-refit path reuses the *architectures* the original AutoML
    search selected (a refit re-estimates parameters on drifted data; it
    does not need to re-run model selection over the whole pool).
    """
    kind = type(model).KIND
    if kind == "random_forest":
        m = RandomForestRegressor(n_trees=model.n_trees, extra=model.extra,
                                  seed=model.seed)
    elif kind == "extra_trees":
        m = ExtraTreesRegressor(n_trees=model.n_trees, seed=model.seed)
    elif kind == "gbdt":
        m = GradientBoostingRegressor(n_stages=model.n_stages,
                                      learning_rate=model.lr,
                                      subsample=model.subsample,
                                      seed=model.seed)
    elif kind == "ridge":
        return RidgeRegressor(alpha=model.alpha)
    elif kind == "knn":
        return KNNRegressor(k=model.k)
    else:
        raise ValueError(f"unknown model kind {kind!r}")
    m.cfg = dataclasses.replace(model.cfg)
    return m
