"""Port parity: the AutoML-lite pool and search (repro_torch.core.automl).

The port's copies must give bit-identical predictions to the reference's on
the same (x, y, seed), and equal ``to_dict`` JSON: the serving fleet rebuilds
generations with the reference's ``from_dict``, so the formats must not drift.
The data is ``tests/test_automl.py``'s.
"""

import json

import numpy as np
import pytest

from repro.core.automl import models as jm
from repro.core.automl import search as js
from repro.core.automl import tree as jt
from repro_torch.core.automl import models as tm
from repro_torch.core.automl import search as ts
from repro_torch.core.automl import tree as tt


def _data(n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 8))
    y = 3 * x[:, 0] + np.where(x[:, 1] > 0.5, 2.0, -1.0) + 0.5 * x[:, 2] ** 2
    return x, y


def _same(port, ref, x):
    """Equal predictions, bit for bit, and equal JSON; and each package's
    ``model_from_dict`` rebuilds the other's model."""
    assert (port.predict(x) == ref.predict(x)).all()
    assert json.dumps(port.to_dict()) == json.dumps(ref.to_dict())
    assert (jm.model_from_dict(port.to_dict()).predict(x) == ref.predict(x)).all()
    assert (tm.model_from_dict(ref.to_dict()).predict(x) == port.predict(x)).all()


@pytest.mark.parametrize("depth,random_splits,max_features", [
    (8, False, 1.0), (1, False, 1.0), (12, True, 0.5), (6, False, 0.5)])
def test_tree_bit_identical(depth, random_splits, max_features):
    x, y = _data()
    cfg = dict(max_depth=depth, random_splits=random_splits, max_features=max_features)
    port = tt.DecisionTreeRegressor(tt.TreeConfig(**cfg), seed=3).fit(x[:240], y[:240])
    ref = jt.DecisionTreeRegressor(jt.TreeConfig(**cfg), seed=3).fit(x[:240], y[:240])
    assert (port.predict(x) == ref.predict(x)).all()
    assert json.dumps(port.to_dict()) == json.dumps(ref.to_dict())


@pytest.mark.parametrize("kind,kw", [
    ("RandomForestRegressor", {"n_trees": 15, "seed": 2}),
    ("ExtraTreesRegressor", {"n_trees": 40, "seed": 5}),
    ("GradientBoostingRegressor", {"n_stages": 60, "seed": 1}),
    ("RidgeRegressor", {"alpha": 0.5}),
    ("KNNRegressor", {"k": 4}),
])
def test_models_bit_identical_and_same_json(kind, kw):
    x, y = _data()
    port = getattr(tm, kind)(**kw).fit(x[:240], y[:240])
    ref = getattr(jm, kind)(**kw).fit(x[:240], y[:240])
    _same(port, ref, x[240:])


@pytest.mark.parametrize("candidates", ["default", "pool"])
def test_fit_automl_bit_identical(candidates):
    x, y = _data()
    y = np.exp(y)  # strictly positive target, wide range

    def pool(mod):
        return [mod.RandomForestRegressor(n_trees=10), mod.RidgeRegressor(),
                mod.GradientBoostingRegressor(n_stages=30, seed=4), mod.KNNRegressor(k=3)]
    if candidates == "default":  # the default pool's first two models, on 120 points
        xt, yt, xv = x[:120], y[:120], x[120:150]
        port = ts.fit_automl(xt, yt, seed=1, candidates=ts.default_candidates(1)[:2])
        ref = js.fit_automl(xt, yt, seed=1, candidates=js.default_candidates(1)[:2])
    else:
        xt, yt, xv = x[:240], y[:240], x[240:]
        port = ts.fit_automl(xt, yt, seed=0, candidates=pool(tm))
        ref = js.fit_automl(xt, yt, seed=0, candidates=pool(jm))
    assert len(xv) and (port.predict(xv) == ref.predict(xv)).all()
    assert port.leaderboard == ref.leaderboard
    assert json.dumps(port.to_dict()) == json.dumps(ref.to_dict())
    back = js.FittedEnsemble.from_dict(port.to_dict())
    assert (back.predict(xv) == ref.predict(xv)).all()


def test_clone_unfitted_same_config():
    x, y = _data()
    x, y = x[:120], y[:120]
    for kind, kw in (("RandomForestRegressor", {"n_trees": 8}),
                     ("GradientBoostingRegressor", {"n_stages": 40}), ("KNNRegressor", {})):
        port = tm.clone_unfitted(getattr(tm, kind)(**kw).fit(x[:60], y[:60])).fit(x, y)
        ref = jm.clone_unfitted(getattr(jm, kind)(**kw).fit(x[:60], y[:60])).fit(x, y)
        assert (port.predict(x) == ref.predict(x)).all()


def _ties(n, f, seed):
    """Features full of ties: few distinct values, a constant column, and
    duplicated columns, so that equal gains across features and equal
    values within one decide which split a scan keeps."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, (n, f)).astype(np.float64)
    x[:, 1] = 2.0
    x[:, 3] = x[:, 0]
    x[:, -1] = x[:, 2]
    y = x[:, 0] * 1.5 - x[:, 2] + rng.normal(0, 0.1, n)
    return x, y


@pytest.mark.parametrize("n,f,leaf,max_features,seed", [
    (4, 6, 1, None, 0), (5, 6, 2, None, 1), (12, 9, 1, None, 2), (36, 40, 2, None, 3),
    (36, 40, 1, 0.3, 4), (60, 25, 5, 0.8, 5), (7, 6, 4, None, 6), (200, 12, 1, 0.5, 7)])
def test_best_split_is_the_references_scan(n, f, leaf, max_features, seed):
    """The split search over all sampled features at once picks the
    reference's one-feature-at-a-time split: the same feature, threshold
    and gain, bit for bit, first feature winning a tie; then whole trees."""
    x, y = _ties(n, f, seed)
    cfg = dict(min_samples_leaf=leaf, max_features=max_features)
    port = tt.DecisionTreeRegressor(tt.TreeConfig(**cfg), seed=seed)
    ref = jt.DecisionTreeRegressor(jt.TreeConfig(**cfg), seed=seed)
    port.n_features = ref.n_features = f
    for rows in (slice(None), slice(0, max(2, n // 2)), slice(1, None, 3)):
        got, want = port._best_split(x[rows], y[rows]), ref._best_split(x[rows], y[rows])
        assert got == want
    port = tt.DecisionTreeRegressor(tt.TreeConfig(**cfg), seed=seed).fit(x, y)
    ref = jt.DecisionTreeRegressor(jt.TreeConfig(**cfg), seed=seed).fit(x, y)
    assert json.dumps(port.to_dict()) == json.dumps(ref.to_dict())


def test_boosting_on_many_features_is_many_times_quicker_than_the_reference():
    """A refit in ``predict_and_schedule_torch.py`` boosts 120 stages on a
    few dozen records of ~850 NSM features; the reference's scan of one
    feature at a time made it take tens of seconds, past the example's 60 s
    wait on a loaded host. Same trees, at least 4x quicker."""
    import time
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, (36, 400)).astype(np.float64)
    y = x[:, :5].sum(1) + rng.uniform(0, 0.1, 36)

    def best_of_two(mod):
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            model = mod.GradientBoostingRegressor(n_stages=12, seed=1).fit(x, y)
            times.append(time.perf_counter() - t0)
        return min(times), model
    ref_s, ref = best_of_two(jm)
    port_s, port = best_of_two(tm)
    assert json.dumps(port.to_dict()) == json.dumps(ref.to_dict())
    assert port_s * 4 <= ref_s, (port_s, ref_s)
