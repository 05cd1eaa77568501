"""CART regression trees (variance-reduction splits), vectorized numpy.

The building block for the RF / Extra-Trees / GBDT models in the
AutoML-lite pool (the image has no sklearn). Split search per node is
O(F' · N log N) using sorted prefix sums, over all F' sampled features in
one pass of array operations (the reference scans them one by one, which
on a record's several hundred NSM features made a refit take tens of
seconds); ``max_features`` subsamples features per split (random
forest), ``random_splits`` draws thresholds uniformly instead of
scanning (extra-trees).

A copy of ``repro.core.automl.tree`` (the port imports nothing of the reference).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TreeConfig:
    max_depth: int = 12
    min_samples_leaf: int = 2
    min_samples_split: int = 4
    max_features: Optional[float] = None  # fraction of features per split
    random_splits: bool = False           # extra-trees style thresholds


class _Node:
    __slots__ = ("feature", "threshold", "left", "right", "value")

    def __init__(self, value=0.0):
        self.feature = -1
        self.threshold = 0.0
        self.left = None
        self.right = None
        self.value = value


class DecisionTreeRegressor:
    def __init__(self, cfg: TreeConfig = TreeConfig(), seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.root: Optional[_Node] = None

    # -- fitting -----------------------------------------------------------
    def fit(self, x: np.ndarray, y: np.ndarray) -> "DecisionTreeRegressor":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        self.n_features = x.shape[1]
        self.root = self._build(x, y, depth=0)
        return self

    def _feature_subset(self) -> np.ndarray:
        f = self.n_features
        if self.cfg.max_features is None:
            return np.arange(f)
        k = max(1, int(round(self.cfg.max_features * f)))
        return self.rng.choice(f, size=k, replace=False)

    def _best_split(self, x, y):
        n = len(y)
        best = (None, None, 0.0)  # feature, threshold, gain
        base = np.var(y) * n
        if base <= 1e-18:
            return best
        feats = self._feature_subset()
        if self.cfg.random_splits:
            return self._best_random_split(x, y, feats, base, best)
        if n < 2:
            return best
        # every sampled feature at once, one column each: the same stable
        # order, prefix sums and scores as a scan of one feature at a time
        msl = self.cfg.min_samples_leaf
        xs = x[:, feats]
        order = np.argsort(xs, axis=0, kind="stable")
        cs, ys = np.take_along_axis(xs, order, axis=0), y[order]
        csum = np.cumsum(ys, axis=0)
        csum2 = np.cumsum(ys * ys, axis=0)
        nl = np.arange(1, n)[:, None]
        valid = (cs[1:] > cs[:-1]) & (nl >= msl) & ((n - nl) >= msl)
        sl, sl2 = csum[:-1], csum2[:-1]
        sr, sr2 = csum[-1] - sl, csum2[-1] - sl2
        sse = (sl2 - sl * sl / nl) + (sr2 - sr * sr / (n - nl))
        sse = np.where(valid, sse, np.inf)
        rows = np.argmin(sse, axis=0)
        cols = np.arange(len(feats))
        gains = np.where(np.isfinite(sse[rows, cols]), base - sse[rows, cols], -np.inf)
        c = int(np.argmax(gains))  # the first of the best, as a scan keeps it
        if gains[c] > best[2]:
            i = rows[c]
            best = (feats[c], (cs[i, c] + cs[i + 1, c]) / 2.0, gains[c])
        return best

    def _best_random_split(self, x, y, feats, base, best):
        n = len(y)
        msl = self.cfg.min_samples_leaf
        for j in feats:
            col = x[:, j]
            lo, hi = col.min(), col.max()
            if hi <= lo:
                continue
            thr = self.rng.uniform(lo, hi)
            mask = col <= thr
            nl = int(mask.sum())
            if nl < msl or n - nl < msl:
                continue
            yl, yr = y[mask], y[~mask]
            gain = base - (np.var(yl) * nl + np.var(yr) * (n - nl))
            if best[2] < gain:
                best = (j, thr, gain)
        return best

    def _build(self, x, y, depth):
        node = _Node(float(np.mean(y)))
        if (depth >= self.cfg.max_depth
                or len(y) < self.cfg.min_samples_split):
            return node
        j, thr, gain = self._best_split(x, y)
        if j is None or gain <= 1e-18:
            return node
        mask = x[:, j] <= thr
        node.feature = int(j)
        node.threshold = float(thr)
        node.left = self._build(x[mask], y[mask], depth + 1)
        node.right = self._build(x[~mask], y[~mask], depth + 1)
        return node

    # -- inference ----------------------------------------------------------
    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        out = np.empty(len(x), np.float64)
        # iterative per-node partition (vectorized walk)
        stack = [(self.root, np.arange(len(x)))]
        while stack:
            node, idx = stack.pop()
            if node.feature < 0 or node.left is None:
                out[idx] = node.value
                continue
            mask = x[idx, node.feature] <= node.threshold
            stack.append((node.left, idx[mask]))
            stack.append((node.right, idx[~mask]))
        return out

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        def enc(n):
            if n is None:
                return None
            return {"f": n.feature, "t": n.threshold, "v": n.value,
                    "l": enc(n.left), "r": enc(n.right)}
        return {"cfg": dataclasses.asdict(self.cfg), "root": enc(self.root),
                "n_features": getattr(self, "n_features", 0)}

    @classmethod
    def from_dict(cls, d: dict) -> "DecisionTreeRegressor":
        t = cls(TreeConfig(**d["cfg"]))
        t.n_features = d.get("n_features", 0)

        def dec(e):
            if e is None:
                return None
            n = _Node(e["v"])
            n.feature = e["f"]
            n.threshold = e["t"]
            n.left = dec(e["l"])
            n.right = dec(e["r"])
            return n

        t.root = dec(d["root"])
        return t
