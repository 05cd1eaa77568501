"""Graph-embedding comparison arm (paper §3.2.2 "Graph embedding").

The paper evaluates graph2vec against NSM. graph2vec's backbone is
Weisfeiler-Lehman subtree relabeling followed by an embedding of the
bag-of-rooted-subtrees; with no gensim in the image we realize the same
object as *WL feature hashing*: h iterations of neighborhood relabeling
over the operator graph, hashing each label into a fixed-size count
vector. This preserves exactly the information graph2vec's doc2vec stage
consumes, in a deterministic, dependency-free form — and, like the paper
observes, it is more expensive to build than the one-pass NSM.

A copy of ``repro.core.graphfeat`` (the port imports nothing of the reference).
"""

from __future__ import annotations

import hashlib
from collections import defaultdict
from typing import Dict, Tuple

import numpy as np

EdgeCounts = Dict[Tuple[str, str], float]


def _h(s: str, dim: int) -> int:
    return int.from_bytes(hashlib.blake2b(s.encode(), digest_size=8).digest(),
                          "little") % dim


class WLGraphEmbedder:
    """WL-subtree feature hashing over the operator multigraph."""

    def __init__(self, dim: int = 256, iterations: int = 3):
        self.dim = dim
        self.iterations = iterations

    def vector(self, edges: EdgeCounts, log_scale: bool = True) -> np.ndarray:
        # adjacency with multiplicity; nodes = operator types
        nbrs = defaultdict(list)
        nodes = set()
        for (a, b), n in edges.items():
            if n <= 0:
                continue
            nodes.update((a, b))
            nbrs[b].append((a, n))  # in-neighbors define the subtree
        labels = {v: v for v in nodes}
        vec = np.zeros(self.dim, np.float64)
        for v in nodes:
            vec[_h(labels[v], self.dim)] += 1
        for _ in range(self.iterations):
            new_labels = {}
            for v in nodes:
                parts = sorted(f"{labels[a]}*{int(n)}" for a, n in nbrs[v])
                new_labels[v] = labels[v] + "(" + ",".join(parts) + ")"
            labels = new_labels
            for v in nodes:
                vec[_h(labels[v], self.dim)] += 1
        return np.log1p(vec) if log_scale else vec

    @property
    def dim_out(self) -> int:
        return self.dim
