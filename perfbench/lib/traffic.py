"""The general traffic generator: every mix is a data file under
``perfbench/traffic/`` that this module reads.

A prefill mix (``"kind": "prefill"``) is a closed loop of one client
sending one batch of ``batch`` prompts of one length at a time. The
lengths are a fixed set, the same for every seed: ``"dist": "bands"``
gives ``per_band`` lengths spread evenly over each band ``[lo, hi)`` of
``bands`` (a band with ``lo == hi`` is that one length, ``per_band``
times); ``"dist": "log_uniform"`` gives ``count`` values spread
log-uniformly from ``min`` to ``max``, both included. The seed only orders
them, each cycle through the set in a new order, and picks each prompt's
token ids (a window of a pool of ids drawn on the device below
``token_ids_below``). So every seed asks for the same work.

A train mix (``"kind": "train"``) is a stream of (``batch``, ``seq``) token
batches with their next-token labels, every row drawn anew from the seed
and the step, on the host as the program's loader expects them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.lib.seeds import derive, rng


def lengths(spec) -> List[int]:
    """The set of prompt lengths of a prefill mix, in increasing order."""
    if spec["dist"] == "bands":
        n = spec["per_band"]
        return sorted(lo + (hi - lo) * i // n for lo, hi in spec["bands"] for i in range(n))
    if spec["dist"] != "log_uniform":
        raise ValueError(f"length distribution {spec['dist']!r} is not known")
    lo, hi, n = spec["min"], spec["max"], spec["count"]
    if n == 1:
        return [hi]
    return [int(round(lo * (hi / lo) ** (i / (n - 1)))) for i in range(n)]


class PrefillTraffic:
    """Request ``i`` of a run: ``prompt(i)`` -> (B, L) int32 ids on the device."""

    def __init__(self, traffic: Dict, seed: int, device):
        self.seed = seed
        self.batch = traffic["batch"]
        self.lengths = lengths(traffic["lengths"])
        self.max_len = max(self.lengths)
        self.pool_len = 2 * self.max_len
        gen = torch.Generator(device=device)
        gen.manual_seed(derive(seed, "token_pool"))
        self.pool = torch.randint(0, traffic["token_ids_below"], (self.batch, self.pool_len),
                                  generator=gen, device=device, dtype=torch.int32)
        self._cycles: Dict[int, tuple] = {}

    def _cycle(self, c: int):
        if c not in self._cycles:
            r = rng(self.seed, "order", c)
            order = r.permutation(len(self.lengths))
            lens = [self.lengths[j] for j in order]
            offs = [int(r.integers(0, self.pool_len - n + 1)) for n in lens]
            self._cycles = {c: (lens, offs)}  # one cycle is read at a time
        return self._cycles[c]

    def length(self, i: int) -> int:
        c, j = divmod(i, len(self.lengths))
        return self._cycle(c)[0][j]

    def prompt(self, i: int):
        c, j = divmod(i, len(self.lengths))
        lens, offs = self._cycle(c)
        return self.pool[:, offs[j]:offs[j] + lens[j]]

    def tokens(self, i: int) -> int:
        return self.batch * self.length(i)


class TrainSource:
    """The program's data source for a train mix: ``batch_at(step)``."""

    def __init__(self, traffic: Dict, seed: int):
        self.seed = seed
        self.batch, self.seq = traffic["batch"], traffic["seq"]
        self.below = traffic["token_ids_below"]

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        ids = rng(self.seed, "batch", step).integers(0, self.below, (self.batch, self.seq + 1),
                                                     dtype=np.int32)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}

    def tokens_per_step(self) -> int:
        return self.batch * self.seq

