"""Seeds of one run: every random draw of the benchmark derives its own
seed from the run's ``--seed`` and the name of what it draws, so that
adding a draw never moves another."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, purpose: str, *more: int) -> int:
    """A seed in [0, 2**63) for ``purpose``; any whole ``seed``, negative or
    beyond 64 bits, is accepted."""
    words = [int(seed) % (1 << 64), zlib.crc32(purpose.encode())] + [int(m) % (1 << 64)
                                                                     for m in more]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, purpose: str, *more: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, purpose, *more))
