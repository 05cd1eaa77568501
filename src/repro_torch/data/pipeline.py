"""Token sources and a prefetching loader.

Port of ``repro.data.pipeline``. Sources are deterministic in (seed, step),
so a restart resumes the exact token stream from the checkpointed step;
``batch_at`` is the reference's numpy code, so its tokens equal the
reference's byte for byte. ``ShardedLoader`` turns each host batch into
int32 tensors on its ``device`` from a producer thread; without a device the
batches stay on the host (CPU tensors), as the reference's stay numpy
without shardings. With ``shardings`` ({key: NamedSharding}, as
``train.step.batch_shardings`` gives) each batch is a DTensor on the mesh:
every rank makes the same host batch from ``batch_at(step)`` and keeps its
own slice (``distributed.sharding.distribute``), so no scatter runs; the
slices go to the mesh's device type.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.distributed import sharding as shd


class SyntheticLM:
    """Deterministic synthetic next-token data (zipf-ish unigram stream)."""

    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # zipf-like marginal so losses are non-degenerate
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        tokens = np.minimum(z - 1, self.vocab_size - 1).astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapLM:
    """Windows over a flat binary token file (np.uint16/uint32 memmap)."""

    def __init__(self, path: str, batch: int, seq: int, dtype=np.uint16,
                 seed: int = 0):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        max_start = len(self.data) - self.seq - 1
        starts = rng.integers(0, max_start, size=self.batch)
        toks = np.stack([self.data[s:s + self.seq + 1] for s in starts])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ShardedLoader:
    """Host batches as int32 tensors on ``device``, with background prefetch.

    The producer thread builds each batch and issues its host-to-device copy
    (on the default stream, so the step that takes it is ordered after the
    copy); ``close()`` stops it within one ``put`` timeout.
    """

    def __init__(self, source, shardings=None, start_step: int = 0,
                 prefetch: int = 2, device=None):
        self.source = source
        self.shardings = shardings
        if shardings is not None and device is None:
            device = next(iter(shardings.values())).mesh.device_type
        self.device = None if device is None else torch.device(device)
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _put(self, batch):
        out = {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.int32))
               for k, v in batch.items()}
        if self.device is not None:
            out = {k: v.to(self.device) for k, v in out.items()}
        if self.shardings is not None:
            out = {k: shd.distribute(v, self.shardings[k]) for k, v in out.items()}
        return out

    def _producer(self):
        step, b = self.step, None
        while not self._stop.is_set():
            if b is None:
                b = self._put(self.source.batch_at(step))
            try:
                self._q.put((step, b), timeout=0.5)
                step, b = step + 1, None
            except queue.Full:
                continue

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
