"""Persistent cross-process trace store for the prediction server.

The trace cache in ``PredictionService`` dies with the process, so every
scheduler restart re-pays the train-step trace for every admission query it
has ever answered. ``TraceStore`` persists traced ``ProfileRecord``s
(including NSM edges) to disk, content-addressed by the same
``(config fingerprint, batch, seq)`` key the in-memory cache uses, so a
fresh process warm-starts from prior traces: load-on-miss, atomic
write-on-trace.

All persistence mechanics — versioned schema, corrupt/foreign records
skipped (counted, never fatal), atomic writes, TTL/entry-cap
``compact``, order-independent ``merge`` — live in the shared
``repro_torch.serve.kvstore`` engines; this module only defines what a
*trace* value is (the ``TraceValues`` mixin), composed with either
physical layout:

  * ``TraceStore`` — the historical file-per-key JSON layout.
  * ``SegmentTraceStore`` — the append-only segment-log layout.
  * ``make_trace_store`` — backend-selected construction
    (``REPRO_STORE_BACKEND`` chooses the fleet-wide default).

A copy of ``repro.serve.trace_store`` (the port imports nothing of the
reference): the on-disk layout, the schema version and the stats keys are
the reference's, so each package opens the other's directories. One
guard is the port's own. ``config_fingerprint`` hashes field values only,
so equal configs of the two packages share a key, and a directory the
reference also writes to may hold a record its jaxpr trace made. Such a
record (any ``platform`` but ``PLATFORM_TORCH_CUDA``) is served as a miss
and dropped at compaction, never handed to the port's predictor.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

from repro_torch.core.features import (PLATFORM_TORCH_CUDA, ProfileRecord,
                                       record_from_json, record_to_json)
from repro_torch.serve.kvstore import (SCHEMA_VERSION, STORE_BACKENDS,
                                       JsonFileStore, SegmentLogStore, StoreKey,
                                       atomic_write_json, store_backend)

__all__ = ["TraceStore", "SegmentTraceStore", "make_trace_store",
           "TraceValues", "StoreStats", "StoreKey", "SCHEMA_VERSION",
           "atomic_write_json"]


class ForeignPlatform(ValueError):
    """A stored record whose platform tag is not the port's."""


def _port_record(raw: Dict) -> ProfileRecord:
    """The record in ``raw``; raises ``ForeignPlatform`` unless the port
    traced it."""
    rec = record_from_json(raw)
    if rec.platform != PLATFORM_TORCH_CUDA:
        raise ForeignPlatform(f"record of platform {rec.platform!r}")
    return rec


@dataclasses.dataclass
class StoreStats:
    hits: int = 0        # get() served a record from disk
    misses: int = 0      # get() found no (servable) file
    writes: int = 0      # put() persisted a record
    corrupt: int = 0     # files skipped: unparseable / wrong version / bad key
    merged: int = 0      # records imported by merge()

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class TraceValues:
    """Trace value semantics, independent of physical layout.

    Defines what a *trace* value is — validation, the deterministic
    record-union merge, stats accounting, the typed ``get``/``put``
    API — as a mixin over any ``repro_torch.serve.kvstore`` engine.
    """

    VALUE_FIELD = "record"

    def __init__(self, root: str, **kwargs):
        super().__init__(root, **kwargs)
        self.stats = StoreStats()

    # -- store engine hooks -------------------------------------------------
    def _check_raw(self, raw):
        if not isinstance(raw, dict):
            raise ValueError("missing record payload")
        return raw

    def _servable(self, raw) -> None:
        # a record that cannot load, or that the reference traced, is
        # dead weight to the port's predictor
        _port_record(raw)

    def _merge_raw(self, mine, theirs):
        """Deterministic record union: identical contents dedupe; two
        hosts that (exceptionally) traced different records for one key
        converge on the same winner regardless of merge order, chosen
        by canonical-JSON ordering — never by who merged first."""
        if mine is None:
            return theirs, 1
        if mine == theirs:
            return mine, 0
        keep_mine = (json.dumps(mine, sort_keys=True)
                     >= json.dumps(theirs, sort_keys=True))
        return (mine, 0) if keep_mine else (theirs, 1)

    def _note_corrupt(self) -> None:
        with self._lock:
            self.stats.corrupt += 1

    def _on_merge(self, key: StoreKey, n_new: int) -> None:
        with self._lock:
            self.stats.merged += n_new

    # -- load / save --------------------------------------------------------
    def get(self, key: StoreKey) -> Optional[ProfileRecord]:
        """Record for ``key``, or None. Corrupted files are skipped."""
        raw = self.get_raw(key)  # corrupt counted by the shared load path
        if raw is not None:
            try:
                rec = _port_record(raw)
            except ForeignPlatform:
                rec = None  # another package's trace: a miss, not damage
            except (ValueError, KeyError, TypeError):
                self._note_corrupt()
                rec = None
            if rec is not None:
                with self._lock:
                    self.stats.hits += 1
                return rec
        with self._lock:
            self.stats.misses += 1
        return None

    def put(self, key: StoreKey, rec: ProfileRecord) -> str:
        """Atomically persist ``rec`` under ``key``; returns the file path."""
        path = self.put_raw(key, record_to_json(rec))
        with self._lock:
            self.stats.writes += 1
        return path

    # -- introspection ------------------------------------------------------
    def info(self) -> Dict[str, int]:
        return {"store_entries": len(self), **self.stats.as_dict()}


class TraceStore(TraceValues, JsonFileStore):
    """Durable ``(fingerprint, batch, seq) -> ProfileRecord`` map on disk,
    one JSON file per key (the historical layout)."""


class SegmentTraceStore(TraceValues, SegmentLogStore):
    """Trace store on the append-only segment-log engine."""


def make_trace_store(root: str, backend: Optional[str] = None) -> TraceValues:
    """Trace store on the selected engine (arg > ``REPRO_STORE_BACKEND``
    env var > ``json``). Both engines serve the identical contract; the
    backend only changes the physical layout under ``root``."""
    cls = {"json": TraceStore,
           "segment": SegmentTraceStore}[store_backend(backend)]
    return cls(root)


assert set(STORE_BACKENDS) == {"json", "segment"}  # keep factories in sync
