"""Measured-cost feedback: the observations that close the refit loop.

The serving stack (PR 1-2) predicts every admitted job's (time, memory)
and then throws the *measured* outcome away, so drift between predicted
and realized cost silently degrades admission quality. This module
persists those outcomes and tracks calibration:

  * ``Observation`` — one finished job's measured ``(time_s, mem_bytes)``
    plus the prediction context (generation, timestamp, job id).
  * ``FeedbackStore`` / ``SegmentFeedbackStore`` — durable
    ``(config fingerprint, batch, seq) -> {obs_id: Observation}`` map on
    disk, the ``FeedbackValues`` mixin composed with either
    ``repro_torch.serve.kvstore`` engine (file-per-key JSON, or the
    append-only segment log; ``make_feedback_store`` selects by name or
    the ``REPRO_STORE_BACKEND`` env var). All persistence mechanics
    (atomic writes, the shared schema version, corrupt-records-skipped
    loads, order-independent ``merge``) live in the engines.
    Observation ids are content-derived when the caller supplies none,
    so re-reporting the same completion is idempotent and ``merge``
    (union by id) is order-independent — the property multi-host
    aggregation relies on.
  * ``CalibrationWindow`` — rolling predicted-vs-observed window with
    per-generation MRE and signed drift, surfaced via
    ``AbacusServer.stats()``.

Cross-process writes to the *same key* are last-writer-wins (one file
per key, re-read + union under a process-local lock before each write);
concurrent writers never corrupt a file, they can only drop each
other's newest observation for that key — one lost data point, never a
torn record.

A copy of ``repro.serve.feedback_store`` (the port imports nothing of
the reference): the observation schema, the on-disk layout, the counters
and every ``stats()`` key are the reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.serve.kvstore import (SCHEMA_VERSION, JsonFileStore,
                                       SegmentLogStore, StoreKey, store_backend)

__all__ = ["Observation", "observation_id", "FeedbackStats", "FeedbackStore",
           "SegmentFeedbackStore", "make_feedback_store", "FeedbackValues",
           "CalibrationWindow", "TenantCalibration", "StoreKey",
           "SCHEMA_VERSION"]


@dataclasses.dataclass(frozen=True)
class Observation:
    """One finished job's measured cost (plus prediction context)."""
    time_s: float
    mem_bytes: float
    generation: Optional[int] = None  # generation that predicted this job
    ts: float = 0.0                   # wall-clock seconds (0 = unknown)
    job_id: str = ""                  # admission job id ('' = anonymous)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "Observation":
        return cls(time_s=float(d["time_s"]), mem_bytes=float(d["mem_bytes"]),
                   generation=(None if d.get("generation") is None
                               else int(d["generation"])),
                   ts=float(d.get("ts", 0.0)), job_id=str(d.get("job_id", "")))


def observation_id(key: StoreKey, obs: Observation) -> str:
    """Content-derived id: identical reports dedupe, merges commute.

    For job-identified observations the wall-clock ``ts`` is excluded
    from the id — a *retried* completion report for the same job (and
    same measurements) dedupes even though it carries a fresh
    timestamp. Anonymous observations keep ``ts`` in the id so two
    genuinely distinct runs with identical measurements stay distinct.
    """
    payload = obs.as_dict()
    if obs.job_id:
        payload.pop("ts")
    blob = json.dumps([list(key), payload], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass
class FeedbackStats:
    adds: int = 0        # observations accepted (new ids)
    duplicates: int = 0  # re-reported ids ignored
    merged: int = 0      # observations imported by merge()
    corrupt: int = 0     # files skipped: unparseable / wrong version / bad key

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class FeedbackValues:
    """Feedback value semantics, independent of physical layout.

    Defines what a *feedback* value is — the ``{obs_id: Observation}``
    map, id-union merge, dedup-on-add, the observation-level ``compact``
    — as a mixin over any ``repro_torch.serve.kvstore`` engine.
    """

    FILE_PREFIX = "fb_"
    VALUE_FIELD = "obs"

    def __init__(self, root: str, **kwargs):
        super().__init__(root, **kwargs)
        self.stats = FeedbackStats()
        # observation count is cached: threshold checks / stats polls run
        # on every observe() and must not re-scan the whole directory.
        # Seeded by one startup scan; add/merge/clear keep it current for
        # THIS process (a concurrent process's writes surface on rescan).
        self._total: Optional[int] = None

    # -- store engine hooks -------------------------------------------------
    def _check_raw(self, raw):
        if not isinstance(raw, dict):
            raise ValueError("missing observation map")
        return raw

    def _merge_raw(self, mine, theirs):
        """Union by observation id; malformed foreign entries skipped."""
        existing = dict(mine or {})
        fresh = {}
        for oid, d in theirs.items():
            if oid in existing:
                continue
            try:
                Observation.from_dict(d)
            except (KeyError, TypeError, ValueError):
                self._note_corrupt()
                continue
            fresh[oid] = d
        if not fresh:
            return existing, 0
        existing.update(fresh)
        return existing, len(fresh)

    def _note_corrupt(self) -> None:
        with self._lock:
            self.stats.corrupt += 1
            self._total = None  # count is suspect: rescan on next total()

    def _on_merge(self, key: StoreKey, n_new: int) -> None:
        with self._lock:
            self.stats.merged += n_new
            if self._total is not None:
                self._total += n_new

    def _on_split(self, n_removed: int) -> None:
        with self._lock:
            self._total = None  # whole key files left: recount lazily

    # -- writes -------------------------------------------------------------
    def add(self, key: StoreKey, time_s: float, mem_bytes: float,
            generation: Optional[int] = None, job_id: str = "",
            ts: Optional[float] = None) -> str:
        """Record one measured outcome; returns its observation id.

        Re-adding an identical observation (same content-derived id) is
        a no-op, so completion reports can be retried safely.
        """
        obs = Observation(time_s=float(time_s), mem_bytes=float(mem_bytes),
                          generation=generation,
                          ts=time.time() if ts is None else float(ts),
                          job_id=str(job_id))
        oid = observation_id(key, obs)
        with self._lock:
            existing = self.get_raw(key) or {}
            if oid in existing:
                self.stats.duplicates += 1
                return oid
            existing[oid] = obs.as_dict()
            self.put_raw(key, existing)
            self.stats.adds += 1
            if self._total is not None:
                self._total += 1
        return oid

    # -- reads --------------------------------------------------------------
    def _validated(self, raw: Dict) -> Dict[str, Observation]:
        out = {}
        for oid, d in raw.items():
            try:
                out[oid] = Observation.from_dict(d)
            except (KeyError, TypeError, ValueError):
                self._note_corrupt()
        return out

    def get(self, key: StoreKey) -> List[Observation]:
        """Observations for ``key`` in deterministic (ts, id) order."""
        raw = self.get_raw(key)
        if raw is None:
            return []
        obs = self._validated(raw)
        return [o for _, o in sorted(obs.items(),
                                     key=lambda e: (e[1].ts, e[0]))]

    def items(self) -> Iterator[Tuple[StoreKey, Dict[str, Observation]]]:
        """(key, {obs_id: Observation}) for every loadable key file."""
        for key, raw in self.iter_raw():
            yield key, self._validated(raw)

    def grouped(self) -> Dict[StoreKey, List[Observation]]:
        """key -> observations, each list in deterministic (ts, id) order."""
        return {key: [o for _, o in
                      sorted(obs.items(), key=lambda e: (e[1].ts, e[0]))]
                for key, obs in self.items()}

    def keys(self) -> List[StoreKey]:
        return [key for key, _ in self.items()]

    def snapshot(self) -> Dict[StoreKey, Dict[str, Dict]]:
        """Canonical content view (for equality checks across stores)."""
        return {key: {oid: o.as_dict() for oid, o in obs.items()}
                for key, obs in self.items()}

    def total(self, rescan: bool = False) -> int:
        """Total observation count across all keys.

        Served from the in-process counter (seeded by one directory
        scan, maintained by ``add``/``merge``/``clear``) so hot callers
        — refit threshold checks, ``server.stats()`` polls — cost O(1)
        instead of re-parsing every file. ``rescan=True`` forces a
        directory scan (picks up writes from other processes).
        """
        with self._lock:
            if rescan or self._total is None:
                self._total = sum(len(obs) for _, obs in self.items())
            return self._total

    def __len__(self) -> int:
        """Number of keys with at least one loadable observation."""
        return sum(1 for _ in self.items())

    def oldest_ts(self) -> Optional[float]:
        """Earliest observation timestamp, or None when empty."""
        ts = [o.ts for _, obs in self.items() for o in obs.values()]
        return min(ts) if ts else None

    def clear(self) -> int:
        n = super().clear()
        with self._lock:
            self._total = 0
        return n

    def compact(self, max_age_s: Optional[float] = None,
                max_per_key: Optional[int] = None) -> Dict[str, int]:
        """Prune the store: drop stale observations, cap per-key history.

        Finer-grained than the base file-level compact: observations
        older than ``max_age_s`` are dropped *within* each key file,
        each key keeps at most its ``max_per_key`` newest (by
        timestamp; the newest observation per key always survives),
        unparseable files and keys left empty are deleted. A long-lived
        deployment (e.g. every ``dryrun --predict`` sweep appending
        here) grows without bound otherwise — and refit targets only
        use each key's newest window anyway. Returns removal counts.

        Layout-agnostic: records that no longer load are purged through
        the engine (``_purge_unloadable``), per-observation pruning goes
        through ``get_raw``/``put_raw``/``_delete_key``, and the final
        ``_reclaim`` lets the segment engine rewrite away dead bytes
        (a no-op for the file-per-key layout).
        """
        now = time.time()
        removed = {"expired": 0, "over_cap": 0,
                   "corrupt_files": self._purge_unloadable()}
        for key in [k for k, _ in self.iter_raw()]:
            with self._lock:
                obs = self.get_raw(key)
                if obs is None:
                    continue  # vanished/corrupted since the listing
                keep = dict(obs)
                if max_age_s is not None:
                    fresh = {oid: d for oid, d in keep.items()
                             if now - float(d.get("ts", 0.0)) <= max_age_s}
                    removed["expired"] += len(keep) - len(fresh)
                    keep = fresh
                if max_per_key is not None and len(keep) > max_per_key:
                    newest = sorted(keep.items(),
                                    key=lambda e: (float(e[1].get("ts", 0.0)),
                                                   e[0]))[-max_per_key:]
                    removed["over_cap"] += len(keep) - len(newest)
                    keep = dict(newest)
                if len(keep) == len(obs):
                    continue
                if keep:
                    self.put_raw(key, keep)
                else:
                    self._delete_key(key)
                self._total = None  # recount lazily
        self._reclaim()  # segment engine: rewrite away the dead bytes
        return {**removed,
                "removed": removed["expired"] + removed["over_cap"],
                "kept": self.total(rescan=True)}

    def info(self) -> Dict[str, int]:
        return {"feedback_keys": len(self),
                "feedback_total": self.total(), **self.stats.as_dict()}


class FeedbackStore(FeedbackValues, JsonFileStore):
    """Durable measured-cost observations, one JSON file per key (the
    historical layout)."""


class SegmentFeedbackStore(FeedbackValues, SegmentLogStore):
    """Feedback store on the append-only segment-log engine."""


def make_feedback_store(root: str,
                        backend: Optional[str] = None) -> FeedbackValues:
    """Feedback store on the selected engine (arg >
    ``REPRO_STORE_BACKEND`` env var > ``json``)."""
    cls = {"json": FeedbackStore,
           "segment": SegmentFeedbackStore}[store_backend(backend)]
    return cls(root)


class CalibrationWindow:
    """Rolling predicted-vs-observed calibration (windowed MRE + drift).

    ``observe`` records one completed job; ``metrics`` reports, over the
    last ``window`` completions: MRE for time and memory (the paper's
    metric, now measured online), signed relative drift
    (mean((pred - obs) / obs); negative = the predictor underestimates),
    and the same per prediction generation — the split that shows a
    refit actually helped (old-generation MRE vs new-generation MRE).
    """

    def __init__(self, window: int = 256):
        self.window = int(window)
        self._obs: deque = deque(maxlen=self.window)
        self._lock = threading.Lock()

    def observe(self, pred_time_s: float, obs_time_s: float,
                pred_mem_bytes: float, obs_mem_bytes: float,
                generation: Optional[int] = None) -> None:
        with self._lock:
            self._obs.append((float(pred_time_s), float(obs_time_s),
                              float(pred_mem_bytes), float(obs_mem_bytes),
                              generation))

    @staticmethod
    def _agg(rows) -> Dict[str, float]:
        def rel(pred, obs):
            return (pred - obs) / obs if obs else math.inf
        t_rel = [rel(pt, ot) for pt, ot, _, _, _ in rows]
        m_rel = [rel(pm, om) for _, _, pm, om, _ in rows]
        n = len(rows)
        return {"count": n,
                "time_mre": sum(abs(r) for r in t_rel) / n,
                "mem_mre": sum(abs(r) for r in m_rel) / n,
                "time_drift": sum(t_rel) / n,
                "mem_drift": sum(m_rel) / n}

    def metrics(self) -> Dict:
        with self._lock:
            rows = list(self._obs)
        if not rows:
            return {"count": 0, "time_mre": None, "mem_mre": None,
                    "time_drift": None, "mem_drift": None,
                    "by_generation": {}}
        by_gen: Dict[Optional[int], list] = {}
        for row in rows:
            by_gen.setdefault(row[4], []).append(row)
        out = self._agg(rows)
        out["by_generation"] = {gen: self._agg(grp)
                                for gen, grp in sorted(
                                    by_gen.items(),
                                    key=lambda e: (-1 if e[0] is None
                                                   else e[0]))}
        return out

    def reset(self) -> None:
        with self._lock:
            self._obs.clear()


class TenantCalibration:
    """Per-tenant :class:`CalibrationWindow` family, keyed by job owner.

    Admission inflates a tenant's reservations by that tenant's own
    observed drift (a tenant whose jobs consistently run 30% hotter than
    predicted reserves 30% more), instead of letting one noisy tenant
    skew the shared window. Untenanted observations (``tenant == ""``)
    still land in the shared ``CalibrationWindow`` owned by the server;
    this class only tracks named tenants.
    """

    def __init__(self, window: int = 256):
        self.window = int(window)
        self._tenants: Dict[str, CalibrationWindow] = {}
        self._lock = threading.Lock()

    def window_for(self, tenant: str) -> CalibrationWindow:
        with self._lock:
            win = self._tenants.get(tenant)
            if win is None:
                win = self._tenants[tenant] = CalibrationWindow(self.window)
            return win

    def observe(self, tenant: str, pred_time_s: float, obs_time_s: float,
                pred_mem_bytes: float, obs_mem_bytes: float,
                generation: Optional[int] = None) -> None:
        if not tenant:
            return
        self.window_for(tenant).observe(pred_time_s, obs_time_s,
                                        pred_mem_bytes, obs_mem_bytes,
                                        generation=generation)

    def inflation(self, tenant: str, kind: str = "time", *,
                  cap: float = 2.0, min_count: int = 8) -> float:
        """Reservation multiplier from the tenant's observed drift.

        Drift is ``mean((pred - obs) / obs)``; negative means the
        predictor underestimates this tenant, so reservations scale by
        ``1 / (1 + drift)`` (clamped to ``[1.0, cap]``). Overestimating
        tenants are left alone — admission never shrinks a reservation
        below the prediction. Fewer than ``min_count`` observations is
        no evidence: multiplier 1.0.
        """
        if not tenant:
            return 1.0
        with self._lock:
            win = self._tenants.get(tenant)
        if win is None:
            return 1.0
        m = win.metrics()
        if (m["count"] or 0) < min_count:
            return 1.0
        drift = m.get(f"{kind}_drift")
        if drift is None or drift >= 0.0:
            return 1.0
        denom = 1.0 + drift
        if denom <= 0.0:
            return float(cap)
        return float(min(cap, max(1.0, 1.0 / denom)))

    def metrics(self) -> Dict[str, Dict]:
        with self._lock:
            tenants = dict(self._tenants)
        return {t: win.metrics() for t, win in sorted(tenants.items())}

    def reset(self) -> None:
        with self._lock:
            self._tenants.clear()
