"""Batched prediction service with train-step trace caching (paper §4.3 online).

``DNNAbacus.predict_config`` answers one admission-control query by
building the model, tracing the train step, and extracting the NSM — all
from scratch. At datacenter query rates (scheduler loops, per-job
admission control) that trace dominates end-to-end latency, and it is
fully determined by ``(config, batch, seq)``. ``PredictionService``
amortizes it:

  * **Trace cache** — content-addressed by ``(config fingerprint, batch,
    seq)`` where the fingerprint hashes every ``ModelConfig`` field, so
    structurally identical queries (including distinct-but-equal config
    objects) never re-build or re-trace. LRU-bounded, thread-safe, with
    in-flight deduplication of concurrent identical misses.
  * **Batched queries** — ``predict_many`` featurizes N queries into one
    design matrix and runs the time/memory ensembles once, instead of N
    single-row predictions.
  * **Scheduling bridge** — ``jobs``/``schedule`` turn query estimates
    directly into GA/optimal/random placement (``repro_torch.core.scheduler``).

The service holds a *reference* to the fitted ``DNNAbacus``; re-fitting
the predictor is picked up automatically (cached records store raw NSM
edges, featurization happens at predict time).

A copy of ``repro.serve.prediction_service`` (the port imports nothing of
the reference): the cache keys, ``stats.as_dict()`` and ``cache_info()``
are the reference's, key for key. ``trace_query`` is the port's tracer: the
train step's aten graph traced by ``make_fx`` on fake tensors. ``store`` is
the port's ``TraceStore`` (``repro_torch.serve.trace_store``).
``config_fingerprint`` hashes field values only, so equal configs of the
two packages share a key; the port's store serves a record the reference
traced as a miss, so a directory both packages write to never hands the
reference's NSM to the port's predictor.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.features import PLATFORM_TORCH_CUDA, ProfileRecord
from repro_torch.core.predictor import HBM_PER_DEVICE
from repro_torch.core.scheduler import Machine, jobs_from_estimates, schedule_jobs
from repro_torch.obs.metrics import MetricsRegistry

CacheKey = Tuple[str, int, int]


@dataclasses.dataclass(frozen=True)
class Query:
    """One admission-control question: cost of (config, batch, seq).

    ``fp`` optionally carries a precomputed config fingerprint: the
    cluster frontend fingerprints each query once to route it, and the
    owning replica reuses that key instead of re-hashing the config
    (the fingerprint is the hot path's dominant per-query cost).

    ``tc`` optionally carries a trace context
    (``{"trace": id, "span": root}``, see :mod:`repro_torch.obs.tracing`);
    it rides the query across process boundaries so every stage stamps
    spans into one coherent per-query trace.

    ``tenant`` names the submitting job owner for per-tenant admission
    quotas and tenant-keyed calibration; ``""`` means untenanted (the
    default shared quota bucket). ``deadline`` is an absolute
    ``time.monotonic()`` instant after which serving the query is wasted
    work: the tick expires it with ``DeadlineExceeded`` instead.
    """
    cfg: Any  # ModelConfig
    batch: int
    seq: int
    fp: Optional[str] = None  # precomputed config fingerprint
    tc: Optional[Dict] = None  # trace context (repro_torch.obs.tracing)
    tenant: str = ""  # job owner for quotas + calibration ("" = shared)
    deadline: Optional[float] = None  # absolute time.monotonic() deadline

    def key(self) -> Optional[CacheKey]:
        """Cache key when the fingerprint was precomputed, else None."""
        if self.fp is None:
            return None
        return (self.fp, int(self.batch), int(self.seq))


def _canonical(value):
    """Recursively reduce ``value`` to JSON-safe, process-stable primitives.

    ``json.dumps(..., default=str)`` is NOT stable across processes: any
    object whose ``str`` embeds ``id()`` (the ``<Foo object at 0x..>``
    default repr) fingerprints differently per process, and sets iterate
    in hash-seed order. Tuples and lists are also kept distinct here
    (JSON flattens both to arrays), so ``(1, 2)`` and ``[1, 2]`` config
    fields cannot collide into one cache entry.
    """
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _canonical(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, tuple):
        return {"__tuple__": [_canonical(v) for v in value]}
    if isinstance(value, list):
        return [_canonical(v) for v in value]
    if isinstance(value, (set, frozenset)):
        items = [json.dumps(_canonical(v), sort_keys=True) for v in value]
        return {"__set__": sorted(items)}
    if isinstance(value, dict):
        items = [(json.dumps(_canonical(k), sort_keys=True), _canonical(v))
                 for k, v in value.items()]
        return {"__dict__": sorted(items, key=lambda kv: kv[0])}
    if isinstance(value, bytes):
        return {"__bytes__": value.hex()}
    if hasattr(value, "dtype") and hasattr(value, "ndim"):  # numpy
        if value.ndim == 0:  # scalar (or 0-d array): plain python value
            return _canonical(value.item())
        return {"__ndarray__": _canonical(value.tolist()),
                "dtype": str(value.dtype)}
    if isinstance(value, functools.partial):
        return {"__partial__": [_canonical(value.func),
                                _canonical(value.args),
                                _canonical(dict(value.keywords))]}
    if isinstance(value, type) or callable(value):
        qn = getattr(value, "__qualname__", None)
        if qn is not None:  # named function/class: a stable identity
            return {"__name__": f"{getattr(value, '__module__', '')}.{qn}"}
        # callable *instances* (objects defining __call__) fall through to
        # the attrs-based last resort — their repr embeds id()
    # last resort: type identity + public attributes (never id()-bearing repr)
    cls = type(value)
    tag = f"{cls.__module__}.{cls.__qualname__}"
    try:
        attrs = {k: _canonical(v) for k, v in sorted(vars(value).items())
                 if not k.startswith("_")}
    except TypeError:
        s = str(value)
        if " at 0x" in s:  # default repr embeds id(): type identity only
            return {"__obj__": tag}
        return {"__obj__": tag, "str": s}
    return {"__obj__": tag, "attrs": attrs}


def config_fingerprint(cfg) -> str:
    """Content hash over every config field (stable across processes).

    The payload is canonicalized recursively (``_canonical``) before
    hashing, so nested tuples/sets/objects hash identically in every
    process — the persistent ``TraceStore`` depends on this key.
    """
    if dataclasses.is_dataclass(cfg):
        payload = _canonical(cfg)
    else:  # duck-typed config (tests): hash its public attributes
        payload = {k: _canonical(v) for k, v in sorted(vars(cfg).items())}
    blob = json.dumps(payload, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def trace_query(cfg, batch: int, seq: int) -> ProfileRecord:
    """Build + trace one train step at abstract shapes; features only.

    This is the expensive path the cache exists to amortize: model
    construction on the ``meta`` device, ``make_fx`` of the full train step
    on fake tensors, and NSM extraction. No memory is allocated on any
    device and no kernel is launched. Uses the profiler's
    ``lm_trace``/``lm_record``, as the reference does, so the NSM matches
    the offline profiling rig's (``profile_lm``) exactly.

    ``flops`` is the reference's online count, ``6 * active params * batch
    * seq``; the offline records carry the traced count instead (ROADMAP
    Queue C item 2). The traced count is kept beside it, as
    ``extra["traced_flops"]``.
    """
    from repro_torch.core.profiler import lm_record, lm_trace, trace_step

    model, step, state_specs, b = lm_trace(cfg, batch, seq)
    traced = trace_step(step, (state_specs, b))
    rec = lm_record(
        cfg, model, batch, seq,
        flops=6.0 * model.param_count(active_only=True) * batch * seq,
        nsm_edges=traced["nsm_edges"], platform=PLATFORM_TORCH_CUDA)
    rec.extra = {"traced_flops": traced["flops"]}
    return rec


class ServiceStats:
    """Cache counters, refactored onto a ``MetricsRegistry``.

    Byte-compatible with the dataclass it replaces: attribute access
    and ``+=`` mutate registry counters (``service_hits_total``, ...),
    ``as_dict()`` keeps the same keys including the derived ``queries``,
    and keyword construction (``ServiceStats(hits=3)``) still works.
    Counters are unlocked — callers mutate them under
    ``PredictionService._lock`` exactly as before.

    - hits: served from the in-memory cache
    - misses: not in memory (filled by store load or trace)
    - store_hits: misses answered by the persistent TraceStore
    - traces: misses that actually ran the tracer
    - store_errors: failed write-throughs (served memory-only)
    - est_hits: queries served from the prediction cache
    - adopts: generations adopted (prediction cache cleared)
    """

    COUNTERS = ("hits", "misses", "evictions", "store_hits", "traces",
                "store_errors", "est_hits", "adopts")

    def __init__(self, registry=None, **initial):
        object.__setattr__(self, "_metrics", {})
        registry = registry if registry is not None else MetricsRegistry()
        object.__setattr__(self, "registry", registry)
        metrics = self.__dict__["_metrics"]
        for name in self.COUNTERS:
            metrics[name] = registry.counter(f"service_{name}_total")
        for k, v in initial.items():
            setattr(self, k, v)

    def __getattr__(self, name):
        metrics = self.__dict__.get("_metrics")
        if metrics is not None and name in metrics:
            return metrics[name].value
        raise AttributeError(name)

    def __setattr__(self, name, value):
        metrics = self.__dict__.get("_metrics")
        if metrics is not None and name in metrics:
            metrics[name].set(value)
        else:
            object.__setattr__(self, name, value)

    @property
    def queries(self) -> int:
        return self.hits + self.misses

    def as_dict(self) -> Dict[str, int]:
        metrics = self.__dict__["_metrics"]
        d = {name: metrics[name].value for name in self.COUNTERS}
        d["queries"] = d["hits"] + d["misses"]
        return d

    def reset(self) -> None:
        for name in self.COUNTERS:
            setattr(self, name, 0)


class PredictionService:
    """Online query engine over a fitted ``DNNAbacus``."""

    def __init__(self, abacus, max_cache_entries: int = 1024,
                 hbm_budget: float = HBM_PER_DEVICE,
                 tracer: Callable[..., ProfileRecord] = trace_query,
                 store=None, cache_predictions: bool = True, metrics=None):
        self.abacus = abacus
        self.hbm_budget = float(hbm_budget)
        self.max_cache_entries = max_cache_entries
        self.cache_predictions = bool(cache_predictions)
        self._tracer = tracer  # injectable: tests count trace calls
        self.store = store  # optional TraceStore: cross-process persistence
        self._cache: "OrderedDict[CacheKey, ProfileRecord]" = OrderedDict()
        self._inflight: Dict[CacheKey, threading.Event] = {}
        self._lock = threading.Lock()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.stats = ServiceStats(self.metrics)
        # computed gauges, snapshot-time only: never touched on the hot path
        self.metrics.register_callback(
            lambda: {"service_cache_entries": len(self._cache),
                     "service_est_entries": len(self._est_cache),
                     "service_generation": self.generation})
        # model generation (bumped by adopt()) + per-generation prediction
        # cache: (key -> (time, mem)) valid only for the generation that
        # computed it — invalidated wholesale on every swap, while the
        # trace cache and persistent store survive (traces are
        # generation-independent raw features).
        self.generation = 0
        self._est_cache: "OrderedDict[CacheKey, Tuple[float, float]]" = \
            OrderedDict()

    # -- trace cache --------------------------------------------------------
    def cache_key(self, cfg, batch: int, seq: int) -> CacheKey:
        return (config_fingerprint(cfg), int(batch), int(seq))

    def record_for(self, cfg, batch: int, seq: int) -> ProfileRecord:
        """Cached (config, batch, seq) -> ProfileRecord feature template.

        Concurrent identical queries are deduplicated: one thread runs
        the trace, the rest wait on its in-flight event and read the
        cache — a burst of N equal queries costs one trace, not N.

        With a backing ``TraceStore``, a memory miss first tries the
        store (a prior process may have traced this key) and only then
        runs the tracer; fresh traces are written through to the store.
        """
        return self._record_for_key(self.cache_key(cfg, batch, seq),
                                    cfg, batch, seq)

    def _record_for_key(self, key: CacheKey, cfg, batch: int,
                        seq: int) -> ProfileRecord:
        """``record_for`` with a precomputed key (the fingerprint is the
        hot path's dominant per-query cost; batched callers compute it
        once and reuse it for record, prediction cache, and store)."""
        while True:
            with self._lock:
                rec = self._cache.get(key)
                if rec is not None:
                    self._cache.move_to_end(key)
                    self.stats.hits += 1
                    return rec
                ev = self._inflight.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[key] = ev
                    self.stats.misses += 1
                    break
            ev.wait()  # another thread is tracing this key; then re-check
        try:
            rec = self.store.get(key) if self.store is not None else None
            if rec is not None:  # warm start: a prior process traced this
                with self._lock:
                    self.stats.store_hits += 1
            else:
                rec = self._tracer(cfg, batch, seq)
                with self._lock:
                    self.stats.traces += 1
                if self.store is not None:
                    try:
                        self.store.put(key, rec)
                    except Exception:  # full/read-only disk: the store is
                        with self._lock:  # an accelerator, never a gate —
                            self.stats.store_errors += 1  # stay memory-only

            with self._lock:
                self._cache[key] = rec
                self._cache.move_to_end(key)
                while len(self._cache) > self.max_cache_entries:
                    self._cache.popitem(last=False)
                    self.stats.evictions += 1
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            ev.set()
        return rec

    def cached_record(self, key: CacheKey) -> Optional[ProfileRecord]:
        """Already-traced record for ``key`` from memory only (no trace).

        The refit path uses this to join feedback observations with
        their feature templates without paying a trace for keys the
        service has never seen.
        """
        with self._lock:
            return self._cache.get(key)

    def cache_info(self) -> Dict[str, int]:
        """Counters, with in-memory entries distinct from store entries."""
        store_entries = len(self.store) if self.store is not None else 0
        with self._lock:
            return {"entries": len(self._cache),
                    "est_entries": len(self._est_cache),
                    "store_entries": store_entries,
                    "generation": self.generation,
                    **self.stats.as_dict()}

    def clear_cache(self, reset_stats: bool = False) -> None:
        """Drop cached records AND wake/forget in-flight traces.

        Waiters blocked on an in-flight event re-check the cache, find
        neither entry nor event, and become tracers themselves — a clear
        mid-trace costs at most one duplicate trace, never a deadlock.
        The backing store (if any) is NOT cleared: it is the durable
        layer shared with other processes (``store.clear()`` is explicit).
        """
        with self._lock:
            self._cache.clear()
            self._est_cache.clear()
            inflight, self._inflight = self._inflight, {}
            if reset_stats:
                self.stats.reset()
        for ev in inflight.values():
            ev.set()

    # -- model generations --------------------------------------------------
    def adopt(self, abacus, generation: Optional[int] = None) -> bool:
        """Hot-swap the predictor to a new model generation.

        Atomically replaces the ensembles and invalidates the
        per-generation prediction cache; the trace cache and persistent
        store are untouched (raw features outlive every generation).
        ``generation`` defaults to the next number; a stale publish
        (``generation`` <= the current one) is refused and returns
        False, so out-of-order deliveries cannot roll the predictor
        back — generations are monotone.
        """
        with self._lock:
            if generation is None:
                generation = self.generation + 1
            elif int(generation) <= self.generation:
                return False
            self.abacus = abacus
            self.generation = int(generation)
            self._est_cache.clear()
            self.stats.adopts += 1
        return True

    def publish_generation(self, gen) -> bool:
        """Sink API for ``OnlineRefitter``: adopt a ``ModelGeneration``."""
        return self.adopt(gen.abacus, gen.number)

    def snapshot(self):
        """Consistent (abacus, generation) pair for one batch of work.

        Callers that predict a whole micro-batch (``AbacusServer``) use
        the snapshot so a concurrent ``adopt`` cannot mix generations
        within the batch.
        """
        with self._lock:
            return self.abacus, self.generation

    # -- queries ------------------------------------------------------------
    def _estimate(self, rec: ProfileRecord, t: float, m: float,
                  generation: Optional[int] = None) -> Dict:
        return {"model": rec.model_name, "time_s": float(t),
                "memory_bytes": float(m), "hbm_budget": self.hbm_budget,
                "admitted": float(m) <= self.hbm_budget,
                "generation": (self.generation if generation is None
                               else int(generation))}

    def predict_one(self, cfg, batch: int, seq: int) -> Dict:
        """Admission-control estimate for a (ModelConfig, batch, seq) job."""
        return self.predict_many([Query(cfg, batch, seq)])[0]

    def predict_many(self, queries: Sequence) -> List[Dict]:
        """Batched queries: one design matrix, one ensemble pass per target.

        ``queries`` holds ``Query`` objects or ``(cfg, batch, seq)``
        tuples. Predictions are memoized per key in a per-generation
        cache (cleared by ``adopt``): a repeat query under the same
        generation skips the ensemble pass entirely.
        """
        qs = [q if isinstance(q, Query) else Query(*q) for q in queries]
        if not qs:
            return []
        keys = [q.key() or self.cache_key(q.cfg, q.batch, q.seq) for q in qs]
        recs = [self._record_for_key(k, q.cfg, q.batch, q.seq)
                for k, q in zip(keys, qs)]
        abacus, gen = self.snapshot()
        preds, _ = self.predict_keys(keys, recs, abacus=abacus,
                                     generation=gen)
        return [self._estimate(r, *preds[k], generation=gen)
                for r, k in zip(recs, keys)]

    def predict_keys(self, keys: Sequence[CacheKey],
                     records: Sequence[ProfileRecord], abacus=None,
                     generation: Optional[int] = None):
        """Keyed batched prediction with per-generation memoization.

        Returns ``({key: (time, mem)}, ran_ensemble)``. Keys already in
        the prediction cache (same generation) skip the ensemble; the
        rest run in ONE batched pass and are memoized — unless the
        snapshot generation no longer matches (a concurrent ``adopt``),
        in which case results are returned but never poison the newer
        generation's cache. Duplicate keys cost one prediction.
        """
        if abacus is None or generation is None:
            abacus, generation = self.snapshot()
        use_cache = self.cache_predictions
        cached: Dict[CacheKey, Tuple[float, float]] = {}
        with self._lock:
            if use_cache and generation == self.generation:
                for k in keys:
                    hit = self._est_cache.get(k)
                    if hit is not None:
                        self._est_cache.move_to_end(k)  # LRU, not FIFO
                        cached[k] = hit
            self.stats.est_hits += sum(1 for k in keys if k in cached)
        cold = [k for k in dict.fromkeys(keys) if k not in cached]
        rec_of = dict(zip(keys, records))
        preds: Dict[CacheKey, Tuple[float, float]] = dict(cached)
        if cold:
            t_pred, m_pred = abacus.predict([rec_of[k] for k in cold])
            for k, t, m in zip(cold, t_pred, m_pred):
                preds[k] = (float(t), float(m))
            with self._lock:
                if use_cache and generation == self.generation:
                    for k in cold:
                        self._est_cache[k] = preds[k]
                        self._est_cache.move_to_end(k)
                    while len(self._est_cache) > self.max_cache_entries:
                        self._est_cache.popitem(last=False)
        return preds, bool(cold)

    def predict_records(self, records: Sequence[ProfileRecord],
                        abacus=None):
        """Batched (time, memory) prediction for already-traced records.

        ``abacus`` pins the ensembles for the whole batch (pass a
        ``snapshot()`` result to keep a micro-batch on one generation
        even if ``adopt`` lands mid-flight).
        """
        return (abacus or self.abacus).predict(list(records))

    # -- scheduling bridge (paper §4.3) -------------------------------------
    def jobs(self, queries: Sequence, time_scale: float = 1.0,
             mem_pad: float = 0.0):
        """Scheduler ``Job``s from batched query estimates."""
        ests = self.predict_many(queries)
        return jobs_from_estimates(
            [e["model"] for e in ests], [e["time_s"] for e in ests],
            [e["memory_bytes"] for e in ests],
            time_scale=time_scale, mem_pad=mem_pad)

    def schedule(self, queries: Sequence, machines: Sequence[Machine],
                 plan: str = "ga", time_scale: float = 1.0,
                 mem_pad: float = 0.0, **kw):
        """Place predicted jobs on machines via the chosen plan."""
        return schedule_jobs(self.jobs(queries, time_scale, mem_pad),
                             machines, plan=plan, **kw)
