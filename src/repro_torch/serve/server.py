"""AbacusServer: async micro-batched admission gateway (paper §4.3 at scale).

``PredictionService`` answers queries synchronously, one caller at a
time. In the datacenter setting the paper targets, admission queries
arrive concurrently from many tenants; serving them serially wastes the
two batchable stages — the ensemble pass (one design matrix amortizes N
queries) and cold trace misses (independent, thread-parallel).

``AbacusServer`` mirrors the continuous-batching shape of
``repro_torch.serve.engine.DecodeEngine``: clients ``submit()`` queries into a
queue and get a ``Future``; a single worker thread wakes, coalesces
*everything* pending into one micro-batch per tick, resolves cold
misses concurrently on a trace pool, runs ONE ensemble pass for the
whole batch, and resolves each future with its admission verdict.

    with AbacusServer(service) as srv:
        futs = [srv.submit(cfg, b, 2048) for b in (8, 16, 32)]
        ests = [f.result() for f in futs]          # admission verdicts

A burst of N identical queries costs one trace (the service's in-flight
dedup) and one ensemble pass (the micro-batch); distinct cold queries
trace concurrently instead of serially inside ``predict_many``.

A copy of ``repro.serve.server`` (the port imports nothing of the
reference) on the port's service, feedback store, metrics and tracing:
every counter, ``stats()`` / ``server_info()`` key and event name is the
reference's. A shed query's floor comes from the port's
``repro_torch.analysis.roofline``, whose rates are the H100's.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.roofline import floor_estimate
from repro_torch.obs import events
from repro_torch.obs.metrics import CounterDict, MetricsRegistry, merge_snapshots
from repro_torch.obs.tracing import SpanSink, make_span
from repro_torch.serve.feedback_store import CalibrationWindow, TenantCalibration
from repro_torch.serve.prediction_service import PredictionService, Query


class DeadlineExceeded(RuntimeError):
    """The query's deadline passed before it could be served.

    ``where`` records which stage expired it: ``"server"`` when the
    serving tick found it already dead, ``"frontend"`` when a cluster
    frontend expired a parked query before replaying it onto a new ring
    (expired work is never replayed).
    """

    def __init__(self, msg: str, where: str = "server"):
        super().__init__(msg)
        self.where = where


class QuotaExceeded(RuntimeError):
    """The tenant's weighted-fair share of the queue is exhausted."""

    def __init__(self, msg: str, tenant: str = ""):
        super().__init__(msg)
        self.tenant = tenant


def _results_by_deadline(futs: Sequence[Future],
                         timeout: Optional[float]) -> List:
    """Collect ``fut.result()``s under ONE shared deadline.

    ``[f.result(timeout) for f in futs]`` compounds the timeout per
    future (N futures can wait up to N x timeout total); this converts
    ``timeout`` into a single absolute deadline and gives each future
    only what remains of it, raising the builtin ``TimeoutError`` naming
    how many futures were still pending.
    """
    if timeout is None:
        return [f.result() for f in futs]
    deadline = time.monotonic() + float(timeout)
    out = []
    for i, f in enumerate(futs):
        try:
            out.append(f.result(max(0.0, deadline - time.monotonic())))
        except FutureTimeout:
            pending = sum(1 for g in futs[i:] if not g.done())
            raise TimeoutError(
                f"predict_many deadline of {timeout}s exhausted with "
                f"{pending} of {len(futs)} futures still pending") from None
    return out


class ServerStats:
    """Gateway counters, refactored onto a ``MetricsRegistry``.

    Attribute access is byte-compatible with the dataclass this used to
    be: ``stats.ticks += 1`` mutates the registry counter named
    ``server_ticks_total``, ``as_dict()`` returns the same keys in the
    same order, and zero-arg / keyword construction still work (tests
    and stubs build bare ``ServerStats()`` instances). Counters stay
    unlocked — callers synchronize under ``AbacusServer._cond`` exactly
    as before; the registry only gives them names and an exposition
    path.
    """

    COUNTERS = ("submitted", "completed", "failed", "ticks",
                "ensemble_passes", "max_batch", "cold_traces",
                "gen_swaps", "observations")
    # high-water marks merge by max, not sum
    _GAUGES = frozenset({"max_batch"})

    def __init__(self, registry: Optional[MetricsRegistry] = None, **initial):
        object.__setattr__(self, "_metrics", {})
        registry = registry if registry is not None else MetricsRegistry()
        object.__setattr__(self, "registry", registry)
        metrics = self.__dict__["_metrics"]
        for name in self.COUNTERS:
            if name in self._GAUGES:
                metrics[name] = registry.gauge(f"server_{name}")
            else:
                metrics[name] = registry.counter(f"server_{name}_total")
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

    def as_dict(self) -> Dict[str, int]:
        metrics = self.__dict__["_metrics"]
        return {name: metrics[name].value for name in self.COUNTERS}

    @property
    def mean_batch(self) -> float:
        """Mean micro-batch size actually coalesced per tick.

        Failed queries still occupied a batch slot — dividing only
        ``completed`` by ``ticks`` would drag the reported coalescing
        size toward zero on failure-heavy workloads.
        """
        return (self.completed + self.failed) / self.ticks \
            if self.ticks else 0.0

    def __call__(self) -> Dict:
        """``server.stats()``: the full stats dict, counters included.

        The server stamps ``_full_stats`` onto its own ``ServerStats``
        instance so the counters stay attribute-addressable
        (``server.stats.ticks``) while ``server.stats()`` reports the
        whole picture — counters plus generation, rolling calibration,
        and refit state.
        """
        fn = getattr(self, "_full_stats", None)
        return fn() if fn is not None else self.as_dict()


class AbacusServer:
    """Event-loop front door over a ``PredictionService``.

    One worker thread owns the micro-batch loop; ``trace_workers``
    bounds the thread pool used for concurrent cold-miss traces.
    ``max_batch`` caps how many queued queries one tick coalesces
    (backpressure: the rest stay queued for the next tick).
    """

    def __init__(self, service: PredictionService, max_batch: int = 256,
                 trace_workers: int = 4, feedback=None, refitter=None,
                 calibration_window: int = 256,
                 metrics: Optional[MetricsRegistry] = None,
                 max_queue: Optional[int] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 shed_watermark: Optional[int] = None):
        self.service = service
        self.max_batch = int(max_batch)
        self.trace_workers = int(trace_workers)
        # overload controls (None = unbounded, the legacy behaviour):
        # `max_queue` bounds the queue with weighted-fair per-tenant
        # shares; `shed_watermark` is the saturation depth past which
        # new submits are answered from the zero-trace roofline floor.
        self.max_queue = None if max_queue is None else int(max_queue)
        self.shed_watermark = (None if shed_watermark is None
                               else int(shed_watermark))
        self.tenant_weights: Dict[str, float] = dict(tenant_weights or {})
        # merged into every estimate this server resolves: a cluster
        # replica stamps {"replica": name} so fleet-level tests and
        # clients can attribute (tick, generation) pairs per replica.
        self.est_tags: Dict[str, object] = {}
        # one registry per gateway: shared with the service (so server_*
        # and service_* counters land in one snapshot) unless the caller
        # supplies its own. `metrics.enabled=False` keeps counters live
        # (tick numbering is load-bearing) but skips histogram observes
        # and timing stamps — the baseline the <3% overhead gate uses.
        self.metrics = (metrics if metrics is not None
                        else getattr(service, "metrics", None)
                        or MetricsRegistry())
        self.stats = ServerStats(self.metrics)
        self.stats._full_stats = self._stats_dict  # server.stats() works too
        self.span_sink = SpanSink()
        self._h_latency = self.metrics.histogram(
            "server_query_latency_seconds",
            help="submit-to-resolution latency per query")
        self._h_queue_wait = self.metrics.histogram(
            "server_queue_wait_seconds",
            help="time between enqueue and the serving tick starting")
        self._h_tick = self.metrics.histogram(
            "server_tick_seconds", help="wall time per micro-batch tick")
        self._h_cold = self.metrics.histogram(
            "server_cold_trace_phase_seconds",
            help="record-resolution phase duration when cold traces ran")
        self._h_ensemble = self.metrics.histogram(
            "server_ensemble_phase_seconds",
            help="ensemble-pass phase duration when the pass ran")
        self.metrics.register_callback(
            lambda: {"server_queued": len(self._queue),
                     "server_running": int(self._running)})
        # feedback loop (optional): measured completions land in the
        # FeedbackStore, calibration tracks predicted-vs-observed, and
        # the refitter publishes new generations back through us.
        self.feedback = feedback      # FeedbackStore or None
        self.calibration = CalibrationWindow(window=calibration_window)
        self.tenant_calibration = TenantCalibration(window=calibration_window)
        self.refitter = refitter      # OnlineRefitter or None
        if refitter is not None:
            refitter.add_sink(self)
        # overload accounting: NEW metric series (server_shed_total, ...)
        # next to the legacy ServerStats counters, never replacing them.
        # Mutated under self._cond like every other counter here.
        self.overload = CounterDict(self.metrics, "server_",
                                    ("shed", "expired", "quota_rejected"))
        self._tenant_queued: Dict[str, int] = {}
        self._queue: Deque[Tuple[Query, Future]] = deque()
        self._cond = threading.Condition()
        self._pending_gen = None      # generation awaiting a tick boundary
        self._worker: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._running = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "AbacusServer":
        if self._running:
            return self
        if self._worker is not None and self._worker.is_alive():
            raise RuntimeError("previous worker is still draining; "
                               "call stop() again once it finishes")
        self._running = True
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.trace_workers,
                                            thread_name_prefix="abacus-trace")
        self._worker = threading.Thread(target=self._loop,
                                        name="abacus-server", daemon=True)
        self._worker.start()
        return self

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        """Drain-then-stop: queued queries are served before shutdown.

        If the worker does not finish draining within ``timeout`` it is
        left running (it still exits after its current batch); the trace
        pool and queue are only torn down once the worker is gone —
        tearing them down under a live worker would strand its batch.
        """
        with self._cond:
            if not self._running and self._worker is None:
                return
            self._running = False
            self._cond.notify_all()
        worker = self._worker
        if worker is not None:
            worker.join(timeout)
            if worker.is_alive():  # still draining: do not yank the pool
                return
            self._worker = None
        # a publish that raced the worker's exit may still sit queued
        with self._cond:
            self._apply_pending_locked()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        # anything still queued after the drain tick fails loudly
        with self._cond:
            leftovers, self._queue = list(self._queue), deque()
            self._tenant_queued.clear()
        for _, fut in leftovers:
            if not fut.done():
                try:
                    fut.set_exception(RuntimeError("AbacusServer stopped"))
                except Exception:
                    pass  # client cancelled it first

    def __enter__(self) -> "AbacusServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def running(self) -> bool:
        return self._running

    @property
    def draining(self) -> bool:
        """True while a stopped worker is still finishing its drain.

        ``stop(timeout)`` can return before the worker exits (a slow
        trace mid-tick); callers that need a *quiesced* server — the
        reshard protocol migrates store slices only once writes ceased
        — must check this, not just ``running``.
        """
        worker = self._worker
        return (worker is not None and worker.is_alive()
                and not self._running)

    # -- client API ---------------------------------------------------------
    def _quota_exceeded_locked(self, tenant: str) -> bool:
        """Weighted-fair share check; callers hold ``self._cond``.

        A tenant's share of ``max_queue`` is its weight over the total
        weight of tenants with queued work (plus itself): an idle fleet
        lets one tenant use the whole queue, contention splits it by
        weight, and every tenant keeps a floor of one slot.
        """
        if self.max_queue is None:
            return False
        queued = self._tenant_queued.get(tenant, 0)
        active = set(self._tenant_queued)
        active.add(tenant)
        w = float(self.tenant_weights.get(tenant, 1.0))
        w_active = sum(float(self.tenant_weights.get(t, 1.0))
                       for t in active)
        cap = max(1, math.ceil(self.max_queue * w / w_active))
        return queued >= cap

    def _shed_estimate(self, q: Query) -> Dict:
        """Roofline-floor answer for a query shed past the watermark."""
        est = floor_estimate(q.cfg, q.batch, q.seq)
        hbm = getattr(self.service, "hbm_budget", None)
        est["hbm_budget"] = hbm
        est["admitted"] = (est["memory_bytes"] <= hbm if hbm is not None
                           else True)
        est["generation"] = self.service.generation
        est.update(self.est_tags)
        return est

    def submit(self, cfg, batch: int, seq: int,
               fp: Optional[str] = None, tc=None, *, tenant: str = "",
               deadline: Optional[float] = None) -> Future:
        """Enqueue one admission query; resolves to the estimate dict.

        ``fp`` optionally carries the config fingerprint a router
        already computed, sparing this server's worker the re-hash.
        ``tc`` optionally carries a trace context (see
        :mod:`repro_torch.obs.tracing`): the serving tick then records spans
        for this query and ships them back inside the estimate under
        ``"_trace"``.

        Overload ladder (each stage only when configured): a tenant past
        its weighted-fair queue share is rejected synchronously with
        :class:`QuotaExceeded`; a queue past ``shed_watermark`` answers
        immediately from the roofline floor (``degraded: True``); a
        queued query whose ``deadline`` (absolute ``time.monotonic()``)
        passes before its tick fails with :class:`DeadlineExceeded`.
        """
        fut: Future = Future()
        if self.metrics.enabled:
            fut._obs_t0 = time.perf_counter()
        q = Query(cfg, int(batch), int(seq), fp=fp, tc=tc,
                  tenant=tenant, deadline=deadline)
        shed = False
        with self._cond:
            if not self._running:
                raise RuntimeError("AbacusServer is not running "
                                   "(use `with AbacusServer(...)` or start())")
            if self._quota_exceeded_locked(q.tenant):
                self.overload["quota_rejected"] += 1
                raise QuotaExceeded(
                    f"tenant {q.tenant!r} queue quota exhausted",
                    tenant=q.tenant)
            if (self.shed_watermark is not None
                    and len(self._queue) >= self.shed_watermark):
                self.stats.submitted += 1
                self.stats.completed += 1
                self.overload["shed"] += 1
                shed = True
            else:
                self._queue.append((q, fut))
                self._tenant_queued[q.tenant] = \
                    self._tenant_queued.get(q.tenant, 0) + 1
                self.stats.submitted += 1
                self._cond.notify()
        if shed:
            fut.set_result(self._shed_estimate(q))
        return fut

    def submit_many(self, queries: Sequence) -> List[Future]:
        qs = [q if isinstance(q, Query) else Query(*q) for q in queries]
        futs: List[Future] = [Future() for _ in qs]
        if self.metrics.enabled:
            t0 = time.perf_counter()  # one clock read for the whole wave
            for fut in futs:
                fut._obs_t0 = t0
        shed_idx: List[int] = []
        quota_idx: List[int] = []
        with self._cond:
            if not self._running:
                raise RuntimeError("AbacusServer is not running "
                                   "(use `with AbacusServer(...)` or start())")
            for i, (q, fut) in enumerate(zip(qs, futs)):
                if self._quota_exceeded_locked(q.tenant):
                    # batch submits report quota per-future instead of
                    # failing the whole wave synchronously
                    self.overload["quota_rejected"] += 1
                    quota_idx.append(i)
                elif (self.shed_watermark is not None
                        and len(self._queue) >= self.shed_watermark):
                    self.stats.submitted += 1
                    self.stats.completed += 1
                    self.overload["shed"] += 1
                    shed_idx.append(i)
                else:
                    self._queue.append((q, fut))
                    self._tenant_queued[q.tenant] = \
                        self._tenant_queued.get(q.tenant, 0) + 1
                    self.stats.submitted += 1
            self._cond.notify()
        for i in quota_idx:
            futs[i].set_exception(QuotaExceeded(
                f"tenant {qs[i].tenant!r} queue quota exhausted",
                tenant=qs[i].tenant))
        for i in shed_idx:
            futs[i].set_result(self._shed_estimate(qs[i]))
        return futs

    def predict_one(self, cfg, batch: int, seq: int,
                    timeout: Optional[float] = None) -> Dict:
        """Synchronous convenience: submit and wait for the verdict."""
        return self.submit(cfg, batch, seq).result(timeout)

    def predict_many(self, queries: Sequence,
                     timeout: Optional[float] = None) -> List[Dict]:
        return _results_by_deadline(self.submit_many(queries), timeout)

    # -- model generations --------------------------------------------------
    def publish_generation(self, gen) -> bool:
        """Queue a ``ModelGeneration`` for adoption at a tick boundary.

        The swap is applied by the worker thread *between* micro-batch
        ticks, so an in-flight micro-batch always finishes on the
        generation it started with — a hot swap can never mix
        generations within one tick. With no live worker (bare server)
        nothing is in flight and the service adopts immediately.
        """
        with self._cond:
            # queue only while the worker is RUNNING: during shutdown the
            # worker may already be past its final pending check, so a
            # queued generation could be stranded — adopt directly
            # instead (safe: an in-flight tick predicts from its own
            # snapshot, so a mid-drain adopt still can't mix a tick).
            if (self._running and self._worker is not None
                    and self._worker.is_alive()):
                if (self._pending_gen is None
                        or gen.number > self._pending_gen.number):
                    self._pending_gen = gen
                self._cond.notify_all()
                return True
        adopted = self.service.adopt(gen.abacus, gen.number)
        if adopted:
            # the direct-adopt path bypasses _apply_pending_locked, but a
            # successful swap is a swap — count it, or fleet-level swap
            # accounting disagrees with the generations actually serving.
            with self._cond:
                self.stats.gen_swaps += 1
            events.emit("gen_swap", generation=gen.number, **self.est_tags)
        return adopted

    def _apply_pending_locked(self) -> None:
        """Adopt a queued generation; callers hold ``self._cond``."""
        gen, self._pending_gen = self._pending_gen, None
        if gen is not None and self.service.adopt(gen.abacus, gen.number):
            self.stats.gen_swaps += 1
            events.emit("gen_swap", generation=gen.number, **self.est_tags)

    # -- feedback loop ------------------------------------------------------
    def observe(self, cfg, batch: int, seq: int, time_s: float,
                mem_bytes: float, *, predicted_time_s: Optional[float] = None,
                predicted_mem_bytes: Optional[float] = None,
                generation: Optional[int] = None, job_id: str = "",
                fp: Optional[str] = None, tenant: str = "") -> None:
        """Report one finished job's measured cost.

        Feeds the rolling calibration window (when the prediction that
        admitted the job is supplied), persists the observation in the
        ``FeedbackStore`` (when attached), and wakes the refitter.
        Non-positive measurements are dropped at this shared entry
        point: they carry no calibration signal and would poison the
        window (inf MRE) and the refit targets (log of ~0).
        """
        if float(time_s) <= 0.0 or float(mem_bytes) <= 0.0:
            return
        with self._cond:  # concurrent observers race the unlocked += 1
            self.stats.observations += 1
        if predicted_time_s is not None and predicted_mem_bytes is not None:
            self.calibration.observe(predicted_time_s, time_s,
                                     predicted_mem_bytes, mem_bytes,
                                     generation)
            if tenant:
                self.tenant_calibration.observe(
                    tenant, predicted_time_s, time_s,
                    predicted_mem_bytes, mem_bytes, generation=generation)
        if self.feedback is not None:
            key = ((fp, int(batch), int(seq)) if fp is not None
                   else self.service.cache_key(cfg, batch, seq))
            self.feedback.add(key, time_s, mem_bytes,
                              generation=generation, job_id=job_id)
        if self.refitter is not None:
            self.refitter.notify()

    # -- worker loop --------------------------------------------------------
    def _tenant_dec_locked(self, tenant: str) -> None:
        n = self._tenant_queued.get(tenant, 0) - 1
        if n > 0:
            self._tenant_queued[tenant] = n
        else:
            self._tenant_queued.pop(tenant, None)

    def _take_batch_locked(self) -> Tuple[List[Tuple[Query, Future]],
                                          List[Tuple[Query, Future]]]:
        """Next tick's batch (EDF order) + already-expired entries.

        Callers hold ``self._cond``. Deadline-free workloads skip the
        scan entirely and keep the legacy FIFO popleft. With deadlines
        present, past-deadline entries are pulled out for expiry and the
        rest are stably sorted earliest-deadline-first (deadline-less
        queries sort last, FIFO preserved within every tie class).
        """
        if not any(q.deadline is not None for q, _ in self._queue):
            batch = [self._queue.popleft()
                     for _ in range(min(len(self._queue), self.max_batch))]
            for q, _ in batch:
                self._tenant_dec_locked(q.tenant)
            return batch, []
        now = time.monotonic()
        expired: List[Tuple[Query, Future]] = []
        pending: List[Tuple[Query, Future]] = []
        for item in self._queue:
            q, _ = item
            if q.deadline is not None and q.deadline <= now:
                expired.append(item)
            else:
                pending.append(item)
        pending.sort(key=lambda e: (e[0].deadline is None,
                                    e[0].deadline or 0.0))
        batch, rest = pending[:self.max_batch], pending[self.max_batch:]
        self._queue = deque(rest)
        for q, _ in expired:
            self._tenant_dec_locked(q.tenant)
        for q, _ in batch:
            self._tenant_dec_locked(q.tenant)
        return batch, expired

    def _expire(self, expired: List[Tuple[Query, Future]]) -> None:
        """Fail past-deadline futures with a structured DeadlineExceeded."""
        now = time.monotonic()
        for q, fut in expired:
            if not fut.set_running_or_notify_cancel():
                continue  # client cancelled it first
            with self._cond:
                self.stats.failed += 1
                self.overload["expired"] += 1
            try:
                fut.set_exception(DeadlineExceeded(
                    f"deadline passed {now - q.deadline:.4f}s before "
                    f"serving (tenant {q.tenant!r})"))
            except Exception:
                pass

    def _loop(self) -> None:
        while True:
            with self._cond:
                self._apply_pending_locked()
                while self._running and not self._queue:
                    self._cond.wait()
                    self._apply_pending_locked()
                if not self._queue:  # stopped and drained
                    self._apply_pending_locked()
                    return
                batch, expired = self._take_batch_locked()
            if expired:
                self._expire(expired)
            # client-cancelled futures drop out of the batch here; the
            # rest transition to RUNNING so cancel() can no longer race
            # our set_result below.
            live = [(q, fut) for q, fut in batch
                    if fut.set_running_or_notify_cancel()]
            try:
                if live:
                    self._serve_batch(live)
            except Exception as e:
                # catch-all: a tick must never kill the worker — that
                # would hang every pending and future query silently.
                for _, fut in live:
                    if not fut.done():
                        with self._cond:
                            self.stats.failed += 1
                        try:
                            fut.set_exception(e)
                        except Exception:
                            pass
            with self._cond:
                if not self._running and not self._queue:
                    self._apply_pending_locked()  # don't strand a publish
                    return

    def _serve_batch(self, batch: List[Tuple[Query, Future]]) -> None:
        # counter mutations here happen under self._cond: the worker is
        # not the only writer (observe() and remote stats readers run on
        # client threads), and unlocked read-modify-writes drop counts.
        svc = self.service
        obs_on = self.metrics.enabled
        t_start = time.perf_counter()
        with self._cond:
            self.stats.ticks += 1
            tick = self.stats.ticks
            self.stats.max_batch = max(self.stats.max_batch, len(batch))
        # one (abacus, generation) snapshot covers the whole tick: even a
        # direct service.adopt racing this batch cannot mix generations
        # within it (verdicts are tagged with the snapshot generation).
        abacus, generation = svc.snapshot()
        # 1) resolve records: unique keys, cold misses traced concurrently.
        #    record_for's in-flight dedup makes duplicate keys (within the
        #    batch or racing with direct service callers) cost one trace.
        traces_before = svc.stats.traces
        by_key: Dict[tuple, Future] = {}
        rec_of, err_of = {}, {}
        key_of = []
        for idx, (q, _) in enumerate(batch):
            try:
                key = q.key() or svc.cache_key(q.cfg, q.batch, q.seq)
            except Exception as e:  # unfingerprintable cfg: fail that query
                key = ("__badkey__", idx)
                err_of[key] = e
                key_of.append(key)
                continue
            key_of.append(key)
            if key not in by_key:  # reuse the computed key: one fingerprint
                by_key[key] = self._pool.submit(
                    svc._record_for_key, key, q.cfg, q.batch, q.seq)
        for key, f in by_key.items():
            try:
                rec_of[key] = f.result()
            except Exception as e:  # bad config: fail that query, not the tick
                err_of[key] = e
        traces_ran = svc.stats.traces - traces_before
        with self._cond:
            self.stats.cold_traces += traces_ran
        t_records = time.perf_counter()
        # 2) ONE ensemble pass over the unique resolvable records.
        uniq = [k for k in by_key if k in rec_of]
        preds = {}
        ran_ensemble = False
        if uniq:
            try:
                # at most ONE ensemble pass per tick — and zero when the
                # whole micro-batch hits the per-generation prediction
                # cache (repeat queries under an unchanged generation).
                preds, ran_ensemble = svc.predict_keys(
                    uniq, [rec_of[k] for k in uniq],
                    abacus=abacus, generation=generation)
                with self._cond:
                    self.stats.ensemble_passes += int(ran_ensemble)
            except Exception as e:
                err_of.update({k: e for k in uniq})
        t_ensemble = time.perf_counter()
        # 3) resolve futures with per-query admission verdicts.
        for (q, fut), key in zip(batch, key_of):
            if key in preds:
                t, m = preds[key]
                with self._cond:
                    self.stats.completed += 1
                est = svc._estimate(rec_of[key], t, m, generation=generation)
                est["tick"] = tick
                est.update(self.est_tags)
                if q.tc is not None:
                    est["_trace"] = self._spans_for(
                        q, fut, tick, generation, len(batch), t_start,
                        t_records, t_ensemble, traces_ran, ran_ensemble)
                fut.set_result(est)
            else:
                with self._cond:
                    self.stats.failed += 1
                fut.set_exception(err_of.get(
                    key, RuntimeError("prediction failed")))
        if obs_on:
            t_end = time.perf_counter()
            t0s = [t0 for _, fut in batch
                   if (t0 := getattr(fut, "_obs_t0", None)) is not None]
            self._h_queue_wait.observe_many([t_start - t0 for t0 in t0s])
            self._h_latency.observe_many([t_end - t0 for t0 in t0s])
            self._h_tick.observe(t_end - t_start)
            if traces_ran:
                self._h_cold.observe(t_records - t_start)
            if ran_ensemble:
                self._h_ensemble.observe(t_ensemble - t_records)

    def _spans_for(self, q: Query, fut: Future, tick: int, generation,
                   batch_len: int, t_start: float, t_records: float,
                   t_ensemble: float, traces_ran: int,
                   ran_ensemble: bool) -> List[Dict]:
        """Lifecycle spans for one traced query's pass through the tick.

        Off the warm path by construction: only queries carrying a trace
        context reach here. Spans are recorded locally and returned so
        the caller can ship them back inside the estimate dict."""
        tid = q.tc.get("trace")
        parent = q.tc.get("span")
        now_perf = time.perf_counter()
        now_wall = time.time()

        def wall(tp: float) -> float:
            return now_wall - (now_perf - tp)

        replica = self.est_tags.get("replica")
        spans = []
        t0 = getattr(fut, "_obs_t0", None)
        if t0 is not None:
            spans.append(make_span(tid, "queue_wait", t_start - t0,
                                   parent=parent, ts=wall(t0),
                                   replica=replica))
        spans.append(make_span(tid, "tick_batch", now_perf - t_start,
                               parent=parent, ts=wall(t_start), tick=tick,
                               batch=batch_len, generation=generation,
                               replica=replica))
        tick_span = spans[-1]["span"]
        if traces_ran:
            spans.append(make_span(tid, "cold_trace", t_records - t_start,
                                   parent=tick_span, ts=wall(t_start),
                                   traces=traces_ran, replica=replica))
        if ran_ensemble:
            spans.append(make_span(tid, "ensemble", t_ensemble - t_records,
                                   parent=tick_span, ts=wall(t_records),
                                   replica=replica))
        spans.append(make_span(tid, "reply", now_perf - t_ensemble,
                               parent=tick_span, ts=wall(t_ensemble),
                               replica=replica))
        self.span_sink.extend(spans)
        return spans

    # -- introspection ------------------------------------------------------
    def metrics_snapshot(self) -> Dict:
        """JSON-safe snapshot of this gateway's registry (server_* and,
        when the service shares the registry, service_* metrics)."""
        svc_reg = getattr(self.service, "metrics", None)
        if svc_reg is None or svc_reg is self.metrics:
            return self.metrics.snapshot()
        return merge_snapshots([self.metrics.snapshot(), svc_reg.snapshot()])

    def metrics_text(self) -> str:
        """Prometheus text exposition of :meth:`metrics_snapshot`."""
        from repro_torch.obs.metrics import render_prometheus
        return render_prometheus(self.metrics_snapshot(),
                                 namespace=self.metrics.namespace)

    def trace_spans(self, trace_id: str) -> List[Dict]:
        """Spans recorded locally for one trace id."""
        return self.span_sink.for_trace(trace_id)

    def server_info(self) -> Dict:
        with self._cond:
            queued = len(self._queue)
        return {"running": self._running, "queued": queued,
                "mean_batch": round(self.stats.mean_batch, 2),
                **self.stats.as_dict(), **self.service.cache_info()}

    def _stats_dict(self) -> Dict:
        """Everything ``server.stats()`` reports: counters + calibration.

        ``calibration`` carries the rolling windowed MRE / drift for
        time and memory, overall and split by the generation that made
        each prediction — the numbers that show a refit paying off.
        """
        d = self.server_info()
        d["calibration"] = self.calibration.metrics()
        # NEW keys only (stats() compat, PR 7): shed/expired/quota
        # accounting and per-tenant calibration land beside the legacy
        # surface, never inside it.
        d["overload"] = self.overload.as_dict()
        d["tenants"] = self.tenant_calibration.metrics()
        if self.refitter is not None:
            d["refit"] = self.refitter.info()
        if self.feedback is not None:
            d["feedback"] = self.feedback.info()
        return d

    def overload_counters(self) -> Dict[str, int]:
        """Shed/expired/quota counters, in the replica-interface shape
        the cluster frontend banks when a member retires."""
        with self._cond:
            return self.overload.as_dict()
