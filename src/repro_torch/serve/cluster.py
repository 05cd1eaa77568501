"""Multi-host serving fabric: sharded gateway replicas behind one frontend.

A single ``AbacusServer`` is one worker loop, one trace-cache budget,
and one feedback stream — the datacenter setting the paper targets
(admission control for whole fleets, §4.3) needs N of them. This module
is the fleet seam:

  * ``HashRing`` — consistent hashing over replica names. Points are
    SHA-256 derived, so routing is a pure function of the key string:
    stable across processes, hash seeds (``PYTHONHASHSEED``), and
    restarts — the property that makes a replica's trace-store slice
    *own* its keys.
  * ``GatewayReplica`` — an ``AbacusServer`` over its own
    ``PredictionService`` slice: a fingerprint-sharded ``TraceStore``
    directory, its own ``FeedbackStore``, its own micro-batch worker.
    Every estimate it resolves is stamped with ``replica`` so
    (tick, generation) pairs are attributable fleet-wide.
  * ``ClusterFrontend`` — routes each query to the replica that owns
    its config fingerprint (computed ONCE here and forwarded via
    ``Query.fp``), fans a wave of submissions out so every replica's
    worker ticks concurrently on its partition, aggregates ``stats()``
    fleet-wide, and broadcasts model generations. Membership is LIVE:
    ``add_replica``/``remove_replica``/``resize`` run a drain ->
    migrate -> cutover protocol that quiesces only the replicas losing
    keyspace (``HashRing.diff``), hands their ``TraceStore``/
    ``FeedbackStore`` slices to the new owners through the commutative
    ``JsonFileStore.split``/``merge`` contract, swaps the ring
    atomically, and replays queries that raced the cutover — a fleet
    grows and shrinks with traffic without losing a trace, an
    observation, or an in-flight Future.
  * ``GenerationPublisher`` — the sink a central ``OnlineRefitter``
    publishes through: every replica receives each ``ModelGeneration``
    and applies it at its own tick boundary (``AbacusServer``'s
    between-ticks guarantee), so no replica ever serves two
    generations within one micro-batch. The refitter itself consumes a
    *federated* merge of all per-replica ``FeedbackStore``s
    (``OnlineRefitter(sources=...)``) and resolves feedback keys
    against the owning shard's traces (``ShardedTraces``).

Sharding by config fingerprint (not by full key) keeps every shape of
one model on one replica, so that replica's trace/prediction caches see
all the locality. The fleet-level win on one box is aggregate cache
capacity — each replica only holds 1/N of the working set — and the
seam is transport-agnostic: replicas are in-process here, but nothing
in the frontend assumes it (the later RPC step swaps the replica list
for remote stubs).

A copy of ``repro.serve.cluster`` (the port imports nothing of the
reference): a replica's default tracer is the port's ``trace_query``, and
every counter, ``stats()`` key and event name is the reference's.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import os
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import events
from repro_torch.obs.metrics import (CounterDict, MetricsRegistry, merge_snapshots,
                                     render_prometheus)
from repro_torch.obs.tracing import SpanSink, make_span, new_context
from repro_torch.serve.feedback_store import FeedbackStore, make_feedback_store
from repro_torch.serve.prediction_service import (PredictionService, Query,
                                                  config_fingerprint, trace_query)
from repro_torch.serve.refit import OnlineRefitter
from repro_torch.serve.server import (AbacusServer, DeadlineExceeded, QuotaExceeded,
                                      ServerStats, _results_by_deadline)
from repro_torch.serve.trace_store import TraceStore, make_trace_store


class ReplicaUnavailable(RuntimeError):
    """A replica cannot be reached: dead connection, timed-out call, or
    a send that failed mid-flight. Retryable — the frontend re-routes
    the query to the next ring owner (the query is idempotent)."""


class ReplicaNotRunning(RuntimeError):
    """The remote gateway rejected the call because its worker is not
    running (drain window of a reshard, or stopped). Retryable through
    the post-cutover ring."""


def _first_wins(fut: Future, result=None, error=None) -> None:
    """Resolve ``fut`` if nobody beat us to it (hedged duplicates race)."""
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(result)
    except Exception:
        pass  # already resolved (or cancelled) by the other attempt


def _relay(src: Future, out: Future) -> None:
    """Propagate one attempt's outcome into the caller's Future."""
    if src.cancelled() or out.done():
        return
    err = src.exception()
    if err is None:
        _first_wins(out, result=src.result())
    else:
        _first_wins(out, error=err)


class HashRing:
    """Consistent-hash ring over replica names.

    ``vnodes`` virtual points per replica smooth the key distribution;
    all points are SHA-256 derived so ``route`` is a pure function of
    its argument — two processes (or two hash seeds) always agree on
    which replica owns a fingerprint. Adding or removing one replica
    moves only ~1/N of the keyspace (the consistent-hashing property
    the later resharding step relies on).
    """

    SPAN = 1 << 64  # hash space: first 8 bytes of SHA-256

    def __init__(self, names: Sequence[str], vnodes: int = 64):
        if not names:
            raise ValueError("HashRing needs at least one replica name")
        if len(set(names)) != len(names):
            raise ValueError("replica names must be unique")
        self.names = [str(n) for n in names]
        self.vnodes = int(vnodes)
        points: List[Tuple[int, str]] = []
        for name in self.names:
            for v in range(self.vnodes):
                points.append((self._point(f"{name}#{v}"), name))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._names = [n for _, n in points]

    @staticmethod
    def _point(label: str) -> int:
        # never the builtin hash(): it is salted per process
        return int.from_bytes(
            hashlib.sha256(label.encode()).digest()[:8], "big")

    def route(self, key: str) -> str:
        """Owning replica name for ``key`` (clockwise successor)."""
        idx = bisect.bisect_right(self._hashes, self._point(str(key)))
        return self._names[idx % len(self._names)]

    def successors(self, key: str) -> List[str]:
        """EVERY replica name in clockwise order from ``key``'s point.

        ``successors(k)[0] == route(k)``; the rest are the fallback
        order the frontend hedges/retries through when an owner is slow
        or dead — the same order a ring *without* the owner would route
        to, so a hedge lands exactly where an exclusion reshard will put
        the key's slice.
        """
        idx = bisect.bisect_right(self._hashes, self._point(str(key)))
        out: List[str] = []
        seen: set = set()
        total = len(self.names)
        for i in range(len(self._names)):
            name = self._names[(idx + i) % len(self._names)]
            if name not in seen:
                seen.add(name)
                out.append(name)
                if len(out) == total:
                    break
        return out

    def _owner_after(self, point: int) -> str:
        """Owner of the arc just clockwise of ``point``."""
        idx = bisect.bisect_right(self._hashes, point)
        return self._names[idx % len(self._names)]

    def table(self, keys: Sequence[str]) -> Dict[str, str]:
        """key -> owner for a batch of keys (debug / stability tests)."""
        return {k: self.route(k) for k in keys}

    @staticmethod
    def diff(old: "HashRing", new: "HashRing") -> "RingDiff":
        """Exact ownership delta between two rings (see ``RingDiff``)."""
        return RingDiff(old, new)


class RingDiff:
    """Ownership delta between two ``HashRing`` memberships.

    Computed by sweeping the union of both rings' vnode points: every
    arc between consecutive points has one owner per ring, so the set
    of arcs whose owner changed IS the moved keyspace — exact in
    measure, no key sampling. ``sources`` are the replicas that lose
    keyspace (the ones a reshard must quiesce), ``dests`` the ones that
    gain it, and ``moved_fraction`` the fraction of the hash space that
    changes hands (~1/N for one replica added to N, the
    consistent-hashing bound; 1.0 would be a naive full rehash).

    ``moves(keys)`` classifies concrete keys by re-routing each through
    both rings — the per-key delta migration acts on.
    """

    def __init__(self, old: HashRing, new: HashRing):
        self.old, self.new = old, new
        self.added = [n for n in new.names if n not in old.names]
        self.removed = [n for n in old.names if n not in new.names]
        self.sources: set = set()
        self.dests: set = set()
        points = sorted(set(old._hashes) | set(new._hashes))
        moved = 0
        for i, point in enumerate(points):
            nxt = points[(i + 1) % len(points)]
            length = (nxt - point) % HashRing.SPAN or HashRing.SPAN
            was, now = old._owner_after(point), new._owner_after(point)
            if was != now:
                moved += length
                self.sources.add(was)
                self.dests.add(now)
        self.moved_fraction = moved / HashRing.SPAN

    def moves(self, keys: Sequence[str]) -> Dict[str, Tuple[str, str]]:
        """key -> (old owner, new owner) for keys whose owner changed."""
        out: Dict[str, Tuple[str, str]] = {}
        for k in keys:
            was, now = self.old.route(k), self.new.route(k)
            if was != now:
                out[k] = (was, now)
        return out

    def kept(self, keys: Sequence[str]) -> List[str]:
        """Keys whose owner is identical under both rings."""
        return [k for k in keys if self.old.route(k) == self.new.route(k)]


class GatewayReplica(AbacusServer):
    """One shard of the fleet: an ``AbacusServer`` over its own slice.

    The replica owns a ``PredictionService`` built around its
    fingerprint-sharded ``TraceStore`` slice and (optionally) its own
    ``FeedbackStore``; everything else — micro-batch worker, tick
    boundaries, generation adoption — is inherited unchanged, which is
    exactly the point: the fleet is N unmodified gateways plus routing.
    """

    def __init__(self, name: str, abacus, *, store: Optional[TraceStore] = None,
                 feedback: Optional[FeedbackStore] = None,
                 tracer=trace_query, service_kw: Optional[Dict] = None,
                 **server_kw):
        self.name = str(name)
        service = PredictionService(abacus, store=store, tracer=tracer,
                                    **dict(service_kw or {}))
        super().__init__(service, feedback=feedback, **server_kw)
        self.est_tags = {"replica": self.name}


class GenerationPublisher:
    """Broadcast ``ModelGeneration``s from a central refitter fleet-wide.

    Registered as the refitter's sink; each replica applies the
    generation at its own tick boundary (the ``AbacusServer``
    guarantee), so a publish under load never mixes generations within
    any replica's micro-batch. A failing replica is counted, never
    allowed to swallow the generation for the others.

    Membership is mutable (``set_replicas``: live resharding adds and
    removes gateways under load); each broadcast iterates over a
    snapshot of the list taken at publish time, so a membership change
    mid-``publish_generation`` can neither skip a replica of the
    snapshot nor corrupt the success accounting — the joining replica
    simply catches the *next* generation (resharding seeds it with the
    current one before it serves).
    """

    def __init__(self, replicas: Sequence[AbacusServer]):
        self.replicas = list(replicas)
        self.published = 0          # generations broadcast
        self.deliveries = 0         # per-replica deliveries that succeeded
        self.failures = 0           # per-replica deliveries that raised
        self.last_generation: Optional[int] = None
        self._lock = threading.Lock()

    def set_replicas(self, replicas: Sequence[AbacusServer]) -> None:
        """Swap the broadcast membership (in-flight publishes keep
        the snapshot they started with)."""
        with self._lock:
            self.replicas = list(replicas)

    def publish_generation(self, gen) -> bool:
        with self._lock:
            replicas = list(self.replicas)  # snapshot: membership may move
        ok = 0
        for replica in replicas:
            try:
                replica.publish_generation(gen)
                ok += 1
            except Exception:
                with self._lock:
                    self.failures += 1
        with self._lock:
            self.published += 1
            self.deliveries += ok
            self.last_generation = int(gen.number)
        return ok == len(replicas)

    def info(self) -> Dict:
        with self._lock:
            return {"replicas": len(self.replicas),
                    "published": self.published,
                    "deliveries": self.deliveries,
                    "failures": self.failures,
                    "last_generation": self.last_generation}


class ShardedTraces:
    """``.get(key)`` router over the fleet's trace slices.

    The central refitter resolves feedback keys to traced records; in a
    sharded fleet the record lives on the owning replica — its memory
    cache first, then its persistent slice.
    """

    def __init__(self, frontend: "ClusterFrontend"):
        self.frontend = frontend

    def get(self, key):
        replica = self.frontend.replica_for(key[0])
        rec = replica.service.cached_record(key)
        if rec is None and replica.service.store is not None:
            rec = replica.service.store.get(key)
        return rec


def merge_calibration(metrics: Sequence[Dict]) -> Dict:
    """Fleet-wide calibration from per-replica ``CalibrationWindow``s.

    MRE/drift are per-completion means, so the fleet view is the
    count-weighted mean of the replica windows (exact, not an
    approximation, as long as every completion sits in exactly one
    replica's window). ``by_generation`` merges the same way.
    """
    def _merge(rows: List[Dict]) -> Dict:
        rows = [r for r in rows if r and r.get("count")]
        n = sum(r["count"] for r in rows)
        if not n:
            return {"count": 0, "time_mre": None, "mem_mre": None,
                    "time_drift": None, "mem_drift": None}
        out = {"count": n}
        for field in ("time_mre", "mem_mre", "time_drift", "mem_drift"):
            out[field] = sum(r[field] * r["count"] for r in rows) / n
        return out

    fleet = _merge(list(metrics))
    by_gen: Dict = {}
    for m in metrics:
        for gen, grp in (m or {}).get("by_generation", {}).items():
            by_gen.setdefault(gen, []).append(grp)
    fleet["by_generation"] = {
        gen: _merge(grps)
        for gen, grps in sorted(by_gen.items(),
                                key=lambda e: (-1 if e[0] is None else e[0]))}
    return fleet


class ClusterFrontend:
    """Consistent-hash router over N ``GatewayReplica``s.

    Construction either builds a homogeneous fleet (``abacus`` +
    ``n_replicas``, with per-replica ``TraceStore``/``FeedbackStore``
    slices under ``trace_root``/``feedback_root``) or wraps
    pre-built ``replicas``. The frontend mirrors the ``AbacusServer``
    client API (``submit``/``submit_many``/``predict_one``/
    ``predict_many``/``observe``/``stats``) so existing consumers —
    ``AdmissionController``, ``dryrun --predict`` — can point at a
    fleet unchanged.
    """

    def __init__(self, abacus=None, n_replicas: int = 4, *,
                 trace_root: Optional[str] = None,
                 feedback_root: Optional[str] = None,
                 tracer=trace_query, vnodes: int = 64,
                 service_kw: Optional[Dict] = None,
                 replicas: Optional[Sequence[GatewayReplica]] = None,
                 reshard_timeout: float = 30.0,
                 hedge_after_s: Optional[float] = None,
                 auto_exclude: bool = True,
                 max_retries: int = 3,
                 store_backend: Optional[str] = None,
                 **server_kw):
        # construction recipe, kept so live resharding can mint replicas
        self._abacus = abacus
        self._trace_root = trace_root
        self._feedback_root = feedback_root
        # physical store layout for every slice this fleet mints (per-
        # replica trace/feedback stores AND the central feedback store):
        # None defers to REPRO_STORE_BACKEND / "json" at build time
        self._store_backend = store_backend
        self._tracer = tracer
        self._vnodes = int(vnodes)
        self._service_kw = service_kw
        self._server_kw = server_kw
        if replicas is not None:
            self.replicas = list(replicas)
        else:
            if abacus is None:
                raise ValueError("pass a fitted abacus or explicit replicas")
            self.replicas = [self._build_replica(f"r{i}")
                             for i in range(int(n_replicas))]
        if not self.replicas:
            raise ValueError("ClusterFrontend needs at least one replica")
        self._by_name = {r.name: r for r in self.replicas}
        self.ring = HashRing([r.name for r in self.replicas], vnodes=vnodes)
        # routing state (ring/membership) swaps atomically under one
        # lock at reshard cutover; submits that raced a cutover park on
        # the condition and replay once the epoch moves.
        self._route_lock = threading.RLock()
        self._cutover = threading.Condition(self._route_lock)
        self._epoch = 0
        self._resharding = False
        self._draining: set = set()   # replica names quiesced mid-reshard
        self._started = False
        self.reshard_timeout = float(reshard_timeout)
        # frontend-local registry: the reshard/hedge/retry counters live
        # here (CounterDict keeps the dict mutation surface, so
        # `reshard_stats["hedges"] += 1` and `dict(reshard_stats)` are
        # unchanged); metrics_snapshot() merges it with every replica's.
        self.metrics = MetricsRegistry()
        self.span_sink = SpanSink()
        self.reshard_stats = CounterDict(
            self.metrics, "fleet_",
            ("reshards", "keys_moved", "units_moved", "keys_skipped",
             "keys_replayed", "cutover_ticks", "hedges", "hedge_failures",
             "retries", "exclusions"))
        # replicas excluded or removed take their ServerStats with them;
        # this ledger banks every additive counter a leaver had
        # contributed at departure, so fleet + retired is the all-time
        # truth (`stats()["retired"]`, `fleet_retired_*_total`) even
        # after kills and downsizes. max_batch is a high-water mark, not
        # additive, so it stays out.
        self.retired_stats = CounterDict(
            self.metrics, "fleet_retired_",
            tuple(c for c in ServerStats.COUNTERS if c != "max_batch"))
        # overload ledgers live in their own CounterDicts: the
        # reshard_stats/retired_stats key sets are a frozen wire shape
        # (PR 7), so new series go in beside them, never inside them.
        # `replay_expired` counts parked queries whose deadline passed
        # before a cutover replay (expired work never hits the new ring);
        # `retired_overload` banks a leaver's shed/expired/quota counters
        # the same way retired_stats banks its ServerStats.
        self.overload_stats = CounterDict(self.metrics, "fleet_",
                                          ("replay_expired",))
        self.retired_overload = CounterDict(
            self.metrics, "fleet_retired_",
            ("shed", "expired", "quota_rejected"))
        self.metrics.register_callback(
            lambda: {"fleet_replicas": len(self.replicas)})
        # failure handling for transport-backed replicas (repro_torch.serve.rpc):
        # hedge_after_s duplicates a slow query to the next ring owner,
        # max_retries bounds re-routes of failed submits, auto_exclude
        # reshards a heartbeat-dead replica out of the fleet. In-process
        # replicas don't advertise ``supports_hedge`` and are untouched.
        self.hedge_after_s = hedge_after_s
        self.auto_exclude = bool(auto_exclude)
        self.max_retries = int(max_retries)
        for r in self.replicas:
            self._wire_failure_handling(r)
        # central (federated) feedback store: the refitter's input
        self.feedback = (make_feedback_store(
            os.path.join(feedback_root, "central"),
            backend=self._store_backend) if feedback_root else None)
        self.refitter: Optional[OnlineRefitter] = None
        self.publisher: Optional[GenerationPublisher] = None

    def _build_replica(self, name: str) -> GatewayReplica:
        """Mint one homogeneous replica from the construction recipe."""
        if self._abacus is None:
            raise ValueError(
                "this frontend wraps pre-built replicas; pass a "
                "GatewayReplica object instead of a bare name")
        store = (make_trace_store(os.path.join(self._trace_root, name),
                                  backend=self._store_backend)
                 if self._trace_root else None)
        feedback = (make_feedback_store(
            os.path.join(self._feedback_root, name),
            backend=self._store_backend) if self._feedback_root else None)
        return GatewayReplica(name, self._abacus, store=store,
                              feedback=feedback, tracer=self._tracer,
                              service_kw=self._service_kw, **self._server_kw)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ClusterFrontend":
        with self._route_lock:
            self._started = True
            replicas = list(self.replicas)
        for r in replicas:
            r.start()
        return self

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        with self._route_lock:
            self._started = False
            replicas = list(self.replicas)
        for r in replicas:
            r.stop(timeout)

    def __enter__(self) -> "ClusterFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def running(self) -> bool:
        return all(r.running for r in self.replicas)

    # -- routing ------------------------------------------------------------
    def replica_for(self, fingerprint: str) -> GatewayReplica:
        with self._route_lock:
            return self._by_name[self.ring.route(fingerprint)]

    def route(self, cfg) -> Tuple[str, GatewayReplica]:
        """(fingerprint, owning replica) for one config."""
        fp = config_fingerprint(cfg)
        return fp, self.replica_for(fp)

    def _await_cutover(self, epoch: int, deadline: float) -> None:
        """Park until the routing epoch moves past ``epoch`` (replay).

        Called with ``_route_lock`` held (the condition shares it, so
        waiting releases the lock). A query that raced a reshard —
        routed to a replica whose worker is quiesced — waits here for
        the cutover and is then re-routed through the NEW ring:
        ``Query.fp`` is already computed, so the replay is one dict
        lookup, not a re-hash.
        """
        # a failed/aborted reshard also wakes us (_resharding drops):
        # the retry then surfaces the replica's real error instead of
        # parking forever on a cutover that will never come.
        if not self._cutover.wait_for(
                lambda: self._epoch != epoch or not self._resharding,
                timeout=deadline - time.monotonic()):
            raise RuntimeError("reshard cutover did not complete within "
                               f"{self.reshard_timeout}s; query not replayed")

    # -- client API ---------------------------------------------------------
    def submit(self, cfg, batch: int, seq: int, trace: bool = False, *,
               tenant: str = "", deadline: Optional[float] = None) -> Future:
        """Route one query to its shard; fingerprint computed ONCE here.

        ``trace=True`` opts the query into per-stage span recording: a
        trace context rides the query (across the RPC boundary for
        remote replicas), every stage stamps spans with one trace id,
        and ``trace_spans(fut.trace_id)`` returns the assembled trace
        once the future resolves. ``tenant``/``deadline`` ride the query
        to the owning replica's admission ladder (quota, shed, EDF)."""
        fp = config_fingerprint(cfg)
        tc = new_context() if trace else None
        t0 = time.perf_counter() if trace else 0.0
        fut = self._submit_query(Query(cfg, int(batch), int(seq),
                                       fp=fp, tc=tc, tenant=tenant,
                                       deadline=deadline))
        if tc is not None:
            # the root span: frontend accepted + routed the query
            self.span_sink.record(make_span(
                tc["trace"], "submit", time.perf_counter() - t0,
                span_id=tc["span"], ts=time.time(), fp=fp))
            fut.trace_id = tc["trace"]
        return fut

    def _pick_owner(self, fp: str, avoid: frozenset):
        """Owning replica for ``fp``, skipping avoided and dead members.

        With nothing to avoid and no dead replicas this IS ``route``
        (``successors[0]`` is the primary owner); the fallback order is
        the hedge/retry order."""
        for name in self.ring.successors(fp):
            replica = self._by_name.get(name)
            if replica is None or name in avoid:
                continue
            if getattr(replica, "dead", False):
                continue
            return replica
        return None

    def _expired_future(self, q: Query) -> Future:
        """Failed Future for a parked query whose deadline passed before
        its cutover replay: expired work is never replayed onto the new
        ring, and the expiry is counted in ``fleet_replay_expired_total``
        (it never reached a replica, so no server counter moves)."""
        with self._route_lock:
            self.overload_stats["replay_expired"] += 1
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        fut.set_exception(DeadlineExceeded(
            f"deadline passed before replay of {q.fp!r} onto the new ring",
            where="frontend"))
        return fut

    def _submit_query(self, q: Query, avoid: frozenset = frozenset(),
                      attempts: Optional[int] = None,
                      replay: bool = False) -> Future:
        """Submit one routed query; transport-backed owners get a
        guarded Future (retry on replica death, optional hedging)."""
        attempts = self.max_retries if attempts is None else attempts
        deadline = time.monotonic() + self.reshard_timeout
        parked = False
        while True:
            # first-pass submits always reach the owning replica (the
            # server's tick expires dead work with exact accounting);
            # only a REPLAY — post-cutover wake or a retry re-route —
            # checks the deadline here, so an expired query is never
            # replayed onto the new ring.
            if ((parked or replay) and q.deadline is not None
                    and time.monotonic() >= q.deadline):
                return self._expired_future(q)
            with self._route_lock:
                epoch = self._epoch
                replica = self._pick_owner(q.fp, avoid)
                if replica is None:
                    raise ReplicaUnavailable(
                        f"no live replica owns {q.fp!r} "
                        f"(avoided={sorted(avoid)})")
                kw = {}
                if q.tenant:
                    kw["tenant"] = q.tenant
                if q.deadline is not None:
                    kw["deadline"] = q.deadline
                try:
                    if q.tc is None:
                        fut = replica.submit(q.cfg, q.batch, q.seq,
                                             fp=q.fp, **kw)
                    else:
                        fut = replica.submit(q.cfg, q.batch, q.seq,
                                             fp=q.fp, tc=q.tc, **kw)
                except ReplicaUnavailable:
                    # owner died between the dead-check and the send:
                    # fall through to its ring successor immediately
                    avoid = avoid | {replica.name}
                    continue
                except (QuotaExceeded, DeadlineExceeded):
                    # RuntimeError subclasses, but NOT cutover races:
                    # quota/deadline rejections surface to the caller
                    # instead of parking for a replay
                    raise
                except RuntimeError:
                    if not self._resharding:
                        raise  # genuinely stopped, not a racing cutover
                    self._await_cutover(epoch, deadline)
                    parked = True
                    continue
                if parked:  # counted once per query, not per wakeup
                    self.reshard_stats["keys_replayed"] += 1
                if q.tc is not None:
                    name = "replay" if parked else "route"
                    self.span_sink.record(make_span(
                        q.tc["trace"], name, 0.0, parent=q.tc["span"],
                        replica=replica.name, epoch=epoch))
                    fut.add_done_callback(self._harvest_spans)
                if getattr(replica, "supports_hedge", False):
                    return self._guard(q, fut, replica.name, attempts)
                return fut

    def _guard(self, q: Query, fut: Future, owner: str,
               attempts: int) -> Future:
        """Wrap a transport-backed Future with failure handling.

        The caller's Future resolves from whichever attempt finishes
        first (duplicate results are dropped — queries are idempotent
        and replicas agree byte-for-byte). A retryable failure
        (connection death, timeout, a drain-window rejection) re-routes
        the query; ``hedge_after_s`` additionally duplicates a *slow*
        query to the next ring owner without waiting for a failure.
        """
        out: Future = Future()
        out.set_running_or_notify_cancel()
        timer: List = [None]

        def settle(src: Future) -> None:
            if timer[0] is not None:
                timer[0].cancel()
            if out.done():
                return
            if src.cancelled():
                return
            err = src.exception()
            if err is None:
                _first_wins(out, result=src.result())
            elif isinstance(err, (ReplicaUnavailable, ReplicaNotRunning)) \
                    and attempts > 0:
                # re-route on a fresh thread: this callback may run on
                # the dying replica's reader thread, and the retry can
                # need to park for an exclusion cutover.
                threading.Thread(
                    target=self._retry, args=(q, out, {owner}, attempts - 1),
                    name="cluster-retry", daemon=True).start()
            else:
                _first_wins(out, error=err)

        if self.hedge_after_s is not None:
            t = threading.Timer(self.hedge_after_s, self._hedge,
                                args=(q, out, owner))
            t.daemon = True
            timer[0] = t
            t.start()
        fut.add_done_callback(settle)
        return out

    def _retry(self, q: Query, out: Future, avoid: set,
               attempts: int) -> None:
        """Re-route a failed query; parks for a cutover mid-reshard.

        If a reshard (often the exclusion of the replica that just
        failed) is in flight, wait for its cutover and trust the NEW
        ring — the post-cutover owner holds the migrated slice, so the
        replay costs zero re-traces. Otherwise route around the failure
        via the ring's successor order right away.
        """
        try:
            with self._route_lock:
                if self._resharding:
                    try:
                        self._await_cutover(
                            self._epoch,
                            time.monotonic() + self.reshard_timeout)
                        avoid = set()  # the new ring is authoritative
                    except RuntimeError:
                        pass  # cutover never came: fall back to avoidance
                self.reshard_stats["retries"] += 1
            if q.tc is not None:
                self.span_sink.record(make_span(
                    q.tc["trace"], "retry", 0.0, parent=q.tc["span"],
                    avoided=sorted(avoid)))
            inner = self._submit_query(q, avoid=frozenset(avoid),
                                       attempts=attempts, replay=True)
        except Exception as e:
            _first_wins(out, error=e)
            return
        inner.add_done_callback(lambda f: _relay(f, out))

    def _hedge(self, q: Query, out: Future, primary: str) -> None:
        """Duplicate a slow query to the next ring owner (first wins).

        The hedge counter moves only AFTER the duplicate submit
        succeeded: a hedge whose submission raises (every successor
        excluded, say) never reached another replica, and counting it
        as issued made ``hedges`` overstate real duplicates. Failed
        attempts are tallied separately under ``hedge_failures``.
        """
        if out.done():
            return
        try:
            inner = self._submit_query(q, avoid=frozenset({primary}),
                                       attempts=0)
        except Exception:
            # the primary may still answer; never fail out here
            with self._route_lock:
                self.reshard_stats["hedge_failures"] += 1
            return
        with self._route_lock:
            self.reshard_stats["hedges"] += 1
        if q.tc is not None:
            self.span_sink.record(make_span(
                q.tc["trace"], "hedge", 0.0, parent=q.tc["span"],
                primary=primary))
        inner.add_done_callback(lambda f: _relay(f, out))

    def submit_many(self, queries: Sequence) -> List[Future]:
        """Fan a wave out: one enqueue (-> one tick wake) per replica.

        Futures come back in input order; each replica's worker
        coalesces its whole partition into one concurrent micro-batch.
        A partition routed to a replica that a concurrent reshard
        quiesced parks until the cutover, then replays through the new
        ring — every submitted query resolves to exactly one Future.
        """
        qs = [q if isinstance(q, Query) else Query(*q) for q in queries]
        qs = [q if q.fp is not None
              else dataclasses.replace(q, fp=config_fingerprint(q.cfg))
              for q in qs]
        futs: List[Optional[Future]] = [None] * len(qs)
        pending = list(range(len(qs)))
        parked: set = set()        # queries that raced a cutover, deduped
        singles: List[int] = []    # rerouted one-by-one around a dead owner
        deadline = time.monotonic() + self.reshard_timeout
        while pending:
            # parked entries woken by a cutover are REPLAYS: expire the
            # ones whose deadline already passed instead of replaying
            # them onto the new ring (they also leave `parked`, keeping
            # keys_replayed exact).
            if parked:
                now = time.monotonic()
                live = []
                for i in pending:
                    if (i in parked and qs[i].deadline is not None
                            and qs[i].deadline <= now):
                        parked.discard(i)
                        futs[i] = self._expired_future(qs[i])
                    else:
                        live.append(i)
                pending = live
                if not pending:
                    with self._route_lock:
                        if parked:
                            self.reshard_stats["keys_replayed"] += len(parked)
                    break
            with self._route_lock:
                epoch = self._epoch
                parts: Dict[str, List[int]] = {}
                for i in pending:
                    parts.setdefault(self.ring.route(qs[i].fp), []).append(i)
                raced: List[int] = []
                for name, idxs in parts.items():
                    replica = self._by_name[name]
                    try:
                        for i, fut in zip(idxs, replica
                                          .submit_many([qs[i] for i in idxs])):
                            if qs[i].tc is not None:
                                fut.add_done_callback(self._harvest_spans)
                            futs[i] = (self._guard(qs[i], fut, name,
                                                   self.max_retries)
                                       if getattr(replica, "supports_hedge",
                                                  False) else fut)
                    except ReplicaUnavailable:
                        # dead owner: re-route those queries individually
                        # (outside this lock) through the successor order
                        singles.extend(idxs)
                    except RuntimeError:
                        if not self._resharding:
                            raise
                        raced.extend(idxs)
                pending = raced
                if pending:
                    parked.update(pending)
                    self._await_cutover(epoch, deadline)
                elif parked:  # counted once per query, not per wakeup
                    self.reshard_stats["keys_replayed"] += len(parked)
        for i in singles:
            futs[i] = self._submit_query(qs[i])
        return futs  # type: ignore[return-value]

    def _harvest_spans(self, fut: Future) -> None:
        """Collect server-side spans shipped back inside a traced
        estimate (``est["_trace"]``) into the frontend's sink — for a
        remote replica these crossed the process boundary, so the sink
        ends up holding one coherent cross-process trace."""
        try:
            if fut.cancelled() or fut.exception() is not None:
                return
            est = fut.result()
        except Exception:
            return
        if isinstance(est, dict):
            # pop, not get: the shipping envelope is transport detail,
            # not part of the estimate callers see. Done-callbacks run
            # before result() wakes waiters, so callers never observe
            # the key either way.
            spans = est.pop("_trace", None)
            if spans:
                self.span_sink.extend(spans)

    def trace_spans(self, trace_id: str) -> List[Dict]:
        """Every span harvested for one trace id (frontend + replicas),
        ordered by start timestamp."""
        return self.span_sink.for_trace(trace_id)

    def predict_one(self, cfg, batch: int, seq: int,
                    timeout: Optional[float] = None) -> Dict:
        return self.submit(cfg, batch, seq).result(timeout)

    def predict_many(self, queries: Sequence,
                     timeout: Optional[float] = None) -> List[Dict]:
        # one SHARED deadline across the wave (not timeout-per-future,
        # which compounds to N x timeout worst case)
        return _results_by_deadline(self.submit_many(queries), timeout)

    # -- live resharding ----------------------------------------------------
    def add_replica(self, replica) -> Dict:
        """Grow the fleet by one gateway, migrating its slice to it live.

        ``replica`` is a bare name (a homogeneous replica is minted from
        the construction recipe) or a pre-built ``GatewayReplica``. The
        joiner adopts the fleet's current ``ModelGeneration`` before it
        serves a single query. Returns the migration summary.
        """
        prebuilt: Dict[str, GatewayReplica] = {}
        if isinstance(replica, GatewayReplica):
            prebuilt[replica.name] = replica
            name = replica.name
        else:
            name = str(replica)

        def plan(old_names):
            if name in old_names:
                raise ValueError(f"replica {name!r} already in the fleet")
            return old_names + [name]

        return self._reshard(plan, prebuilt)

    def remove_replica(self, name: str) -> Dict:
        """Shrink the fleet by one gateway: drain it, migrate its
        ``TraceStore``/``FeedbackStore`` slices to the new owners, cut
        the ring over. Every query queued on it resolves (the drain
        serves them); queries racing the cutover replay to new owners.
        """
        name = str(name)

        def plan(old_names):
            if name not in old_names:
                raise ValueError(f"no replica named {name!r}")
            if len(old_names) == 1:
                raise ValueError("cannot remove the last replica")
            return [n for n in old_names if n != name]

        return self._reshard(plan)

    # -- failure handling (transport-backed replicas) ------------------------
    def _wire_failure_handling(self, replica) -> None:
        """Attach the dead-replica callback to a transport-backed member."""
        if getattr(replica, "supports_hedge", False) \
                and hasattr(replica, "on_dead"):
            replica.on_dead = self._on_replica_dead

    def _on_replica_dead(self, replica) -> None:
        """Heartbeat verdict: a member stopped answering.

        Runs on the dead replica's heartbeat (or reader) thread, so the
        exclusion reshard is handed to its own thread — the protocol
        drains, migrates, and must never run on a transport thread.
        """
        if not self.auto_exclude:
            return
        threading.Thread(target=self._exclude_dead, args=(replica.name,),
                         name=f"exclude-{replica.name}", daemon=True).start()

    def _exclude_dead(self, name: str, retries: int = 50) -> None:
        for _ in range(retries):
            try:
                self.exclude_replica(name)
                return
            except ValueError:
                return  # already excluded (or fleet-of-one: nothing to do)
            except RuntimeError:
                time.sleep(0.2)  # another reshard holds the guard: retry

    def exclude_replica(self, name: str) -> Dict:
        """Reshard a DEAD replica out of the fleet (the crash path).

        Unlike ``remove_replica`` there is nothing to drain — the
        process is gone and its worker with it. Its authoritative state
        is its on-disk ``TraceStore``/``FeedbackStore`` slice (the
        gateway writes through at trace time), which the ordinary
        migrate step hands to the ring successors exactly as the PR 5
        crash-restart path does: warm keys are rebuilt from disk, zero
        re-traces. In-flight queries against the dead member fail fast
        (``ReplicaUnavailable``) and re-route via hedge/retry.
        """
        name = str(name)

        def plan(old_names):
            if name not in old_names:
                raise ValueError(f"no replica named {name!r}")
            if len(old_names) == 1:
                raise ValueError("cannot exclude the last replica")
            return [n for n in old_names if n != name]

        doomed = self._by_name.get(name)
        summary = self._reshard(plan)
        with self._route_lock:
            self.reshard_stats["exclusions"] += 1
        events.emit("exclusion", replica=name,
                    keys_moved=summary.get("keys_moved", 0),
                    members=summary.get("to", []))
        if doomed is not None and hasattr(doomed, "close"):
            try:
                doomed.close()
            except Exception:
                pass
        return summary

    def resize(self, n_replicas: int) -> Dict:
        """Reshard the fleet to ``n_replicas`` gateways in ONE protocol
        pass (one drain, one migration, one cutover — not N single-step
        reshards). Growth mints ``r<i>`` replicas from the construction
        recipe; shrink retires the most recently added gateways.
        """
        n = int(n_replicas)
        if n < 1:
            raise ValueError("a fleet needs at least one replica")

        def plan(old_names):
            if n <= len(old_names):
                return old_names[:n]
            names, i = list(old_names), 0
            while len(names) < n:
                if f"r{i}" not in names:
                    names.append(f"r{i}")
                i += 1
            return names

        return self._reshard(plan)

    def _current_generation(self):
        """(abacus, generation) snapshot of the newest LIVE replica.

        Dead members still report a (cached) generation but can no
        longer serve a snapshot — never pick one while a survivor
        exists."""
        live = [r for r in self.replicas if not getattr(r, "dead", False)]
        newest = max(live or self.replicas,
                     key=lambda r: r.service.generation)
        return newest.service.snapshot()

    @staticmethod
    def _slices(replica: GatewayReplica):
        """The migratable stores of one replica, tagged by kind."""
        return (("trace", replica.service.store),
                ("feedback", replica.feedback))

    def _reshard(self, plan,
                 prebuilt: Optional[Dict[str, GatewayReplica]] = None) -> Dict:
        """Drain -> migrate -> cutover to the membership ``plan`` names.

        ``plan(old_names) -> new_names`` runs AFTER the single-reshard
        guard is taken, so concurrent admin calls always compute (and
        validate) against the membership they will actually change —
        never a stale snapshot an overlapping reshard just replaced.

        1. **drain**: quiesce ONLY the affected replicas — the ones the
           ring diff says lose keyspace (``RingDiff.sources``) plus the
           leavers — by stopping their workers (queued queries are
           served before the worker exits, so every in-flight Future
           resolves). Unaffected replicas keep ticking throughout. A
           replica still draining past the timeout ABORTS the reshard
           (migrating under a live writer would orphan its last ticks'
           keys); the abort restarts whatever quiesced, and a retry
           succeeds once the stuck worker exits.
        2. **migrate**: each quiesced replica hands exactly its moved
           ``TraceStore``/``FeedbackStore`` keys to their new owners via
           ``JsonFileStore.split`` (the commutative merge contract — a
           destination that cold-traced a moved key mid-migration
           converges, never conflicts). Key sets are computed AFTER the
           drain, so records written by the final ticks migrate too. A
           migration failure (e.g. disk full) restarts the drained
           survivors on the OLD ring and re-raises; retrying the same
           reshard completes the handoff (split/merge converge).
        3. **cutover**: atomically swap ring + membership, restart the
           quiesced survivors, start the joiners (already seeded with
           the fleet's current generation), bump the routing epoch, and
           wake every parked query for replay. Publisher and refitter
           membership follow.
        """
        with self._route_lock:
            if self._resharding:
                raise RuntimeError("a reshard is already in progress")
            self._resharding = True
            old_names = [r.name for r in self.replicas]
        drained: List[GatewayReplica] = []
        try:
            names = [str(n) for n in plan(old_names)]
            if not names:
                raise ValueError("a fleet needs at least one replica")
            summary = {"from": old_names, "to": names, "keys_moved": 0,
                       "units_moved": 0, "keys_skipped": 0,
                       "cutover_ticks": 0, "trace_keys_moved": 0,
                       "feedback_keys_moved": 0}
            new_ring = HashRing(names, vnodes=self._vnodes)
            diff = HashRing.diff(self.ring, new_ring)
            summary["moved_fraction_bound"] = diff.moved_fraction
            joiners = {n: (prebuilt or {}).get(n) or self._build_replica(n)
                       for n in names if n not in self._by_name}
            # joiners adopt the fleet's CURRENT generation before serving
            # (lazily: an exclusion has no joiners and possibly no live
            # replica to snapshot from until the cutover)
            if joiners:
                abacus, generation = self._current_generation()
                for rep in joiners.values():
                    if generation > rep.service.generation:
                        rep.service.adopt(abacus, generation)
            # 1) drain the affected replicas (keyspace losers + leavers)
            affected = [self._by_name[n] for n in old_names
                        if n in diff.sources or n not in names]
            with self._route_lock:
                self._draining = {r.name for r in affected}
            ticks_before = sum(r.stats.ticks for r in affected)
            drained = [r for r in affected if r.running]
            for r in drained:
                r.stop(timeout=self.reshard_timeout)
            # verify EVERY affected worker is gone (including one still
            # draining from a previously aborted reshard): migration
            # must never run concurrently with a live writer.
            stuck = [r.name for r in affected if r.draining]
            if stuck:
                raise RuntimeError(
                    f"replicas {stuck} did not drain within "
                    f"{self.reshard_timeout}s; reshard aborted (retry "
                    "once their in-flight micro-batches finish)")
            summary["cutover_ticks"] = (sum(r.stats.ticks for r in affected)
                                        - ticks_before)
            # leavers are quiesced (or dead) now, so their counters are
            # final: snapshot them here, bank them only after the
            # cutover commits (an aborted reshard keeps its leavers, and
            # banking early would double-count them on retry)
            retiring = {r.name: {c: int(getattr(r.stats, c, 0) or 0)
                                 for c in self.retired_stats}
                        for r in affected if r.name not in names}
            # same banking for the overload ledger: a leaver's shed/
            # expired/quota counters are final once quiesced (a dead
            # remote falls back to its cached snapshot; no counters at
            # all banks zeros).
            retiring_overload: Dict[str, Dict] = {}
            for r in affected:
                if r.name in names:
                    continue
                fn = getattr(r, "overload_counters", None)
                if fn is None:
                    continue
                try:
                    retiring_overload[r.name] = dict(fn())
                except Exception:
                    retiring_overload[r.name] = {}
            # 2) migrate: hand exactly the moved slices to the new owners
            owners = {**self._by_name, **joiners}
            for src in affected:
                for which, src_store in self._slices(src):
                    if src_store is None:
                        continue
                    by_dest: Dict[str, List] = {}
                    for key in src_store.keys():
                        owner = new_ring.route(key[0])
                        if owner != src.name:
                            by_dest.setdefault(owner, []).append(key)
                    for owner, keys in sorted(by_dest.items()):
                        dest_store = dict(
                            self._slices(owners[owner]))[which]
                        if dest_store is None:
                            summary["keys_skipped"] += len(keys)
                            continue
                        res = src_store.split(keys, dest_store)
                        summary["keys_moved"] += res["moved"]
                        summary[f"{which}_keys_moved"] += res["moved"]
                        summary["units_moved"] += res["units"]
                        summary["keys_skipped"] += res["skipped"]
            # 3) cutover: swap the ring atomically, wake parked queries
            self._cutover_swap(names, new_ring, joiners)
        except BaseException:
            # any failure before the cutover leaves the OLD ring in
            # place: the quiesced survivors must serve again, or their
            # shards would reject every query until a manual restart.
            if self._started:
                for r in drained:
                    try:
                        r.start()
                    except RuntimeError:
                        pass  # still draining: it finishes on its own
            raise
        finally:
            with self._route_lock:
                self._resharding = False
                self._draining = set()
                self._cutover.notify_all()  # never strand a parked query
        for k in ("keys_moved", "units_moved", "keys_skipped",
                  "cutover_ticks"):
            self.reshard_stats[k] += summary[k]
        self.reshard_stats["reshards"] += 1
        for counters in retiring.values():
            for c, v in counters.items():
                self.retired_stats[c] += v
        for counters in retiring_overload.values():
            for c, v in counters.items():
                if c in self.retired_overload:  # cached dicts may carry
                    self.retired_overload[c] += int(v or 0)  # e.g. "stale"
        summary["retired"] = sorted(retiring)
        events.emit("reshard", members_from=summary["from"],
                    members_to=summary["to"],
                    keys_moved=summary["keys_moved"],
                    keys_skipped=summary["keys_skipped"],
                    cutover_ticks=summary["cutover_ticks"])
        return summary

    def _cutover_swap(self, names: Sequence[str], new_ring: HashRing,
                      joiners: Dict[str, GatewayReplica]) -> None:
        """Atomic membership + ring swap; restarts quiesced gateways.

        Everything a router can observe — ``replicas``, ``_by_name``,
        ``ring``, the running state of every member — changes under ONE
        ``_route_lock`` hold, then the epoch bump releases every query
        parked on the cutover condition to re-route through the new
        ring. (Separated from ``_reshard`` so crash tests can fail the
        protocol precisely between migrate and cutover.)
        """
        for rep in joiners.values():
            self._wire_failure_handling(rep)
        with self._route_lock:
            self.replicas = [joiners.get(n) or self._by_name[n]
                             for n in names]
            self._by_name = {r.name: r for r in self.replicas}
            self.ring = new_ring
            self._draining = set()
            if self._started:
                for r in self.replicas:
                    if not r.running:
                        r.start()
            self._epoch += 1
            self._cutover.notify_all()
        if self.publisher is not None:
            self.publisher.set_replicas(self.replicas)
        if self.refitter is not None:
            self.refitter.set_sources(
                [r.feedback for r in self.replicas
                 if r.feedback is not None])

    # -- feedback loop ------------------------------------------------------
    def observe(self, cfg, batch: int, seq: int, time_s: float,
                mem_bytes: float, **kw) -> None:
        """Report a completion to the replica that owns the config.

        The observation lands in the owning replica's ``FeedbackStore``
        slice (and its calibration window); the central refitter pulls
        it on its next federated sync. ``notify()`` keeps that sync
        prompt without the frontend doing any merging inline. An
        observation racing a reshard of its owner parks until the
        cutover and lands in the NEW owner's slice. The file write
        itself happens OUTSIDE the routing lock (submits never stall
        behind disk I/O); if the written replica was *removed* from
        the fleet mid-write — its slice already handed off — the
        observation is re-delivered to the current owner (a surviving
        member's slice stays a refitter source, so only removal needs
        the retry; the rare duplicate this can add is benign, lost
        feedback would not be).
        """
        fp = kw.pop("fp", None) or config_fingerprint(cfg)
        deadline = time.monotonic() + self.reshard_timeout
        redeliveries = 0
        avoid: set = set()
        while True:
            with self._route_lock:
                name = self.ring.route(fp)
                if name in self._draining:
                    self._await_cutover(self._epoch, deadline)
                    continue                  # parked; re-route fresh
                replica = self._by_name[name]
                if name in avoid or getattr(replica, "dead", False):
                    picked = self._pick_owner(fp, frozenset(avoid))
                    if picked is None:
                        raise ReplicaUnavailable(
                            f"no live replica to observe {fp!r}")
                    replica = picked
            try:
                replica.observe(cfg, batch, seq, time_s, mem_bytes,
                                fp=fp, **kw)
            except ReplicaUnavailable:
                # owner died mid-call: its slice survives on disk and the
                # exclusion reshard will hand it over — deliver to the
                # ring successor now (feedback merges are idempotent).
                avoid.add(replica.name)
                if len(avoid) >= len(self.replicas):
                    raise
                continue
            with self._route_lock:
                if (self._by_name.get(replica.name) is replica
                        or redeliveries >= 3):
                    break                     # still a member: durable
            redeliveries += 1
        if self.refitter is not None:
            self.refitter.notify()

    def sync_feedback(self) -> int:
        """Merge every replica's feedback slice into the central store."""
        if self.feedback is None:
            raise ValueError("no central feedback store "
                             "(construct with feedback_root=...)")
        return sum(self.feedback.merge(r.feedback) for r in self.replicas
                   if r.feedback is not None)

    # -- model generations --------------------------------------------------
    def publish_generation(self, gen) -> bool:
        """Broadcast a generation to every replica (tick-boundary applied)."""
        if self.publisher is None:
            self.publisher = GenerationPublisher(self.replicas)
        return self.publisher.publish_generation(gen)

    def attach_refitter(self, refitter: OnlineRefitter) -> OnlineRefitter:
        """Wire a central refitter into the fleet's publish path."""
        self.publisher = self.publisher or GenerationPublisher(self.replicas)
        refitter.add_sink(self.publisher)
        self.refitter = refitter
        return refitter

    def make_refitter(self, seed_records=None, **kw) -> OnlineRefitter:
        """Central ``OnlineRefitter`` over the fleet.

        Consumes the federated merge of every replica's
        ``FeedbackStore`` (``sources=``), resolves feedback keys
        against the owning shard's traces, and publishes each new
        generation to every replica via ``GenerationPublisher``.
        """
        if self.feedback is None:
            raise ValueError("central refit needs feedback_root=...")
        refitter = OnlineRefitter(
            self.replicas[0].service, self.feedback,
            seed_records=seed_records, traces=ShardedTraces(self),
            sources=[r.feedback for r in self.replicas
                     if r.feedback is not None], **kw)
        return self.attach_refitter(refitter)

    # -- introspection ------------------------------------------------------
    def server_info(self) -> Dict:
        per = {r.name: r.server_info() for r in self.replicas}
        fleet = self._sum_counters(per)
        fleet["queued"] = sum(p.get("queued", 0) for p in per.values())
        return {"replicas": len(self.replicas), "running": self.running,
                "fleet": fleet, "per_replica": per}

    @staticmethod
    def _sum_counters(per: Dict[str, Dict]) -> Dict:
        counters = ServerStats.COUNTERS
        fleet = {c: sum(p.get(c, 0) for p in per.values()) for c in counters}
        # max_batch is a high-water mark, not additive
        fleet["max_batch"] = max((p.get("max_batch", 0)
                                  for p in per.values()), default=0)
        return fleet

    def stats(self) -> Dict:
        """Fleet-wide view: summed counters, merged calibration, refit,
        and the lifetime resharding/migration counters.

        ``stale_replicas`` lists members whose contribution is a cached
        fallback (a dead ``RemoteReplica`` serving its last-known
        counters, stamped ``{"stale": true, ...}``) — the fleet sums
        include those cached numbers, so consumers can tell live truth
        from a dead member's last words."""
        per = {r.name: r.stats() for r in self.replicas}
        fleet = self._sum_counters(per)
        out = {
            "replicas": len(self.replicas),
            "fleet": fleet,
            "reshard": dict(self.reshard_stats),
            "retired": dict(self.retired_stats),
            "generations": sorted({r.service.generation
                                   for r in self.replicas}),
            "calibration": merge_calibration(
                [p.get("calibration", {}) for p in per.values()]),
            "per_replica": per,
            "stale_replicas": sorted(name for name, p in per.items()
                                     if p.get("stale")),
            # NEW key (stats() compat): all-time overload accounting is
            # fleet (live members) + retired (banked leavers) + frontend
            # (replay expiries that never reached a replica).
            "overload": {
                "fleet": {k: sum(int((p.get("overload") or {}).get(k, 0)
                                     or 0) for p in per.values())
                          for k in ("shed", "expired", "quota_rejected")},
                "retired": dict(self.retired_overload),
                "frontend": dict(self.overload_stats),
            },
        }
        if self.refitter is not None:
            out["refit"] = self.refitter.info()
        if self.publisher is not None:
            out["publisher"] = self.publisher.info()
        if self.feedback is not None:
            out["feedback"] = self.feedback.info()
        return out

    def metrics_snapshot(self) -> Dict:
        """Fleet-merged registry snapshot: the frontend's own counters
        plus every reachable replica's (counters sum, gauges max,
        histogram buckets add — replica order cannot change the
        result). Unreachable members are skipped and counted in the
        ``fleet_unreachable`` gauge."""
        snaps = [self.metrics.snapshot()]
        unreachable = 0
        for r in list(self.replicas):
            fn = getattr(r, "metrics_snapshot", None)
            if fn is None:
                continue
            try:
                snaps.append(fn())
            except Exception:
                unreachable += 1
        merged = merge_snapshots(snaps)
        merged["fleet_unreachable"] = {"type": "gauge",
                                       "value": unreachable}
        return merged

    def metrics_text(self) -> str:
        """Prometheus text exposition of :meth:`metrics_snapshot`."""
        return render_prometheus(self.metrics_snapshot(),
                                 namespace=self.metrics.namespace)
