"""Online refit: stream measured costs back into the DNNAbacus ensembles.

The serving stack admits jobs from predictions fit *offline*; once the
fleet drifts (new kernels, thermal throttling, contended hosts), those
predictions go stale and nothing corrects them. ``OnlineRefitter``
closes the loop:

  1. finished jobs report measured ``(time, mem)`` into a
     ``FeedbackStore`` (``AdmissionController.report_completion`` ->
     ``AbacusServer.observe``),
  2. when enough fresh feedback accrues (count or staleness threshold),
     the refitter joins each observation with its traced
     ``ProfileRecord`` (same ``(fingerprint, batch, seq)`` key, resolved
     from the service's memory cache or the persistent ``TraceStore``),
     overwrites the record's targets with the measured costs, and refits
     the ensembles on seed records + feedback via ``DNNAbacus.refit``
     (which reuses the currently selected model architectures instead of
     re-searching the full pool),
  3. the result is published as an immutable, monotonically numbered
     ``ModelGeneration``; sinks (``AbacusServer`` — which applies the
     swap *between* micro-batch ticks — or a bare ``PredictionService``)
     adopt it, invalidating their per-generation prediction caches
     while keeping every persisted trace.

The refitter can run as a background worker (``start``/``stop`` or the
context manager: a daemon thread wakes on ``notify()`` and on a
staleness timer) or be driven synchronously with ``refit_now()``.

A copy of ``repro.serve.refit`` (the port imports nothing of the
reference): it refits the port's ``DNNAbacus`` (``DNNAbacus.refit``),
whose JSON either package loads.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core.features import ProfileRecord
from repro_torch.obs import events
from repro_torch.serve.feedback_store import FeedbackStore, StoreKey


@dataclasses.dataclass(frozen=True)
class ModelGeneration:
    """One immutable published predictor version."""
    number: int
    abacus: object = dataclasses.field(repr=False, compare=False)
    n_feedback: int = 0         # observations the refit consumed
    n_train_records: int = 0    # seed + feedback records it was fit on
    n_unresolved: int = 0       # observations skipped (no trace for key)
    source: str = "refit"       # "seed" for generation 0
    created_at: float = 0.0

    def summary(self) -> Dict:
        return {"number": self.number, "source": self.source,
                "n_feedback": self.n_feedback,
                "n_train_records": self.n_train_records,
                "n_unresolved": self.n_unresolved,
                "created_at": self.created_at}


class OnlineRefitter:
    """Threshold-triggered ensemble refit + generation publisher.

    ``service`` is the ``PredictionService`` whose predictor is being
    refit (its memory cache and backing ``TraceStore`` resolve feedback
    keys to traced records; it is also the default publish sink when no
    other sink registers). ``feedback`` is the ``FeedbackStore`` the
    completion reports land in.

    ``min_observations`` fresh observations — or any fresh observation
    older than ``max_staleness_s`` — arm ``should_refit``. Seed records
    keep the refit anchored on the offline profile set; with
    ``replace_seed`` (default) seed records whose
    ``(model, batch, input)`` identity collides with a feedback record
    are dropped, so measured costs *replace* stale profiles instead of
    fighting them, and ``feedback_repeat`` replicates feedback records
    to upweight fresh measurements against a large seed set.
    """

    def __init__(self, service, feedback: FeedbackStore,
                 seed_records: Optional[Sequence[ProfileRecord]] = None,
                 traces=None, min_observations: int = 8,
                 max_staleness_s: Optional[float] = None,
                 replace_seed: bool = True, feedback_repeat: int = 1,
                 min_train_records: int = 4, val_frac: float = 0.2,
                 obs_window: int = 32,
                 sources: Optional[Sequence[FeedbackStore]] = None):
        self.service = service
        self.feedback = feedback
        self.seed_records = list(seed_records or [])
        self.traces = traces  # optional extra source with .get(key)
        # federated inputs: per-replica FeedbackStores whose contents are
        # merged into `feedback` before every threshold check, so one
        # central refitter consumes the whole fleet's observations.
        # merge() is commutative+idempotent, so repeated syncs converge.
        self.sources = list(sources or [])
        self.synced = 0  # observations imported from sources so far
        # sum of source totals at the last sync: a full federated merge
        # re-parses every key file of every source, so routine
        # should_refit() polls skip it unless some source's O(1) cached
        # count moved since the last sync (see sync_sources)
        self._source_mark: Optional[int] = None
        self.min_observations = int(min_observations)
        self.max_staleness_s = max_staleness_s
        self.replace_seed = bool(replace_seed)
        self.feedback_repeat = max(1, int(feedback_repeat))
        self.min_train_records = int(min_train_records)
        self.val_frac = float(val_frac)
        # refit targets average only each key's newest obs_window
        # observations (by timestamp): when reality drifts AGAIN, fresh
        # measurements must displace the old regime instead of blending
        # with it forever.
        self.obs_window = max(1, int(obs_window))

        self.generation = ModelGeneration(
            number=int(getattr(service, "generation", 0)),
            abacus=service.abacus, source="seed",
            n_train_records=len(self.seed_records), created_at=time.time())
        self.refits = 0
        self.refit_failures = 0
        self.publish_failures = 0
        self.last_refit_s: Optional[float] = None

        # observations persisted by PRIOR processes count as fresh: the
        # documented "later refit pass" (e.g. over a dryrun-populated
        # store) must consume them, not silently skip to the watermark.
        self._consumed = 0
        self._fresh_since: Optional[float] = None
        self._kick = False  # latched notify(): never miss a pre-wait wakeup
        # total() at the last NO-PROGRESS attempt (all feedback
        # unresolvable / too little to fit): until the count moves or a
        # notify() arrives, should_refit() stays False so the staleness
        # poll cannot re-run a doomed full-store scan every interval.
        self._stuck_at: Optional[int] = None
        self._sinks: List[object] = []
        self._cond = threading.Condition()
        self._refit_lock = threading.Lock()  # one refit at a time
        self._worker: Optional[threading.Thread] = None
        self._running = False

    # -- sinks --------------------------------------------------------------
    def add_sink(self, sink) -> "OnlineRefitter":
        """Register a generation consumer (``publish_generation(gen)``)."""
        with self._cond:
            if sink not in self._sinks:
                self._sinks.append(sink)
        return self

    def _publish(self, gen: ModelGeneration) -> None:
        with self._cond:
            sinks = list(self._sinks)
        if not sinks:  # default: the service adopts directly
            self.service.adopt(gen.abacus, gen.number)
            return
        for sink in sinks:
            try:
                sink.publish_generation(gen)
            except Exception:
                # a failing sink (e.g. a future remote gateway) must not
                # swallow the generation for the others, and must be
                # visible in info() — not silently dropped.
                self.publish_failures += 1

    # -- triggering ---------------------------------------------------------
    def notify(self) -> None:
        """New feedback arrived: stamp staleness clock, wake the worker."""
        with self._cond:
            if self._fresh_since is None:
                self._fresh_since = time.time()
            self._kick = True
            self._stuck_at = None  # fresh signal: a retry may now progress
            self._cond.notify_all()

    def set_sources(self, sources: Sequence[FeedbackStore]) -> None:
        """Swap the federated source list (live fleet resharding).

        The change detector mark is reset so the next ``sync_sources``
        scans unconditionally — a replica that just joined may carry
        merged observations the old mark would wrongly skip.
        """
        with self._cond:
            self.sources = list(sources or [])
            self._source_mark = None

    def sync_sources(self, force: bool = False) -> int:
        """Federated merge: pull every source store into ``feedback``.

        Returns how many observations were new to the central store.
        Safe to call at any time from any thread (merge is idempotent);
        called automatically before each ``should_refit`` evaluation so
        fleet-wide feedback counts toward the refit thresholds.

        The merge itself re-parses every key file of every source, so
        it is gated on a cheap change detector: the sum of the sources'
        O(1) cached ``total()``s. Sources are the fleet's *in-process*
        replica slices (their counters track every local add), so an
        unchanged sum means nothing new to pull and the scan is
        skipped; ``force=True`` (the explicit ``refit_now(force=True)``
        path) always scans, which also picks up writes landed by other
        processes.
        """
        try:
            mark = sum(src.total() for src in self.sources)
        except Exception:
            mark = None  # a source can't even count: scan to find out
        with self._cond:
            if not force and mark is not None and mark == self._source_mark:
                return 0
        imported = 0
        for src in self.sources:
            try:
                imported += self.feedback.merge(src)
            except Exception:
                # a torn/unreadable source (e.g. a remote replica's
                # store mid-copy) must not take down the refit loop;
                # merge is retried on the next sync anyway.
                continue
        with self._cond:
            self._source_mark = mark
        if imported:
            self.synced += imported
        return imported

    def fresh_observations(self) -> int:
        return max(0, self.feedback.total() - self._consumed)

    def should_refit(self) -> bool:
        if self.sources:
            self.sync_sources()
        fresh = self.fresh_observations()
        if fresh <= 0:
            return False
        with self._cond:
            if self._stuck_at is not None \
                    and self.feedback.total() == self._stuck_at:
                return False  # last attempt made no progress; wait for news
        if fresh >= self.min_observations:
            return True
        if self.max_staleness_s is not None:
            with self._cond:
                since = self._fresh_since
            if since is None:  # feedback written without notify()
                since = self.feedback.oldest_ts()
            if since is not None:
                return time.time() - since >= self.max_staleness_s
        return False

    # -- record resolution ---------------------------------------------------
    def _resolve(self, key: StoreKey) -> Optional[ProfileRecord]:
        """Traced ProfileRecord for a feedback key, or None."""
        rec = self.service.cached_record(key)
        if rec is not None:
            return rec
        for source in (self.traces, getattr(self.service, "store", None)):
            if source is None:
                continue
            try:
                rec = source.get(key)
            except Exception:
                rec = None
            if rec is not None:
                return rec
        return None

    @staticmethod
    def _identity(rec: ProfileRecord):
        return (rec.model_name, rec.batch_size, rec.input_size)

    def training_records(self):
        """(records, n_feedback_consumed, n_unresolved) for the next refit."""
        fb_records, unresolved, consumed = [], 0, 0
        for key, observations in sorted(self.feedback.grouped().items()):
            consumed += len(observations)
            rec = self._resolve(key)
            if rec is None:
                unresolved += len(observations)
                continue
            window = observations[-self.obs_window:]  # newest (ts-sorted)
            t = sum(o.time_s for o in window) / len(window)
            m = sum(o.mem_bytes for o in window) / len(window)
            fb_records.append(dataclasses.replace(
                rec, time_s=float(t), mem_bytes=float(m)))
        seeds = self.seed_records
        if self.replace_seed and fb_records:
            stale = {self._identity(r) for r in fb_records}
            seeds = [r for r in seeds if self._identity(r) not in stale]
        records = list(seeds) + fb_records * self.feedback_repeat
        return records, consumed, unresolved

    # -- refit ---------------------------------------------------------------
    def refit_now(self, force: bool = False) -> Optional[ModelGeneration]:
        """Refit + publish one generation; None when below thresholds.

        ``force`` skips the count/staleness thresholds (still requires
        at least one resolvable feedback record).
        """
        with self._refit_lock:
            if force and self.sources:
                # should_refit (the guarded sync) is skipped on this
                # path: scan unconditionally so an explicit force also
                # sees observations landed by other processes
                self.sync_sources(force=True)
            if not force and not self.should_refit():
                return None
            records, consumed, unresolved = self.training_records()
            if (consumed == unresolved
                    or len(records) < self.min_train_records):
                with self._cond:  # no progress: park until the count moves
                    self._stuck_at = consumed
                return None  # nothing resolvable (or too little) to fit on
            t0 = time.perf_counter()
            try:
                abacus = self.generation.abacus.refit(
                    records, val_frac=self.val_frac)
            except Exception:
                self.refit_failures += 1
                events.emit("refit_failed", generation=self.generation.number)
                raise
            self.last_refit_s = time.perf_counter() - t0
            gen = ModelGeneration(
                number=self.generation.number + 1, abacus=abacus,
                n_feedback=consumed - unresolved,
                n_train_records=len(records), n_unresolved=unresolved,
                created_at=time.time())
            self.generation = gen
            self.refits += 1
            with self._cond:
                self._consumed = consumed
                self._fresh_since = None
        events.emit("refit", generation=gen.number,
                    n_feedback=gen.n_feedback,
                    n_train_records=gen.n_train_records,
                    duration_s=self.last_refit_s)
        self._publish(gen)
        return gen

    # -- background worker ---------------------------------------------------
    def start(self) -> "OnlineRefitter":
        with self._cond:
            if self._running:
                return self
            self._running = True
        self._worker = threading.Thread(target=self._loop,
                                        name="abacus-refit", daemon=True)
        self._worker.start()
        return self

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        worker, self._worker = self._worker, None
        if worker is not None:
            worker.join(timeout)

    def __enter__(self) -> "OnlineRefitter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        # staleness forces periodic re-checks even without notify()
        poll = (None if self.max_staleness_s is None
                else max(0.01, self.max_staleness_s / 4.0))
        while True:
            with self._cond:
                if not self._running:
                    return
                # every attempt is gated on a notify() (latched in _kick,
                # so a wakeup arriving before this wait is never lost) or
                # the staleness poll. A refit that makes no progress —
                # all feedback unresolvable, or a raising fit — therefore
                # parks here instead of busy-spinning full-store scans.
                if not self._kick:
                    self._cond.wait(timeout=poll)
                self._kick = False
                if not self._running:
                    return
            try:
                if self.should_refit():
                    self.refit_now()
            except Exception:
                pass  # counted in refit_failures; the worker must survive

    # -- introspection -------------------------------------------------------
    def info(self) -> Dict:
        return {"generation": self.generation.summary(),
                "refits": self.refits,
                "refit_failures": self.refit_failures,
                "publish_failures": self.publish_failures,
                "sources": len(self.sources),
                "synced": self.synced,
                "last_refit_s": self.last_refit_s,
                "fresh_observations": self.fresh_observations(),
                "min_observations": self.min_observations,
                "max_staleness_s": self.max_staleness_s,
                "running": self._running}
