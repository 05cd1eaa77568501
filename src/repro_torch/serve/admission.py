"""Admission bridge: streaming queries -> incremental GA placement (§4.3).

``PredictionService.schedule`` answers the paper's one-shot question —
place N known jobs on an empty cluster. A scheduler front door sees a
*stream*: queries arrive in waves while earlier admissions are still
running, so each wave must be placed against the cluster's **current**
load, not a blank slate.

``AdmissionController`` keeps that rolling state — per-machine committed
busy time and HBM reserved by resident jobs — and turns each wave of
queries into an incremental placement: estimates come from the
micro-batched ``AbacusServer`` (or a bare ``PredictionService``), jobs
whose predicted memory cannot fit any machine's *residual* HBM are
rejected up front, and the rest are placed by ``repro_torch.core.scheduler``
with the committed load as the optimization baseline (``base_time`` /
``reserved_mem``). ``complete(job_id)`` releases a finished job's
reservation so later waves see the freed capacity.

A copy of ``repro.serve.admission`` (the port imports nothing of the
reference) on the port's ``repro_torch.core.scheduler``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.scheduler import Machine, jobs_from_estimates, schedule_jobs
from repro_torch.serve.prediction_service import Query


@dataclasses.dataclass(frozen=True)
class Verdict:
    """One query's admission outcome."""
    job_id: str
    model: str
    admitted: bool
    machine: Optional[str]      # None iff rejected
    time_s: float
    mem_bytes: float
    reason: str = ""            # non-empty iff rejected

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class AdmissionController:
    """Rolling cluster state + incremental placement for query streams.

    ``predictor`` is anything with ``predict_many(queries) -> [est]`` —
    an ``AbacusServer`` (micro-batched, the production path) or a
    ``PredictionService`` (synchronous). Thread-safe: concurrent
    ``admit``/``complete`` calls serialize on one lock so reservations
    never double-commit a machine's HBM.
    """

    # plans that return a per-job assignment; "random" returns trial
    # makespans (a baseline statistic), which admission cannot commit
    ASSIGNING_PLANS = ("ga", "optimal")

    #: completed-job summaries retained for idempotent re-reports
    COMPLETED_CACHE = 1024

    def __init__(self, predictor, machines: Sequence[Machine],
                 plan: str = "ga", time_scale: float = 1.0,
                 mem_pad: float = 0.0, metrics=None,
                 tenant_calibration=None, **plan_kw):
        if plan not in self.ASSIGNING_PLANS:
            raise ValueError(
                f"plan {plan!r} does not produce an assignment; "
                f"choose from {self.ASSIGNING_PLANS}")
        # admission outcomes on the shared registry (the predictor's, if
        # it has one): exposed alongside the serving metrics so operator
        # dashboards see admit/reject rates next to query latency.
        from repro_torch.obs.metrics import MetricsRegistry
        self.metrics = (metrics if metrics is not None
                        else getattr(predictor, "metrics", None)
                        or MetricsRegistry())
        self._c_admitted = self.metrics.counter("admission_admitted_total")
        self._c_rejected = self.metrics.counter("admission_rejected_total")
        self._c_completions = self.metrics.counter(
            "admission_completions_total")
        self._h_wave = self.metrics.histogram(
            "admission_wave_seconds",
            help="wall time to place one wave of queries")
        self.predictor = predictor
        self.machines = list(machines)
        self.plan = plan
        self.time_scale = float(time_scale)
        self.mem_pad = float(mem_pad)
        self.plan_kw = dict(plan_kw)
        self._busy = np.zeros(len(self.machines))      # committed time
        self._reserved = np.zeros(len(self.machines))  # committed HBM
        # job_id -> (m_idx, Job, Query, estimate): the query/estimate pair
        # is kept so a completion report can feed the measured outcome —
        # joined with what we *predicted* — back into the refit loop.
        self._resident: Dict[str, tuple] = {}
        # job_id -> completion summary: duplicate report_completion calls
        # (a retried caller) get the cached summary instead of a
        # double-release; bounded so long-lived controllers don't leak.
        self._completed: "OrderedDict[str, Dict]" = OrderedDict()
        # per-tenant drift source for reservation inflation: explicit, or
        # borrowed from the predictor (the AbacusServer gateway owns one)
        self.tenant_calibration = (
            tenant_calibration if tenant_calibration is not None
            else getattr(predictor, "tenant_calibration", None))
        self._ids = itertools.count()
        self._lock = threading.Lock()

    # -- admission ----------------------------------------------------------
    def admit(self, queries: Sequence) -> List[Verdict]:
        """Place one wave of queries against current cluster state."""
        qs = [q if isinstance(q, Query) else Query(*q) for q in queries]
        if not qs:
            return []
        t_wave = time.perf_counter()
        ests = self.predictor.predict_many(qs)
        names = [f"{e['model']}#{next(self._ids)}" for e in ests]
        times = [e["time_s"] for e in ests]
        mems = [e["memory_bytes"] for e in ests]
        if self.tenant_calibration is not None:
            # inflate reservations by each tenant's own observed drift:
            # a tenant whose jobs run hotter than predicted reserves
            # proportionally more, instead of starving its neighbours.
            for i, q in enumerate(qs):
                tenant = getattr(q, "tenant", "")
                if not tenant:
                    continue
                times[i] *= self.tenant_calibration.inflation(tenant, "time")
                mems[i] *= self.tenant_calibration.inflation(tenant, "mem")
        jobs = jobs_from_estimates(
            names, times, mems,
            time_scale=self.time_scale, mem_pad=self.mem_pad)
        with self._lock:
            # reject jobs no machine can host at current residual HBM —
            # the placement plans treat them as globally infeasible.
            placeable, verdicts = [], [None] * len(jobs)
            for i, job in enumerate(jobs):
                residual = [m.hbm_bytes - self._reserved[k]
                            for k, m in enumerate(self.machines)]
                if job.mem_bytes <= max(residual):
                    placeable.append(i)
                else:
                    verdicts[i] = Verdict(
                        job_id=job.name, model=ests[i]["model"],
                        admitted=False, machine=None,
                        time_s=jobs[i].time_s, mem_bytes=job.mem_bytes,
                        reason=f"needs {job.mem_bytes:.3g} B; max residual "
                               f"HBM {max(residual):.3g} B")
            if placeable:
                sub = [jobs[i] for i in placeable]
                _, assign = schedule_jobs(
                    sub, self.machines, plan=self.plan,
                    base_time=self._busy.copy(),
                    reserved_mem=self._reserved.copy(), **self.plan_kw)
                for i, a in zip(placeable, assign):
                    a = int(a)
                    # guard: a stochastic plan (GA) can hand back an
                    # assignment violating residual HBM, and commits
                    # earlier in this wave shrink it further — repair
                    # onto the least-busy machine that can still host
                    # the job, or reject if none remains.
                    job = jobs[i]
                    if (job.mem_bytes + self._reserved[a]
                            > self.machines[a].hbm_bytes):
                        ok = [k for k, mc in enumerate(self.machines)
                              if job.mem_bytes + self._reserved[k]
                              <= mc.hbm_bytes]
                        if not ok:
                            verdicts[i] = Verdict(
                                job_id=job.name, model=ests[i]["model"],
                                admitted=False, machine=None,
                                time_s=job.time_s, mem_bytes=job.mem_bytes,
                                reason="no residual HBM after earlier "
                                       "placements in this wave")
                            continue
                        a = min(ok, key=lambda k: self._busy[k])
                    m = self.machines[a]
                    self._busy[a] += job.time_s / m.speed
                    self._reserved[a] += job.mem_bytes
                    self._resident[job.name] = (a, job, qs[i], ests[i])
                    verdicts[i] = Verdict(
                        job_id=job.name, model=ests[i]["model"],
                        admitted=True, machine=m.name,
                        time_s=job.time_s, mem_bytes=job.mem_bytes)
            n_adm = sum(1 for v in verdicts if v.admitted)
            self._c_admitted.inc(n_adm)
            self._c_rejected.inc(len(verdicts) - n_adm)
        self._h_wave.observe(time.perf_counter() - t_wave)
        return verdicts

    def complete(self, job_id: str) -> None:
        """Release a finished job's time/memory reservation (no feedback)."""
        self.report_completion(job_id)

    def report_completion(self, job_id: str,
                          time_s: Optional[float] = None,
                          mem_bytes: Optional[float] = None) -> Dict:
        """Finish a job: free its reservation AND stream its measured cost.

        Releasing the reservation is unconditional — the cluster state
        must return to baseline once every admitted job completes, with
        or without measurements. ``time_s``/``mem_bytes`` are measured
        in the *verdict* domain (what the caller was told to expect:
        predictor estimate x ``time_scale``, + ``mem_pad``); they are
        normalized back to the predictor's per-step domain before
        feeding the loop, so calibration and refit targets stay
        commensurate with the ensembles' outputs. When the predictor
        exposes ``observe`` (the ``AbacusServer`` gateway), the
        observation — joined with the prediction that admitted the job
        and the generation that made it — feeds the online refit loop.
        Returns a small completion summary (predicted vs measured, raw
        domain). Idempotent: a duplicate report (a retried caller whose
        first call already landed) returns the cached summary without
        releasing the reservation a second time; a job this controller
        never admitted still raises ``KeyError``.
        """
        with self._lock:
            if job_id not in self._resident:
                cached = self._completed.get(job_id)
                if cached is not None:
                    return dict(cached)
                raise KeyError(f"unknown or already-completed job {job_id!r}")
            k, job, query, est = self._resident.pop(job_id)
            self._busy[k] = max(0.0, self._busy[k]
                                - job.time_s / self.machines[k].speed)
            self._reserved[k] = max(0.0, self._reserved[k] - job.mem_bytes)
            self._c_completions.inc()
            raw_t = (None if time_s is None
                     else float(time_s) / self.time_scale)
            raw_m = (None if mem_bytes is None
                     else max(0.0, float(mem_bytes) - self.mem_pad))
            summary = {"job_id": job_id, "machine": self.machines[k].name,
                       "predicted_time_s": est["time_s"],
                       "predicted_mem_bytes": est["memory_bytes"],
                       "measured_time_s": raw_t, "measured_mem_bytes": raw_m,
                       "generation": est.get("generation"), "observed": False}
            # cache the summary before dropping the lock: a concurrent
            # duplicate must either pop the reservation (it can't — we
            # just did) or find the cache populated.
            self._completed[job_id] = summary
            while len(self._completed) > self.COMPLETED_CACHE:
                self._completed.popitem(last=False)
        observe = getattr(self.predictor, "observe", None)
        # non-positive normalized measurements (e.g. measured mem below
        # mem_pad) carry no calibration signal and would poison the
        # window (inf MRE) and the refit targets (log(~0)): release the
        # reservation but do not observe.
        if (observe is not None and raw_t is not None and raw_m is not None
                and raw_t > 0.0 and raw_m > 0.0):
            kw = {}
            tenant = getattr(query, "tenant", "")
            if tenant:
                kw["tenant"] = tenant
            observe(query.cfg, query.batch, query.seq, raw_t, raw_m,
                    predicted_time_s=est["time_s"],
                    predicted_mem_bytes=est["memory_bytes"],
                    generation=est.get("generation"), job_id=job_id, **kw)
            summary["observed"] = True
        return dict(summary)

    # -- introspection ------------------------------------------------------
    def cluster_state(self) -> Dict:
        with self._lock:
            return {
                "machines": [
                    {"name": m.name,
                     "busy_s": float(self._busy[k]),
                     "reserved_bytes": float(self._reserved[k]),
                     "residual_bytes": float(m.hbm_bytes - self._reserved[k]),
                     "jobs": sorted(j for j, (a, *_) in
                                    self._resident.items() if a == k)}
                    for k, m in enumerate(self.machines)],
                "resident_jobs": len(self._resident),
                "makespan_s": float(self._busy.max()) if len(self._busy)
                              else 0.0,
            }
