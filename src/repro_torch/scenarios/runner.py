"""Schedule replay against a live fleet, with independent ground truth.

``ScenarioRunner`` replays a :class:`~repro_torch.scenarios.workload.Schedule`
against an ``AbacusServer`` or ``ClusterFrontend`` (in-process or RPC
replicas — the runner only touches the shared client API plus the fault
surface). Virtual timestamps are scaled by ``time_scale`` real seconds
per virtual second (0 = as fast as possible, order preserved).

The runner is the *independent witness* the oracles compare telemetry
against: it counts everything it does on its own (submits dispatched,
futures resolved/failed, observations issued, expected generation swaps
and exclusions) without reading a single server counter, and records a
per-query outcome ledger (tenant, estimate, generation at answer,
serving replica).

Fault mapping per target:

  * ``publish`` — mints the next ``ModelGeneration`` from a snapshot of
    the newest live predictor (same abacus, bumped number: estimates
    stay parity-comparable across the swap), broadcasts it, and WAITS
    until every live replica reports adoption — so the expected
    ``gen_swaps`` delta is exactly the membership size at publish time.
  * ``kill`` — RPC replica: SIGKILL the child and wait for the
    heartbeat-driven auto-exclusion. In-process replica: there is no
    process to kill, so the same end state is forced via
    ``exclude_replica`` (drain -> migrate -> cutover; the drain serves
    queued futures first). Either way: one exclusion expected.
  * ``sigstop``/``sigcont`` — RPC only (wedges the child process);
    skipped and counted against in-process targets.
  * ``resize`` — ``ClusterFrontend.resize(n)`` (one protocol pass).

Submits are asynchronous; faults run synchronously in the replay thread
(so expected counters are unambiguous), while a harvester thread awaits
each future in dispatch order and issues the schedule's observations
(measured cost = estimate x the event's drift factors).

A copy of ``repro.scenarios.runner`` (the port imports nothing of the reference).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import signal
import threading
import time
from typing import Dict, List, Optional

from repro_torch.obs import events
from repro_torch.scenarios.workload import Schedule, config_from_payload
from repro_torch.serve.refit import ModelGeneration
from repro_torch.serve.server import DeadlineExceeded, QuotaExceeded

#: counters a retired (excluded/removed) replica contributed before it
#: left the fleet — everything additive in ``ServerStats.COUNTERS``
#: (``max_batch`` is a high-water mark, not additive).
#: Overload ground truth: ``expired`` counts every DeadlineExceeded
#: outcome (``replay_expired`` is the subset expired at the *frontend*,
#: i.e. a parked/replayed query that never reached a replica again);
#: ``shed`` counts estimates answered degraded from the roofline floor;
#: ``quota_rejected`` counts per-tenant admission rejections (sync
#: raises AND failed futures — the via-future form also retro-decrements
#: ``submitted``, because the server never accepted the query).
GROUND_KEYS = (
    "submitted", "resolved", "failed", "submit_rejected",
    "observes_issued", "observe_failed", "publishes",
    "expected_gen_swaps", "kills", "expected_exclusions", "resizes",
    "sigstops", "skipped_events",
    "expired", "shed", "quota_rejected", "replay_expired",
)


@dataclasses.dataclass
class ScenarioResult:
    """Everything one replay produced, in oracle-consumable form."""

    schedule: Schedule
    ground: Dict[str, int]
    outcomes: Dict[int, Dict]      # schedule event index -> outcome record
    stats_after: Dict
    metrics_after: Dict
    generations: Dict[int, object]  # generation number -> serving abacus
    is_cluster: bool
    supports_hedge: bool
    wall_s: float

    def resolved_outcomes(self) -> List[Dict]:
        return [o for _, o in sorted(self.outcomes.items()) if o.get("ok")]


class ScenarioRunner:
    """Replay one schedule against one target fleet; see module docstring."""

    def __init__(self, target, schedule: Schedule, *,
                 time_scale: float = 0.0, result_timeout: float = 120.0,
                 fault_timeout: float = 30.0):
        self.target = target
        self.schedule = schedule
        self.time_scale = float(time_scale)
        self.result_timeout = float(result_timeout)
        self.fault_timeout = float(fault_timeout)
        self.is_cluster = hasattr(target, "replicas")
        self.ground: Dict[str, int] = {k: 0 for k in GROUND_KEYS}
        self.outcomes: Dict[int, Dict] = {}
        self.generations: Dict[int, object] = {}
        self._q: "queue.Queue" = queue.Queue()
        self._glock = threading.Lock()

    # -- helpers -------------------------------------------------------------
    def _replicas(self) -> List:
        return list(self.target.replicas) if self.is_cluster \
            else [self.target]

    def _live_replicas(self) -> List:
        return [r for r in self._replicas()
                if not getattr(r, "dead", False)]

    def _member_names(self) -> List[str]:
        return [getattr(r, "name", "server") for r in self._replicas()]

    def _max_generation(self) -> int:
        gens = []
        for r in self._live_replicas():
            try:
                gens.append(int(r.service.generation))
            except Exception:
                pass
        return max(gens) if gens else 0

    def _snapshot_abacus(self):
        newest = max(self._live_replicas() or self._replicas(),
                     key=lambda r: r.service.generation)
        abacus, _ = newest.service.snapshot()
        return abacus

    def _bump(self, key: str, n: int = 1) -> None:
        with self._glock:
            self.ground[key] += n

    # -- replay --------------------------------------------------------------
    def run(self) -> ScenarioResult:
        t0 = time.perf_counter()
        self.generations.setdefault(self._max_generation(),
                                    self._snapshot_abacus())
        events.emit("scenario_start", name=self.schedule.meta.get("name"),
                    seed=self.schedule.meta.get("seed"),
                    n_events=len(self.schedule))
        harvester = threading.Thread(target=self._harvest,
                                     name="scenario-harvest", daemon=True)
        harvester.start()
        t_prev: Optional[float] = None
        try:
            for ev in self.schedule:
                if (self.time_scale > 0 and t_prev is not None
                        and ev["t"] > t_prev):
                    time.sleep((ev["t"] - t_prev) * self.time_scale)
                t_prev = ev["t"]
                self._dispatch(ev)
        finally:
            self._q.put(None)
            harvester.join(self.result_timeout
                           + self.result_timeout * len(self.schedule) ** 0.5)
        stats_after = self.target.stats()
        metrics_after = self.target.metrics_snapshot()
        wall = time.perf_counter() - t0
        result = ScenarioResult(
            schedule=self.schedule, ground=dict(self.ground),
            outcomes=self.outcomes, stats_after=stats_after,
            metrics_after=metrics_after, generations=dict(self.generations),
            is_cluster=self.is_cluster,
            supports_hedge=any(getattr(r, "supports_hedge", False)
                               for r in self._replicas()),
            wall_s=wall)
        events.emit("scenario_end", name=self.schedule.meta.get("name"),
                    wall_s=round(wall, 4), **{k: result.ground[k]
                                              for k in ("submitted",
                                                        "resolved", "failed",
                                                        "observes_issued")})
        return result

    def _dispatch(self, ev: Dict) -> None:
        op = ev["op"]
        if op == "submit":
            self._do_submit(ev)
            return
        events.emit("scenario_fault", op=op, t=ev["t"],
                    replica=ev.get("replica"), n=ev.get("n"))
        if op == "publish":
            self._do_publish(ev)
        elif op == "kill":
            self._do_kill(ev)
        elif op == "resize":
            self._do_resize(ev)
        elif op in ("sigstop", "sigcont"):
            self._do_signal(ev)
        else:
            self._bump("skipped_events")

    # -- submits + observations ----------------------------------------------
    def _do_submit(self, ev: Dict) -> None:
        cfg = config_from_payload(ev["cfg"])
        kw = {}
        if ev.get("tenant"):
            kw["tenant"] = ev["tenant"]
        if ev.get("deadline") is not None:
            # budget (seconds) -> absolute monotonic deadline, anchored
            # at dispatch so queueing (not schedule skew) consumes it
            kw["deadline"] = time.monotonic() + float(ev["deadline"])
        try:
            fut = self.target.submit(cfg, ev["batch"], ev["seq"], **kw)
        except QuotaExceeded as e:
            # typed rejection BEFORE submitted is counted: the server
            # refused the query at the door, so neither side counts it
            self._bump("quota_rejected")
            self.outcomes[ev["i"]] = {"i": ev["i"], "t": ev["t"],
                                      "tenant": ev["tenant"], "ok": False,
                                      "quota": True, "error": repr(e)}
            return
        except Exception as e:
            self._bump("submit_rejected")
            self.outcomes[ev["i"]] = {"i": ev["i"], "t": ev["t"],
                                      "tenant": ev["tenant"], "ok": False,
                                      "error": repr(e)}
            return
        self._bump("submitted")
        self._q.put((ev, cfg, fut))

    def _harvest(self) -> None:
        """Await futures in dispatch order; issue scheduled observations."""
        while True:
            item = self._q.get()
            if item is None:
                return
            ev, cfg, fut = item
            try:
                est = fut.result(self.result_timeout)
            except DeadlineExceeded as e:
                # a cleanly expired future is an *accounted* outcome, not
                # a failure: the SLO was missed, dead work was not served
                self._bump("expired")
                if getattr(e, "where", "") == "frontend":
                    self._bump("replay_expired")
                self.outcomes[ev["i"]] = {"i": ev["i"], "t": ev["t"],
                                          "tenant": ev["tenant"],
                                          "ok": False, "expired": True,
                                          "where": getattr(e, "where", ""),
                                          "error": repr(e)}
                continue
            except QuotaExceeded as e:
                # via-future quota rejection (the RPC transport relays
                # the server's sync refusal as a failed reply): the
                # server never accepted it, so undo the dispatch count
                self._bump("quota_rejected")
                self._bump("submitted", -1)
                self.outcomes[ev["i"]] = {"i": ev["i"], "t": ev["t"],
                                          "tenant": ev["tenant"],
                                          "ok": False, "quota": True,
                                          "error": repr(e)}
                continue
            except Exception as e:
                self._bump("failed")
                self.outcomes[ev["i"]] = {"i": ev["i"], "t": ev["t"],
                                          "tenant": ev["tenant"],
                                          "ok": False, "error": repr(e)}
                continue
            self._bump("resolved")
            if est.get("degraded"):
                self._bump("shed")
            self.outcomes[ev["i"]] = {
                "i": ev["i"], "t": ev["t"], "tenant": ev["tenant"],
                "ok": True, "cfg": ev["cfg"], "batch": ev["batch"],
                "seq": ev["seq"], "model": est.get("model"),
                "time_s": est.get("time_s"),
                "mem_bytes": est.get("memory_bytes"),
                "admitted": est.get("admitted"),
                "generation": est.get("generation"),
                "replica": est.get("replica"),
                "degraded": bool(est.get("degraded", False)),
            }
            obs = ev.get("observe")
            if not obs:
                continue
            time_s = float(est["time_s"]) * float(obs["time_factor"])
            mem_b = float(est["memory_bytes"]) * float(obs["mem_factor"])
            if time_s <= 0.0 or mem_b <= 0.0:
                # the server drops non-positive measurements; never let
                # one desync the expected-observations ledger
                self._bump("observe_failed")
                continue
            try:
                self.target.observe(
                    cfg, ev["batch"], ev["seq"], time_s, mem_b,
                    predicted_time_s=est["time_s"],
                    predicted_mem_bytes=est["memory_bytes"],
                    generation=est.get("generation"))
            except Exception:
                self._bump("observe_failed")
                continue
            self._bump("observes_issued")

    # -- faults --------------------------------------------------------------
    def _do_publish(self, ev: Dict) -> None:
        number = self._max_generation() + 1
        abacus = self._snapshot_abacus()
        gen = ModelGeneration(number=number, abacus=abacus,
                              source="scenario", created_at=time.time())
        expected = len(self._replicas())
        self.target.publish_generation(gen)
        self._bump("publishes")
        self._bump("expected_gen_swaps", expected)
        self.generations[number] = abacus
        # wait until every member adopted: the next event must observe a
        # fleet that is unambiguously serving generation `number`
        deadline = time.monotonic() + self.fault_timeout
        while time.monotonic() < deadline:
            try:
                if all(int(r.service.generation) >= number
                       for r in self._live_replicas()):
                    return
            except Exception:
                pass
            time.sleep(0.01)
        raise RuntimeError(
            f"generation {number} not adopted fleet-wide within "
            f"{self.fault_timeout}s")

    def _find_replica(self, name: str):
        for r in self._replicas():
            if getattr(r, "name", None) == name:
                return r
        return None

    def _do_kill(self, ev: Dict) -> None:
        if not self.is_cluster:
            self._bump("skipped_events")
            return
        name = ev["replica"]
        replica = self._find_replica(name)
        if replica is None:
            self._bump("skipped_events")
            return
        self._bump("kills")
        if getattr(replica, "proc", None) is not None:
            replica.kill()  # SIGKILL: the heartbeat verdict excludes it
            deadline = time.monotonic() + self.fault_timeout
            while name in self._member_names() \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            if name in self._member_names():
                raise RuntimeError(
                    f"killed replica {name!r} was not auto-excluded "
                    f"within {self.fault_timeout}s")
        else:
            # in-process: no process to SIGKILL — force the same end
            # state (exclusion reshard; the drain resolves queued work)
            self.target.exclude_replica(name)
        self._bump("expected_exclusions")

    def _do_resize(self, ev: Dict) -> None:
        if not self.is_cluster:
            self._bump("skipped_events")
            return
        self.target.resize(int(ev["n"]))
        self._bump("resizes")

    def _do_signal(self, ev: Dict) -> None:
        replica = self._find_replica(ev.get("replica"))
        proc = getattr(replica, "proc", None) if replica else None
        if proc is None:
            self._bump("skipped_events")
            return
        os.kill(proc.pid, signal.SIGSTOP if ev["op"] == "sigstop"
                else signal.SIGCONT)
        if ev["op"] == "sigstop":
            self._bump("sigstops")
