"""Invariant oracles: cross-validate a replay against the telemetry plane.

Each oracle takes the :class:`~repro_torch.scenarios.runner.ScenarioResult`
(which carries the runner's independently-counted ground truth *and* the
target's post-run ``stats()`` / ``metrics_snapshot()``) and returns an
:class:`OracleResult`. The point is mutual corroboration: the runner
never reads a server counter while replaying, the servers never see the
runner's ledger — so agreement means both are right, and a mutation of
either side (an undercounted metric, a dropped future) is caught.

Counter accounting across membership churn: replicas excluded or removed
mid-run take their counters with them, so ``ClusterFrontend`` keeps a
``retired`` ledger (``stats()["retired"]`` / ``fleet_retired_*_total``)
of everything a leaver had contributed at departure. All-time truth is
``fleet + retired``, which is what the exact oracles compare.

``observations`` is the one counter checked with ``>=`` instead of
``==`` when kills/resizes occurred: a drain-and-migrate can redeliver an
observe to the new owner after the old owner already counted it (benign
at-least-once delivery), so exactness only holds on a churn-free run.

A copy of ``repro.scenarios.oracles`` (the port imports nothing of the reference).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.scenarios.runner import ScenarioResult
from repro_torch.scenarios.workload import config_from_payload, scenario_trace
from repro_torch.serve.server import ServerStats

#: legacy ``stats()`` surfaces consumers already scrape — presence is
#: itself an invariant (PR 7 promised new telemetry adds keys, never
#: renames these)
CLUSTER_STATS_KEYS = ("replicas", "fleet", "reshard", "generations",
                      "calibration", "per_replica", "stale_replicas")
RESHARD_KEYS = ("reshards", "keys_moved", "units_moved", "keys_skipped",
                "keys_replayed", "cutover_ticks", "hedges",
                "hedge_failures", "retries", "exclusions")


@dataclasses.dataclass
class OracleResult:
    name: str
    ok: bool
    detail: str = ""

    def __bool__(self) -> bool:
        return self.ok


def failed(results: List[OracleResult]) -> List[OracleResult]:
    """The subset of oracle results that did not hold."""
    return [r for r in results if not r.ok]


def _counter_total(result: ScenarioResult, name: str) -> int:
    """All-time fleet counter: live members + the retired ledger."""
    if result.is_cluster:
        live = int(result.stats_after["fleet"].get(name, 0) or 0)
        retired = int(result.stats_after.get("retired", {})
                      .get(name, 0) or 0)
        return live + retired
    return int(result.stats_after.get(name, 0) or 0)


def _metric_total(result: ScenarioResult, name: str) -> int:
    """All-time metric counter: merged snapshot + the retired series."""
    value = int(result.metrics_after.get(f"server_{name}_total", {})
                .get("value", 0) or 0)
    value += int(result.metrics_after.get(f"fleet_retired_{name}_total", {})
                 .get("value", 0) or 0)
    return value


# -- the oracles --------------------------------------------------------------


def oracle_all_resolved(result: ScenarioResult) -> OracleResult:
    """Every submitted future reached a *clean* terminal state.

    Served (including shed-degraded) or expired with a structured
    ``DeadlineExceeded`` both count; what must never happen is an
    untyped failure, an untyped rejection, or a future that simply
    never resolves. Quota rejections happen *before* ``submitted`` is
    counted, so they don't enter this identity.
    """
    g = result.ground
    ok = (g["failed"] == 0 and g["submit_rejected"] == 0
          and g["resolved"] + g["expired"] == g["submitted"]
          and g["submitted"] > 0)
    errors = [o.get("error") for o in result.outcomes.values()
              if not o.get("ok") and not o.get("expired")
              and not o.get("quota")]
    return OracleResult(
        "all_resolved", ok,
        f"submitted={g['submitted']} resolved={g['resolved']} "
        f"expired={g['expired']} failed={g['failed']} "
        f"rejected={g['submit_rejected']}"
        + (f" first_error={errors[0]}" if errors else ""))


def oracle_counters(result: ScenarioResult) -> OracleResult:
    """``stats()`` counters equal the runner's ground truth exactly."""
    g = result.ground
    churn_free = g["kills"] == 0 and g["resizes"] == 0
    probs: List[str] = []

    def expect(name: str, got: int, want: int, exact: bool = True) -> None:
        bad = got != want if exact else got < want
        if bad:
            probs.append(f"{name}: got {got}, want "
                         f"{'==' if exact else '>='} {want}")

    # frontend replay expiries never reached a replica (the parked
    # query was expired at the cutover instead of being replayed), so
    # they appear in the runner's submitted count but not the servers'.
    accepted = g["submitted"] - g["replay_expired"]
    expect("submitted", _counter_total(result, "submitted"), accepted)
    expect("completed+failed",
           _counter_total(result, "completed")
           + _counter_total(result, "failed"), accepted)
    expect("gen_swaps", _counter_total(result, "gen_swaps"),
           g["expected_gen_swaps"])
    expect("observations", _counter_total(result, "observations"),
           g["observes_issued"], exact=churn_free)
    if result.is_cluster:
        reshard = result.stats_after["reshard"]
        expect("exclusions", int(reshard.get("exclusions", 0)),
               g["expected_exclusions"])
        if not result.supports_hedge:
            expect("hedges", int(reshard.get("hedges", 0)), 0)
    return OracleResult("counters", not probs, "; ".join(probs) or "exact")


def oracle_metrics_parity(result: ScenarioResult) -> OracleResult:
    """``metrics_snapshot()`` series equal the same ground truth — the
    metrics plane and the stats plane cannot drift apart."""
    g = result.ground
    probs: List[str] = []

    def expect(name: str, got: int, want: int) -> None:
        if got != want:
            probs.append(f"{name}: got {got}, want {want}")

    expect("server_submitted_total", _metric_total(result, "submitted"),
           g["submitted"] - g["replay_expired"])
    expect("server_gen_swaps_total", _metric_total(result, "gen_swaps"),
           g["expected_gen_swaps"])
    if result.is_cluster:
        expect("fleet_exclusions_total",
               int(result.metrics_after.get("fleet_exclusions_total", {})
                   .get("value", 0) or 0), g["expected_exclusions"])
        if not result.supports_hedge:
            expect("fleet_hedges_total",
                   int(result.metrics_after.get("fleet_hedges_total", {})
                       .get("value", 0) or 0), 0)
    return OracleResult("metrics_parity", not probs,
                        "; ".join(probs) or "exact")


def oracle_legacy_stats(result: ScenarioResult) -> OracleResult:
    """The pre-telemetry ``stats()`` surface is still fully present."""
    stats = result.stats_after
    missing: List[str] = []
    if result.is_cluster:
        missing += [k for k in CLUSTER_STATS_KEYS if k not in stats]
        fleet = stats.get("fleet", {})
        missing += [f"fleet.{c}" for c in ServerStats.COUNTERS
                    if c not in fleet]
        reshard = stats.get("reshard", {})
        missing += [f"reshard.{k}" for k in RESHARD_KEYS
                    if k not in reshard]
    else:
        missing += [c for c in ServerStats.COUNTERS if c not in stats]
        if "calibration" not in stats:
            missing.append("calibration")
    return OracleResult("legacy_stats", not missing,
                        ("missing: " + ", ".join(missing)) if missing
                        else "all keys present")


def oracle_calibration(result: ScenarioResult) -> OracleResult:
    """Windowed calibration drift sits inside the schedule's bounds.

    Every observation reports measured = estimate x factor, so its drift
    is exactly ``1/factor - 1``; the rolling window's mean must land in
    ``[min, max]`` of the per-factor drifts (+- tolerance).
    """
    bounds = result.schedule.meta.get("drift", {})
    if result.ground["observes_issued"] == 0:
        return OracleResult("calibration", True, "no observations scheduled")
    cal = result.stats_after.get("calibration", {})
    if not cal.get("count"):
        return OracleResult("calibration", False,
                            "observations issued but window is empty")
    tol = float(bounds.get("tolerance", 0.05))
    probs: List[str] = []
    for axis, key in (("time", "time_drift"), ("mem", "mem_drift")):
        span = bounds.get(axis)
        if span is None:
            continue
        got = cal.get(key)
        if got is None or not (span[0] - tol <= got <= span[1] + tol):
            probs.append(f"{key}={got} outside "
                         f"[{span[0]:.4f}, {span[1]:.4f}] +- {tol}")
    return OracleResult("calibration", not probs,
                        "; ".join(probs) or
                        f"drift in bounds over {cal['count']} observations")


def oracle_estimate_parity(result: ScenarioResult) -> OracleResult:
    """Fleet answers == a fresh single-service replay of the same queries.

    For each generation the fleet served from, rebuild a bare
    ``PredictionService`` around that generation's abacus and re-predict
    every (cfg, batch, seq) the fleet answered under it. RandomForest
    predictions are per-row exact, so micro-batching, routing, hedging
    and resharding must not change a single estimate.
    """
    from repro_torch.serve.prediction_service import PredictionService
    probs: List[str] = []
    checked = 0
    by_gen: Dict[int, Dict] = {}
    for o in result.resolved_outcomes():
        if o.get("degraded"):
            # shed answers come from the analytical roofline floor by
            # design — parity against the learned predictor is the one
            # property they intentionally give up
            continue
        gen = o.get("generation")
        key = (o["cfg"]["name"], o["batch"], o["seq"])
        by_gen.setdefault(gen, {})[key] = o
    for gen, queries in sorted(by_gen.items(), key=lambda e: (e[0] is None,
                                                              e[0] or 0)):
        abacus = result.generations.get(gen)
        if abacus is None:
            probs.append(f"generation {gen} served but never snapshotted")
            continue
        svc = PredictionService(abacus, tracer=scenario_trace)
        for o in queries.values():
            est = svc.predict_one(config_from_payload(o["cfg"]),
                                  o["batch"], o["seq"])
            checked += 1
            if (round(est["time_s"], 12) != round(o["time_s"], 12)
                    or round(est["memory_bytes"], 6)
                    != round(o["mem_bytes"], 6)
                    or est["model"] != o["model"]):
                probs.append(
                    f"gen={gen} {o['cfg']['name']}x{o['batch']}x{o['seq']}: "
                    f"fleet=({o['time_s']}, {o['mem_bytes']}) "
                    f"fresh=({est['time_s']}, {est['memory_bytes']})")
    return OracleResult("estimate_parity", not probs,
                        "; ".join(probs[:3]) or
                        f"{checked} unique (gen, query) estimates match")


def oracle_overload_accounting(result: ScenarioResult) -> OracleResult:
    """Shed / expired / quota accounting is *exact*, on both planes.

    The runner's ground truth (degraded estimates seen, typed
    ``DeadlineExceeded`` / ``QuotaExceeded`` outcomes) must equal the
    ``stats()["overload"]`` surface AND the metric series
    (``server_*_total`` + the retired ledger; ``fleet_replay_expired_
    total`` for frontend expiries that never reached a replica).
    Trivially true on scenarios that never overload — every side is 0.
    """
    g = result.ground
    probs: List[str] = []

    def expect(name: str, got: int, want: int) -> None:
        if got != want:
            probs.append(f"{name}: got {got}, want {want}")

    ov = result.stats_after.get("overload")
    if result.is_cluster:
        ov = ov if isinstance(ov, dict) else {}
        fleet = ov.get("fleet", {}) or {}
        retired = ov.get("retired", {}) or {}
        frontend = ov.get("frontend", {}) or {}

        def total(name: str) -> int:
            return (int(fleet.get(name, 0) or 0)
                    + int(retired.get(name, 0) or 0))

        expect("stats.shed", total("shed"), g["shed"])
        expect("stats.expired", total("expired"),
               g["expired"] - g["replay_expired"])
        expect("stats.quota_rejected", total("quota_rejected"),
               g["quota_rejected"])
        expect("stats.replay_expired",
               int(frontend.get("replay_expired", 0) or 0),
               g["replay_expired"])
        expect("fleet_replay_expired_total",
               int(result.metrics_after.get("fleet_replay_expired_total", {})
                   .get("value", 0) or 0), g["replay_expired"])
    else:
        ov = ov if isinstance(ov, dict) else {}
        expect("stats.shed", int(ov.get("shed", 0) or 0), g["shed"])
        expect("stats.expired", int(ov.get("expired", 0) or 0), g["expired"])
        expect("stats.quota_rejected",
               int(ov.get("quota_rejected", 0) or 0), g["quota_rejected"])
    expect("server_shed_total", _metric_total(result, "shed"), g["shed"])
    expect("server_expired_total", _metric_total(result, "expired"),
           g["expired"] - g["replay_expired"]
           if result.is_cluster else g["expired"])
    expect("server_quota_rejected_total",
           _metric_total(result, "quota_rejected"), g["quota_rejected"])
    return OracleResult("overload_accounting", not probs,
                        "; ".join(probs) or
                        f"shed={g['shed']} expired={g['expired']} "
                        f"quota_rejected={g['quota_rejected']} "
                        f"replay_expired={g['replay_expired']} (exact)")


ORACLES = (oracle_all_resolved, oracle_counters, oracle_metrics_parity,
           oracle_legacy_stats, oracle_calibration, oracle_estimate_parity,
           oracle_overload_accounting)


def check_all(result: ScenarioResult,
              raise_on_fail: bool = False) -> List[OracleResult]:
    """Run every oracle; optionally raise on the first violation."""
    out = [oracle(result) for oracle in ORACLES]
    if raise_on_fail:
        bad = failed(out)
        if bad:
            raise AssertionError("; ".join(f"{r.name}: {r.detail}"
                                           for r in bad))
    return out
