"""Drift-scenario zoo: deterministic workload replay for the serving fleet.

Every scale claim the serving stack makes — overload survival, refit
MRE recovery, reshard parity, kill-and-heal — is exercised through one
reusable, seeded scenario pipeline instead of bespoke bench loops:

  * :mod:`repro_torch.scenarios.workload` — declarative ``ScenarioSpec`` ->
    ``generate()`` -> ``Schedule``: an explicit, JSONL-serializable
    event schedule (bursty diurnal traffic, multi-tenant drift,
    mid-stream profile swaps, adversarial fingerprint churn, fault
    events). Same seed => byte-identical schedule across processes and
    ``PYTHONHASHSEED``s.
  * :mod:`repro_torch.scenarios.runner` — ``ScenarioRunner`` replays a
    schedule against an ``AbacusServer`` or ``ClusterFrontend``
    (in-process or RPC), collecting per-query ground truth.
  * :mod:`repro_torch.scenarios.oracles` — invariant checkers that
    cross-validate the run against the telemetry plane (counters,
    metrics snapshot, legacy ``stats()`` keys, calibration drift,
    estimate parity vs a fresh single-server replay).

A copy of ``repro.scenarios`` over the port's serving fleet
(``repro_torch.serve``); the port imports nothing of the reference.
"""

from repro_torch.scenarios.oracles import (OracleResult, check_all, failed,
                                           oracle_overload_accounting)
from repro_torch.scenarios.runner import ScenarioResult, ScenarioRunner
from repro_torch.scenarios.workload import (FaultSpec, ProfileSwap, ScenarioConfig,
                                            ScenarioSpec, Schedule, TenantSpec,
                                            TrafficSpec, config_from_payload,
                                            fit_abacus, fit_records, generate,
                                            scenario_trace, schedule_digest,
                                            schedule_digest_subprocess,
                                            tenant_overload_spec)

__all__ = [
    "FaultSpec",
    "OracleResult",
    "ProfileSwap",
    "ScenarioConfig",
    "ScenarioResult",
    "ScenarioRunner",
    "ScenarioSpec",
    "Schedule",
    "TenantSpec",
    "TrafficSpec",
    "check_all",
    "config_from_payload",
    "failed",
    "fit_abacus",
    "fit_records",
    "generate",
    "oracle_overload_accounting",
    "scenario_trace",
    "schedule_digest",
    "schedule_digest_subprocess",
    "tenant_overload_spec",
]
