"""Seeded workload generators: declarative specs -> explicit schedules.

A ``ScenarioSpec`` describes a workload (tenants, traffic shape, drift,
churn, faults); :func:`generate` expands it into a ``Schedule`` — a flat
list of timestamped events, each one JSON-serializable, so a scenario
is *data*: it can be saved to JSONL, diffed, shipped to another host,
and replayed bit-for-bit.

Determinism contract (the property the whole zoo hangs on):

  * same seed => byte-identical ``to_jsonl()`` output, across processes
    AND across ``PYTHONHASHSEED``s. All randomness flows through ONE
    ``np.random.default_rng(seed)``; nothing touches the builtin
    ``hash()`` (salted per process), wall clock, or dict iteration
    order of unsorted inputs (every dump is ``sort_keys=True``).
  * timestamps are **virtual seconds**. The runner scales them by a
    real-time factor at replay (``time_scale``), so the same schedule
    drives a leisurely soak or an as-fast-as-possible smoke run.

Event ops (one JSON object per line; ``i`` is the creation index and
the tiebreak for equal timestamps):

  ``submit``   {t, op, i, tenant, cfg, batch, seq, observe}
               ``observe`` is null (estimate only) or
               {time_factor, mem_factor}: after the estimate resolves,
               report measured cost = estimate x factor (per-tenant
               drift; per-observation calibration drift is then exactly
               ``1/factor - 1``, which the oracles bound).
  ``publish``  {t, op, i} — mint + broadcast the next ModelGeneration.
  ``kill``     {t, op, i, replica} — SIGKILL an RPC replica / exclude
               an in-process one (both end in an exclusion reshard).
  ``sigstop``/``sigcont`` {t, op, i, replica} — wedge/unwedge an RPC
               replica process (skipped + counted in-process).
  ``resize``   {t, op, i, n} — live-reshard the fleet to n replicas.

Adversarial fingerprint churn: ``churn_rate`` adds submits whose config
payload carries a unique ``nonce`` field — ``config_fingerprint`` hashes
every attribute, so each one is a near-miss config (identical features,
fresh fingerprint) that defeats the trace cache and forces a cold trace.

A copy of ``repro.scenarios.workload`` (the port imports nothing of the
reference); its schedules, and so its digests, are the reference's byte for
byte. The records of ``scenario_trace`` and ``fit_records`` carry
``PLATFORM_TORCH_CUDA``: they stand for the port's traces, and the port's
trace store serves no other platform. The digest child process imports
``repro_torch`` and needs no JAX.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.features import PLATFORM_TORCH_CUDA, ProfileRecord

SCHEDULE_VERSION = 1


# -- deterministic configs + tracer ------------------------------------------


class ScenarioConfig:
    """Duck-typed model config materialized from a schedule payload.

    Attributes are set in sorted-key order purely for readability;
    ``config_fingerprint`` canonicalizes over sorted ``vars()`` anyway,
    so the fingerprint is a pure function of the payload contents.
    """

    def __init__(self, **attrs):
        for k in sorted(attrs):
            setattr(self, k, attrs[k])

    def as_dict(self) -> Dict:
        return dict(vars(self))

    def __repr__(self) -> str:
        return f"ScenarioConfig({vars(self)!r})"


def config_from_payload(payload: Dict) -> ScenarioConfig:
    """Materialize the duck-typed config a ``submit`` event carries."""
    return ScenarioConfig(**payload)


def scenario_trace(cfg, batch: int, seq: int) -> ProfileRecord:
    """Deterministic dependency-free tracer for scenario configs.

    Features follow the same generative law as :func:`fit_records`
    (``dots`` parameterizes cost), so a predictor fit on those records
    is in-distribution for every scenario query. A ``nonce`` attribute
    (fingerprint churn) deliberately does NOT enter the features: the
    churned config is a *near miss* — fresh fingerprint, identical
    record — exactly the trace-cache-defeating adversary.
    """
    dots = float(getattr(cfg, "dots", 8.0))
    flops = batch * seq * dots * 1e6
    edges = {("dot", "add"): dots, ("add", "tanh"): dots,
             ("tanh", "dot"): max(1.0, dots - 1)}
    return ProfileRecord(
        model_name=cfg.name, family=getattr(cfg, "family", "dense"),
        batch_size=batch, input_size=seq, channels=64, learning_rate=1e-3,
        epoch=1, optimizer="adamw", layers=int(getattr(cfg, "num_layers", 4)),
        flops=flops, params=int(dots * 1e5), nsm_edges=edges,
        platform=PLATFORM_TORCH_CUDA)


def fit_records(n: int = 80, seed: int = 0) -> List[ProfileRecord]:
    """Synthetic training corpus matching :func:`scenario_trace` features."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        batch = int(rng.choice([2, 4, 8, 16]))
        seq = int(rng.choice([32, 64, 128]))
        dots = float(rng.integers(4, 60))
        flops = batch * seq * dots * 1e6
        edges = {("dot", "add"): dots, ("add", "tanh"): dots,
                 ("tanh", "dot"): dots - 1}
        recs.append(ProfileRecord(
            model_name=f"m{i}", family="dense", batch_size=batch,
            input_size=seq, channels=64, learning_rate=1e-3, epoch=1,
            optimizer="adamw", layers=int(rng.integers(2, 16)), flops=flops,
            params=int(dots * 1e5), nsm_edges=edges,
            time_s=flops / 5e10, mem_bytes=1e6 * dots + 4.0 * batch * seq,
            platform=PLATFORM_TORCH_CUDA))
    return recs


def fit_abacus(seed: int = 0):
    """RandomForest-backed predictor over :func:`fit_records`.

    Per-row exact tree predictions make estimates independent of
    micro-batch composition, so scenario replays compare byte-for-byte
    against a fresh single-server replay (the parity oracle) no matter
    how ticks coalesce.
    """
    from repro_torch.core.automl.models import RandomForestRegressor
    from repro_torch.core.predictor import DNNAbacus
    fac = lambda s: [RandomForestRegressor(n_trees=10, seed=s)]
    return DNNAbacus(seed=seed).fit(fit_records(seed=seed),
                                    candidate_factory=fac)


# -- declarative spec ---------------------------------------------------------


@dataclasses.dataclass
class TenantSpec:
    """One tenant's config pool, traffic share, and drift law."""

    name: str
    weight: float = 1.0            # relative share of the traffic mix
    n_configs: int = 4             # distinct configs in this tenant's pool
    dots: Tuple[float, float] = (8.0, 48.0)   # cost-knob range of the pool
    batches: Tuple[int, ...] = (2, 4, 8)
    seqs: Tuple[int, ...] = (32, 64)
    time_drift: float = 1.0        # measured time = estimate x factor
    mem_drift: float = 1.0         # measured mem  = estimate x factor
    observe_fraction: float = 0.5  # fraction of submits that report back
    # SLO budget (virtual seconds) stamped on every submit of this
    # tenant; None = no deadline. The runner converts it to an absolute
    # monotonic deadline at submit time, so replay speed (time_scale)
    # does not distort it. Emitted into the event only when set — specs
    # without deadlines keep their historical schedule bytes.
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class TrafficSpec:
    """Bursty diurnal arrival process (rate in submits / virtual second).

    ``rate(t) = base_rate * max(0, 1 + burst_amplitude *
    sin(2 pi t / burst_period_s))`` — amplitude 0 is flat load,
    amplitude 1 swings between 0 and 2x over one virtual "day".
    """

    base_rate: float = 40.0
    burst_amplitude: float = 0.0
    burst_period_s: float = 24.0


@dataclasses.dataclass
class ProfileSwap:
    """Mid-stream hardware-profile swap: from virtual time ``t`` on,
    ``tenant``'s measured costs follow NEW drift factors (new kernels,
    a migrated host class)."""

    t: float
    tenant: str
    time_drift: float
    mem_drift: float


@dataclasses.dataclass
class FaultSpec:
    """One fault event: ``kill``/``sigstop``/``sigcont`` (``target`` =
    replica name), ``resize`` (``n`` = new fleet size), or ``publish``."""

    t: float
    kind: str
    target: Optional[str] = None
    n: Optional[int] = None


@dataclasses.dataclass
class ScenarioSpec:
    """Declarative scenario: everything :func:`generate` needs."""

    name: str = "scenario"
    seed: int = 0
    duration_s: float = 8.0
    tenants: List[TenantSpec] = dataclasses.field(
        default_factory=lambda: [TenantSpec(name="t0")])
    traffic: TrafficSpec = dataclasses.field(default_factory=TrafficSpec)
    churn_rate: float = 0.0        # near-miss submits / virtual second
    swaps: List[ProfileSwap] = dataclasses.field(default_factory=list)
    faults: List[FaultSpec] = dataclasses.field(default_factory=list)
    drift_tolerance: float = 0.05  # oracle slack around the drift bounds

    def to_dict(self) -> Dict:
        # round-trip through JSON so tuples land as lists: the dict a
        # loaded schedule carries compares equal to a fresh one
        return json.loads(_dumps(dataclasses.asdict(self)))

    @classmethod
    def from_dict(cls, d: Dict) -> "ScenarioSpec":
        d = dict(d)
        d["tenants"] = [TenantSpec(**dict(t, dots=tuple(t["dots"]),
                                          batches=tuple(t["batches"]),
                                          seqs=tuple(t["seqs"])))
                        for t in d.get("tenants", [])]
        d["traffic"] = TrafficSpec(**d.get("traffic", {}))
        d["swaps"] = [ProfileSwap(**s) for s in d.get("swaps", [])]
        d["faults"] = [FaultSpec(**f) for f in d.get("faults", [])]
        return cls(**d)


def tenant_payloads(tenant: TenantSpec) -> List[Dict]:
    """The tenant's deterministic config pool (no RNG: a pure function
    of the spec, so benches can enumerate a keyset without generating a
    full schedule)."""
    lo, hi = float(tenant.dots[0]), float(tenant.dots[1])
    n = max(1, int(tenant.n_configs))
    out = []
    for k in range(n):
        frac = k / (n - 1) if n > 1 else 0.0
        out.append({
            "name": f"{tenant.name}-c{k:03d}",
            "family": "dense",
            "num_layers": 2 + k % 14,
            "d_model": 64 + 16 * (k % 8),
            "dots": round(lo + (hi - lo) * frac, 6),
        })
    return out


def tenant_overload_spec(smoke: bool = True, *,
                         base_rate: Optional[float] = None,
                         duration_s: Optional[float] = None) -> ScenarioSpec:
    """The zoo's overload scenario: sustained many-times-capacity load.

    Two tenants past a deliberately tight fleet (the harness pairs this
    spec with a throttled predictor + small ``max_queue`` /
    ``shed_watermark``): "bulk" floods the queue, "slo" rides a tight
    per-query deadline. Exercises every overload path at once — quota
    rejections (bulk exhausts its weighted share), sheds (watermark
    crossings answered from the roofline floor), and deadline expiries
    (slo queries EDF-expired under the backlog) — and the overload
    oracle asserts the shed/expired/quota accounting is *exact* against
    the runner's ground truth.
    """
    if base_rate is None:
        base_rate = 400.0 if smoke else 1200.0
    if duration_s is None:
        duration_s = 4.0 if smoke else 10.0
    return ScenarioSpec(
        name="tenant_overload", seed=20250811,
        duration_s=float(duration_s),
        tenants=[
            TenantSpec(name="bulk", weight=4.0, n_configs=4,
                       dots=(8.0, 40.0), batches=(2, 4), seqs=(32,),
                       observe_fraction=0.2),
            TenantSpec(name="slo", weight=1.0, n_configs=2,
                       dots=(12.0, 24.0), batches=(2,), seqs=(32,),
                       observe_fraction=0.2, deadline_s=0.05),
        ],
        traffic=TrafficSpec(base_rate=float(base_rate),
                            burst_amplitude=0.5, burst_period_s=2.0),
    )


# -- schedule -----------------------------------------------------------------


def _dumps(obj) -> str:
    # canonical form: sorted keys, no whitespace — the byte-stability
    # contract rides on this one call
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class Schedule:
    """An ordered event list + meta header, serializable to JSONL.

    Line 1 is the meta header (``{"scenario_meta": {...}}``: name, seed,
    event counts, the oracle drift bounds, and the full spec dict);
    every following line is one event. ``to_jsonl`` output is the
    byte-stable identity of the scenario.
    """

    def __init__(self, meta: Dict, events: List[Dict]):
        self.meta = meta
        self.events = events

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Schedule) and self.meta == other.meta
                and self.events == other.events)

    def to_jsonl(self) -> str:
        lines = [_dumps({"scenario_meta": self.meta})]
        lines.extend(_dumps(ev) for ev in self.events)
        return "\n".join(lines) + "\n"

    @classmethod
    def from_jsonl(cls, text: str) -> "Schedule":
        meta: Dict = {}
        events: List[Dict] = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if "scenario_meta" in d:
                meta = d["scenario_meta"]
            else:
                events.append(d)
        return cls(meta, events)

    def save(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_jsonl())
        return path

    @classmethod
    def load(cls, path: str) -> "Schedule":
        with open(path, encoding="utf-8") as f:
            return cls.from_jsonl(f.read())

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events:
            out[ev["op"]] = out.get(ev["op"], 0) + 1
        return out


def _drift_at(spec: ScenarioSpec, tenant: str, t: float) -> Tuple[float, float]:
    """(time_factor, mem_factor) for ``tenant`` at virtual time ``t`` —
    the tenant's base drift, overridden by the latest profile swap."""
    base = next(tn for tn in spec.tenants if tn.name == tenant)
    ft, fm = float(base.time_drift), float(base.mem_drift)
    for swap in sorted(spec.swaps, key=lambda s: s.t):
        if swap.tenant == tenant and swap.t <= t:
            ft, fm = float(swap.time_drift), float(swap.mem_drift)
    return ft, fm


def generate(spec: ScenarioSpec) -> Schedule:
    """Expand a spec into its explicit event schedule (deterministic)."""
    rng = np.random.default_rng(int(spec.seed))
    tenants = list(spec.tenants)
    if not tenants:
        raise ValueError("a scenario needs at least one tenant")
    weights = np.array([max(0.0, float(t.weight)) for t in tenants])
    if weights.sum() <= 0:
        raise ValueError("tenant weights must sum to a positive value")
    weights = weights / weights.sum()
    pools = {t.name: tenant_payloads(t) for t in tenants}

    tr = spec.traffic
    events: List[Dict] = []
    i = 0
    churn_id = 0
    n_windows = int(math.ceil(float(spec.duration_s)))
    for w in range(n_windows):
        t_mid = w + 0.5
        rate = tr.base_rate * max(
            0.0, 1.0 + tr.burst_amplitude
            * math.sin(2.0 * math.pi * t_mid / tr.burst_period_s))
        n = int(rng.poisson(rate)) if rate > 0 else 0
        offsets = np.sort(rng.random(n)) if n else []
        for off in offsets:
            t = round(w + float(off), 6)
            tn = tenants[int(rng.choice(len(tenants), p=weights))]
            payload = pools[tn.name][int(rng.integers(len(pools[tn.name])))]
            batch = int(rng.choice(list(tn.batches)))
            seq = int(rng.choice(list(tn.seqs)))
            observe = None
            if rng.random() < tn.observe_fraction:
                ft, fm = _drift_at(spec, tn.name, t)
                observe = {"time_factor": ft, "mem_factor": fm}
            ev = {"i": i, "t": t, "op": "submit",
                  "tenant": tn.name, "cfg": dict(payload),
                  "batch": batch, "seq": seq, "observe": observe}
            if tn.deadline_s is not None:
                ev["deadline"] = round(float(tn.deadline_s), 6)
            events.append(ev)
            i += 1
        # adversarial fingerprint churn: near-miss configs, never observed
        m = int(rng.poisson(spec.churn_rate)) if spec.churn_rate > 0 else 0
        for _ in range(m):
            t = round(w + float(rng.random()), 6)
            tn = tenants[int(rng.choice(len(tenants), p=weights))]
            payload = dict(
                pools[tn.name][int(rng.integers(len(pools[tn.name])))])
            payload["name"] = f"{payload['name']}-churn{churn_id:05d}"
            payload["nonce"] = churn_id
            churn_id += 1
            ev = {"i": i, "t": t, "op": "submit",
                  "tenant": tn.name, "cfg": payload,
                  "batch": int(rng.choice(list(tn.batches))),
                  "seq": int(rng.choice(list(tn.seqs))),
                  "observe": None}
            if tn.deadline_s is not None:
                ev["deadline"] = round(float(tn.deadline_s), 6)
            events.append(ev)
            i += 1
    for fault in spec.faults:
        ev = {"i": i, "t": round(float(fault.t), 6), "op": str(fault.kind)}
        if fault.kind in ("kill", "sigstop", "sigcont"):
            ev["replica"] = str(fault.target)
        elif fault.kind == "resize":
            ev["n"] = int(fault.n)  # type: ignore[arg-type]
        elif fault.kind != "publish":
            raise ValueError(f"unknown fault kind {fault.kind!r}")
        events.append(ev)
        i += 1
    events.sort(key=lambda e: (e["t"], e["i"]))

    # oracle bounds: every per-observation calibration drift is exactly
    # 1/factor - 1, so the windowed mean must land inside [min, max]
    tf = sorted({ev["observe"]["time_factor"] for ev in events
                 if ev["op"] == "submit" and ev["observe"]})
    mf = sorted({ev["observe"]["mem_factor"] for ev in events
                 if ev["op"] == "submit" and ev["observe"]})
    drift = {
        "time": [1.0 / tf[-1] - 1.0, 1.0 / tf[0] - 1.0] if tf else None,
        "mem": [1.0 / mf[-1] - 1.0, 1.0 / mf[0] - 1.0] if mf else None,
        "tolerance": float(spec.drift_tolerance),
    }
    meta = {
        "name": spec.name,
        "seed": int(spec.seed),
        "version": SCHEDULE_VERSION,
        "n_events": len(events),
        "counts": Schedule(
            {}, events).counts(),
        "drift": drift,
        "spec": spec.to_dict(),
    }
    return Schedule(meta, events)


# -- determinism probes -------------------------------------------------------


def schedule_digest(spec: ScenarioSpec) -> str:
    """SHA-256 of the generated schedule's JSONL bytes."""
    return hashlib.sha256(generate(spec).to_jsonl().encode()).hexdigest()


_DIGEST_PROG = """\
import json, sys
from repro_torch.scenarios.workload import ScenarioSpec, schedule_digest
spec = ScenarioSpec.from_dict(json.loads(sys.stdin.read()))
print(schedule_digest(spec))
"""


def schedule_digest_subprocess(spec: ScenarioSpec,
                               hash_seed: int,
                               timeout: float = 120.0) -> str:
    """The schedule digest computed in a FRESH interpreter under an
    explicit ``PYTHONHASHSEED`` — the cross-process half of the
    byte-identity contract (tests/benches compare several seeds)."""
    import repro_torch
    src = os.path.dirname(list(repro_torch.__path__)[0])
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = str(int(hash_seed))
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    out = subprocess.run(
        [sys.executable, "-c", _DIGEST_PROG],
        input=json.dumps(spec.to_dict()), capture_output=True, text=True,
        env=env, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"digest subprocess failed: {out.stderr}")
    return out.stdout.strip()
