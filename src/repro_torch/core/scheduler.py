"""Scheduling application (paper §4.3): GA job placement from predictions.

Assign N training jobs to M machines minimizing makespan, with predicted
peak memory enforced against each machine's HBM (jobs predicted to OOM on
a machine are infeasible there). Three plans, as in the paper:
optimal (exhaustive / DP), random (averaged over trials), and a genetic
algorithm over assignment strings (population 20, elitist selection,
single-point crossover) — the paper reports GA matching optimal in 20
generations at -20.9% vs random.

A copy of ``repro.core.scheduler`` (the port imports nothing of the reference).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Job:
    name: str
    time_s: float
    mem_bytes: float


@dataclasses.dataclass(frozen=True)
class Machine:
    name: str
    hbm_bytes: float
    speed: float = 1.0  # relative throughput


def jobs_from_estimates(names: Sequence[str], times: Sequence[float],
                        mems: Sequence[float], time_scale: float = 1.0,
                        mem_pad: float = 0.0) -> List[Job]:
    """Jobs from predicted (time, memory); scale step time to job length,
    pad memory for framework overhead (as in the paper's §4.3 setup)."""
    return [Job(n, float(t) * time_scale, float(m) + mem_pad)
            for n, t, m in zip(names, times, mems)]


def _base(base, n: int) -> np.ndarray:
    return np.zeros(n) if base is None else np.asarray(base, np.float64)


def makespan(assign: Sequence[int], jobs: Sequence[Job],
             machines: Sequence[Machine], base_time=None,
             reserved_mem=None) -> float:
    """Max per-machine total time; +inf if any job violates memory.

    ``base_time`` / ``reserved_mem`` (per-machine) carry load already
    committed by earlier placements — the incremental-admission case:
    new jobs are placed on top of a running cluster, not an empty one.
    Memory stays a per-job feasibility check (jobs on one machine run
    sequentially, as in the paper); ``reserved_mem`` shrinks the HBM
    that in-flight resident jobs have already claimed.
    """
    totals = _base(base_time, len(machines)).copy()
    reserved = _base(reserved_mem, len(machines))
    for a, j in zip(assign, jobs):
        m = machines[a]
        if j.mem_bytes + reserved[a] > m.hbm_bytes:
            return float("inf")
        totals[a] += j.time_s / m.speed
    return float(totals.max())


def schedule_random(jobs, machines, trials: int = 100, seed: int = 0,
                    base_time=None, reserved_mem=None):
    rng = np.random.default_rng(seed)
    spans = []
    reserved = _base(reserved_mem, len(machines))
    feasible = [[m for m, mc in enumerate(machines)
                 if j.mem_bytes + reserved[m] <= mc.hbm_bytes] for j in jobs]
    for _ in range(trials):
        a = [int(rng.choice(f)) for f in feasible]
        spans.append(makespan(a, jobs, machines, base_time, reserved_mem))
    return float(np.mean(spans)), spans


def schedule_optimal(jobs, machines, base_time=None, reserved_mem=None):
    """Exhaustive for M^N <= ~2M; otherwise multi-start local search."""
    n, m = len(jobs), len(machines)
    if m ** n <= 2_000_000:
        best, best_a = float("inf"), None
        for a in itertools.product(range(m), repeat=n):
            s = makespan(a, jobs, machines, base_time, reserved_mem)
            if s < best:
                best, best_a = s, a
        return best, list(best_a)
    # fallback: LPT + pairwise improvement
    order = np.argsort([-j.time_s for j in jobs])
    totals = _base(base_time, m).copy()
    reserved = _base(reserved_mem, m)
    a = [0] * n
    for i in order:
        ok = [k for k in range(m)
              if jobs[i].mem_bytes + reserved[k] <= machines[k].hbm_bytes]
        k = min(ok, key=lambda k: totals[k] + jobs[i].time_s / machines[k].speed)
        a[i] = k
        totals[k] += jobs[i].time_s / machines[k].speed
    return makespan(a, jobs, machines, base_time, reserved_mem), a


def schedule_ga(jobs, machines, pop_size: int = 20, generations: int = 20,
                mutation: float = 0.05, seed: int = 0,
                return_history: bool = False,
                base_time=None, reserved_mem=None):
    """The paper's GA: assignment strings, fitness = makespan."""
    rng = np.random.default_rng(seed)
    n, m = len(jobs), len(machines)
    pop = rng.integers(0, m, size=(pop_size, n))
    history = []

    def fitness(a):
        return makespan(a, jobs, machines, base_time, reserved_mem)

    best_a, best_s = None, float("inf")
    for g in range(generations):
        scores = np.array([fitness(a) for a in pop])
        order = np.argsort(scores)
        # `or best_a is None` seeds the elite even when generation 0 is
        # entirely infeasible (all-inf fitness) — memory-tight incremental
        # waves hit this; without it `best_a.copy()` below crashes.
        if scores[order[0]] < best_s or best_a is None:
            best_s = float(scores[order[0]])
            best_a = pop[order[0]].copy()
        history.append(best_s)
        parents = pop[order[: max(2, pop_size // 2)]]
        children = [best_a.copy()]  # elitism
        while len(children) < pop_size:
            i, j = rng.integers(0, len(parents), size=2)
            # n == 1: no interior cut point exists; child = parents[i]
            cut = int(rng.integers(1, n)) if n > 1 else 1
            child = np.concatenate([parents[i][:cut], parents[j][cut:]])
            flip = rng.uniform(size=n) < mutation
            child[flip] = rng.integers(0, m, size=int(flip.sum()))
            children.append(child)
        pop = np.stack(children)
    if return_history:
        return best_s, list(best_a), history
    return best_s, list(best_a)


PLANS = {"optimal": schedule_optimal, "random": schedule_random,
         "ga": schedule_ga}


def schedule_jobs(jobs: Sequence[Job], machines: Sequence[Machine],
                  plan: str = "ga", **kw):
    """Dispatch to one of the paper's three placement plans by name."""
    if plan not in PLANS:
        raise ValueError(f"unknown plan {plan!r}; choose from {sorted(PLANS)}")
    return PLANS[plan](jobs, machines, **kw)
