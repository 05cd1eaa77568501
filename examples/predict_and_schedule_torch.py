"""End-to-end scheduling (the paper's application, §4.3) on the
PyTorch port, profiling on the CUDA card (``--device cpu`` asks for the CPU).

Profiles a mixed pool of networks, fits DNNAbacus, predicts cost for 20
training jobs, and schedules them onto two machines with the genetic
algorithm — comparing against optimal and random placement. Saves the
fitted predictor for the launcher's admission control
(``python -m repro_torch.launch.train --predict --predictor-path
artifacts/torch/abacus``).

Online queries then go through the serving subsystem: a persistent
``TraceStore`` (so re-running this script warm-starts from prior
traces), the micro-batched ``AbacusServer`` gateway, and an
``AdmissionController`` placing two arrival waves incrementally.
Finished jobs report measured costs back (``report_completion``); once
enough feedback accrues the ``OnlineRefitter`` publishes a new model
generation, the server hot-swaps it between ticks, and the next wave's
windowed MRE (from ``server.stats()``) drops.

Everything it writes goes under ``artifacts/torch/`` (under
``artifacts/torch/cpu/`` for a CPU run, whose profiles are the host's:
``profile_zoo_on_host``'s wall-clock time and traced peak live bytes, never
fit beside the card's).

    PYTHONPATH=src python examples/predict_and_schedule_torch.py
"""

import sys

sys.path.insert(0, "src")

import argparse
import time

import numpy as np
import torch

from repro_torch.core.automl.models import (GradientBoostingRegressor,
                                            RandomForestRegressor, RidgeRegressor)
from repro_torch.core.predictor import DNNAbacus
from repro_torch.core.profiler import profile_zoo, profile_zoo_on_host
from repro_torch.core.scheduler import (Machine, jobs_from_estimates, schedule_ga,
                                        schedule_jobs)
from repro_torch.models import card_unless_asked
from repro_torch.serve import (AbacusServer, AdmissionController, ClusterFrontend,
                               FeedbackStore, OnlineRefitter, PredictionService,
                               Query, TraceStore)

GIB = 2**30
TIME_DRIFT, MEM_DRIFT = 3.0, 1.5  # synthetic fleet drift ("reality")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    device = card_unless_asked(ap.parse_args().device, "pass --device cpu")
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    out = "artifacts/torch" if device.type == "cuda" else "artifacts/torch/cpu"

    def profile(net, batch):
        if device.type == "cuda":
            return profile_zoo(net, batch=batch, steps=2, device=device)
        return profile_zoo_on_host(net, batch=batch, steps=2)

    nets = ["lenet5", "squeezenet", "nin", "mobilenet_v1", "shufflenet_v2"]
    print("== collecting profiles ==")
    records = []
    for net in nets:
        for batch in (8, 16, 32, 64):
            records.append(profile(net, batch))
            print(f"  {net} b={batch}: {records[-1].time_s*1e3:.0f} ms")

    fac = lambda seed: [RandomForestRegressor(n_trees=30, seed=seed),
                        GradientBoostingRegressor(n_stages=120, seed=seed),
                        RidgeRegressor()]
    abacus = DNNAbacus().fit(records, candidate_factory=fac)
    abacus.save(f"{out}/abacus")
    print(f"predictor saved to {out}/abacus.json")

    # all online queries go through the batched, trace-caching service,
    # backed by a persistent store: re-running this script warm-starts
    service = PredictionService(abacus, store=TraceStore(f"{out}/trace_store"))

    # 20 jobs with predicted cost — one design matrix, one ensemble pass
    rng = np.random.default_rng(0)
    chosen = [records[i] for i in rng.choice(len(records), 20)]
    t_pred, m_pred = service.predict_records(chosen)
    jobs = jobs_from_estimates([r.model_name for r in chosen], t_pred, m_pred,
                               time_scale=100, mem_pad=GIB // 2)
    machines = [Machine("system1", 11 * GIB), Machine("system2", 24 * GIB)]

    opt, _ = schedule_jobs(jobs, machines, plan="optimal")
    rand_mean, _ = schedule_jobs(jobs, machines, plan="random", trials=100)
    ga, assign, hist = schedule_ga(jobs, machines, generations=20,
                                   return_history=True)
    print(f"== makespans ==\n  optimal : {opt:9.1f} s\n"
          f"  random  : {rand_mean:9.1f} s (mean of 100)\n"
          f"  GA      : {ga:9.1f} s "
          f"({(1 - ga / rand_mean) * 100:.1f}% better than random)")
    print(f"  GA generations to best: {int(np.argmin(hist)) + 1}")
    print(f"  assignment: {assign}")

    # admission-control queries on LM configs now go through the async
    # micro-batched gateway: concurrent submissions coalesce into one
    # ensemble pass, cold traces run on the trace pool, and the backing
    # TraceStore makes the *next process* answer them with zero traces.
    from repro_torch.configs import get_config, reduced_config
    cfg = reduced_config(get_config("qwen2-0.5b"))
    queries = [Query(cfg, b, 32) for b in (2, 4)]
    # demo-specific store: artifacts/feedback_store is the shared path
    # dryrun --predict accumulates into, and must not be wiped here
    feedback = FeedbackStore(f"{out}/feedback_store_demo")
    feedback.clear()  # each run demonstrates one fresh feedback cycle
    refitter = OnlineRefitter(service, feedback, seed_records=records,
                              min_observations=4, feedback_repeat=8)
    with refitter, AbacusServer(service, feedback=feedback,
                                refitter=refitter) as server:
        t0 = time.perf_counter()
        server.predict_many(queries)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        ests = server.predict_many(queries)
        warm = time.perf_counter() - t0
        print("== admission control (AbacusServer gateway) ==")
        for e in ests:
            print(f"  {e['model']}: {e['time_s']*1e3:.1f} ms, "
                  f"{e['memory_bytes']/GIB:.2f} GiB, admitted={e['admitted']}")
        print(f"  cold {cold*1e3:.0f} ms -> warm {warm*1e3:.1f} ms "
              f"(server {server.server_info()})")

        # streaming admission: two waves placed incrementally against
        # rolling cluster state (committed busy time + reserved HBM)
        ctl = AdmissionController(server, machines, time_scale=100,
                                  mem_pad=GIB // 2, generations=10, seed=0)
        print("== streaming admission (AdmissionController) ==")
        truth = {}  # drifted reality per (batch, seq), fixed across waves
        for wave, bs in enumerate(((2, 4), (2, 2, 4))):
            wave_qs = [Query(cfg, b, 32) for b in bs]
            verdicts = ctl.admit(wave_qs)
            for v, q in zip(verdicts, wave_qs):
                where = v.machine if v.admitted else f"REJECTED ({v.reason})"
                print(f"  wave{wave} {v.job_id}: {where}")
                if not v.admitted:
                    continue
                # the job "runs"; its measured cost is the drifted reality
                mt, mm = truth.setdefault(
                    (q.batch, q.seq),
                    (v.time_s * TIME_DRIFT, v.mem_bytes * MEM_DRIFT))
                ctl.report_completion(v.job_id, time_s=mt, mem_bytes=mm)
        state = ctl.cluster_state()
        print(f"  cluster makespan {state['makespan_s']:.1f} s, "
              f"{state['resident_jobs']} resident jobs "
              "(all completions reported)")

        # the background refitter saw >= min_observations completions:
        # wait for the new generation to be published and hot-swapped
        print("== online refit (feedback -> new generation) ==")
        pre = server.stats()["calibration"]
        print(f"  pre-refit window: time_mre={pre['time_mre']:.3f} "
              f"drift={pre['time_drift']:+.3f}")
        deadline = time.time() + 60
        while service.generation == 0 and time.time() < deadline:
            time.sleep(0.05)
        if service.generation == 0:
            print(f"  no generation published within 60 s "
                  f"(refit state: {refitter.info()})")
        else:
            gen = refitter.generation
            print(f"  generation {gen.number} published "
                  f"(fit on {gen.n_train_records} records, "
                  f"{gen.n_feedback} observations, "
                  f"refit {refitter.last_refit_s*1e3:.0f} ms); "
                  f"service now at generation {service.generation}")

            # wave 3 runs under the refit generation, SAME reality
            wave3_qs = [Query(cfg, b, 32) for b in (2, 4)]
            for v, q in zip(ctl.admit(wave3_qs), wave3_qs):
                if v.admitted:
                    mt, mm = truth[(q.batch, q.seq)]
                    ctl.report_completion(v.job_id, time_s=mt, mem_bytes=mm)
            by_gen = server.stats()["calibration"]["by_generation"]
            mre0 = by_gen.get(0, {}).get("time_mre")
            mre1 = by_gen.get(service.generation, {}).get("time_mre")
            if mre0 is None or mre1 is None:
                print(f"  calibration by generation: {by_gen}")
            else:
                print(f"  windowed time-MRE: generation 0 = {mre0:.3f} "
                      f"-> generation {service.generation} = {mre1:.3f} "
                      f"({mre0 / max(mre1, 1e-12):.1f}x better)")

    # the same queries now go through the multi-host fabric: N sharded
    # gateway replicas behind a consistent-hash frontend, each owning a
    # fingerprint slice of the trace store. The refit generation from
    # above is broadcast fleet-wide (each replica applies it between
    # ticks), so every replica answers from the freshest predictor.
    print("== multi-host fabric (ClusterFrontend, 2 replicas) ==")
    with ClusterFrontend(abacus, n_replicas=2,
                         trace_root=f"{out}/cluster_trace_store") as fleet:
        if refitter.generation.number > 0:
            fleet.publish_generation(refitter.generation)
        for q in queries:
            fp, owner = fleet.route(q.cfg)
            print(f"  {q.cfg.name} b={q.batch} s={q.seq} -> {owner.name} "
                  f"(fingerprint {fp[:8]}...)")
        ests = fleet.predict_many(queries)
        for e in ests:
            print(f"  [{e['replica']}] {e['model']}: "
                  f"{e['time_s']*1e3:.1f} ms, {e['memory_bytes']/GIB:.2f} GiB "
                  f"(generation {e['generation']})")
        s = fleet.stats()
        print(f"  fleet: {s['fleet']['completed']} served across "
              f"{s['replicas']} replicas, generations={s['generations']}")


if __name__ == "__main__":
    main()
