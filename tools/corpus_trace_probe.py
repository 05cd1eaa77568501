"""Trace every point of ``chip_smoke.py``'s phase-11 corpus both ways and
count the records that differ.

    PYTHONPATH=src python tools/corpus_trace_probe.py [--device cuda] \\
        [--out build/corpus_trace_probe.json]

One way is the in-process trace ``profile_zoo`` / ``profile_lm`` make
(``profiler.trace_step`` on fake tensors of ``--device`` in this process);
the other is phase 11's, ``profiler.TraceAhead`` in ``chip_smoke.trace_workers()``
spawned worker processes, started first so that both run at once. Each
point's record is built from each trace (``time_s`` and ``mem_bytes`` left
0: nothing is timed) and compared field for field. Prints one JSON line:
the points, the differing records (expected 0) with the first few named,
the workers, the serial traces' seconds and the workers' wall and trace
seconds; ``--out`` also gets it. Needs no kernel build; on the card, every
process fakes CUDA tensors and launches nothing.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import profiler as tprof
    from repro_torch.core import randomgen as trand

    points = chip_smoke.corpus_points(tprof, trand, get_config, reduced_config)
    t0 = time.perf_counter()
    ahead = tprof.TraceAhead(points, args.device, chip_smoke.trace_workers())
    serial = []
    for p in points:
        t1 = time.perf_counter()
        step, step_args, _ = tprof.point_step(p)
        serial.append({**tprof.trace_step(step, step_args, args.device),
                       "trace_s": time.perf_counter() - t1})
    serial_s = time.perf_counter() - t0
    traced = ahead.results()
    workers_wall = time.perf_counter() - t0

    def record(p, t):
        return tprof.point_step(p)[2](flops=t["flops"], nsm_edges=t["nsm_edges"],
                                      time_s=0.0, mem_bytes=0.0)
    differ = [f"{p.kind} {getattr(p.model, 'name', p.model)} {p.batch} {p.size}"
              for p, a, b in zip(points, serial, traced) if record(p, a) != record(p, b)]
    out = {"points": len(points), "differing_records": len(differ), "differ": differ[:5],
           "device": args.device, "workers": ahead.workers, "cores": os.cpu_count(),
           "serial_trace_s": sum(t["trace_s"] for t in serial), "serial_wall_s": serial_s,
           "workers_trace_s": sum(t["trace_s"] for t in traced),
           "workers_wall_s": workers_wall}
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if not differ else 1


if __name__ == "__main__":
    sys.exit(main())
