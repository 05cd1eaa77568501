"""The readings a cell's limits are set from, on the card, in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 4
        [--control-seeds 1,2,3] [--faults half,update] [--fault-seeds 1,2,3]

For each of ``--seeds`` it runs the cell as ``run.py`` does, with a short
window, and prints the program's numbers (the lower readings); for each of
``--control-seeds`` the same numbers of the reference computed in float8 in
the program's place (the control); for each fault of ``--faults`` and
each of ``--fault-seeds`` the numbers of the program with that fault
planted (``lib/faults.py``). One JSON line a reading. The benchmark's own
runs never run any of this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text):
    return [int(s) for s in text.split(",") if s] if text else []


def reading(cell, seed, seconds, control=False, fault=None):
    import torch

    from perfbench.lib.context import Context

    run = cell.kind.Run(Context(cell, seed, torch.device("cuda", 0), fault))
    t0 = time.perf_counter()
    run.setup()
    win = run.window(seconds)
    run.release()
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    prog, ctl = run.judge(control=control)
    out = {"seed": seed, "fault": fault, "program": prog, "attempted": win["attempted"],
           "run_s": t1 - t0, "check_s": time.perf_counter() - t1}
    if control:
        out["control"] = ctl
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    from perfbench.lib import port
    from perfbench.lib.cell import Cell
    from perfbench.run import build_kernels, caches_in_checkout

    caches_in_checkout()
    port.import_port()
    build_kernels()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload)
    control = set(_seeds(args.control_seeds))
    for seed in _seeds(args.seeds) + sorted(control - set(_seeds(args.seeds))):
        print(json.dumps(reading(cell, seed, args.seconds, control=seed in control)), flush=True)
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in _seeds(args.fault_seeds):
            print(json.dumps(reading(cell, seed, args.seconds, fault=fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
