"""Run one cell of the benchmark of the PyTorch/CUDA port on the card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names its
configuration, traffic mix and run kind, each a file under ``perfbench/``
(``lib/cell.py``). A run draws its weights and inputs from ``--seed``, sets
up and warms the program (``setup_s`` runs from the start of this process
to the first timed request or step), measures for ``--seconds``, then
frees the program's state and judges its outputs against the plain
reference (``perfbench/reference/``). With ``--trace 1`` it also traces a
short stretch after the window and reports the per-layer metrics
(``perfbench/metrics/``) in place of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), the set-up's parts, and last ``checks``: each number
compared with its limit, also printed as the last lines of standard error.
Without a card, or with fewer than the cell asks for, it prints no result
and exits with 2; if the JAX package or JAX itself is loaded once the window
has closed, it names them and exits with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FOREIGN = ("jax", "jaxlib", "flax", "repro")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def foreign_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FOREIGN)


def card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def caches_in_checkout():
    """Every build or kernel cache lives at a fixed path inside the checkout
    (the port's own libraries go to ``build/`` there already)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)


def build_kernels():
    """Load (and on a checkout's first run build) the port's kernels."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan

    libs = (flash_attention.LIBRARY, ssd_scan.LIBRARY, rmsnorm.LIBRARY)
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.load) for lib in libs]:
            fut.result()


def judged(numbers, limits):
    """(correct, checks): every limit's number present, finite and within."""
    checks, ok = {}, True
    for name, lim in limits.items():
        value = numbers.get(name, float("nan"))
        checks[name] = {"value": value, "limit": lim["limit"]}
        ok = ok and math.isfinite(value) and value <= lim["limit"]
    return ok, checks


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    caches_in_checkout()
    from perfbench.lib.cell import Cell

    cell = Cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from perfbench.lib import port, trace
    from perfbench.lib.context import Context

    split = {}
    port.import_port()
    run = cell.kind.Run(Context(cell, args.seed, torch.device("cuda", 0)))
    split["import_s"] = time.perf_counter() - T_START
    t = time.perf_counter()
    build_kernels()
    split["kernels_s"] = time.perf_counter() - t
    run.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    split.update(run.setup_split)

    win = run.window(args.seconds)
    summary = run.traced(trace.profile) if args.trace else None
    peak = torch.cuda.max_memory_allocated()
    run.release()
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference is float32
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    numbers, _ = run.judge()
    check_s = time.perf_counter() - t

    foreign = foreign_modules()
    if foreign:
        print(f"run.py: loaded in this process: {', '.join(foreign)}", file=sys.stderr)
        return 3
    correct, checks = judged(numbers, cell.limits)
    correct = correct and win["failed"] == 0 and win["attempted"] > 0

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(peak)}
    metrics = {}
    if args.trace:
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
        reader_ctx = SimpleNamespace(kind=cell.traffic["kind"], cfg=cell.config,
                                     model_flops=cell.model_flops, window=win, trace=summary)
        for entry, reader in cell.per_layer():
            value = reader.read(reader_ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        values = dict(win["end_to_end"], setup_s=setup_s)
        for entry in cell.end_to_end():
            metrics[entry["name"]] = {"value": values[entry["name"]], "unit": entry["unit"]}
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        result["breakdown"] = summary.breakdown()
    result["card"] = card_line()
    result["setup_split"] = dict(split, setup_s=setup_s, window_s=win["seconds"],
                                 check_s=check_s)
    result["checks"] = checks
    print(f"run.py: {args.workload} seed {args.seed}: {result['card']}; setup "
          + ", ".join(f"{k} {v:.3f}" for k, v in result["setup_split"].items()), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
