"""Resumable dry-run sweep driver: every (arch x shape x mesh) cell.

Port of the reference's sweep. Runs each cell in a FRESH subprocess
(``python -m repro_torch.launch.dryrun``: each process holds one fake
process group of its mesh's size, and isolation also bounds trace-memory
growth), appends JSONL records, and skips cells already present — so the
sweep can be interrupted/resumed freely. Cells are ordered cheapest-first
to bank results early.

Usage: PYTHONPATH=src python -m repro_torch.launch.sweep --out artifacts/dryrun.jsonl \
    [--meshes single,multi] [--only-arch A]

Each record carries the cell's trace seconds (``lower_s``), its
matrix-product FLOPs a device (``dot_flops_per_device``) and the cell's
peak resident memory (``host_rss_gib``). Sweeps of different archs run side
by side as processes of their own, each with ``--only-arch`` and its own
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ARCH_ORDER = [
    "whisper-tiny", "qwen2-0.5b", "mamba2-370m", "chatglm3-6b",
    "phi4-mini-3.8b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b",
    "qwen2.5-32b", "arctic-480b", "llama-3.2-vision-90b",
]
SHAPE_ORDER = ["train_4k", "decode_32k", "prefill_32k", "long_500k"]

# Per-arch training scheme, the reference's: models below ~8B parameters
# train as pure 256-way DP with FSDP weights ("dp"); larger models keep
# tensor/expert parallelism with a sequence-parallel residual stream
# ("sp"). Serving cells always use "sp".
TRAIN_SCHEME = {
    "whisper-tiny": "dp", "qwen2-0.5b": "dp", "mamba2-370m": "dp",
    "chatglm3-6b": "dp", "phi4-mini-3.8b": "dp",
    "moonshot-v1-16b-a3b": "sp", "jamba-v0.1-52b": "sp",
    "qwen2.5-32b": "sp", "arctic-480b": "sp", "llama-3.2-vision-90b": "sp",
}


def scheme_for(arch: str, shape: str) -> str:
    return TRAIN_SCHEME.get(arch, "sp") if shape.startswith("train") else "sp"


def cells(meshes):
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    out = []
    for mp in meshes:
        for shape in SHAPE_ORDER:
            for arch in ARCH_ORDER:
                ok, why = shape_applicable(get_config(arch), SHAPES[shape])
                out.append((arch, shape, mp, ok, why))
    return out


def done_keys(path):
    keys = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in ("ok", "skipped"):
                    keys.add((r["arch"], r["shape"], r["multi_pod"]))
    return keys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/dryrun.jsonl")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--only-arch", default=None)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    meshes = [m == "multi" for m in args.meshes.split(",")]

    done = done_keys(args.out)
    todo = [c for c in cells(meshes)
            if (c[0], c[1], c[2]) not in done
            and (args.only_arch is None or c[0] == args.only_arch)]
    print(f"[sweep] {len(todo)} cells to run ({len(done)} already done)")
    for i, (arch, shape, mp, ok, why) in enumerate(todo):
        key = f"{arch} x {shape} x {'multi' if mp else 'single'}"
        if not ok:
            rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                   "status": "skipped", "reason": why}
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"[sweep] {i+1}/{len(todo)} SKIP {key}: {why[:80]}")
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", args.out,
               "--scheme", scheme_for(arch, shape)]
        if mp:
            cmd.append("--multi-pod")
        t0 = time.time()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=args.timeout,
                                  env={**os.environ, "PYTHONPATH": "src"})
            status = "ok" if proc.returncode == 0 else "fail"
            tail = (proc.stderr or proc.stdout or "").strip()[-400:]
        except subprocess.TimeoutExpired:
            status, tail = "timeout", ""
            rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                   "status": "TIMEOUT", "timeout_s": args.timeout}
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        dt = time.time() - t0
        print(f"[sweep] {i+1}/{len(todo)} {status} {key} ({dt:.0f}s)"
              + ("" if status == "ok" else f"\n  {tail}"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
