"""Collective bytes a device of reduced dry-run cells, port beside reference.

    PYTHONPATH=src python tools/collective_bytes.py

Each cell is reduced (bf16, batch 16, seq 64) on a (4, 4) world, as
``tests/_dryrun_cells.py`` builds it. The port's side is the
``collective_bytes`` of its ``dryrun_cell`` record, traced on a fake
16-rank world (``tests/_torch_dist.py::dryrun_cells``). The reference's is
``repro.analysis.roofline.analyze(compiled).collective_bytes`` of its
``_lower_cell`` compiled for 16 fake host devices, in a JAX child. Three
cells are traced or compiled at once. Prints a markdown table and one JSON
line of both sides' bytes.
"""

import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, os.path.join(ROOT, "tests"))

CELLS = [("qwen2-0.5b", "sp", "prefill"), ("jamba-v0.1-52b", "sp", "prefill"),
         ("mamba2-370m", "sp", "prefill"), ("moonshot-v1-16b-a3b", "sp", "prefill"),
         ("qwen2-0.5b", "dp", "train"), ("jamba-v0.1-52b", "sp", "decode")]
BATCH, SEQ = 16, 64

_REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import jax
from jax.sharding import Mesh
import repro.launch.dryrun as d
from repro.analysis import roofline as rl
from repro.configs import get_config, reduced_config
from repro.configs.base import ShapeConfig
from repro.distributed import sharding as shd

arch, scheme, kind, batch, seq = json.loads(sys.argv[1])
cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="bfloat16")
d.get_config = lambda a: cfg
d.SHAPES = {"train_4k": ShapeConfig("train_4k", seq, batch, kind)}
mesh = Mesh(np.array(jax.devices()[:16]).reshape(4, 4), ("data", "model"))
_, lowered = d._lower_cell(arch, "train_4k", mesh, shd.ShardingRules(), scheme=scheme)
print(json.dumps(rl.analyze(lowered.compile()).collective_bytes))
"""


def reference_bytes(cell) -> float:
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=16"}
    out = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps([*cell, BATCH, SEQ])],
                         env=env, capture_output=True, text=True, timeout=1800)
    if out.returncode:
        raise RuntimeError(out.stderr[-3000:])
    return float(out.stdout.splitlines()[-1])


def port_bytes(cell) -> float:
    from _torch_dist import run_world

    with tempfile.TemporaryDirectory() as tmp:
        rec, = run_world("dryrun_cells", 16, tmp, fake=True, cells=[list(cell)], batch=BATCH,
                         seq=SEQ, timeout=1800)
    if rec["status"] != "ok":
        raise RuntimeError(f"{cell}: {rec}")
    return float(rec["collective_bytes"])


def main():
    with ThreadPoolExecutor(3) as pool:
        ref = list(pool.map(reference_bytes, CELLS))
        port = list(pool.map(port_bytes, CELLS))
    print("| cell | port B | reference B | port / reference |")
    print("| --- | ---: | ---: | ---: |")
    for (arch, scheme, kind), p, r in zip(CELLS, port, ref):
        print(f"| {arch} \"{scheme}\" {kind} | {int(p):,} | {int(r):,} | {p / r:.4f} |")
    print(json.dumps({"cells": [dict(arch=a, scheme=s, kind=k, port=p, reference=r)
                                for (a, s, k), p, r in zip(CELLS, port, ref)]}))


if __name__ == "__main__":
    main()
