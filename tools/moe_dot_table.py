"""Per-device matrix products of a reduced dry-run train cell, grouped by the
einsum they come from, for the port and for the JAX reference.

    PYTHONPATH=src python tools/moe_dot_table.py --arch moonshot-v1-16b-a3b \\
        --scheme dp [--batch 16 --seq 64] [--json out.json]

Both sides trace the reduced config (bf16) at (batch, seq) with the arch's
``TRAIN_ACCUM`` microbatches on a (4, 4) ``("data", "model")`` mesh, as
``tests/test_torch_dryrun_cells_dots.py`` does:

- the port: one rank's step traced by ``launch.dryrun._lower_cell`` in a
  fake process group of 16 ranks, in this process; each ``mm``/``bmm``
  counted as ``analysis.hlo`` counts it (2 x result x contracted). A
  product is backward where its stack trace passes through
  ``autograd.grad``; its einsum is read from its operands' dims (the
  experts' d_ff and 2 d_ff, the capacity, the expert count, the vocab);
- the reference: a child process (``XLA_FLAGS`` with 16 host devices,
  ``JAX_PLATFORMS=cpu``) compiles ``repro.launch.dryrun._lower_cell`` and
  lists each ``dot`` of the compiled HLO with the product of the trip
  counts of the loops around it, its FLOPs counted as
  ``repro.analysis.hlo`` counts them. The einsum and the direction come
  from the dot's ``op_name`` (``transpose(jvp`` is backward); a dot that
  lost its ``op_name`` to XLA's rewrites takes those of a dot of the
  partitioned module (dumped after ``spmd-partitioning``) with the same
  FLOPs and operand sizes.

Prints one table: FLOPs per group (router, dispatch, wi, wo, combine,
unembed, rest; forward and backward) on each side, and the totals. This
file imports no JAX: the reference runs in the child only.
"""

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

EINSUMS = {"gsd,de->gse": "router", "gsec,gsd->gecd": "dispatch",
           "gecd,ednf->gecnf": "wi", "gecf,efd->gecd": "wo",
           "gecd,gsec->gsd": "combine", "...d,dv->...v": "unembed"}
GROUPS = ("router", "dispatch", "wi", "wo", "combine", "unembed", "rest")

_REFERENCE = r"""
import collections, dataclasses, glob, json, os, re, sys
import numpy as np
import jax
from jax.sharding import Mesh
import repro.launch.dryrun as d
from repro.analysis import hlo
from repro.configs import get_config, reduced_config
from repro.configs.base import ShapeConfig
from repro.distributed import sharding as shd

arch, scheme, batch, seq, dump = sys.argv[1:6]
cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="bfloat16")
d.get_config = lambda a: cfg
d.SHAPES = {"train_4k": ShapeConfig("train_4k", int(seq), int(batch), "train")}
mesh = Mesh(np.array(jax.devices()[:16]).reshape(4, 4), ("data", "model"))
_, lowered = d._lower_cell(arch, "train_4k", mesh, shd.ShardingRules(), scheme=scheme)
EINSUMS = json.loads(sys.argv[6])


def dots(text, loops):
    m = hlo.HloCostModel(text)
    out = []

    def walk(comp, mult):
        env = m._shape_env(comp)
        for ins in m.computations.get(comp, []):
            if ins.op == "dot":
                name = re.search(r'op_name="([^"]*)"', ins.rest)
                sizes = sorted(hlo._shape_info(s)[0] for s in
                               (ins.shape, env.get(ins.operands[0], ""),
                                env.get(ins.operands[1], "")))
                out.append({"mult": mult, "flops": m._dot_flops(ins, env), "sizes": sizes,
                            "op_name": name.group(1) if name else ""})
            elif ins.op == "while":
                body = re.search(r"body=%?([\w.\-]+)", ins.rest).group(1)
                walk(body, mult * (m._trip_count(ins.rest) if loops else 1))
            elif ins.op in ("fusion", "call", "custom-call", "async-start", "conditional"):
                for n in m._called(ins.rest):
                    walk(n, mult)

    walk(m.entry, 1)
    return out


def label(op_name):
    group = next((g for e, g in EINSUMS.items() if e in op_name), "rest")
    return group, "bwd" if "transpose(jvp" in op_name else "fwd"


final = dots(lowered.compile().as_text(), loops=True)
parted, = glob.glob(os.path.join(dump, "*after_spmd-partitioning*.txt"))
pool = collections.defaultdict(list)
for p in dots(open(parted).read(), loops=False):
    if p["op_name"]:
        pool[(p["flops"], tuple(p["sizes"]))].append(p["op_name"])
rows = []
for p in final:
    name = p["op_name"]
    if not name:  # rewritten by XLA: a partitioned dot of the same FLOPs and sizes
        names = pool.get((p["flops"], tuple(p["sizes"])))
        name = names.pop(0) if names else ""
    group, way = label(name)
    rows.append({"group": group, "way": way, "flops": p["mult"] * p["flops"]})
print(json.dumps(rows))
"""


def reference_rows(arch, scheme, batch, seq):
    with tempfile.TemporaryDirectory() as dump:
        env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=16 "
                            f"--xla_dump_to={dump} --xla_dump_hlo_pass_re=spmd-partitioning"}
        out = subprocess.run([sys.executable, "-c", _REFERENCE, arch, scheme, str(batch),
                              str(seq), dump, json.dumps(EINSUMS)],
                             env=env, capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_label(cfg, cap, shapes):
    """The einsum of a port product from its operands' dims: the reference's
    names, read from the config's expert d_ff (``wo``), 2 d_ff (``wi``), the
    capacity (a dim a multiple of it: dispatch and combine), the expert
    count (the router) and the vocab (the unembedding)."""
    dims = {d for s in shapes for d in s[-2:]}
    moe = any(d % cap == 0 for d in dims)
    if moe and 2 * cfg.d_ff in dims:
        return "wi"
    if moe and cfg.d_ff in dims:
        return "wo"
    if cfg.num_experts in dims and cfg.d_model in dims and len(shapes[0]) == 3 \
            and shapes[0][0] == 1:
        return "router"
    if moe:
        return "dispatch/combine"
    if cfg.vocab_size in dims:
        return "unembed"
    return "rest"


def port_rows(arch, scheme, batch, seq):
    import torch
    import torch.distributed as dist
    import torch.fx.experimental.proxy_tensor as proxy
    from torch.testing._internal.distributed.fake_pg import FakeStore

    import repro_torch.launch.dryrun as dr
    from repro_torch.analysis import hlo
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import _mesh
    from repro_torch.models import moe

    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="bfloat16")
    dr.get_config = lambda a: cfg
    dr.SHAPES = {"train": ShapeConfig("train", seq, batch, "train")}
    make_fx = proxy.make_fx
    proxy.make_fx = lambda f, *a, **k: make_fx(f, *a, record_stack_traces=True, **k)
    try:
        _, graph = dr._lower_cell(arch, "train", _mesh("cpu", (4, 4), ("data", "model")),
                                  shd.ShardingRules(), scheme=scheme)
    finally:
        proxy.make_fx = make_fx
        dist.destroy_process_group()
    cap = moe.capacity(cfg, cfg.moe_group_size)
    rows = []
    for node in graph.graph.nodes:
        if node.op != "call_function" or hlo.coll_kind(node.target) is not None:
            continue
        outs = list(hlo.tensors(node.meta.get("val")))
        flops = hlo._dot_flops(node.target, node, outs[0]) if outs else None
        if not flops:
            continue
        shapes = [tuple(next(hlo.tensors(a.meta["val"])).shape) for a in node.args[:2]]
        way = "bwd" if "autograd.grad" in (node.meta.get("stack_trace") or "") else "fwd"
        group = _port_label(cfg, cap, shapes + [tuple(outs[0].shape)])
        if group == "dispatch/combine":  # the one-hot products, told apart by what they contract
            k = shapes[0][-1]
            if way == "fwd":
                group = "combine" if k % cap == 0 else "dispatch"
            else:
                group = "dispatch" if k % cap == 0 else "combine"
        rows.append({"group": group, "way": way, "flops": flops})
    return rows


def table(port, ref):
    def sums(rows):
        out = collections.Counter()
        for r in rows:
            out[(r["group"], r["way"])] += r["flops"]
        return out

    p, r = sums(port), sums(ref)
    lines = ["| group | way | port FLOPs | reference FLOPs | port - reference |",
             "| --- | --- | ---: | ---: | ---: |"]
    for g in GROUPS:
        for w in ("fwd", "bwd"):
            if (g, w) in p or (g, w) in r:
                lines.append(f"| {g} | {w} | {int(p[(g, w)]):,} | {int(r[(g, w)]):,} | "
                             f"{int(p[(g, w)] - r[(g, w)]):+,} |")
    tp, tr = sum(p.values()), sum(r.values())
    lines.append(f"| total | | {int(tp):,} | {int(tr):,} | {int(tp - tr):+,} |")
    return "\n".join(lines), p, r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="moonshot-v1-16b-a3b")
    ap.add_argument("--scheme", default="dp")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--json", default=None, help="also write both sides' groups here")
    args = ap.parse_args(argv)
    ref = reference_rows(args.arch, args.scheme, args.batch, args.seq)
    port = port_rows(args.arch, args.scheme, args.batch, args.seq)
    text, p, r = table(port, ref)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"port": {"/".join(k): v for k, v in p.items()},
                       "reference": {"/".join(k): v for k, v in r.items()}}, f, indent=1)


if __name__ == "__main__":
    main()
