"""Per-device matrix products of a dry-run cell, grouped by the einsum
they come from, for the port and for the JAX reference.

    PYTHONPATH=src python tools/dot_table.py --arch moonshot-v1-16b-a3b \\
        [--kind train|prefill|decode] [--scheme dp] [--batch 16 --seq 64] \\
        [--port-only | --reference-only] [--json out.json]
    PYTHONPATH=src python tools/dot_table.py --arch qwen2-0.5b \\
        --shape prefill_32k [--multi-pod] [--layers 1] [...]

With ``--shape`` the cell is the full-size one the sweep traces
(``launch.sweep``): the config at full width (cut to ``--layers`` where
given, as ``dataclasses.replace(cfg, num_layers=...)``), the shape's batch
and sequence, the production mesh of 256 ranks, 512 with ``--multi-pod``,
and ``sweep.scheme_for``'s scheme; both sides also give the cell's live
bytes a device (``argument_gib``, ``temp_gib``, ``peak_hbm_gib``: the
reference's ``memory_analysis``, the port's ``analysis.hlo.live_bytes``).
The reference lowers a full cell in seconds (its layers are one scanned
body); the port traces each layer, so at full depth it takes the sweep's
minutes and memory (``--port-only`` or ``--reference-only`` runs one side).

Without ``--shape`` both sides trace the reduced config (bf16) at (batch,
seq) on a (4, 4)
``("data", "model")`` mesh, as ``tests/test_torch_dryrun_cells_dots.py``
does: a train cell (the default) with the arch's ``TRAIN_ACCUM``
microbatches, under "dp" unless ``--scheme`` says otherwise; a prefill or
decode cell (a batch of one token against a ``seq`` cache) under "sp", as
``launch.sweep.scheme_for`` runs every serve cell. The groups: the MoE layer's
router, dispatch, ``wi``, ``wo`` and combine; self-attention's scores and
context (``attn``, the encoder's and a decode step's grouped ones too) and
cross-attention's (``cross``);
the SSD scan's products (``ssd``); the Mamba2 block's projections
(``ssm_proj``: z, x, B, C, dt and out); the unembedding; and the rest
(attention's projections and the MLPs).

- the port: one rank's step traced by ``launch.dryrun._lower_cell`` in a
  fake process group of 16 ranks, in this process; each ``mm``/``bmm``
  counted as ``analysis.hlo`` counts it (2 x result x contracted). A
  product is backward where its stack trace passes through
  ``autograd.grad``. The MoE products are told apart by their operands'
  dims (the experts' d_ff and 2 d_ff, the capacity at the cell's group
  size, the expert count); a
  forward product by the functions on its stack (``dot_attention`` under
  ``apply_cross_attn`` or not, ``ssd_chunked_ref``, ``apply_ssm`` without
  it, ``unembed``); a backward product takes the group of the forward
  products that read one of its operands (a view of it: a product's
  gradients read its operands, transposed), or where that is not one
  group, of those it shares its dims with (a product's gradients multiply
  the same three dims over the same batch, unless one is laid out anew);
  a backward product left with two groups raises.
- the reference: a child process (``XLA_FLAGS`` with 16 host devices, 512
  at full size,
  ``JAX_PLATFORMS=cpu``) compiles ``repro.launch.dryrun._lower_cell`` and
  lists each ``dot`` of the compiled HLO with the product of the trip
  counts of the loops around it, its FLOPs counted as
  ``repro.analysis.hlo`` counts them. The einsum and the direction come
  from the dot's ``op_name`` (``transpose(jvp`` is backward); a dot that
  lost its ``op_name`` to XLA's rewrites takes those of a dot of the
  partitioned module (dumped after ``spmd-partitioning``) with the same
  FLOPs and operand sizes. In a config with cross-attention layers, self-
  and cross-attention share their einsums: a self-attention product's two
  smaller tensors are alike (S x hd twice, beside S x S), a
  cross-attention product's are not (the memory's length is not the
  sequence's; under "sp" a self-attention product whose query is split
  over the sequence looks the same); a decode step's self-attention has
  einsums of its own. No name on the reference's dots marks the
  Mamba2 block's projections, so they count in its "rest".

Prints one table: FLOPs per group (forward and backward) on each side, and
the totals; then the port's collectives a device by kind. ``--port-only``
skips the reference. This file imports no JAX: the reference runs in the
child only. ``products(cfg, graph)`` is the port half, for a traced graph
recorded with ``stack_traces()``.
"""

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import re
import resource
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

EINSUMS = {"gsd,de->gse": "router", "gsec,gsd->gecd": "dispatch",
           "gecd,ednf->gecnf": "wi", "gecf,efd->gecd": "wo",
           "gecd,gsec->gsd": "combine", "bqhd,bshd->bhqs": "attn",
           "bhqs,bshd->bqhd": "attn", "bctn,bcsn->bcts": "ssd",
           "bcts,bctsh,bcshp->bcthp": "ssd", "bcsh,bcsn,bcshp->bchnp": "ssd",
           "bctn,bchnp->bcthp": "ssd", "...d,dv->...v": "unembed",
           "bqkgd,bskd->bkgqs": "attn", "bkgqs,bskd->bqkgd": "attn"}
DECODE_EINSUMS = ("bqkgd,bskd->bkgqs", "bkgqs,bskd->bqkgd")  # self-attention only
KINDS = ("train", "prefill", "decode")
GROUPS = ("router", "dispatch", "wi", "wo", "combine", "attn", "cross", "ssd", "ssm_proj",
          "unembed", "rest")

_REFERENCE = r"""
import collections, dataclasses, glob, json, os, re, sys
import numpy as np
import jax
from jax.sharding import Mesh
import repro.launch.dryrun as d
from repro.analysis import hlo
from repro.analysis import roofline as rl
from repro.configs import get_config, reduced_config
from repro.configs.base import ShapeConfig
from repro.distributed import sharding as shd

cell, dump = json.loads(sys.argv[1]), sys.argv[2]
EINSUMS, DECODE_EINSUMS = json.loads(sys.argv[3])
arch, scheme = cell["arch"], cell["scheme"]
if cell["shape"]:  # full size: the sweep's cell on the production mesh
    from repro.launch.mesh import make_production_mesh
    cfg = get_config(arch)
    shape = cell["shape"]
    mesh = make_production_mesh(multi_pod=cell["multi_pod"])
else:
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="bfloat16")
    shape = "train_4k"
    d.SHAPES = {shape: ShapeConfig(shape, cell["seq"], cell["batch"], cell["kind"])}
    mesh = Mesh(np.array(jax.devices()[:16]).reshape(4, 4), ("data", "model"))
if cell["layers"]:
    cfg = dataclasses.replace(cfg, num_layers=cell["layers"])
d.get_config = lambda a: cfg
_, lowered = d._lower_cell(arch, shape, mesh, shd.ShardingRules(), scheme=scheme)


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


CROSS = any(mixer in ("cross", "attn_cross") for mixer, _ in cfg.pattern())


def label(op_name, sizes):
    group = next((g for e, g in EINSUMS.items() if e in op_name), "rest")
    if group == "attn" and CROSS and sizes[0] != sizes[1] \
            and not any(e in op_name for e in DECODE_EINSUMS):
        group = "cross"
    return group, "bwd" if "transpose(jvp" in op_name else "fwd"


compiled = lowered.compile()
final = dots(compiled.as_text(), loops=True)
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
    group, way = label(name, p["sizes"])
    rows.append({"group": group, "way": way, "flops": p["mult"] * p["flops"]})
live = rl.analyze(compiled).summary()
print(json.dumps({"rows": rows, "live": {k: live[k] for k in
                                         ("argument_gib", "temp_gib", "peak_hbm_gib")}}))
"""


LIVE = ("argument_gib", "temp_gib", "peak_hbm_gib")


def _cell(arch, scheme, batch=16, seq=64, kind="train", shape=None, multi_pod=False,
          layers=None):
    return {"arch": arch, "scheme": scheme, "batch": batch, "seq": seq, "kind": kind,
            "shape": shape, "multi_pod": multi_pod, "layers": layers}


def reference_cell(cell):
    """The reference's dots of ``cell`` (``_cell``), grouped as rows, and
    its live bytes a device: ``{"rows", "live"}``."""
    devices = 512 if cell["shape"] else 16
    with tempfile.TemporaryDirectory() as dump:
        env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices} "
                            f"--xla_dump_to={dump} --xla_dump_hlo_pass_re=spmd-partitioning"}
        out = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(cell), dump,
                              json.dumps([EINSUMS, DECODE_EINSUMS])],
                             env=env, capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def _moe_label(cfg, cap, shapes):
    """The MoE einsum of a port product from its operands' dims, or None:
    the experts' d_ff (``wo``), 2 d_ff (``wi``), the capacity (a dim a
    multiple of it: dispatch and combine) and the expert count (the
    router)."""
    if not cfg.num_experts:
        return None
    dims = {d for s in shapes for d in s[-2:]}
    if any(d % cap == 0 for d in dims):
        return "wi" if 2 * cfg.d_ff in dims else "wo" if cfg.d_ff in dims else "dispatch/combine"
    if cfg.num_experts in dims and cfg.d_model in dims and len(shapes[0]) == 3 \
            and shapes[0][0] == 1:
        return "router"
    return None


_FRAME = re.compile(r", in (\w+)$", re.M)


def _stack_label(stack):
    """The group of a forward product from the functions on its stack."""
    funcs = set(_FRAME.findall(stack))
    if "dot_attention" in funcs:
        return "cross" if funcs & {"apply_cross_attn", "decode_cross_attn"} else "attn"
    if "decode_self_attn" in funcs and not funcs & {"_project_q", "_project_kv", "_out_proj"}:
        return "attn"  # a decode step's grouped scores and context
    if "ssd_chunked_ref" in funcs:
        return "ssd"
    if "apply_ssm" in funcs:
        return "ssm_proj"
    if "unembed" in funcs:
        return "unembed"
    return "rest"


def _signature(shapes):
    """A product's batch and its three dims (a gradient of the product
    multiplies the same ones)."""
    a, b = shapes[:2]
    return tuple(a[:-2]), tuple(sorted((a[-2], a[-1], b[-1])))


@contextlib.contextmanager
def stack_traces():
    """``make_fx`` records each node's whole stack trace inside the scope
    (the port half reads its groups from the functions on it; by default
    the tracer keeps only the frames of ``forward`` methods)."""
    import torch.fx.experimental.proxy_tensor as proxy
    from torch.fx.proxy import TracerBase

    make_fx, keep = proxy.make_fx, TracerBase._filter_traceback_frames
    proxy.make_fx = lambda f, *a, **k: make_fx(f, *a, record_stack_traces=True, **k)
    TracerBase._filter_traceback_frames = lambda self, summary: summary
    try:
        yield
    finally:
        proxy.make_fx, TracerBase._filter_traceback_frames = make_fx, keep


def group_tokens(arch, kind, batch, seq):
    """The tokens that one MoE group is taken from in a cell: a decode
    step's batch, a prefill's batch x seq, a train microbatch's rows x seq."""
    from repro_torch.launch.dryrun import TRAIN_ACCUM

    if kind == "decode":
        return batch
    if kind == "prefill":
        return batch * seq
    return batch // TRAIN_ACCUM.get(arch, 1) * seq


def products(cfg, graph, tokens=None):
    """Each matrix product of one rank's traced step (recorded under
    ``stack_traces()``): ``{"group", "way", "flops", "sig"}``, ``sig`` its
    batch dims and its three dims, sorted. ``tokens`` are those a MoE group
    is taken from (``group_tokens``; default a whole group): the capacity
    that tells the MoE products apart is taken at the group's size."""
    from repro_torch.analysis import hlo
    from repro_torch.models import moe

    gs = min(cfg.moe_group_size, tokens or cfg.moe_group_size)
    cap = moe.capacity(cfg, gs) if cfg.num_experts else None
    rows, fwd, by_source = [], collections.defaultdict(set), collections.defaultdict(set)
    for node in graph.graph.nodes:
        if node.op != "call_function" or hlo.coll_kind(node.target) is not None:
            continue
        outs = list(hlo.tensors(node.meta.get("val")))
        flops = hlo._dot_flops(node.target, node, outs[0]) if outs else None
        if not flops:
            continue
        operands = node.args[1:3] if "add" in str(node.target) else node.args[:2]  # addmm
        shapes = [tuple(next(hlo.tensors(a.meta["val"])).shape) for a in operands]
        sources = {_source(a) for a in operands}
        stack = node.meta.get("stack_trace") or ""
        way = "bwd" if "autograd.grad" in stack else "fwd"
        # a forward product under attention, the SSD scan, the Mamba2 block
        # or the unembedding is that group whatever its dims (at a batch of
        # one token every dim is a multiple of the capacity)
        on_stack = _stack_label(stack) if way == "fwd" else None
        group = on_stack if on_stack not in (None, "rest") else \
            _moe_label(cfg, cap, shapes + [tuple(outs[0].shape)])
        if group == "dispatch/combine":  # the one-hot products, told apart by what they contract
            k = shapes[0][-1]
            if way == "fwd":
                group = "combine" if k % cap == 0 else "dispatch"
            else:
                group = "dispatch" if k % cap == 0 else "combine"
        elif group is None:
            group = on_stack
        if group is not None and group == on_stack:
            fwd[_signature(shapes)].add(group)
            for src in sources:
                by_source[src].add(group)
        rows.append({"group": group, "way": way, "flops": flops, "sig": _signature(shapes),
                     "sources": sources})
    for r in rows:
        sig, sources = r["sig"], r.pop("sources")
        if r["group"] is None:
            # the group of the forward products that read one of its operands,
            # else of those with its dims
            read = set().union(*(by_source[src] for src in sources))
            seen = read if len(read) == 1 else fwd.get(sig, {"rest"})
            if len(seen) > 1 and read:
                seen = seen & read
            if len(seen) != 1:
                raise ValueError(f"a backward product of dims {sig} matches {sorted(seen)}")
            r["group"], = seen
    return rows


_VIEWS = ("t", "transpose", "permute", "view", "_unsafe_view", "reshape", "expand", "clone",
          "contiguous", "alias")


def _source(node):
    """The node a product's operand is a view or copy of: a product's
    gradients read its operands as they are, or transposed."""
    while (getattr(node, "op", None) == "call_function" and node.args
           and getattr(node.target, "__name__", "").split(".")[0] in _VIEWS):
        node = node.args[0]
    return node


def port_cell(cell):
    """The port's products of ``cell`` (``_cell``), its collectives a device
    by kind, and its live bytes a device: ``(rows, collectives, live)``."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    import repro_torch.launch.dryrun as dr
    from repro_torch.analysis import hlo, roofline
    from repro_torch.configs import SHAPES, get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import _mesh, make_production_mesh

    torch.set_num_threads(1)
    arch, kind = cell["arch"], cell["kind"]
    if cell["shape"]:
        cfg, shape = get_config(arch), cell["shape"]
        mesh = make_production_mesh(multi_pod=cell["multi_pod"])
        shp = SHAPES[shape]
        batch, seq, kind = shp.global_batch, shp.seq_len, shp.kind
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
        cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="bfloat16")
        shape, batch, seq = kind, cell["batch"], cell["seq"]
        dr.SHAPES = {kind: ShapeConfig(kind, seq, batch, kind)}
        mesh = _mesh("cpu", (4, 4), ("data", "model"))
    if cell["layers"]:
        cfg = dataclasses.replace(cfg, num_layers=cell["layers"])
    get = dr.get_config
    dr.get_config = lambda a: cfg
    try:
        with stack_traces():
            _, graph = dr._lower_cell(arch, shape, mesh, shd.ShardingRules(),
                                      scheme=cell["scheme"])
    finally:
        dr.get_config = get
        dist.destroy_process_group()
    live = hlo.live_bytes(graph)
    return (products(cfg, graph, group_tokens(arch, kind, batch, seq)),
            roofline.collective_stats(graph),
            {"argument_gib": live["argument"] / 2**30, "temp_gib": live["temp"] / 2**30,
             "peak_hbm_gib": live["peak"] / 2**30})


def sums(rows):
    out = collections.Counter()
    for r in rows:
        out[(r["group"], r["way"])] += r["flops"]
    return out


def table(port, ref=None):
    p, r = sums(port), sums(ref or [])
    head = "| group | way | port FLOPs |"
    lines = [head + (" reference FLOPs | port - reference |" if ref is not None else ""),
             "| --- | --- | ---: |" + (" ---: | ---: |" if ref is not None else "")]
    for g in GROUPS:
        for w in ("fwd", "bwd"):
            if (g, w) in p or (g, w) in r:
                line = f"| {g} | {w} | {int(p[(g, w)]):,} |"
                if ref is not None:
                    line += f" {int(r[(g, w)]):,} | {int(p[(g, w)] - r[(g, w)]):+,} |"
                lines.append(line)
    tp, tr = sum(p.values()), sum(r.values())
    lines.append(f"| total | | {int(tp):,} |" + (f" {int(tr):,} | {int(tp - tr):+,} |"
                                                   if ref is not None else ""))
    return "\n".join(lines), p, r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="moonshot-v1-16b-a3b")
    ap.add_argument("--kind", default="train", choices=KINDS)
    ap.add_argument("--shape", default=None,
                    help="a full-size cell of the sweep (train_4k, prefill_32k, ...)")
    ap.add_argument("--multi-pod", action="store_true", help="with --shape: 512 ranks")
    ap.add_argument("--layers", type=int, default=None, help="cut the config to this depth")
    ap.add_argument("--scheme", default=None,
                    help='default "dp" for a reduced train cell, "sp" for a serve cell, '
                         "sweep.scheme_for's at full size")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    side = ap.add_mutually_exclusive_group()
    side.add_argument("--port-only", action="store_true", help="skip the reference's compile")
    side.add_argument("--reference-only", action="store_true", help="skip the port's trace")
    ap.add_argument("--json", default=None,
                    help="also write both sides' groups and live bytes here, with the "
                         "port's trace seconds and this process's peak resident memory")
    args = ap.parse_args(argv)
    if args.shape:
        sys.path.insert(0, SRC)
        from repro_torch.launch.sweep import scheme_for
        scheme = args.scheme or scheme_for(args.arch, args.shape)
    else:
        scheme = args.scheme or ("dp" if args.kind == "train" else "sp")
    cell = _cell(args.arch, scheme, args.batch, args.seq, args.kind, args.shape,
                 args.multi_pod, args.layers)
    ref = None if args.port_only else reference_cell(cell)
    t0 = time.perf_counter()
    port, colls, live = ([], {}, None) if args.reference_only else port_cell(cell)
    trace_s = time.perf_counter() - t0
    text, p, r = table(port, ref and ref["rows"])
    print(text)
    for name, got in (("port", live), ("reference", ref and ref["live"])):
        if got:
            print(f"{name} live bytes a device: " + ", ".join(f"{k} {v:.4f}"
                                                             for k, v in got.items()))
    if not args.reference_only:
        print("port collectives a device: " + ", ".join(
            f"{k} {v['count']} x, {int(v['bytes']):,} B" for k, v in sorted(colls.items())))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"cell": cell, "port": {"/".join(k): v for k, v in p.items()},
                       "reference": {"/".join(k): v for k, v in r.items()},
                       "port_live": live, "reference_live": ref and ref["live"],
                       "collectives": colls, "port_trace_s": live and trace_s,
                       "rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20},
                      f, indent=1)


if __name__ == "__main__":
    main()
