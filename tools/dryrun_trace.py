"""Time and dissect one rank's traced step of a dry-run cell.

    PYTHONPATH=src python tools/dryrun_trace.py --arch qwen2-0.5b \\
        --shape train_4k --scheme dp [--layers 12] [--old-trace] [--peak 12]

Traces the cell as ``repro_torch.launch.dryrun`` does, on a fake world of
the production mesh, and prints one JSON line: the trace's wall time and
the part of it Python's garbage collector took, the graph's nodes and
FLOPs (``analysis.hlo``'s count), the collectives by kind (count and result bytes) before and after the dead-code
pass, and the ops whose results the scalar all-reduces read. ``--peak N``
adds the live bytes a device (``analysis.hlo.live_bytes``: arguments,
temp, peak) and the ``N`` largest op results alive at the peak, each with
its shape, its GiB, and the index of the op that makes it and of its last
use.
``--old-trace`` hands the DTensors to ``make_fx`` whole and keeps torch's
own dead-code pass, as the dry run traced before it traced the local
shards; it is here only to compare the two.
"""

import argparse
import collections
import dataclasses
import gc
import json
import time

from repro_torch.analysis import hlo
from repro_torch.analysis import roofline as rl
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_production_mesh


def _stats(graph):
    return {k: [v["count"], v["bytes"]] for k, v in rl.collective_stats(graph).items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--scheme", default="dp")
    ap.add_argument("--layers", type=int, default=None, help="cut the config to this depth")
    ap.add_argument("--old-trace", action="store_true")
    ap.add_argument("--peak", type=int, default=0,
                    help="list this many of the largest results alive at the peak")
    args = ap.parse_args(argv)

    if args.layers:
        full = dr.get_config
        dr.get_config = lambda arch: dataclasses.replace(full(arch), num_layers=args.layers)
    before = {}
    drop = dr._drop_dead

    def dead_code(graph):
        if args.old_trace:
            graph.graph.eliminate_dead_code()
            graph.recompile()
        before.update(nodes=len(graph.graph.nodes), collectives=_stats(graph))
        if not args.old_trace:
            drop(graph)

    dr._drop_dead = dead_code
    if args.old_trace:
        dr._on_local_shards = lambda fn, fn_args: (fn, fn_args)

    in_gc, start = [0.0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            in_gc[0] += time.perf_counter() - start[0]

    mesh = make_production_mesh()
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    _, graph = dr._lower_cell(args.arch, args.shape, mesh, shd.ShardingRules(),
                              scheme=args.scheme)
    wall = time.perf_counter() - t0
    gc.callbacks.remove(on_gc)

    producers = collections.Counter()
    for node in graph.graph.nodes:
        if node.op != "call_function" or hlo.coll_kind(node.target) != "all-reduce":
            continue
        (val,) = hlo.tensors(node.meta.get("val"))
        if val.ndim == 0:
            src = node.args[0]
            up = src.all_input_nodes[0].target if src.all_input_nodes else None
            producers[f"{src.target} <- {up}"] += 1
    out = {"arch": args.arch, "shape": args.shape, "scheme": args.scheme,
           "layers": dr.get_config(args.arch).num_layers,
           "trace": "old" if args.old_trace else "shards", "trace_s": round(wall, 2),
           "gc_s": round(in_gc[0], 2), "nodes_before_dead_code": before["nodes"],
           "nodes": len(graph.graph.nodes), "flops": hlo.analyze_graph(graph).flops,
           "collectives_before_dead_code": before["collectives"],
           "collectives": _stats(graph), "scalar_all_reduce_inputs": dict(producers)}
    if args.peak:
        live = hlo.live_bytes(graph, top=args.peak)
        out["live_gib"] = {k: live[k] / 2**30 for k in ("argument", "temp", "peak")}
        out["peak_at"] = [live["peak_at"], len(graph.graph.nodes)]
        out["alive_at_peak"] = [[name, op, shapes, size / 2**30, born, last]
                                for name, op, shapes, size, born, last in live["at_peak"]]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
