"""Multi-pod dry run: trace one rank's step of every (arch x shape x mesh) cell.

Port of ``repro.launch.dryrun``. Where the reference lowers and compiles
each cell for 512 fake XLA devices, the port builds the cell on fake
tensors over a fake process group of the production mesh's size
(``launch.mesh.make_production_mesh``): the model on the ``meta`` device
with the mesh's sharder, the state distributed by ``state_shardings`` (or
the parameters and cache by the engine's shardings) as DTensors whose local
shards are fake, and one rank's train, prefill or decode step traced by
``make_fx`` as a function of the rank's local shards, with what no result
depends on dropped, collectives included. Its per-rank graph carries the
rank's local shapes and every collective DTensor inserts;
``analysis.roofline.analyze`` turns it into the reference's roofline
record. Kernels are pinned plain: no kernel runs on fake tensors. Records
keep the reference's keys: ``lower_s`` is the trace's time and
``compile_s`` the graph analysis' (nothing is compiled). They add
``dot_flops_per_device``, the FLOPs of the rank's matrix products alone
(``analysis.hlo.dot_flops``: the count that compares with the dots of the
reference's compiled HLO), and ``host_rss_gib``, the process's peak
resident memory after the cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k --scheme dp --out build/dryrun.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import torch

from repro_torch.analysis import hlo
from repro_torch.analysis import roofline as rl
from repro_torch.configs import SHAPES, get_config, list_archs, shape_applicable
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.serve import engine
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def input_specs(arch: str, shape_name: str = "train_4k") -> Dict:
    """``meta`` stand-ins for every model input of a cell (no allocation).

    Training cells get {tokens, labels}; prefill cells {tokens}; decode cells
    {tokens, pos}. Modality frontends are stubs: VLM cells add precomputed
    patch embeddings, audio cells add precomputed frame embeddings.
    """
    cfg = get_config(arch)
    shp = SHAPES[shape_name]
    b = shp.global_batch

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if shp.kind == "train":
        specs = {"tokens": meta((b, shp.seq_len), torch.int32),
                 "labels": meta((b, shp.seq_len), torch.int32)}
    elif shp.kind == "prefill":
        specs = {"tokens": meta((b, shp.seq_len), torch.int32)}
    else:  # decode: one new token against a seq_len cache
        specs = {"tokens": meta((b, 1), torch.int32), "pos": meta((b,), torch.int32)}
    if cfg.cross_every and shp.kind != "decode":
        specs["patches"] = meta((b, cfg.vision_seq, cfg.d_model), _dtype(cfg))
    if cfg.is_encoder_decoder and shp.kind != "decode":
        specs["frames"] = meta((b, cfg.audio_seq, cfg.d_model), _dtype(cfg))
    return specs


# Giant archs: parameters FSDP-shard over (pod, data) in addition to
# model-axis TP, and arctic trains masterless (pure-bf16 AdamW).
FSDP_PARAMS = {"arctic-480b", "llama-3.2-vision-90b"}
NO_MASTER = {"arctic-480b"}
# Gradient accumulation (microbatching) for train cells whose activation
# working set exceeds HBM at full batch.
TRAIN_ACCUM = {"llama-3.2-vision-90b": 4, "arctic-480b": 4,
               "qwen2.5-32b": 4, "jamba-v0.1-52b": 4,
               "moonshot-v1-16b-a3b": 2}


def _fake_tree(tree, shardings, fake_mode):
    """A tree of ``meta`` tensors as DTensors whose local shards are fake
    tensors of this rank's shapes."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _fake_tree(v, shardings[k], fake_mode) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fake_tree(v, s, fake_mode) for v, s in zip(tree, shardings)]
    mesh, pls = shardings.mesh, shardings.placements
    local = shd.local_part(tree, mesh, pls)
    with fake_mode:
        loc = torch.empty(local.shape, dtype=tree.dtype)
    return DTensor.from_local(loc, mesh, pls, run_check=False, shape=tree.shape,
                              stride=tree.stride())


def _lower_cell(arch: str, shape_name: str, mesh, rules: shd.ShardingRules,
                opt_cfg: Optional[opt_lib.OptConfig] = None, scheme: str = "sp"):
    """Build the cell on fake tensors over ``mesh`` and trace one rank's step.
    Returns (model, graph)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.core.nsm import TRACE_LOCK
    from repro_torch.models.api import use_impls

    cfg = get_config(arch)
    shp = SHAPES[shape_name]
    rules = shd.scheme_rules(scheme, rules)
    fsdp = arch in FSDP_PARAMS
    model = build_model(cfg, device="meta", sharder=shd.make_sharder(mesh, rules, scheme))
    specs = input_specs(arch, shape_name)
    batch_sh = step_lib.batch_shardings(mesh, specs, rules)
    fake_mode = FakeTensorMode()

    if shp.kind == "train":
        opt_cfg = opt_cfg or opt_lib.OptConfig(
            moment_dtype="bfloat16", keep_master=arch not in NO_MASTER)
        fn = step_lib.make_train_step(model, opt_cfg, accum=TRAIN_ACCUM.get(arch, 1))
        state_sh = step_lib.state_shardings(model, opt_cfg, mesh, rules,
                                            scheme=scheme, fsdp_params=fsdp)
        args = (_fake_tree(step_lib.state_shapes(model, opt_cfg), state_sh, fake_mode),
                _fake_tree(specs, batch_sh, fake_mode))
    else:
        p_sh = engine.param_shardings(model, mesh, rules, fsdp_params=fsdp)
        params = _fake_tree({k: v.detach() for k, v in model.named_parameters()},
                            p_sh, fake_mode)
        if shp.kind == "prefill":
            fn = engine.make_prefill_step(model)
            args = (params, _fake_tree(specs, batch_sh, fake_mode))
        else:  # decode
            fn = engine.make_decode_step(model)
            c_sh, c_shape = engine.cache_shardings(model, mesh, shp.global_batch,
                                                   shp.seq_len, rules)
            batch = _fake_tree(specs, batch_sh, fake_mode)
            args = (params, _fake_tree(c_shape, c_sh, fake_mode),
                    batch["tokens"], batch["pos"])
    local_fn, local_args = _on_local_shards(fn, args)
    # make_fx keeps module-level state: one trace at a time
    with TRACE_LOCK, use_impls(attention="plain", ssd="plain", norm="plain"):
        graph = make_fx(local_fn, tracing_mode="fake")(*local_args)
    _drop_dead(graph)
    return model, graph


def _on_local_shards(fn, args):
    """``fn`` as a function of this rank's local shards, and those shards.

    The traced function wraps each shard as its DTensor and returns the
    local shards of the results, so the graph runs from the rank's inputs to
    its outputs (a DTensor passed to ``make_fx`` whole is not tied to its
    placeholder, nor a DTensor result to the output)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

    leaves, spec = tree_flatten(args)
    metas = [(t.device_mesh, t.placements, t.shape, t.stride())
             if isinstance(t, DTensor) else None for t in leaves]

    def run(*local):
        whole = [DTensor.from_local(x, m[0], m[1], run_check=False, shape=m[2], stride=m[3])
                 if m else x for x, m in zip(local, metas)]
        out = fn(*tree_unflatten(whole, spec))
        return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t, out)

    return run, [t.to_local() if m else t for t, m in zip(leaves, metas)]


def _drop_dead(graph) -> None:
    """Remove what no output depends on, collectives included: torch's
    dead-code elimination keeps a collective (and its ``wait_tensor``) as a
    side effect, and some torch versions' DTensor runs its sharding
    propagation on whole-shape tensors under the trace, collectives and
    all, beside the rank's program."""
    for node in reversed(list(graph.graph.nodes)):
        if node.op in ("placeholder", "output") or node.users:
            continue
        if (not node.is_impure()
                or getattr(node.target, "namespace", None) == "_c10d_functional"):
            graph.graph.erase_node(node)
    graph.recompile()


def _host_rss_gib() -> float:
    """This process's peak resident memory so far."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                rules: Optional[shd.ShardingRules] = None,
                verbose: bool = True, scheme: str = "sp",
                service=None) -> Dict:
    """Trace + analyze one cell; return its roofline record.

    ``service`` is anything with ``predict_one(cfg, batch, seq)`` — a
    ``PredictionService`` or the micro-batched ``AbacusServer`` gateway.
    Train cells then carry the DNNAbacus (predicted) step time/memory next
    to the roofline numbers, and the roofline time and peak bytes go back to
    the service's ``observe``.
    """
    cfg = get_config(arch)
    shp = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shp)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}
    rules = rules or shd.ShardingRules()
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size()

    t0 = time.time()
    model, graph = _lower_cell(arch, shape_name, mesh, rules, scheme=scheme)
    t_lower = time.time() - t0
    t0 = time.time()
    roof = rl.analyze(graph)
    t_compile = time.time() - t0

    mflops = rl.model_flops(cfg, shp, model.param_count(),
                            model.param_count(active_only=True)) / n_dev
    rec = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "devices": n_dev, "status": "ok", "scheme": scheme,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        **roof.summary(mflops),
        "dot_flops_per_device": hlo.dot_flops(graph), "host_rss_gib": _host_rss_gib(),
    }
    if service is not None and shp.kind == "train":
        # the estimate is an optional annotation: never let a predictor
        # failure overwrite a successfully traced cell's record
        try:
            est = service.predict_one(cfg, shp.global_batch, shp.seq_len)
            rec["abacus_time_s"] = round(est["time_s"], 4)
            rec["abacus_memory_gib"] = round(est["memory_bytes"] / 2**30, 3)
            if "generation" in est:
                rec["abacus_generation"] = est["generation"]
            # the roofline-bound step time and the traced peak bytes are
            # proxies for the job's realized cost: a dry-run sweep doubles
            # as a calibration pass over every train cell
            observe = getattr(service, "observe", None)
            if observe is not None:
                t_roof = max(roof.t_compute, roof.t_memory, roof.t_collective)
                observe(cfg, shp.global_batch, shp.seq_len,
                        float(t_roof), rec["peak_hbm_gib"] * 2**30,
                        predicted_time_s=est["time_s"],
                        predicted_mem_bytes=est["memory_bytes"],
                        generation=est.get("generation"),
                        job_id=f"dryrun:{arch}:{shape_name}")
        except Exception as e:
            rec["abacus_error"] = f"{type(e).__name__}: {e}"[:200]
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} mesh={tuple(mesh.shape)}")
        print(f"  live bytes: args={rec['argument_gib']:.2f}GiB "
              f"temp={rec['temp_gib']:.2f}GiB peak={rec['peak_hbm_gib']:.2f}GiB")
        print(f"  graph cost: flops/dev={roof.flops:.3e} "
              f"bytes/dev={roof.bytes_accessed:.3e}")
        print(f"  collectives: { {k: int(v['count']) for k, v in roof.collectives.items()} }")
        print(f"  roofline: compute={roof.t_compute*1e3:.2f}ms "
              f"memory={roof.t_memory*1e3:.2f}ms "
              f"collective={roof.t_collective*1e3:.2f}ms "
              f"-> bound by {roof.bottleneck}")
        print(f"  model_flops/dev={mflops:.3e} useful={rec['useful_flop_fraction']:.3f} "
              f"mfu_bound={rec.get('mfu_bound', 0):.3f}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--scheme", default="sp", help="sp | sp_heads | tp | dp")
    ap.add_argument("--predict", action="store_true",
                    help="attach DNNAbacus estimates to train cells")
    ap.add_argument("--predictor-path", default="artifacts/abacus")
    ap.add_argument("--trace-store", default="artifacts/trace_store",
                    help="persistent trace dir ('' disables): repeated "
                         "dry runs warm-start instead of re-tracing")
    ap.add_argument("--feedback-store", default="artifacts/feedback_store",
                    help="persistent measured-cost observations ('' "
                         "disables): each predicted train cell's roofline "
                         "time / peak bytes feed the online-refit loop")
    ap.add_argument("--replicas", type=int, default=1,
                    help="gateway replicas: > 1 serves estimates from a "
                         "fingerprint-sharded ClusterFrontend (per-replica "
                         "trace/feedback slices under the store paths)")
    ap.add_argument("--resize-to", type=int, default=0,
                    help="live-reshard the fleet to this many replicas "
                         "after the first arch (requires --replicas > 1)")
    ap.add_argument("--rpc", action="store_true",
                    help="with --replicas > 1: spawn each gateway as its "
                         "own process (python -m repro_torch.serve.rpc) "
                         "behind the TCP frame transport")
    ap.add_argument("--store-backend", default=None,
                    choices=("json", "segment"),
                    help="physical layout for the trace/feedback stores "
                         "(default: REPRO_STORE_BACKEND env var, else "
                         "json); exported to RPC children")
    ap.add_argument("--metrics-out", default=None,
                    help="with --predict: write the serving metrics "
                         "snapshot here at sweep end (.prom/.txt -> "
                         "Prometheus text exposition, else JSON)")
    ap.add_argument("--events-out", default=None,
                    help="with --predict: append structured JSONL "
                         "lifecycle events to this file; RPC children "
                         "append to the same file")
    args = ap.parse_args(argv)

    service = server = None
    rpc_fleet = []
    if args.rpc and args.replicas < 2:
        print("[dryrun] --rpc needs a fleet (--replicas > 1); serving "
              "in-process", file=sys.stderr)
        args.rpc = False
    if args.store_backend:
        # one env var selects the layout everywhere: the factories below
        # read it, and spawned RPC children inherit it
        os.environ["REPRO_STORE_BACKEND"] = args.store_backend
    if args.predict:
        from repro_torch.core.predictor import DNNAbacus
        from repro_torch.obs import events
        from repro_torch.serve.feedback_store import make_feedback_store
        from repro_torch.serve.server import AbacusServer
        from repro_torch.serve.trace_store import make_trace_store
        if args.events_out:
            events.configure(path=args.events_out)
        if os.path.exists(args.predictor_path + ".json"):
            if args.rpc:
                from repro_torch.serve.cluster import ClusterFrontend
                from repro_torch.serve.rpc import shutdown_fleet, spawn_replica
                try:
                    for i in range(args.replicas):
                        name = f"r{i}"
                        rpc_fleet.append(spawn_replica(
                            name, args.predictor_path,
                            trace_root=(os.path.join(args.trace_store, name)
                                        if args.trace_store else None),
                            feedback_root=(
                                os.path.join(args.feedback_store, name)
                                if args.feedback_store else None),
                            event_log=args.events_out or None))
                except BaseException:
                    shutdown_fleet(rpc_fleet)
                    raise
                server = ClusterFrontend(replicas=rpc_fleet,
                                         hedge_after_s=5.0).start()
            elif args.replicas > 1:
                from repro_torch.serve.cluster import ClusterFrontend
                server = ClusterFrontend(
                    DNNAbacus.load(args.predictor_path),
                    n_replicas=args.replicas,
                    trace_root=args.trace_store or None,
                    feedback_root=args.feedback_store or None).start()
            else:
                store = (make_trace_store(args.trace_store)
                         if args.trace_store else None)
                service = DNNAbacus.load(args.predictor_path).service(store=store)
                feedback = (make_feedback_store(args.feedback_store)
                            if args.feedback_store else None)
                server = AbacusServer(service, feedback=feedback).start()
        else:
            print(f"[dryrun] no fitted predictor at {args.predictor_path}; "
                  "skipping estimates", file=sys.stderr)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    resize_to = int(args.resize_to or 0)
    if resize_to and not hasattr(server, "resize"):
        print("[dryrun] --resize-to needs a fleet (--replicas > 1); "
              "ignoring", file=sys.stderr)
        resize_to = 0
    if resize_to and rpc_fleet and resize_to > len(rpc_fleet):
        print("[dryrun] --resize-to growth is not supported with --rpc; "
              "ignoring", file=sys.stderr)
        resize_to = 0
    failures = 0
    try:
        for arch in archs:
            for shape_name in shapes:
                for mp in meshes:
                    try:
                        rec = dryrun_cell(arch, shape_name, multi_pod=mp,
                                          scheme=args.scheme,
                                          service=server or service)
                    except Exception as e:  # a failure here is a sharding bug
                        rec = {"arch": arch, "shape": shape_name,
                               "multi_pod": mp, "status": "FAILED",
                               "error": f"{type(e).__name__}: {e}",
                               "dot_flops_per_device": None,
                               "host_rss_gib": _host_rss_gib()}
                        failures += 1
                        print(f"[dryrun] FAILED {arch} x {shape_name} mp={mp}: "
                              f"{rec['error'][:500]}", file=sys.stderr)
                    if args.out:
                        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                        with open(args.out, "a") as f:
                            f.write(json.dumps(rec) + "\n")
            if resize_to:
                mig = server.resize(resize_to)
                print(f"[dryrun] resharded fleet {len(mig['from'])} -> "
                      f"{len(mig['to'])} replicas: {mig['keys_moved']} keys "
                      f"moved ({mig['moved_fraction_bound']:.0%} of keyspace; "
                      f"naive rehash = 100%), {mig['cutover_ticks']} drain "
                      "ticks", file=sys.stderr)
                resize_to = 0
    finally:
        if server is not None:
            cal = server.stats()["calibration"]
            if cal["count"]:
                print(f"[dryrun] calibration over {cal['count']} cells: "
                      f"time_mre={cal['time_mre']:.3f} "
                      f"time_drift={cal['time_drift']:+.3f} "
                      f"mem_mre={cal['mem_mre']:.3f}", file=sys.stderr)
            reshard = getattr(server, "reshard_stats", None)
            if reshard and reshard["reshards"]:
                print(f"[dryrun] reshards={reshard['reshards']} "
                      f"keys_moved={reshard['keys_moved']} "
                      f"replayed={reshard['keys_replayed']}", file=sys.stderr)
            if args.metrics_out:
                # snapshot before stop(): a fleet frontend fetches each
                # replica's registry over RPC, so the fleet must be alive
                try:
                    if args.metrics_out.endswith((".prom", ".txt")):
                        body = server.metrics_text()
                    else:
                        body = json.dumps(server.metrics_snapshot(),
                                          indent=2, sort_keys=True)
                    with open(args.metrics_out, "w") as f:
                        f.write(body + "\n")
                    print(f"[dryrun] metrics snapshot -> {args.metrics_out}",
                          file=sys.stderr)
                except Exception as e:
                    print(f"[dryrun] metrics snapshot failed: "
                          f"{type(e).__name__}: {e}", file=sys.stderr)
            server.stop()
        if rpc_fleet:
            from repro_torch.serve.rpc import shutdown_fleet
            shutdown_fleet(rpc_fleet)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
