"""CPU worlds of several processes for the port's multi-rank tests.

``run_world(target, world, tmp_path)`` starts ``world`` Python processes,
one per rank, that meet in a gloo process group through a ``file://`` store
in ``tmp_path`` (no port to collide with another test's), run
``target(rank, world, **kw)`` (a function of this module, named by string)
and exit; rank 0's return value comes back as JSON. ``fake=True`` starts
one process in a fake group of ``world`` ranks instead (collectives return
at once), for traces of a full-size layout. Each world has its own timeout,
after which every process is killed, so a hang fails one test and does not
stall the suite.

The rank functions import torch and the port only (no JAX), so a child
starts in a few seconds.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TIMEOUT_S = 120


def run_world(target: str, world: int, tmp_path, *, fake: bool = False,
              timeout: float = TIMEOUT_S, **kw):
    out = os.path.join(str(tmp_path), f"{target}.out.json")
    init = "file://" + os.path.join(str(tmp_path), f"{target}.store")
    env = {**os.environ, "PYTHONPATH": SRC + os.pathsep + HERE, "OMP_NUM_THREADS": "1"}
    ranks = [0] if fake else range(world)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dist.py"), target, str(r), str(world),
         init, out, json.dumps(kw), "fake" if fake else "gloo"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in ranks]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            left = max(0.1, deadline - time.monotonic())
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{target}: world of {world} timed out after {timeout} s")
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    assert not bad, f"{target}: ranks failed {bad}:\n" + "\n".join(log[-3000:] for log in logs)
    with open(out) as f:
        return json.load(f)


def _init(rank: int, world: int, init: str, backend: str):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    else:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)


def main(argv):
    target, rank, world, init, out, kw, backend = argv
    rank, world = int(rank), int(world)
    _init(rank, world, init, backend)
    import torch.distributed as dist

    result = globals()[target](rank, world, **json.loads(kw))
    if rank == 0:
        with open(out + ".tmp", "w") as f:
            json.dump(result, f)
        os.replace(out + ".tmp", out)
    dist.destroy_process_group()


# -- rank functions ------------------------------------------------------------


def placements_local_shapes(rank, world):
    """Placements and rank 0's local shapes under a few specs on a (2, 2)
    mesh of a fake world."""
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(2, 2, device="cpu")
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    out = {}
    for name, spec in {"dm": shd.P("data", "model"), "md": shd.P("model", "data"),
                       "both": shd.P(("data", "model")), "none": shd.P(),
                       "col": shd.P(None, "model")}.items():
        d = shd.distribute(t, shd.NamedSharding(mesh, spec))
        out[name] = {"placements": [str(p) for p in d.placements],
                     "local": list(d.to_local().shape), "global": list(d.shape)}
    return out


def rmsnorm_rows(rank, world):
    """The RMSNorm kernels' wrapper (its plain version on the CPU) on a
    DTensor of (rows, 8) split over ``world`` ranks, for 8 rows (even), 7
    (uneven) and 3 (a rank would hold none): the output's layout, and the
    output and the gradients of x and of the replicated gain against plain
    ``rmsnorm_ref`` on the whole tensors; then whether a local map with an
    output held whole on a split mesh dim is refused."""
    import warnings

    import numpy as np
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ref as ref_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L

    mesh = make_host_mesh(world, 1, device="cpu")
    rng = np.random.default_rng(0)
    out = {}
    for n in (8, 7, 3):
        x = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
        gain = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
        dy = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
        xd = shd.distribute(x, shd.NamedSharding(mesh, shd.P("data"))).requires_grad_()
        gd = shd.distribute(gain, shd.replicated(mesh)).requires_grad_()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            y = L._rmsnorm_local(xd, gd, 1e-6)
        (y * shd.distribute(dy, shd.NamedSharding(mesh, shd.P("data")))).sum().backward()
        xr, gr = x.clone().requires_grad_(), gain.clone().requires_grad_()
        yr = ref_lib.rmsnorm_ref(xr, gr, 1e-6)
        (yr * dy).sum().backward()
        out[n] = {"placements": [str(p) for p in y.placements], "warned": len(caught),
                  "y": float((y.full_tensor() - yr).abs().max()),
                  "dx": float((xd.grad.full_tensor() - xr.grad).abs().max()),
                  "dgain": float((gd.grad.full_tensor() - gr.grad).abs().max())}
    try:
        shd.local_map(lambda a: a, [Replicate(), Replicate()], ([Shard(0), Replicate()],), mesh)
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    return out


def norm_layouts(rank, world):
    """RMSNorm of x (2, S, 8) split over rows ("data") and features
    ("model") on a (2, 2) mesh, through the plain path and the kernels'
    wrapper (its plain version on the CPU), for a decode step's one token
    (S 1) and a prefill's four (S 4): each path's output placements, and
    the output and x's gradient against plain ``rmsnorm_ref`` on the whole
    tensors."""
    import numpy as np
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ref as ref_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L

    mesh = make_host_mesh(2, 2, device="cpu")
    rng = np.random.default_rng(1)
    gain = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    out = {}
    for s in (1, 4):
        x = torch.from_numpy(rng.standard_normal((2, s, 8)).astype(np.float32))
        dy = torch.from_numpy(rng.standard_normal((2, s, 8)).astype(np.float32))
        xr = x.clone().requires_grad_()
        yr = ref_lib.rmsnorm_ref(xr, gain, 1e-6)
        (yr * dy).sum().backward()
        for kernel in (False, True):
            L._use_kernel = lambda t, k=kernel: k
            split = shd.NamedSharding(mesh, shd.P("data", None, "model"))
            xd = shd.distribute(x, split).requires_grad_()
            y = L._norm({"scale": shd.distribute(gain, shd.replicated(mesh))}, xd, 1e-6)
            (y * shd.distribute(dy, split)).sum().backward()
            out[f"{s} {'kernel' if kernel else 'plain'}"] = {
                "placements": [str(p) for p in y.placements],
                "y": float((y.full_tensor() - yr).abs().max()),
                "dx": float((xd.grad.full_tensor() - xr.grad).abs().max())}
    return out


def compressed_allreduce(rank, world, seed):
    """The mean of every rank's compressed gradients: w (16, 8) from
    ``seed + rank`` and b (8,) from ``seed + 100 + rank``, normal x 0.1; in
    a one-rank world w (16, 16) from ``seed``."""
    import numpy as np
    import torch

    from repro_torch.distributed import compression as comp

    def normal(s, shape):
        return torch.from_numpy(
            (np.random.default_rng(s).standard_normal(shape) * 0.1).astype(np.float32))
    grads = ({"w": normal(seed + rank, (16, 8)), "b": normal(seed + 100 + rank, (8,))}
             if world > 1 else {"w": normal(seed, (16, 16))})
    mean, _ = comp.allreduce_compressed(grads, comp.ef_init(grads), None)
    return {k: mean[k].tolist() for k in mean}


def _model_and_state(arch, npz, dtype="float32", heads=None):
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model
    from repro_torch.models.module import params_from_jax

    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype)
    if heads:  # query heads over one KV head (a count that need not divide the mesh)
        cfg = dataclasses.replace(cfg, num_heads=heads, num_kv_heads=1)
    with np.load(npz) as z:
        flat = {k.replace("|", "/"): z[k] for k in z.files}
    return cfg, params_from_jax(cfg, flat)


def sharded_steps(rank, world, arch, npz, ckpt_dir, steps, batch, seq, data, model_par,
                  lr, warmup_steps, accum=1, norm_kernel=False, scheme="sp", heads=None):
    """``steps`` sharded train steps of the reduced ``arch`` (weights from
    ``npz``; AdamW at ``lr`` after ``warmup_steps``, ``accum`` microbatches)
    on a (data, model_par) mesh with ZeRO-1, laid out by the sharding
    ``scheme``; then the elastic restore of its checkpoint onto (4, 1) over
    the same ranks and onto (1, 1) in a one-rank world. Returns the losses,
    gradient norms, final parameters, the placements of the first moments
    and of the MoE experts' weights before and after the steps, how many
    experts a rank's MoE layer served and on how many heads a rank's causal
    attention and SSD scan ran (and on how many query rows), and the
    restores' bit-for-bit verdicts. ``heads`` sets the query heads (over one
    KV head)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data.pipeline import ShardedLoader, SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models import ssm
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import step as step_lib

    kernel_calls, local_experts, local_heads, local_ssd_heads = [], set(), set(), set()
    local_rows = set()
    experts_of, causal_of, scan_of = moe._experts, attn.causal_attention, ssm.ssd_chunked

    def counted_experts(cfg, router, wi, wo, x, e0):
        local_experts.add(wi.shape[0])  # the experts this rank serves
        return experts_of(cfg, router, wi, wo, x, e0)

    def counted_attention(q, k, v, **kw):
        if not hasattr(q, "placements"):  # a rank's local shards
            local_heads.add(q.shape[2])
            local_rows.add(q.shape[1])
        return causal_of(q, k, v, **kw)

    def counted_scan(xb, *args):
        if not hasattr(xb, "placements"):
            local_ssd_heads.add(xb.shape[2])
        return scan_of(xb, *args)
    moe._experts, attn.causal_attention = counted_experts, counted_attention
    ssm.ssd_chunked = counted_scan
    if norm_kernel:
        # the RMSNorm kernels' wrapper on each rank's rows (layers._rmsnorm_local); on
        # the CPU it runs the kernel's plain version
        from repro_torch.kernels import ops as kops
        real = kops.rmsnorm
        L._use_kernel = lambda x: True
        kops.rmsnorm = lambda *a: kernel_calls.append(1) or real(*a)

    cfg, params = _model_and_state(arch, npz, heads=heads)
    mesh = make_host_mesh(data, model_par, device="cpu")
    model = build_model(cfg, device="cpu", sharder=shd.make_sharder(mesh, scheme=scheme))
    model.load_state_dict(params)
    opt_cfg = opt_lib.OptConfig(lr=lr, warmup_steps=warmup_steps)
    state = {"params": {k: v.detach() for k, v in model.named_parameters()},
             "step": torch.zeros((), dtype=torch.int32)}
    state["opt"] = opt_lib.init_opt_state(opt_cfg, state["params"])
    sh = step_lib.state_shardings(model, opt_cfg, mesh, zero=True, scheme=scheme)
    state = step_lib.distribute_state(state, sh)

    def experts():
        return {k: [str(p) for p in v.placements] for k, v in state["params"].items()
                if k.endswith(("mlp.wi", "mlp.wo"))}
    experts_before = experts()
    src = SyntheticLM(cfg.vocab_size, batch, seq, 0)
    loader = ShardedLoader(src, step_lib.batch_shardings(mesh, src.batch_at(0)))
    step = step_lib.make_train_step(model, opt_cfg, accum=accum)
    losses, gnorms = [], []
    try:
        for _ in range(steps):
            state, metrics = step(state, next(loader))
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
    finally:
        loader.close()
    placements = {k: [str(p) for p in v.placements]
                  for k, v in list(state["opt"]["m"].items())[:4]}
    experts_after = experts()
    final = {k: v.full_tensor().numpy().tolist() for k, v in state["params"].items()}
    ckpt.save(ckpt_dir, steps, state)
    written = ckpt.read_arrays(ckpt_dir, steps)
    like = step_lib.state_shapes(model, opt_cfg)

    def same(restored):
        flat = ckpt._flatten(restored)
        return all(torch.equal(
            (v.full_tensor() if hasattr(v, "full_tensor") else v).view(-1).view(torch.uint8),
            written[k].view(-1).view(torch.uint8)) for k, v in flat.items())

    mesh41 = make_host_mesh(4, 1, device="cpu")
    sh41 = step_lib.state_shardings(model, opt_cfg, mesh41, zero=True, scheme=scheme)
    restored41 = ckpt.restore(ckpt_dir, steps, like, sh41)
    ok41 = same(restored41)
    split41 = str(restored41["opt"]["m"][next(iter(restored41["opt"]["m"]))].placements)
    dist.barrier()
    ok11 = None
    if rank == 0:
        dist.destroy_process_group()
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        mesh11 = make_host_mesh(1, 1, device="cpu")
        sh11 = step_lib.state_shardings(model, opt_cfg, mesh11, zero=True, scheme=scheme)
        ok11 = same(ckpt.restore(ckpt_dir, steps, like, sh11))
    return {"losses": losses, "grad_norms": gnorms, "params": final, "placements": placements,
            "experts_before": experts_before, "experts_after": experts_after,
            "local_experts": sorted(local_experts), "local_heads": sorted(local_heads),
            "local_rows": sorted(local_rows),
            "local_ssd_heads": sorted(local_ssd_heads),
            "restore_4x1": ok41, "restore_4x1_m": split41, "restore_1x1": ok11,
            "kernel_calls": len(kernel_calls)}


def serve_inputs(cfg, batch, seq, steps):
    """A serve run's inputs, drawn with numpy: ``batch`` rows of ``seq +
    steps`` tokens (the prompt, then one token a decode step) and the
    config's stub memory (``patches`` or ``frames``)."""
    import numpy as np

    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq + steps)).astype(np.int32)}
    if cfg.cross_every:
        out["patches"] = rng.standard_normal((batch, cfg.vision_seq, cfg.d_model), np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal((batch, cfg.audio_seq, cfg.d_model), np.float32)
    return out


def grown_cache(cache, seq, steps, pad):
    """A prefill's cache with ``steps`` more slots where its sequence axis
    is the prompt's (``pad(array, steps)`` pads axis 1 at its end)."""
    return [{n: pad(a, steps) if n in ("k", "v") and a.shape[1] == seq else a
             for n, a in c.items()} for c in cache]


def sharded_serve(rank, world, arch, npz, batch, seq, steps, data, model_par):
    """The reduced ``arch`` (weights from ``npz``) served on a (data,
    model_par) mesh through the engine's sharded path: the parameters laid
    out by ``param_shardings`` (FSDP over "data" too for the archs the dry
    run serves so), a prefill of ``serve_inputs``' prompts by
    ``make_prefill_step``, its cache grown by ``steps`` slots and laid out
    by ``cache_shardings``, and ``steps`` decode steps of the next tokens
    by ``make_decode_step``. Returns each step's logits, whole, and how many
    MoE layer calls took the path where a group spans ranks."""
    import torch
    import torch.nn.functional as F

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.dryrun import FSDP_PARAMS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model, moe
    from repro_torch.serve import engine
    from repro_torch.train import step as step_lib

    spans, spanning = [], moe._spanning
    moe._spanning = lambda *a: spans.append(1) or spanning(*a)
    cfg, params = _model_and_state(arch, npz)
    mesh = make_host_mesh(data, model_par, device="cpu")
    model = build_model(cfg, device="cpu", sharder=shd.make_sharder(mesh))
    model.load_state_dict(params)
    p_sh = engine.param_shardings(model, mesh, fsdp_params=arch in FSDP_PARAMS)
    p = {k: shd.distribute(v.detach(), p_sh[k]) for k, v in model.named_parameters()}

    def laid_out(arrays):
        tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
        sh = step_lib.batch_shardings(mesh, tensors)
        return {k: shd.distribute(v, sh[k]) for k, v in tensors.items()}

    inputs = serve_inputs(cfg, batch, seq, steps)
    tokens = inputs.pop("tokens")
    logits, cache = engine.make_prefill_step(model)(p, laid_out({**inputs,
                                                                 "tokens": tokens[:, :seq]}))
    out = [logits.full_tensor()]
    c_sh, _ = engine.cache_shardings(model, mesh, batch, seq + steps)
    cache = grown_cache([{n: a.full_tensor() for n, a in c.items()} for c in cache], seq,
                        steps, lambda a, n: F.pad(a, (0, 0, 0, 0, 0, n)))
    cache = [{n: shd.distribute(a, c_sh[i][n]) for n, a in c.items()}
             for i, c in enumerate(cache)]
    decode = engine.make_decode_step(model)
    for n in range(steps):
        pos = torch.full((batch,), seq + n, dtype=torch.int32).numpy()
        step = laid_out({"tokens": tokens[:, seq + n:seq + n + 1], "pos": pos})
        logits, cache = decode(p, cache, step["tokens"], step["pos"])
        out.append(logits.full_tensor())
    return {"logits": [t.tolist() for t in out], "spanning": len(spans)}


def fake_trace_checks(rank, world):
    """A collective in a Python loop of 7 and a 4-way column-sharded matmul,
    traced on a fake (1, 4) world."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.analysis import hlo, roofline
    from repro_torch.launch import dryrun

    mesh = DeviceMesh("cpu", torch.arange(4).reshape(1, 4), mesh_dim_names=("data", "model"))
    fm = FakeTensorMode()

    def dt(shape, pls, local):
        with fm:
            loc = torch.empty(local)
        return DTensor.from_local(loc, mesh, pls, run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    x = dt((32, 64), [Replicate(), Replicate()], (32, 64))
    w = dt((64, 128), [Replicate(), Shard(1)], (64, 32))
    mm = hlo.analyze_graph(make_fx(lambda a, b: a @ b, tracing_mode="fake")(x, w))

    def gather7(t):
        for _ in range(7):
            t = t.redistribute(mesh, [Replicate(), Replicate()]).redistribute(
                mesh, [Replicate(), Shard(0)])
        return t.to_local()

    g = make_fx(gather7, tracing_mode="fake")(dt((32, 16), [Replicate(), Shard(0)], (8, 16)))
    cost = hlo.analyze_graph(g)

    def dead_gather(t):  # a collective whose result reaches nothing
        t.redistribute(mesh, [Replicate(), Replicate()])
        return t * 2

    fn, args = dryrun._on_local_shards(dead_gather, (dt((32, 16), [Replicate(), Shard(0)],
                                                        (8, 16)),))
    dead = make_fx(fn, tracing_mode="fake")(*args)
    kept = roofline.collective_stats(dead)
    dryrun._drop_dead(dead)
    out_args = [a.op for a in dead.graph.find_nodes(op="output")[0].all_input_nodes]
    return {"mm_flops": mm.flops, "mm_colls": mm.coll_counts,
            "loop_counts": cost.coll_counts, "loop_bytes": cost.coll_bytes,
            "loop_stats": roofline.collective_stats(g),
            "dead_before": kept, "dead_after": roofline.collective_stats(dead),
            "dead_output_from": out_args,
            "dead_ops": [str(n.target) for n in dead.graph.nodes if n.op == "call_function"]}


def _reduced_cells(batch, seq):
    """The dry run's registry cut down: every config reduced (bf16), every
    shape (batch, seq) of its kind, the production mesh (4, 4)."""
    import dataclasses

    import repro_torch.launch.dryrun as dr
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import _mesh

    dr.get_config = lambda arch: dataclasses.replace(reduced_config(get_config(arch)),
                                                     dtype="bfloat16")
    dr.SHAPES = {k: ShapeConfig(k, seq, batch, k) for k in ("train", "prefill", "decode")}
    dr.make_production_mesh = lambda multi_pod=False: _mesh("cpu", (4, 4), ("data", "model"))
    return dr


def dryrun_cells(rank, world, cells, batch, seq):
    """``dryrun_cell`` of reduced cells ([arch, scheme, kind]) at (batch,
    seq) on a (4, 4) mesh of a fake world."""
    dr = _reduced_cells(batch, seq)
    return [dr.dryrun_cell(arch, kind, scheme=scheme, verbose=False)
            for arch, scheme, kind in cells]


def dryrun_cell_products(rank, world, cell, batch, seq):
    """``dryrun_cell`` of one reduced cell ([arch, scheme, kind]), as
    ``dryrun_cells`` runs it, and the matrix products of its traced step by
    group (``tools/dot_table.py``'s port half): for each group and
    direction, how many, their FLOPs summed and the largest one's."""
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
    import dot_table

    dr = _reduced_cells(batch, seq)
    arch, scheme, kind = cell
    lower, graphs = dr._lower_cell, []

    def lowered(*args, **kw):
        model, graph = lower(*args, **kw)
        graphs.append(graph)
        return model, graph
    dr._lower_cell = lowered
    with dot_table.stack_traces():
        rec = dr.dryrun_cell(arch, kind, scheme=scheme, verbose=False)
    groups = {}
    for r in dot_table.products(dr.get_config(arch), graphs[0]):
        g = groups.setdefault(f"{r['group']}/{r['way']}", {"count": 0, "total": 0.0, "max": 0.0})
        g["count"] += 1
        g["total"] += r["flops"]
        g["max"] = max(g["max"], r["flops"])
    return {"record": rec, "products": groups}


def traced_cell(rank, world, arch, scheme, batch, seq):
    """How a reduced train cell's traced step on a (4, 4) mesh of a fake
    world is tied together: its graph constants, the ops that feed the
    output, its collectives by kind and the bytes of the parameters'
    gradients (whole, in their dtypes)."""
    from repro_torch.analysis import roofline
    from repro_torch.distributed import sharding as shd

    dr = _reduced_cells(batch, seq)
    model, graph = dr._lower_cell(arch, "train", dr.make_production_mesh(),
                                  shd.ShardingRules(), scheme=scheme)
    nodes = list(graph.graph.nodes)
    return {"get_attr": sum(n.op == "get_attr" for n in nodes),
            "output_from": sorted({a.op for a in nodes[-1].all_input_nodes}),
            "unused_ops": sum(n.op == "call_function" and not n.users for n in nodes),
            "collectives": roofline.collective_stats(graph),
            "grad_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}


def collectives_cell(rank, world, arch, scheme, batch, seq):
    """Each collective of a reduced train cell's traced step on a (4, 4)
    mesh of a fake world: its kind and its result's shape."""
    from repro_torch.analysis import hlo
    from repro_torch.distributed import sharding as shd

    dr = _reduced_cells(batch, seq)
    _, graph = dr._lower_cell(arch, "train", dr.make_production_mesh(), shd.ShardingRules(),
                              scheme=scheme)
    return [[hlo.coll_kind(n.target), list(next(hlo.tensors(n.meta["val"])).shape)]
            for n in graph.graph.nodes
            if n.op == "call_function" and hlo.coll_kind(n.target) is not None]


def dot_flops_cell(rank, world, arch, scheme, batch, seq, kind="train"):
    """One rank's matrix-product FLOPs in a reduced cell's traced step (a
    train step, or a prefill or decode step for ``kind``) on a (4, 4) mesh
    of a fake world."""
    from repro_torch.analysis import hlo
    from repro_torch.distributed import sharding as shd

    dr = _reduced_cells(batch, seq)
    _, graph = dr._lower_cell(arch, kind, dr.make_production_mesh(), shd.ShardingRules(),
                              scheme=scheme)
    return {"dot_flops": hlo.dot_flops(graph)}


def ssm_layer_products(rank, world, arch, scheme, rows, seq):
    """One Mamba2 block of the reduced ``arch`` (bf16) on ``rows`` rows of
    ``seq`` tokens, forward and backward, traced on one rank of a (4, 4)
    mesh of a fake world under ``scheme`` as a train step's layer runs it:
    the residual stream laid out by the "acts" constraint, the pre-norm
    before the block, the block's weights in the train state's layout made
    whole for compute by the sharder. Returns the block's matrix products
    but the scan's (``tools/dot_table.py``'s ``ssm_proj`` group: direction,
    FLOPs, dims) and the collectives by kind."""
    import dataclasses

    import torch
    import torch.fx.experimental.proxy_tensor as proxy

    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
    import dot_table
    from repro_torch.analysis import roofline
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import _mesh
    from repro_torch.models import layers as L
    from repro_torch.models import ssm
    from repro_torch.models.api import use_impls

    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="bfloat16")
    mesh = _mesh("cpu", (4, 4), ("data", "model"))
    sharder = shd.make_sharder(mesh, scheme=scheme)
    specs = {**ssm.ssm_spec(cfg), "norm": L.norm_spec(cfg)["scale"]}
    axes = {k: s.axes for k, s in specs.items()}
    shapes = {k: s.shape for k, s in specs.items()}
    if scheme == "dp":
        axes = shd.fsdp_axes(axes, shapes, mesh)
    layout = shd.tree_shardings(mesh, axes, shapes, shd.scheme_rules(scheme))
    gen = torch.Generator().manual_seed(0)
    params = {k: shd.distribute(torch.randn(s.shape, generator=gen).to(s.dtype or torch.bfloat16),
                                layout[k]) for k, s in specs.items()}
    shape = (rows, seq, cfg.d_model)
    resid = shd.distribute(torch.randn(shape, generator=gen).to(torch.bfloat16),
                           sharder.layout("acts", shape))

    def step(params, resid):
        leaves = [resid] + list(params.values())
        leaves = [t.detach().requires_grad_() for t in leaves]
        w = {k: sharder.whole(v) for k, v in zip(params, leaves[1:])}
        norm = w.pop("norm")
        y, _ = ssm.apply_ssm(w, cfg, L.apply_norm({"scale": norm}, leaves[0]))
        out = shd.constrain(sharder, "acts", leaves[0] + y)
        return torch.autograd.grad(out.float().square().mean(), leaves)

    fn, args = dryrun._on_local_shards(step, (params, resid))
    with dot_table.stack_traces(), use_impls(ssd="plain", norm="plain"):
        graph = proxy.make_fx(fn, tracing_mode="fake")(*args)
    dryrun._drop_dead(graph)
    return {"products": [r for r in dot_table.products(cfg, graph) if r["group"] == "ssm_proj"],
            "collectives": roofline.collective_stats(graph)}


if __name__ == "__main__":
    main(sys.argv[1:])
