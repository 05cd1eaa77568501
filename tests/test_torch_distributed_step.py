"""The port's sharded train step on a CPU world of four gloo processes.

A (2, 2) ``("data", "model")`` mesh; the reduced config in fp32, its weights
drawn by the JAX package's ``init`` and carried across (``params_from_jax``);
the state laid out by ``state_shardings`` with ZeRO-1 (moments and master
split over ``data`` as well), the batches by ``ShardedLoader(shardings=...)``;
``STEPS`` steps of ``SyntheticLM`` batches, AdamW at ``LR`` = 1e-3 from the
first step (``WARMUP`` = 1), so that each step moves a parameter by about
1e-3. Held against the port's unsharded step and the reference's
``make_train_step`` on the same batches: losses and gradient norms within
``LOSS_RTOL`` = 1e-5 relative; each leaf's whole update (final minus
initial parameters) within ``UPDATE_RTOL`` = 1e-3 of the other step's, in
norm relative to it, which a skipped or misplaced moment or master update
on any leaf fails; final parameters within ``PARAM_TOL`` = 2e-3 (the
sharded step sums in another order: partial sums across ranks). One
qwen2-0.5b case accumulates two microbatches (contiguous blocks of rows,
as the reference splits them). The qwen2-0.5b world also runs the RMSNorm
kernels' wrapper on each rank's rows (``layers._rmsnorm_local``; its plain version on
the CPU).

The checkpoint the sharded state writes restores bit for bit onto a (4, 1)
mesh over the same ranks and onto (1, 1) in a one-rank world (the elastic
restart of ``tests/test_ckpt_ft.py``'s reference case). mamba2-370m's "sp"
case and moonshot-v1-16b-a3b's two (experts split over ``model``) take
over 30 s each and are marked ``slow``.

Two cases run the "dp" scheme (``make_sharder`` and ``state_shardings``
with ``scheme="dp"``: the batch over both mesh dims, every weight
FSDP-split over ``model`` and gathered where a layer reads it):
qwen2-0.5b, and moonshot-v1-16b-a3b (``slow``) at batch 4, ``accum`` 2 and
seq 64, whose microbatches of 2 rows split over ``data`` only, so that the
4 experts' weights stay split over ``model`` for compute (2 experts a rank,
each rank's row one whole group of 64 tokens): each rank's MoE layer
serves its 2 experts, and their placements are the same before and after
the steps. qwen2-0.5b and mamba2-370m run "dp" with ``accum`` 2 as well
(both tier-1, ~15 s and ~35 s): their microbatches of 2 rows leave
"model" idle too, so there each rank runs attention or the SSD scan on its
half of the heads (mamba2-370m's projections, conv and gated norm on its
half of the sequence or of the channels), and with ``accum`` 1 on all of
them (the rows split over both mesh dims); the "dp" cases report the heads
a rank's causal attention and scan saw.

qwen2-0.5b with 3 query heads over one KV head (``heads``), which do not
divide the 2 ranks of "model": under "sp" (tier-1, ~30 s) and under "dp"
with ``accum`` 2 (``slow``) each rank of "model" runs causal attention on
all 3 heads and its half of the queries against whole K/V, from its first
query's position (``attention._per_shard``), and the context comes back
to q's layout; its gradients reach K/V summed over the ranks.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_dist import run_world  # noqa: E402
from _torch_parity import jax_flat, port_model, torch_cfg  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

LOSS_RTOL = 1e-5
UPDATE_RTOL = 1e-3
PARAM_TOL = 2e-3
STEPS, BATCH, SEQ = 2, 4, 16
LR, WARMUP = 1e-3, 1
KIND = {"local_heads": "attn", "local_ssd_heads": "ssm"}  # the mixer a report counts


def _config(arch, heads=None):
    """The reduced ``arch``; with ``heads``, that many query heads over one
    KV head."""
    cfg = jax_reduced(jax_get_config(arch))
    return dataclasses.replace(cfg, num_heads=heads, num_kv_heads=1) if heads else cfg


def _reference_and_unsharded(arch, accum, seq, tmp_path, heads=None):
    """The JAX init written for the world; the initial parameters; and the
    losses, gradient norms and final parameters of the reference's and the
    port's unsharded steps."""
    cfg = _config(arch, heads)
    jm = jax_build(cfg)
    params = jm.init(jax.random.key(0))
    npz = str(tmp_path / "weights.npz")
    np.savez(npz, **{k.replace("/", "|"): v for k, v in jax_flat(params).items()})
    src = SyntheticLM(cfg.vocab_size, BATCH, seq, 0)
    batches = [src.batch_at(i) for i in range(STEPS)]

    opt_j = jopt.OptConfig(lr=LR, warmup_steps=WARMUP)
    jax_step = jax.jit(jstep.make_train_step(jm, opt_j, accum=accum))
    sj = {"params": params, "opt": jopt.init_opt_state(opt_j, params),
          "step": jnp.zeros((), jnp.int32)}
    ref = []
    for b in batches:
        sj, m = jax_step(sj, {k: jnp.asarray(v) for k, v in b.items()})
        ref.append((float(m["loss"]), float(m["grad_norm"])))

    tcfg = torch_cfg(cfg)
    tm = port_model(tcfg, params)
    opt_t = topt.OptConfig(lr=LR, warmup_steps=WARMUP)
    pt = {k: v.detach().clone() for k, v in tm.named_parameters()}
    init = {k: v.clone() for k, v in pt.items()}
    st = {"params": pt, "opt": topt.init_opt_state(opt_t, pt),
          "step": torch.zeros((), dtype=torch.int32)}
    step = tstep.make_train_step(tm, opt_t, accum=accum)
    mine = []
    for b in batches:
        st, m = step(st, {k: torch.from_numpy(v) for k, v in b.items()})
        mine.append((float(m["loss"]), float(m["grad_norm"])))
    ref_params = tstep.state_from_jax(tcfg, _ckpt_arrays(sj))["params"]
    return npz, init, ref, mine, st["params"], ref_params


def _ckpt_arrays(state):
    """A JAX state as ``state_from_jax`` takes it (``|``-joined paths)."""
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    return {"|".join(str(getattr(p, "key", p)) for p in path):
            torch.from_numpy(np.array(jnp.asarray(leaf, jnp.float32) if leaf.dtype != jnp.int32
                                      else leaf))
            for path, leaf in leaves}


def _worst_update_error(got, want, init):
    """The largest, over the leaves, of |got - want| / |want - init| (norms
    of the whole leaf): each leaf's update held against the other step's."""
    worst, at = 0.0, None
    for k, v in init.items():
        v = v.float().numpy()
        moved = np.linalg.norm(want[k] - v)
        assert moved > 0, f"{k}: the reference did not move it"
        err = np.linalg.norm(got[k] - want[k]) / moved
        if err > worst:
            worst, at = err, k
    return worst, at


@pytest.mark.parametrize("arch,accum,scheme,seq,heads", [
    pytest.param("qwen2-0.5b", 1, "sp", SEQ, None, id="qwen2-0.5b"),
    pytest.param("qwen2-0.5b", 2, "sp", SEQ, None, id="qwen2-0.5b-accum2"),
    pytest.param("qwen2-0.5b", 1, "dp", SEQ, None, id="qwen2-0.5b-dp"),
    pytest.param("qwen2-0.5b", 2, "dp", SEQ, None, id="qwen2-0.5b-dp-accum2"),
    pytest.param("qwen2-0.5b", 1, "sp", SEQ, 3, id="qwen2-0.5b-3heads"),
    pytest.param("qwen2-0.5b", 2, "dp", SEQ, 3, id="qwen2-0.5b-3heads-dp-accum2",
                 marks=pytest.mark.slow),
    pytest.param("mamba2-370m", 1, "sp", SEQ, None, id="mamba2-370m", marks=pytest.mark.slow),
    pytest.param("mamba2-370m", 2, "dp", SEQ, None, id="mamba2-370m-dp-accum2"),
    pytest.param("moonshot-v1-16b-a3b", 1, "sp", SEQ, None, id="moonshot-v1-16b-a3b",
                 marks=pytest.mark.slow),
    pytest.param("moonshot-v1-16b-a3b", 2, "dp", 64, None, id="moonshot-v1-16b-a3b-dp",
                 marks=pytest.mark.slow),
])
def test_sharded_steps_equal_the_unsharded_and_reference_steps(arch, accum, scheme, seq,
                                                               heads, tmp_path):
    npz, init, ref, mine, params, ref_params = _reference_and_unsharded(arch, accum, seq,
                                                                        tmp_path, heads)
    out = run_world("sharded_steps", 4, tmp_path, timeout=180 if arch != "qwen2-0.5b" else 120,
                    arch=arch, npz=npz, ckpt_dir=str(tmp_path / "ck"), steps=STEPS,
                    batch=BATCH, seq=seq, data=2, model_par=2, lr=LR, warmup_steps=WARMUP,
                    accum=accum, norm_kernel=arch == "qwen2-0.5b", scheme=scheme, heads=heads)
    got = list(zip(out["losses"], out["grad_norms"]))
    np.testing.assert_allclose(got, mine, rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=0)
    assert set(out["params"]) == set(params)
    final = {k: np.asarray(v, np.float32) for k, v in out["params"].items()}
    unsharded = {k: v.numpy() for k, v in params.items()}
    reference = {k: v.float().numpy() for k, v in ref_params.items()}
    for want in (unsharded, reference):
        worst, at = _worst_update_error(final, want, init)
        assert worst <= UPDATE_RTOL, f"{at}: update off by {worst:.3g} of itself"
        for k, v in want.items():
            np.testing.assert_allclose(final[k], v, atol=PARAM_TOL, rtol=PARAM_TOL, err_msg=k)
    # ZeRO-1: the moments are split over data as well as the parameters' split
    assert any(p[0].startswith("S(") for p in out["placements"].values()), out["placements"]
    assert out["restore_4x1"] is True and out["restore_1x1"] is True
    assert "Shard" in out["restore_4x1_m"], out["restore_4x1_m"]
    if arch == "qwen2-0.5b":
        assert out["kernel_calls"] > 0
    if heads:
        # 3 heads do not divide the 2 ranks of "model", which attention's rows
        # leave idle ("sp": the heads made whole; "dp" with 2 microbatches):
        # each rank of it runs all the heads on its half of the queries
        assert out["local_heads"] == [heads] and out["local_rows"] == [seq // 2], out
    elif scheme == "dp":
        # with 2 microbatches a microbatch's rows split over "data" only, and
        # each rank of the idle "model" dim runs attention and the SSD scan on
        # its half of the heads; with one, the rows split over both dims and
        # the heads stay whole
        cfg = jax_reduced(jax_get_config(arch))
        for key, h in (("local_heads", cfg.num_heads), ("local_ssd_heads", cfg.ssm_heads)):
            want = [] if not any(kind == KIND[key] for kind, _ in cfg.pattern()) else \
                [h // 2 if accum == 2 else h]
            assert out[key] == want, (key, out[key])
    if arch == "moonshot-v1-16b-a3b" and scheme == "dp":
        # the experts' weights stay split over "model" (mesh dim 1) through the steps
        assert out["experts_after"] == out["experts_before"], out["experts_after"]
        assert out["experts_after"] and all(p[1] == "S(0)" for p in out["experts_after"].values())
        assert out["local_experts"] == [2], out["local_experts"]  # 4 experts over 2 ranks
