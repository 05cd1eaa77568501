"""Port parity: the optimizer and the train step (repro_torch.train) against
the JAX reference (repro.train), on reduced qwen2-0.5b and mamba2-370m with
the JAX weights carried across.

Tolerances: the optimizer on identical inputs to 1e-6 (fp32 arithmetic in
both, summed in another order); the step's loss to 1e-5 and its gradients
to 1e-4 of each leaf's largest gradient (fp32 models, sums in another
order); the parameters after the step to 1e-6 twice over: the port's step
applies the gradients it computed, and the port's and JAX's optimizers fed
JAX's gradients give the same parameters. (Adam's first step moves a
parameter by lr * g / (|g| + eps), so where |g| is near eps a rounding of g
moves it by up to lr: two computations of the gradients are compared as
gradients, not through the step.)
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import close, jax_flat, np32, port_model, randn, torch_cfg  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.models.module import params_from_jax  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

OPT_TOL = 1e-6
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
LR = 1e-3
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# --- optimizer --------------------------------------------------------------

def _leaves(seed, dtype):
    shapes = {"a": (8, 16), "b": (16,), "c": (4, 4, 3)}
    j = {k: jnp.asarray(randn(seed + i, s), dtype) for i, (k, s) in enumerate(shapes.items())}
    j["b"] = j["b"].astype(jnp.float32)  # an fp32 leaf among low-precision ones, as norm scales
    t = {k: torch.from_numpy(np.array(np32(v))).to(TDT[str(v.dtype)]) for k, v in j.items()}
    return j, t


@pytest.mark.parametrize("step", [0, 5, 99, 100, 5000, 20000])
def test_schedule_matches_jax(step):
    cfg_j, cfg_t = jopt.OptConfig(lr=1e-3), topt.OptConfig(lr=1e-3)
    want = jopt.schedule(cfg_j, jnp.asarray(step, jnp.int32))
    got = topt.schedule(cfg_t, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=OPT_TOL, atol=0)


@pytest.mark.parametrize("dtype,keep_master,moment_dtype", [
    ("float32", True, "float32"),        # fp32 params: no master either way
    ("bfloat16", False, "float32"),      # bf16 params updated in fp32 and rounded back
    ("bfloat16", True, "float32"),       # fp32 master weights
    ("bfloat16", True, "bfloat16"),      # bf16 moments
])
def test_apply_updates_matches_jax(dtype, keep_master, moment_dtype):
    kw = dict(lr=1e-2, warmup_steps=1, keep_master=keep_master, moment_dtype=moment_dtype,
              grad_clip=0.5)
    cfg_j, cfg_t = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    pj, pt = _leaves(0, jdt)
    sj, st = jopt.init_opt_state(cfg_j, pj), topt.init_opt_state(cfg_t, pt)
    assert bool(sj["master"]) == bool(st["master"])
    for i in range(3):  # three steps: moments, bias corrections and the schedule move
        gj, gt = _leaves(10 + 3 * i, jdt)
        pj, sj, mj = jopt.apply_updates(cfg_j, pj, gj, sj)
        pt, st, mt = topt.apply_updates(cfg_t, pt, gt, st)
        close(mt["grad_norm"], mj["grad_norm"], OPT_TOL)
        close(mt["lr"], mj["lr"], OPT_TOL)
        assert int(st["count"]) == int(sj["count"]) == i + 1
        for k in pj:
            assert pt[k].dtype == TDT[str(pj[k].dtype)]
            tol = OPT_TOL if pj[k].dtype == jnp.float32 else 1e-2  # one bf16 rounding
            close(pt[k], pj[k], tol)
            close(st["m"][k], sj["m"][k], OPT_TOL if moment_dtype == "float32" else 1e-2)
            close(st["v"][k], sj["v"][k], OPT_TOL if moment_dtype == "float32" else 1e-2)
            if sj["master"]:
                close(st["master"][k], sj["master"][k], OPT_TOL)


def test_opt_state_shapes_are_meta():
    cfg = topt.OptConfig(moment_dtype="bfloat16")
    _, pt = _leaves(0, jnp.bfloat16)
    shapes = topt.opt_state_shapes(cfg, pt)
    real = topt.init_opt_state(cfg, pt)
    for part in ("m", "v", "master"):
        assert shapes[part].keys() == real[part].keys()
        for k, t in shapes[part].items():
            assert t.is_meta and t.shape == real[part][k].shape and t.dtype == real[part][k].dtype
    assert shapes["count"].is_meta and shapes["count"].dtype == torch.int32


# --- the train step ---------------------------------------------------------

def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})


def _port_flat(cfg, jax_tree):
    """A JAX parameter tree under the port's parameter names."""
    return params_from_jax(cfg, jax_flat(jax_tree))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m"])
@pytest.mark.parametrize("remat,accum", [("none", 1), ("full", 1), ("full", 2)])
def test_train_step_matches_jax(arch, remat, accum):
    cfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), remat=remat)
    jm = jax_build(cfg)
    params = jm.init(jax.random.key(0))
    opt_j = jopt.OptConfig(lr=LR, warmup_steps=1)
    opt_t = topt.OptConfig(lr=LR, warmup_steps=1)
    bj, bt = _batch(cfg, 2 * accum, 24)

    jax_step = jax.jit(jstep.make_train_step(jm, opt_j, accum=accum))
    sj = {"params": params, "opt": jopt.init_opt_state(opt_j, params),
          "step": jnp.zeros((), jnp.int32)}
    new_j, mj = jax_step(sj, bj)

    tcfg = torch_cfg(cfg)
    tm = port_model(tcfg, params)
    step = tstep.make_train_step(tm, opt_t, accum=accum)
    pt = {k: v.detach() for k, v in tm.named_parameters()}
    st = {"params": pt, "opt": topt.init_opt_state(opt_t, pt),
          "step": torch.zeros((), dtype=torch.int32)}
    new_t, mt = step(st, bt)

    assert set(mt) == set(mj)
    close(mt["loss"], mj["loss"], LOSS_TOL)
    close(mt["grad_norm"], mj["grad_norm"], LOSS_TOL)
    close(mt["lr"], mj["lr"], OPT_TOL)
    assert int(new_t["step"]) == 1 and int(new_t["opt"]["count"]) == 1

    # the gradients the step applies, against JAX's on the same (micro)batches
    def jloss(p):
        if accum == 1:
            return jm.loss(p, bj)[0]
        micro = [{k: v.reshape(accum, -1, v.shape[-1])[i] for k, v in bj.items()}
                 for i in range(accum)]
        return sum(jm.loss(p, mb)[0] for mb in micro) / accum
    jgrads = jax.grad(jloss)(params)
    gj = _port_flat(tcfg, jgrads)
    _, _, gt = step.compute_grads(pt, bt)
    assert gt.keys() == gj.keys()
    for k in gj:
        scale = float(np.abs(np32(gj[k])).max()) or 1.0
        np.testing.assert_allclose(np32(gt[k]), np32(gj[k]), atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=k)

    # parameters after the step: the step applies the gradients it computed,
    # and both optimizers fed JAX's gradients give the same parameters
    mine, _, _ = topt.apply_updates(opt_t, pt, gt, st["opt"])
    theirs, _, _ = topt.apply_updates(opt_t, pt, gj, st["opt"])
    want = _port_flat(tcfg, jopt.apply_updates(opt_j, params, jgrads, sj["opt"])[0])
    for k in want:
        close(new_t["params"][k], mine[k], OPT_TOL)
        close(theirs[k], want[k], OPT_TOL)


def test_init_state_and_state_shapes():
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model
    cfg = reduced_config(get_config("qwen2-0.5b"), dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    opt = topt.OptConfig()
    state = tstep.init_state(model, opt, torch.Generator().manual_seed(0))
    shapes = tstep.state_shapes(model, opt)
    assert state["params"].keys() == dict(model.named_parameters()).keys()
    assert state["opt"]["master"].keys() == state["params"].keys()  # bf16 params keep masters
    for k, t in state["params"].items():
        assert shapes["params"][k].is_meta and shapes["params"][k].shape == t.shape
        assert shapes["params"][k].dtype == t.dtype
    assert int(state["step"]) == 0 and shapes["step"].dtype == torch.int32
