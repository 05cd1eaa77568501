"""Port parity: repro_torch.models.moe against the JAX reference.

``capacity`` and ``moe_flops_per_token`` equal the reference's;
``apply_moe``'s output and aux loss hold to the reference's at the layer
tolerance (fp32 1e-5, bf16 2e-2) on the same numpy inputs, at a token count
that fills its groups and at ones that pad the last group with zero rows,
and so do the gradients of a loss through it (router included). Top-k breaks
ties toward the lower expert index, as ``jax.lax.top_k``: a padded zero
row's gates are exactly uniform.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import TOL, both, close, np32, randn, torch_cfg  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.core.randomgen import random_lm_config as jax_random_lm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

MOE_ARCHS = ["moonshot-v1-16b-a3b", "arctic-480b", "jamba-v0.1-52b"]
# the reference's capacities at moe_group_size 512
CAPACITIES = {"moonshot-v1-16b-a3b": 60, "arctic-480b": 12, "jamba-v0.1-52b": 80}


def _cfg(arch="moonshot-v1-16b-a3b", **kw):
    """A reduced MoE config: 4 experts, top 2, d 64, d_ff 128, groups of 64."""
    return dataclasses.replace(jax_reduced(jax_get_config(arch)), **kw)


def _params(cfg, seed=0, dtype="float32"):
    """The MoE block's parameters, drawn with numpy at the reference's
    scales (router "small"); (jax dict, torch dict)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    shapes = {"router": ((d, e), 0.1 / np.sqrt(d)), "wi": ((e, d, 2, f), 1 / np.sqrt(e * d * 2)),
              "wo": ((e, f, d), 1 / np.sqrt(e * f))}
    out = {k: both(randn(seed + i, shp, sc), "float32" if k == "router" else dtype)
           for i, (k, (shp, sc)) in enumerate(shapes.items())}
    return {k: j for k, (j, _) in out.items()}, {k: t for k, (_, t) in out.items()}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_matches_jax(arch):
    cfg = jax_get_config(arch)
    assert tmoe.capacity(torch_cfg(cfg), 512) == jmoe.capacity(cfg, 512) == CAPACITIES[arch]
    for gs in (1, 7, 64, 100, 513):
        assert tmoe.capacity(torch_cfg(cfg), gs) == jmoe.capacity(cfg, gs)


@pytest.mark.parametrize("arch", MOE_ARCHS + ["rand_lm_7", "rand_lm_11"])
def test_moe_flops_per_token_matches_jax(arch):
    cfg = (jax_random_lm(int(arch.rsplit("_", 1)[1])) if arch.startswith("rand_lm")
           else jax_get_config(arch))
    assert cfg.num_experts
    assert tmoe.moe_flops_per_token(torch_cfg(cfg)) == jmoe.moe_flops_per_token(cfg)


def test_top_k_breaks_ties_toward_the_lower_index():
    uniform = torch.full((2, 64), 1 / 64)
    vals, idx = tmoe.top_k(uniform, 6)
    assert idx.tolist() == [list(range(6))] * 2 and (vals == 1 / 64).all()
    # ties among other values, against jax.lax.top_k
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1], [0.5, 0.1, 0.5, 0.1, 0.5, 0.5]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = tmoe.top_k(torch.from_numpy(x), 4)
    assert ti.tolist() == np.asarray(ji).tolist()
    assert tv.tolist() == np.asarray(jv).tolist()


def test_one_hot_matches_jax():
    idx = np.array([[0, 3, 1], [2, 2, 0]], np.int32)
    want = jax.nn.one_hot(jnp.asarray(idx), 4, dtype=jnp.float32)
    got = tmoe.one_hot(torch.from_numpy(idx), 4)
    assert got.dtype == torch.float32 and (np32(got) == np32(want)).all()


# (batch, seq): one full group of 64, a last group padded with 28 zero rows
# (100 tokens), and fewer tokens than the group size (one group of 50)
SHAPES = [(2, 32), (2, 50), (1, 50)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s", SHAPES)
def test_apply_moe_matches_jax(b, s, dtype):
    cfg = _cfg(dtype=dtype)
    pj, pt = _params(cfg, dtype=dtype)
    xj, xt = both(randn(7, (b, s, cfg.d_model)), dtype)
    want, want_aux = jmoe.apply_moe(pj, cfg, xj)
    got, got_aux = tmoe.apply_moe(pt, torch_cfg(cfg), xt)
    assert got.shape == (b, s, cfg.d_model) and got.dtype == xt.dtype
    assert got_aux.dtype == torch.float32 and got_aux.shape == ()
    close(got, want, TOL[dtype])
    close(got_aux, want_aux, TOL["float32"])


def test_apply_moe_drops_tokens_over_capacity_as_jax():
    """A router that sends every token to experts 0 and 1 overflows their
    capacity; the same tokens are dropped (token-major priority)."""
    cfg = _cfg()
    pj, pt = _params(cfg)
    bias = np.zeros((cfg.d_model, cfg.num_experts), np.float32)
    bias[:, :2] = 1.0
    pj["router"], pt["router"] = (pj["router"] + bias, pt["router"] + torch.from_numpy(bias))
    xj, xt = both(np.abs(randn(8, (2, 50, cfg.d_model))))
    want, want_aux = jmoe.apply_moe(pj, cfg, xj)
    got, got_aux = tmoe.apply_moe(pt, torch_cfg(cfg), xt)
    dropped = np.abs(np32(want)).reshape(-1, cfg.d_model).max(-1) == 0
    assert dropped.sum() > 0  # the capacity bound bit
    close(got, want, TOL["float32"])
    close(got_aux, want_aux, TOL["float32"])


@pytest.mark.parametrize("b,s", [(2, 32), (2, 50)])
def test_apply_moe_gradients_match_jax(b, s):
    """Gradients of sum(y * w) + aux with respect to the router, the
    experts and x, within 1e-5 of each one's largest (the router's reaches
    it through the top-k values and, padded rows included, the aux loss)."""
    cfg = _cfg()
    pj, pt = _params(cfg)
    xj, xt = both(randn(9, (b, s, cfg.d_model)))
    wj, wt = both(randn(10, (b, s, cfg.d_model)))

    def jloss(p, x):
        y, aux = jmoe.apply_moe(p, cfg, x)
        return jnp.sum(y * wj) + aux
    gj, gxj = jax.grad(jloss, argnums=(0, 1))(pj, xj)
    leaves = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    xt = xt.clone().requires_grad_(True)
    y, aux = tmoe.apply_moe(leaves, torch_cfg(cfg), xt)
    (y * wt).sum().add(aux).backward()
    for name, got, want in ([(k, leaves[k].grad, gj[k]) for k in pj] + [("x", xt.grad, gxj)]):
        scale = float(np.abs(np32(want)).max())
        assert scale > 0, name
        np.testing.assert_allclose(np32(got), np32(want), atol=1e-5 * scale, rtol=0,
                                   err_msg=name)


def test_aux_loss_counts_padded_rows_as_jax():
    """The Switch aux loss averages over the padded rows too: 100 tokens in
    groups of 64 leave 28 zero rows, which route to experts 0 and 1. Its aux
    equals that of the same 100 tokens followed by 28 zero tokens, and
    differs from that of one group of 100, which pads nothing."""
    cfg = _cfg()
    tcfg = torch_cfg(cfg)
    pj, pt = _params(cfg)
    xj, xt = both(randn(11, (2, 50, cfg.d_model)))
    _, want = jmoe.apply_moe(pj, cfg, xj)
    _, got = tmoe.apply_moe(pt, tcfg, xt)
    close(got, want, TOL["float32"])
    zeros = torch.zeros(1, 28, cfg.d_model)
    _, explicit = tmoe.apply_moe(pt, tcfg, torch.cat([xt.reshape(1, 100, -1), zeros], 1))
    _, unpadded = tmoe.apply_moe(pt, torch_cfg(dataclasses.replace(cfg, moe_group_size=100)), xt)
    assert float(got) == float(explicit)
    assert abs(float(got) - float(unpadded)) > 1e-6
