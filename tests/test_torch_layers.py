"""Port parity: repro_torch.models.layers / module vs the JAX reference."""

import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import TOL, both, close, jax_flat, np32, randn  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind, dtype):
    x = randn(0, (2, 5, 32), 3.0)
    p = {"scale": randn(1, (32,)) + 1.0}
    if kind == "layernorm":
        p["bias"] = randn(2, (32,))
    xj, xt = both(x, dtype)
    got = TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, xt)
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, xj)
    assert got.dtype == xt.dtype
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("style", ["full", "2d"])
def test_apply_rope(style, dtype):
    x = randn(3, (2, 12, 3, 16))
    pos = (np.arange(12, dtype=np.int32)[None, :] * 3 + np.array([[0], [5]])).astype(np.int32)
    xj, xt = both(x, dtype)
    got = TL.apply_rope(xt, torch.from_numpy(pos), 10_000.0, style)
    want = JL.apply_rope(xj, jnp.asarray(pos), 10_000.0, style)
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_mlp(dtype):
    x = randn(4, (2, 7, 32))
    wi, wo = randn(5, (32, 2, 48), 0.2), randn(6, (48, 32), 0.2)
    xj, xt = both(x, dtype)
    got = TL.apply_mlp({"wi": both(wi, dtype)[1], "wo": both(wo, dtype)[1]}, xt)
    want = JL.apply_mlp({"wi": both(wi, dtype)[0], "wo": both(wo, dtype)[0]}, xj)
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("v", [1, 255, 256, 257, 151936, 51865])
def test_padded_vocab(v):
    assert TL.padded_vocab(v) == JL.padded_vocab(v)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_embed_unembed(tied, softcap):
    vocab, rows, d = 300, TL.padded_vocab(300), 16
    p = {"table": randn(7, (rows, d))}
    if not tied:
        p["unembed"] = randn(8, (d, rows))
    tokens = np.array([[0, 5, 299], [17, 3, 42]], np.int32)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = TL.embed_tokens(pt, torch.from_numpy(tokens), torch.float32)
    xj = JL.embed_tokens(pj, jnp.asarray(tokens), jnp.float32)
    close(xt, xj, 0)
    got = TL.unembed(pt, xt, softcap, vocab)
    want = JL.unembed(pj, xj, softcap, vocab)
    assert got.dtype == torch.float32 and got.shape == (2, 3, rows)
    assert (got[..., vocab:] == -1e30).all()
    close(got, want, TOL["float32"])


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy(masked):
    logits = randn(9, (3, 6, 40), 2.0)
    labels = np.random.default_rng(10).integers(0, 40, (3, 6)).astype(np.int32)
    mask = (np.arange(6)[None, :] < np.array([[6], [2], [0]])).astype(np.float32)
    args_t = [torch.from_numpy(logits), torch.from_numpy(labels)]
    args_j = [jnp.asarray(logits), jnp.asarray(labels)]
    if masked:
        args_t.append(torch.from_numpy(mask))
        args_j.append(jnp.asarray(mask))
    close(TL.cross_entropy(*args_t), JL.cross_entropy(*args_j), TOL["float32"])


def test_init_params_follows_reference_initialisers():
    from repro_torch.models.module import init_params, spec
    tree = {"w": spec((64, 2, 96), ("embed", None, "mlp")),
            "small": spec((256, 128), ("a", "b"), "small"),
            "e": spec((512, 32), ("vocab", "embed"), "embed", scale=0.02),
            "n": {"scale": spec((32,), ("embed",), "ones", dtype=torch.float32)},
            "b": spec((96,), ("mlp",), "zeros")}
    a = init_params(tree, torch.Generator().manual_seed(3), torch.bfloat16, "cpu")
    again = init_params(tree, torch.Generator().manual_seed(3), torch.bfloat16, "cpu")
    assert sorted(a) == ["b", "e", "n/scale", "small", "w"]
    assert all(torch.equal(a[k], again[k]) for k in a)
    assert a["w"].dtype == torch.bfloat16 and a["n/scale"].dtype == torch.float32
    assert (a["n/scale"] == 1).all() and (a["b"] == 0).all()
    # fan-in scaling: every dim but the last is fan-in
    assert abs(a["w"].float().std().item() * math.sqrt(128) - 1) < 0.05
    assert abs(a["small"].float().std().item() * math.sqrt(256) / 0.1 - 1) < 0.05
    assert abs(a["e"].float().std().item() / 0.02 - 1) < 0.05


def test_params_from_jax_is_exact_for_bf16():
    import jax
    from repro.models import build_model as jax_build
    from repro_torch.models.module import params_from_jax
    from _torch_parity import torch_cfg

    cfg = jax_reduced(jax_get_config("qwen2-0.5b"), dtype="bfloat16")
    params = jax_build(cfg).init(jax.random.key(0))
    state = params_from_jax(torch_cfg(cfg), jax_flat(params))
    wq = np.asarray(params["layers"]["L0"]["mixer"]["wq"])  # (periods, D, H*hd) bf16
    for j in range(cfg.num_periods):
        got = state[f"layers.{j}.mixer.wq"]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(np32(got), wq[j].astype(np.float32))
    assert state["layers.0.norm1.scale"].dtype == torch.float32
    assert state["embed.table"].shape == (512, 64)
