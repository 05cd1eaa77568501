"""Port parity: repro_torch.models.attention vs the JAX reference."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import TOL, both, close, randn, torch_cfg  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _cfg(**kw):
    # reduced qwen2: 4 heads, 2 KV heads, head_dim 16, QKV bias
    cfg = jax_reduced(jax_get_config("qwen2-0.5b"))
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _attn_params(cfg, seed=20):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    shapes = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d),
              "bq": (h * hd,), "bk": (kv * hd,), "bv": (kv * hd,)}
    return {k: randn(seed + i, s, 0.15) for i, (k, s) in enumerate(shapes.items())}


def _split(p, dtype="float32"):
    pairs = {k: both(v, dtype) for k, v in p.items()}
    return {k: j for k, (j, _) in pairs.items()}, {k: t for k, (_, t) in pairs.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True])
def test_dot_attention(dtype, masked):
    q, k, v = (both(randn(s, (2, 9, 4, 16)), dtype) for s in (1, 2, 3))
    mask = None
    if masked:
        m = (np.arange(9)[None, :] <= np.arange(9)[:, None])[None, None]
        mask = (jnp.asarray(m), torch.from_numpy(m))
    got = TA.dot_attention(q[1], k[1], v[1], None if mask is None else mask[1])
    want = JA.dot_attention(q[0], k[0], v[0], None if mask is None else mask[0])
    assert got.dtype == q[1].dtype
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_attention_plain(dtype):
    q, k, v = (both(randn(s, (2, 33, 4, 16)), dtype) for s in (4, 5, 6))
    close(TA.causal_attention(q[1], k[1], v[1]), JA.causal_attention(q[0], k[0], v[0]),
          TOL[dtype])


def test_causal_attention_chunked_path(monkeypatch):
    s = TA.CHUNK_THRESHOLD + TA.CHUNK_Q  # > threshold and a multiple of the chunk
    q, k, v = (both(randn(sd, (1, s, 1, 16))) for sd in (7, 8, 9))
    calls = []
    real = TA._chunked_causal_attention
    monkeypatch.setattr(TA, "_chunked_causal_attention",
                        lambda *a: calls.append(a[3]) or real(*a))
    got = TA.causal_attention(q[1], k[1], v[1])
    assert calls == [TA.CHUNK_Q]
    close(got, JA.causal_attention(q[0], k[0], v[0]), TOL["float32"])


def test_expand_kv():
    cfg = _cfg()
    k = both(randn(10, (2, 5, cfg.num_kv_heads, 16)))
    close(TA._expand_kv(k[1], cfg.num_heads), JA._expand_kv(cfg, k[0]), 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_apply_self_attn(dtype, causal):
    cfg = _cfg()
    pj, pt = _split(_attn_params(cfg), dtype)
    x = both(randn(11, (2, 12, cfg.d_model)), dtype)
    pos = np.arange(12, dtype=np.int32)[None, :]
    yt, (kt, vt) = TA.apply_self_attn(pt, torch_cfg(cfg), x[1], torch.from_numpy(pos), causal)
    yj, (kj, vj) = JA.apply_self_attn(pj, cfg, x[0], jnp.asarray(pos), causal=causal)
    close(yt, yj, TOL[dtype])
    close(kt, kj, TOL[dtype])
    close(vt, vj, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_self_attn_through_kernel_wrapper(dtype, monkeypatch):
    # the kernel path: causal_attention hands grouped K/V (2 KV heads of 4)
    # to kernels.ops.flash_attention unexpanded; on the CPU that wrapper
    # expands them and runs attention_ref. The reference runs its Pallas
    # kernel in interpret mode on its pre-expanded K/V.
    cfg = _cfg()
    assert cfg.num_kv_heads < cfg.num_heads
    pj, pt = _split(_attn_params(cfg, 40), dtype)
    x = both(randn(41, (2, 13, cfg.d_model)), dtype)
    pos = np.arange(13, dtype=np.int32)[None, :]
    from repro_torch.kernels import ops as kops
    seen = []
    real = kops.flash_attention
    monkeypatch.setattr(TA, "_use_kernel", lambda q: True)
    monkeypatch.setattr(kops, "flash_attention",
                        lambda q, k, v, causal=True, q_offset=0:
                        seen.append(k.shape) or real(q, k, v, causal, q_offset))
    yt, _ = TA.apply_self_attn(pt, torch_cfg(cfg), x[1], torch.from_numpy(pos))
    assert seen == [(2, 13, cfg.num_kv_heads, cfg.resolved_head_dim)]
    impl = JA.get_attention_impl()
    try:
        JA.set_attention_impl("pallas_interpret")
        yj, _ = JA.apply_self_attn(pj, cfg, x[0], jnp.asarray(pos), causal=True)
    finally:
        JA.set_attention_impl(impl)
    close(yt, yj, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("first,n", [(0, 7), (7, 7), (14, 7), (5, 16)])
def test_causal_attention_query_block(dtype, kernel, first, n, monkeypatch):
    # a rank's block of the queries (q_offset = its first position) against
    # whole grouped K/V, through the plain path or the kernel wrapper (the
    # kernel's plain version on the CPU): the reference's whole causal
    # attention's rows of that block
    q = both(randn(45, (2, 21, 6, 16)), dtype)
    k, v = (both(randn(s, (2, 21, 2, 16)), dtype) for s in (46, 47))
    monkeypatch.setattr(TA, "_use_kernel", lambda q: kernel)
    got = TA.causal_attention(q[1][:, first:first + n], k[1], v[1], q_offset=first)
    want = JA.causal_attention(q[0], jnp.repeat(k[0], 3, axis=2), jnp.repeat(v[0], 3, axis=2))
    assert got.shape == (2, min(n, 21 - first), 6, 16)
    close(got, want[:, first:first + n], TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_attention_plain_expands_grouped_kv(dtype):
    # the plain path takes grouped K/V too and matches the pre-expanded call
    q = both(randn(42, (2, 21, 6, 16)), dtype)
    k, v = (both(randn(s, (2, 21, 2, 16)), dtype) for s in (43, 44))
    kx, vx = (t[1].repeat_interleave(3, dim=2) for t in (k, v))
    assert torch.equal(TA.causal_attention(q[1], k[1], v[1]), TA.causal_attention(q[1], kx, vx))
    close(TA.causal_attention(q[1], k[1], v[1]),
          JA.causal_attention(q[0], jnp.repeat(k[0], 3, axis=2), jnp.repeat(v[0], 3, axis=2)),
          TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos", [[3, 3], [5, 2], [8, 8]])
def test_decode_self_attn(dtype, pos):
    # pos[0] inside the cache writes there; pos[0] == smax (the engine's
    # prompt-sized cache) writes nothing; masks follow each request's pos
    cfg = _cfg()
    pj, pt = _split(_attn_params(cfg, 30), dtype)
    smax = 8
    x = both(randn(12, (2, 1, cfg.d_model)), dtype)
    cache = {n: both(randn(s, (2, smax, cfg.num_kv_heads, 16)), dtype)
             for n, s in (("k", 13), ("v", 14))}
    p = np.asarray(pos, np.int32)
    yt, ct = TA.decode_self_attn(pt, torch_cfg(cfg), x[1],
                                 {n: t for n, (_, t) in cache.items()}, torch.from_numpy(p))
    yj, cj = JA.decode_self_attn(pj, cfg, x[0], {n: j for n, (j, _) in cache.items()},
                                 jnp.asarray(p))
    close(yt, yj, TOL[dtype])
    for n in ("k", "v"):
        close(ct[n], cj[n], TOL[dtype])
    if pos[0] >= smax:
        assert torch.equal(ct["k"], cache["k"][1])


def test_kv_cache_shape():
    cfg = _cfg()
    assert TA.kv_cache_shape(torch_cfg(cfg), 3, 7) == JA.kv_cache_shape(cfg, 3, 7)


def test_attention_impl_switch():
    q, k, v = (torch.from_numpy(randn(s, (1, 6, 2, 16))) for s in (1, 2, 3))
    assert TA.get_attention_impl() is None
    default = TA.causal_attention(q, k, v)  # CPU tensors: the plain path
    try:
        TA.set_attention_impl("plain")
        assert torch.equal(TA.causal_attention(q, k, v), default)
        TA.set_attention_impl("cuda")
        with pytest.raises(ValueError, match="card"):
            TA.causal_attention(q, k, v)
        with pytest.raises(ValueError):
            TA.set_attention_impl("pallas")
    finally:
        TA.set_attention_impl(None)
