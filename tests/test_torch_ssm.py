"""Port parity: repro_torch.models.ssm and the SSD scan vs the JAX reference.

Layers, the chunked scan (at chunk multiples and ragged lengths), the
kernel wrapper's plain path against the reference's Pallas kernel in
interpret mode, and reduced mamba2-370m with the JAX weights carried across
by ``params_from_jax``. The CUDA kernel itself runs only on the card:
``tests/test_torch_cuda_kernel.py`` (no JAX) and ``chip_smoke.py`` hold it
against ``ssd_chunked_ref`` there.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import MODEL_TOL, TOL, both, close, port_model, randn, torch_cfg  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.module import flatten  # noqa: E402

# the reference's SSD kernel tolerance, for y and the final state
# (tests/test_kernels.py::test_ssd_scan_allclose)
SSD_TOL = 2e-4
# the reference's SSD kernel-test shapes (b, l, h, p, n, chunk)
SSD_SHAPES = [(1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32), (1, 96, 1, 64, 32, 32)]


def _ssd_inputs(b, l, h, p, n, seed=0, dtype="float32"):
    """The reference test's input distributions, drawn with numpy."""
    xb = both(randn(seed, (b, l, h, p), 0.5), dtype)
    dt = both(np.log1p(np.exp(randn(seed + 1, (b, l, h)))).astype(np.float32))
    a_neg = both(-np.exp(randn(seed + 2, (h,), 0.3)).astype(np.float32))
    bm = both(randn(seed + 3, (b, l, n), 0.5), dtype)
    cm = both(randn(seed + 4, (b, l, n), 0.5), dtype)
    return [x for x, _ in (xb, dt, a_neg, bm, cm)], [t for _, t in (xb, dt, a_neg, bm, cm)]


@pytest.fixture
def jax_ssd_impl():
    """Set the JAX package's SSD path for one test, and restore "xla"."""
    yield jssm.set_ssd_impl
    jssm.set_ssd_impl("xla")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    x = both(randn(1, (2, 19, 24)), dtype)
    w = both(randn(2, (4, 24), 0.5), dtype)
    b = both(randn(3, (24,), 0.1), dtype)
    got = tssm._causal_conv(x[1], w[1], b[1])
    assert got.dtype == x[1].dtype and got.shape == (2, 19, 24)
    close(got, jssm._causal_conv(x[0], w[0], b[0]), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_step_matches_jax(dtype):
    buf = both(randn(4, (2, 3, 24)), dtype)
    x_t = both(randn(5, (2, 24)), dtype)
    w = both(randn(6, (4, 24), 0.5), dtype)
    b = both(randn(7, (24,), 0.1), dtype)
    got, got_buf = tssm._conv_step(buf[1], x_t[1], w[1], b[1])
    want, want_buf = jssm._conv_step(buf[0], x_t[0], w[0], b[0])
    close(got, want, TOL[dtype])
    close(got_buf, want_buf, 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_norm_matches_jax(dtype):
    y = both(randn(8, (2, 5, 32)), dtype)
    z = both(randn(9, (2, 5, 32)), dtype)
    scale = both(randn(10, (32,)))
    got = tssm._gated_norm(y[1], z[1], scale[1])
    assert got.dtype == y[1].dtype
    close(got, jssm._gated_norm(y[0], z[0], scale[0]), TOL[dtype])


@pytest.mark.parametrize("l", [32, 1, 11, 17])  # a chunk multiple, L = 1, L < chunk, chunk + 1
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_ref_matches_jax(l, dtype):
    jx, tx = _ssd_inputs(2, l, 3, 8, 4, seed=20, dtype=dtype)
    y, s = tssm.ssd_chunked_ref(*tx, chunk=16)
    yw, sw = jssm.ssd_chunked_ref(*jx, chunk=16)
    assert y.shape == (2, l, 3, 8) and y.dtype == tx[0].dtype
    assert s.shape == (2, 3, 4, 8) and s.dtype == torch.float32
    close(y, yw, TOL[dtype])
    close(s, sw, TOL["float32"])


def _ssm_cfg(dtype="float32"):
    return jax_reduced(jax_get_config("mamba2-370m"), dtype=dtype)


def _ssm_params(cfg, seed=3):
    """The reduced mixer's parameters from the JAX init (a_log, dt_bias and
    the conv biases drawn too, so no term is trivially zero)."""
    from repro.models.module import init_params
    p = init_params(jssm.ssm_spec(cfg), jax.random.key(seed), jnp.dtype(cfg.dtype))
    for i, k in enumerate(("a_log", "dt_bias", "conv_bias_x", "conv_bias_b", "conv_bias_c")):
        p[k] = jnp.asarray(randn(40 + i, p[k].shape, 0.3), p[k].dtype)
    tdt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if v.dtype == jnp.float32 else tdt) for k, v in p.items()}
    return p, tp


@pytest.mark.parametrize("l", [32, 21])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_ssm_matches_jax(l, dtype):
    cfg = _ssm_cfg(dtype)
    jp, tp = _ssm_params(cfg)
    x = both(randn(11, (2, l, cfg.d_model)), dtype)
    tol = TOL[dtype]
    got, s = tssm.apply_ssm(tp, torch_cfg(cfg), x[1])
    want, sw = jssm.apply_ssm(jp, cfg, x[0])
    close(got, want, tol)
    close(s, sw, tol)
    got, cache = tssm.apply_ssm(tp, torch_cfg(cfg), x[1], return_cache=True)
    want, cw = jssm.apply_ssm(jp, cfg, x[0], return_cache=True)
    close(got, want, tol)
    assert set(cache) == set(cw) == {"state", "conv_x", "conv_b", "conv_c"}
    for k in cache:
        assert tuple(cache[k].shape) == cw[k].shape
        close(cache[k], cw[k], tol)
    assert cache["state"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ssm_matches_jax(dtype):
    cfg = _ssm_cfg(dtype)
    jp, tp = _ssm_params(cfg)
    shapes = tssm.ssm_cache_shape(torch_cfg(cfg), 2)
    assert shapes == jssm.ssm_cache_shape(cfg, 2)
    jc, tc = {}, {}
    for i, (k, shp) in enumerate(shapes.items()):
        jc[k], tc[k] = both(randn(50 + i, shp, 0.5), "float32" if k == "state" else dtype)
    x = both(randn(12, (2, 1, cfg.d_model)), dtype)
    got, gc = tssm.decode_ssm(tp, torch_cfg(cfg), x[1], tc)
    want, wc = jssm.decode_ssm(jp, cfg, x[0], jc)
    close(got, want, TOL[dtype])
    for k in shapes:
        close(gc[k], wc[k], TOL[dtype])
    assert gc["state"].dtype == torch.float32


# ---------------------------------------------------------------------------
# The kernel's function: the wrapper's plain path against the TPU kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,l,h,p,n,chunk", SSD_SHAPES)
def test_ops_ssd_scan_matches_pallas_interpret(b, l, h, p, n, chunk):
    jx, tx = _ssd_inputs(b, l, h, p, n, seed=30)
    y, s = tops.ssd_scan(*tx, chunk)
    yw, sw = jops.ssd_scan(*jx, chunk, interpret=True)
    assert y.shape == (b, l, h, p) and s.shape == (b, h, n, p)
    close(y, yw, SSD_TOL)
    close(s, sw, SSD_TOL)


@pytest.mark.parametrize("l", [1, 67, 130])
def test_ops_ssd_scan_ragged_matches_jax_ref(l):
    # the Pallas kernel needs l % chunk == 0; the reference pads in ssd_chunked_ref
    jx, tx = _ssd_inputs(2, l, 4, 32, 16, seed=31)
    y, s = tops.ssd_scan(*tx, 64)
    yw, sw = jssm.ssd_chunked_ref(*jx, 64)
    close(y, yw, SSD_TOL)
    close(s, sw, SSD_TOL)


@pytest.mark.parametrize("b,l,h,p,n,chunk", SSD_SHAPES[:2])
def test_ssd_scan_ref_matches_reference_oracle(b, l, h, p, n, chunk):
    # the kernel layout (B,H,L,P) of the reference's ref.ssd_scan_ref
    jx, tx = _ssd_inputs(b, l, h, p, n, seed=32)
    jx[0], jx[1] = jnp.moveaxis(jx[0], 1, 2), jnp.moveaxis(jx[1], 1, 2)
    tx[0], tx[1] = tx[0].transpose(1, 2), tx[1].transpose(1, 2)
    close(tref.ssd_scan_ref(*tx, chunk), jref.ssd_scan_ref(*jx, chunk), SSD_TOL)


def test_ssd_impl_switch():
    _, tx = _ssd_inputs(1, 8, 2, 16, 8, seed=33)
    assert tssm.get_ssd_impl() is None
    with pytest.raises(ValueError, match="not in"):
        tssm.set_ssd_impl("pallas")
    tssm.set_ssd_impl("cuda")
    try:
        with pytest.raises(ValueError, match="card only"):
            tssm.ssd_chunked(*tx, chunk=4)
    finally:
        tssm.set_ssd_impl(None)
    tssm.set_ssd_impl("plain")
    try:
        y, _ = tssm.ssd_chunked(*tx, chunk=4)
    finally:
        tssm.set_ssd_impl(None)
    close(y, tssm.ssd_chunked_ref(*tx, chunk=4)[0], 0.0)


# ---------------------------------------------------------------------------
# Reduced mamba2-370m
# ---------------------------------------------------------------------------

B = 2


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    cfg = _ssm_cfg(request.param)
    jm = jax_build(cfg)
    params = jm.init(jax.random.key(0))
    return request.param, cfg, jm, params, port_model(torch_cfg(cfg), params)


def _tokens(vocab, s):
    t = (np.arange(B * s, dtype=np.int32).reshape(B, s) * 7) % (vocab - 1)
    return jnp.asarray(t), torch.from_numpy(t)


def _tol(dtype):
    return MODEL_TOL if dtype == "float32" else TOL["bfloat16"]


@pytest.mark.parametrize("impl,s", [("pallas_interpret", 32), ("xla", 37)])
def test_forward_matches_jax(pair, jax_ssd_impl, impl, s):
    dtype, cfg, jm, params, tm = pair
    tj, tt = _tokens(cfg.vocab_size, s)
    jax_ssd_impl(impl)
    want, _ = jm.forward(params, {"tokens": tj})
    with torch.no_grad():
        got, _ = tm.forward({"tokens": tt})
    assert got.shape == want.shape == (B, s, 512)
    close(got, want, _tol(dtype))


@pytest.mark.parametrize("impl,s", [("pallas_interpret", 32), ("xla", 37)])
def test_prefill_matches_jax(pair, jax_ssd_impl, impl, s):
    dtype, cfg, jm, params, tm = pair
    tj, tt = _tokens(cfg.vocab_size, s)
    jax_ssd_impl(impl)
    want, jcache = jm.prefill(params, {"tokens": tj})
    got, tcache = tm.prefill({"tokens": tt})
    close(got, want, _tol(dtype))
    assert len(tcache) == cfg.num_layers
    for i, c in enumerate(tcache):
        assert set(c) == {"state", "conv_x", "conv_b", "conv_c"}
        assert c["state"].dtype == torch.float32
        for k, v in c.items():
            close(v, jcache["L0"][k][i], _tol(dtype))


def test_decode_steps_match_jax(pair):
    dtype, cfg, jm, params, tm = pair
    tj, tt = _tokens(cfg.vocab_size, 16)
    _, jcache = jm.prefill(params, {"tokens": tj})
    _, tcache = tm.prefill({"tokens": tt})
    for k in range(3):
        nxt = np.full((B, 1), 5 + k, np.int32)
        pos = np.full((B,), 16 + k, np.int32)
        want, jcache = jm.decode_step(params, jcache, jnp.asarray(nxt), jnp.asarray(pos))
        got, tcache = tm.decode_step(tcache, torch.from_numpy(nxt), torch.from_numpy(pos))
        close(got, want, _tol(dtype))
    for i, c in enumerate(tcache):
        close(c["state"], jcache["L0"]["state"][i], _tol(dtype))


def test_prefill_decode_teacher_forcing():
    """Prefill on S tokens then k decode steps == forward on S + k (fp32):
    the state takes in every decoded token."""
    cfg = reduced_config(get_config("mamba2-370m"))
    tm = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    s, k = 21, 4
    _, tt = _tokens(cfg.vocab_size, s + k)
    with torch.no_grad():
        full, _ = tm.forward({"tokens": tt})
    _, cache = tm.prefill({"tokens": tt[:, :s]})
    for i in range(k):
        step, cache = tm.decode_step(cache, tt[:, s + i:s + i + 1],
                                     torch.full((B,), s + i, dtype=torch.int32))
        close(step[:, 0], full[:, s + i], MODEL_TOL)


def test_param_spec_matches_jax():
    cfg = _ssm_cfg()
    leaves = jax.tree_util.tree_flatten_with_path(jax_build(cfg).init_shape())[0]
    want = {"/".join(p.key for p in path): leaf.shape for path, leaf in leaves}
    model = build_model(torch_cfg(cfg), device="meta")
    got = {k: ps.shape for k, ps in flatten(model.param_spec()).items()}
    assert got == want
    assert [type(layer).__name__ for layer in model.layers] == ["SSMLayer"] * cfg.num_layers


def test_full_config_param_count():
    cfg = get_config("mamba2-370m")
    assert cfg.param_count() == 368_494_080
    assert cfg.param_count() == jax_build(jax_get_config("mamba2-370m")).param_count()


def test_build_model_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(get_config("mamba2-370m"))
