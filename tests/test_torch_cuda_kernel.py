"""The hand-written kernels' wrappers (flash attention, SSD chunked scan,
RMSNorm forward and backward), and the kernels on the card.

Imports no JAX, so the whole file also runs on the card's machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernel.py

On a host without CUDA the tests of the kernel itself skip (it has no CPU
mode); the wrapper's refusals are checked everywhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.ref import attention_ref, rmsnorm_ref  # noqa: E402
from repro_torch.models.ssm import ssd_chunked_ref  # noqa: E402

# the reference's kernel tolerances (tests/test_kernels.py)
KTOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _randn(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def test_cuda_wrapper_refuses_cpu_tensors():
    # the kernel's own wrapper never falls back to the plain version
    q = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bhsd(q, q, q)
    assert fa.launches == 0


def test_cuda_wrapper_refuses_autograd_inputs():
    # the kernel has no backward: a tracked input must not lose its gradient
    q = torch.zeros(2, 8, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="set_attention_impl"):
        fa.flash_attention_bhsd(q, q.detach(), q.detach())
    assert fa.launches == 0


@pytest.mark.parametrize("shape,dtype,match", [
    ((2, 8, 48), torch.float32, "head_dim"),
    ((2, 8, 64), torch.float16, "dtypes"),
])
def test_cuda_wrapper_rejects_unsupported_inputs(shape, dtype, match):
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        fa.flash_attention_bhsd(q, q, q)


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(kbuild.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.nvcc()


def test_library_is_named_by_source_hash():
    path = fa.LIBRARY.path()
    assert path.parent == kbuild.BUILD_DIR and path.name.startswith("libflash_attention-")
    assert path == fa.LIBRARY.path()


def _ssd_inputs(b, l, h, p, n, seed=0, dtype=torch.float32, slow=False):
    """The reference kernel test's distributions; ``slow`` scales dt down so
    the state carries across many chunks."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    dt = torch.nn.functional.softplus(draw(b, l, h) - (4.0 if slow else 0.0))
    return (0.5 * draw(b, l, h, p)).to(dtype), dt, -torch.exp(0.3 * draw(h)), \
        (0.5 * draw(b, l, n)).to(dtype), (0.5 * draw(b, l, n)).to(dtype)


def test_ssd_wrapper_refuses_cpu_tensors():
    before = ssd.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_blhp(*_ssd_inputs(1, 8, 2, 16, 8), chunk=4)
    assert ssd.launches == before


def test_ssd_wrapper_refuses_autograd_inputs():
    # the kernel has no backward: a tracked input must not lose its gradient
    xb, dt, a_neg, bm, cm = _ssd_inputs(1, 8, 2, 16, 8)
    before = ssd.launches
    with pytest.raises(RuntimeError, match="set_ssd_impl"):
        ssd.ssd_scan_blhp(xb.requires_grad_(), dt, a_neg, bm, cm, chunk=4)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_blhp(xb, dt, a_neg, bm, cm, chunk=4)  # no_grad passes the check
    assert ssd.launches == before


@pytest.mark.parametrize("p,n,chunk,dtype,dt_dtype,match", [
    (48, 16, 16, torch.float32, torch.float32, "head_dim"),
    (16, 12, 16, torch.float32, torch.float32, "state dim"),
    (16, 16, 512, torch.float32, torch.float32, "chunk"),
    (16, 16, 0, torch.float32, torch.float32, "chunk"),
    (16, 16, 16, torch.float16, torch.float32, "dtypes"),
    (16, 16, 16, torch.float32, torch.bfloat16, "float32"),
])
def test_ssd_wrapper_rejects_unsupported_inputs(p, n, chunk, dtype, dt_dtype, match):
    xb, dt, a_neg, bm, cm = _ssd_inputs(1, 8, 2, p, n, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        ssd.ssd_scan_blhp(xb, dt.to(dt_dtype), a_neg, bm, cm, chunk)


def test_ssd_library_is_named_by_source_hash():
    path = ssd.LIBRARY.path()
    assert path.parent == kbuild.BUILD_DIR and path.name.startswith("libssd_scan-")
    assert path != fa.LIBRARY.path()


@pytest.mark.parametrize("b,l,h,p,n,chunk,nc,q", [
    (8, 2081, 32, 64, 128, 256, 9, 256),   # mamba2-370m's serving prefill: 8 chunks + 33 rows
    (2, 1, 4, 32, 16, 64, 1, 1),           # L = 1: one chunk of one row
    (2, 257, 4, 32, 16, 256, 2, 256),      # L = chunk + 1
    (1, 512, 5, 16, 8, 256, 2, 256),       # heads not divisible by the group
    (2, 300, 4, 64, 16, 64, 5, 64),        # jamba's N and chunk, ragged
])
def test_ssd_plan(b, l, h, p, n, chunk, nc, q):
    pl = ssd.plan(b, l, h, p, n, chunk)
    assert (pl.chunk, pl.n_chunks) == (q, nc)
    assert (pl.n_chunks - 1) * pl.chunk < l <= pl.n_chunks * pl.chunk  # last chunk ragged
    assert pl.states_shape == (b, nc, h, n, p) and pl.decay_shape == (b, nc, h)


def test_ssd_plan_scratch_at_the_serving_shape():
    # the serving prefill's chunk states are the 75 MB of fp32 scratch the
    # wrapper allocates, one (N, P) state per (batch, chunk, head)
    pl = ssd.plan(8, 2081, 32, 64, 128, 256)
    assert 4 * np.prod(pl.states_shape) == 8 * 9 * 32 * 128 * 64 * 4 == 75_497_472
    assert 4 * np.prod(pl.decay_shape) == 8 * 9 * 32 * 4


def test_rmsnorm_wrappers_refuse_cpu_tensors():
    x, g = torch.zeros(4, 64), torch.ones(64)
    before = (rn.fwd_launches, rn.bwd_launches)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm_fwd(x, g)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm_bwd(x, g, torch.ones(4), x)
    assert (rn.fwd_launches, rn.bwd_launches) == before


@pytest.mark.parametrize("x_dtype,d,g_dtype,match", [
    (torch.float16, 64, torch.float32, "dtype"),
    (torch.float64, 64, torch.float32, "dtype"),
    (torch.bfloat16, 64, torch.bfloat16, "gain dtype"),
    (torch.bfloat16, 60, torch.float32, "row width"),   # not a whole number of 16-byte vectors
    (torch.float32, 66, torch.float32, "row width"),
    (torch.float32, 8196, torch.float32, "row width"),  # above MAX_D
])
def test_rmsnorm_wrapper_rejects_unsupported_inputs(x_dtype, d, g_dtype, match):
    with pytest.raises((ValueError, TypeError), match=match):
        rn.rmsnorm_fwd(torch.zeros(4, d, dtype=x_dtype), torch.ones(d, dtype=g_dtype))


def test_rmsnorm_build_without_nvcc_raises(monkeypatch, tmp_path):
    # a library not yet built, with no nvcc to build it: load raises, no fallback
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kbuild.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.CudaLibrary("rmsnorm.cu", rn._bind).load()


def test_rmsnorm_library_is_named_by_source_hash():
    path = rn.LIBRARY.path()
    assert path.parent == kbuild.BUILD_DIR and path.name.startswith("librmsnorm-")
    assert path not in (fa.LIBRARY.path(), ssd.LIBRARY.path())


# --- on the card only ---------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("bh,sq,sk,hd", [
    (2, 128, 128, 32), (8, 256, 256, 64), (3, 384, 384, 64), (4, 128, 128, 128),
    (3, 67, 67, 16), (5, 2081, 2081, 64), (2, 1, 1, 64), (2, 50, 130, 32), (2, 130, 50, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_on_card(cuda, bh, sq, sk, hd, dtype, causal):
    q, k, v = (_randn(s, shp).to(cuda).to(getattr(torch, dtype))
               for s, shp in ((7, (bh, sq, hd)), (8, (bh, sk, hd)), (9, (bh, sk, hd))))
    before = fa.launches
    got = fa.flash_attention_bhsd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = attention_ref(q, k, v, causal)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=KTOL[dtype], rtol=KTOL[dtype])


def test_model_layout_wrapper_launches_on_card(cuda):
    q, k, v = (_randn(s, (2, 77, 14, 64)).to(cuda).bfloat16() for s in (1, 2, 3))
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=True)
    assert fa.launches == before + 1
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(),
                               atol=KTOL["bfloat16"], rtol=KTOL["bfloat16"])


def _expand(t, h):
    """(B, S, KV, d) -> (B, S, H, d), head h reading KV head h // (H // KV)."""
    return t.repeat_interleave(h // t.shape[2], dim=2)


@pytest.mark.parametrize("b,sq,sk,h,kv,hd", [
    (8, 2081, 2081, 14, 2, 64),                 # qwen2-0.5b's serving prefill
    (2, 77, 77, 14, 2, 64), (2, 130, 130, 6, 2, 32), (1, 200, 200, 4, 1, 16),
    (2, 129, 129, 8, 4, 128), (3, 1, 1, 4, 2, 64),
    (2, 50, 130, 6, 3, 64), (2, 130, 50, 4, 2, 128), (1, 300, 257, 2, 2, 16),  # Sq != Sk
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_model_layout_gqa_kernel_matches_plain_on_card(cuda, b, sq, sk, h, kv, hd, dtype,
                                                        causal):
    # q (B, Sq, H, d) and grouped k/v (B, Sk, KV, d) read as they are
    q = _randn(11, (b, sq, h, hd)).to(cuda).to(getattr(torch, dtype))
    k, v = (_randn(s, (b, sk, kv, hd)).to(cuda).to(q.dtype) for s in (12, 13))
    before = fa.launches
    got = fa.flash_attention_bshd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.shape == q.shape and got.dtype == q.dtype
    ke, ve = _expand(k, h), _expand(v, h)
    flat = [t.transpose(1, 2).reshape(b * h, -1, hd) for t in (q, ke, ve)]
    want = attention_ref(*flat, causal).reshape(b, h, sq, hd).transpose(1, 2)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=KTOL[dtype], rtol=KTOL[dtype])


@pytest.mark.parametrize("b,s,n,first,h,kv,hd", [
    (1, 2048, 128, 1920, 14, 2, 64),  # qwen2-0.5b's 14 heads, one of 16 query blocks
    (2, 1000, 250, 250, 6, 6, 64), (1, 700, 300, 400, 8, 4, 128), (2, 300, 1, 299, 4, 2, 16),
    (1, 257, 100, 57, 4, 1, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_query_block_kernel_matches_plain_on_card(cuda, b, s, n, first, h, kv, hd, dtype):
    # a block of n queries from position ``first`` (q_offset) against whole
    # K/V: the plain version's rows of that block, run on every query
    q = _randn(14, (b, s, h, hd)).to(cuda).to(getattr(torch, dtype))
    k, v = (_randn(sd, (b, s, kv, hd)).to(cuda).to(q.dtype) for sd in (15, 16))
    block = q[:, first:first + n].contiguous()
    before = fa.launches
    got = fa.flash_attention_bshd(block, k, v, causal=True, q_offset=first)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.shape == block.shape
    flat = [t.transpose(1, 2).reshape(b * h, -1, hd) for t in (q, _expand(k, h), _expand(v, h))]
    want = attention_ref(*flat, True).reshape(b, h, s, hd).transpose(1, 2)[:, first:first + n]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=KTOL[dtype], rtol=KTOL[dtype])


def test_gqa_wrapper_makes_no_copies_on_card(cuda):
    # the model-layout wrapper launches the kernel once and issues no other op
    q = _randn(1, (2, 64, 14, 64)).to(cuda).bfloat16()
    k, v = (_randn(s, (2, 64, 2, 64)).to(cuda).bfloat16() for s in (2, 3))
    ops.flash_attention(q, k, v)  # build and load outside the profile
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ops.flash_attention(q, k, v)
    ops_run = {e.key for e in prof.key_averages() if e.key.startswith("aten::")}
    assert ops_run <= {"aten::empty_like", "aten::empty_strided", "aten::empty"}, ops_run


# the reference's SSD kernel tolerance (tests/test_kernels.py), for y in fp32
# and the fp32 final state; bf16 y against the fp32 plain result cast to bf16
SSD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("b,l,h,p,n,chunk,slow", [
    (1, 64, 2, 16, 8, 16, False), (2, 128, 4, 32, 16, 32, False),
    (1, 96, 1, 64, 32, 32, False),                                 # the reference's shapes
    (2, 1, 4, 32, 16, 64, False), (2, 67, 4, 64, 64, 32, False),
    (2, 2081, 8, 64, 128, 256, False),                             # ragged L
    (2, 2081, 8, 64, 128, 256, True), (2, 512, 32, 64, 128, 256, True),  # mamba2's N, P, chunk
    (2, 300, 4, 64, 16, 64, True),                                 # jamba's N and chunk
    (1, 257, 5, 64, 128, 256, False), (2, 33, 3, 16, 8, 32, True),  # odd heads, L = chunk + 1
    (8, 2081, 32, 64, 128, 256, True),                             # the serving shape, slow
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain_on_card(cuda, b, l, h, p, n, chunk, slow, dtype):
    xb, dt, a_neg, bm, cm = (t.to(cuda) for t in _ssd_inputs(
        b, l, h, p, n, seed=l + n, dtype=getattr(torch, dtype), slow=slow))
    before = ssd.launches
    y, state = ssd.ssd_scan_blhp(xb, dt, a_neg, bm, cm, chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    assert y.dtype == xb.dtype and state.dtype == torch.float32
    yw, sw = ssd_chunked_ref(xb.float(), dt, a_neg, bm.float(), cm.float(), chunk)
    tol = SSD_TOL[dtype]
    np.testing.assert_allclose(y.float().cpu().numpy(), yw.to(xb.dtype).float().cpu().numpy(),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(state.cpu().numpy(), sw.cpu().numpy(),
                               atol=SSD_TOL["float32"], rtol=SSD_TOL["float32"])


def test_ssd_model_layout_wrapper_launches_on_card(cuda):
    args = _ssd_inputs(2, 77, 4, 64, 32, dtype=torch.bfloat16)
    before = ssd.launches
    y, state = ops.ssd_scan(*(t.to(cuda) for t in args), 32)
    assert ssd.launches == before + 1
    yw, sw = ops.ssd_scan(*args, 32)
    np.testing.assert_allclose(y.float().cpu().numpy(), yw.float().numpy(),
                               atol=SSD_TOL["bfloat16"], rtol=SSD_TOL["bfloat16"])
    np.testing.assert_allclose(state.cpu().numpy(), sw.numpy(), atol=2e-4, rtol=2e-4)


# RMSNorm: the reference's kernel tolerances (y, and dx) for each dtype;
# dgain (an fp32 sum over rows) within 1e-4 of its largest entry
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rms_inputs(r, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((r, d)).astype(np.float32)).to(dtype)
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((r, d)).astype(np.float32)).to(dtype)
    return x, g, dy


@pytest.mark.parametrize("r,d", [(1, 64), (7, 896), (300, 1024), (8, 896), (2081, 896),
                                 (513, 8192), (3, 5120)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernels_match_plain_on_card(cuda, r, d, dtype):
    x, g, dy = (t.to(cuda) for t in _rms_inputs(r, d, getattr(torch, dtype), seed=r + d))
    before = (rn.fwd_launches, rn.bwd_launches)
    y, rstd = rn.rmsnorm_fwd(x, g)
    dx, dgain = rn.rmsnorm_bwd(x, g, rstd, dy)
    torch.cuda.synchronize()
    assert (rn.fwd_launches, rn.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert y.dtype == dx.dtype == x.dtype and rstd.dtype == dgain.dtype == torch.float32
    xr = x.float().requires_grad_(True)
    gr = g.clone().requires_grad_(True)
    want = rmsnorm_ref(xr, gr)
    want_dx, want_dg = torch.autograd.grad(want, (xr, gr), dy.float())
    tol = RMS_TOL[dtype]
    np.testing.assert_allclose(y.float().cpu().numpy(), want.to(x.dtype).float().detach().cpu(),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(dx.float().cpu().numpy(), want_dx.to(x.dtype).float().cpu(),
                               atol=tol, rtol=tol)
    scale = want_dg.abs().max().item()
    np.testing.assert_allclose(dgain.cpu().numpy(), want_dg.cpu().numpy(), atol=1e-4 * scale,
                               rtol=0)


def test_rmsnorm_dgain_is_deterministic_on_card(cuda):
    x, g, dy = (t.to(cuda) for t in _rms_inputs(16648, 1024, torch.bfloat16))
    _, rstd = rn.rmsnorm_fwd(x, g)
    first = rn.rmsnorm_bwd(x, g, rstd, dy)[1]
    for _ in range(3):
        assert torch.equal(rn.rmsnorm_bwd(x, g, rstd, dy)[1], first)


def test_rmsnorm_op_differentiates_through_the_kernels_on_card(cuda):
    x, g, dy = _rms_inputs(2 * 37, 896, torch.bfloat16)
    xc = x.reshape(2, 37, 896).to(cuda).requires_grad_(True)
    gc = g.to(cuda).requires_grad_(True)
    before = (rn.fwd_launches, rn.bwd_launches)
    y = ops.rmsnorm(xc, gc)
    y.backward(dy.reshape(2, 37, 896).to(cuda))
    assert (rn.fwd_launches, rn.bwd_launches) == (before[0] + 1, before[1] + 1)
    xp = x.reshape(2, 37, 896).requires_grad_(True)
    gp = g.clone().requires_grad_(True)
    ops.rmsnorm(xp, gp).backward(dy.reshape(2, 37, 896))  # the CPU path: rmsnorm_ref
    tol = RMS_TOL["bfloat16"]
    np.testing.assert_allclose(y.float().detach().cpu(), ops.rmsnorm(xp, gp).float().detach(),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(xc.grad.float().cpu(), xp.grad.float(), atol=tol, rtol=tol)
    np.testing.assert_allclose(gc.grad.cpu(), gp.grad, atol=1e-4 * gp.grad.abs().max().item(),
                               rtol=0)
