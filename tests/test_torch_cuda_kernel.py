"""The hand-written kernels' wrappers (flash attention, SSD chunked scan),
and the kernels on the card.

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
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402
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
