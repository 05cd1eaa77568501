"""The hand-written flash-attention kernel's wrapper, and the kernel on the card.

Imports no JAX, so the whole file also runs on the card's machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernel.py

On a host without CUDA the tests of the kernel itself skip (it has no CPU
mode); the wrapper's refusals are checked everywhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402

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


@pytest.mark.parametrize("shape,dtype,match", [
    ((2, 8, 48), torch.float32, "head_dim"),
    ((2, 8, 64), torch.float16, "dtypes"),
])
def test_cuda_wrapper_rejects_unsupported_inputs(shape, dtype, match):
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        fa.flash_attention_bhsd(q, q, q)


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(fa.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa._nvcc()


def test_library_is_named_by_source_hash():
    path = fa.library_path()
    assert path.parent == fa.BUILD_DIR and path.name.startswith("libflash_attention-")
    assert path == fa.library_path()


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
