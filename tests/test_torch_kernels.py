"""Port parity: the flash-attention wrapper and its plain version.

On the CPU the wrapper ``repro_torch.kernels.ops.flash_attention`` takes
the plain version ``attention_ref``; both are held against the reference's
Pallas kernel in interpret mode over the reference's own sweep. The CUDA
kernel itself runs only on the card: ``tests/test_torch_cuda_kernel.py``
(no JAX) and ``chip_smoke.py`` hold it against ``attention_ref`` there.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_parity import both, close, randn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# the reference's kernel tolerances (tests/test_kernels.py)
KTOL = {"float32": 3e-5, "bfloat16": 2e-2}
SWEEP = [(1, 128, 1, 32), (2, 256, 4, 64), (1, 384, 3, 64), (2, 128, 2, 128)]


@pytest.mark.parametrize("b,s,h,hd", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_wrapper_matches_pallas_interpret(b, s, h, hd, dtype, causal):
    qkv = [both(randn(seed, (b, s, h, hd)), dtype) for seed in (1, 2, 3)]
    want = jops.flash_attention(*(j for j, _ in qkv), causal=causal, interpret=True)
    got = tops.flash_attention(*(t for _, t in qkv), causal=causal)
    assert got.shape == (b, s, h, hd) and got.dtype == qkv[0][1].dtype
    close(got, want, KTOL[dtype])


@pytest.mark.parametrize("sq,sk", [(37, 37), (20, 45), (45, 20)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_reference_oracle(sq, sk, causal):
    # ragged and unequal lengths: the causal mask is aligned top-left
    q = both(randn(4, (3, sq, 16)))
    k, v = (both(randn(seed, (3, sk, 16))) for seed in (5, 6))
    close(tref.attention_ref(q[1], k[1], v[1], causal),
          jref.attention_ref(q[0], k[0], v[0], causal), 1e-5)
