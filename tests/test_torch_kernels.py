"""Port parity: the flash-attention wrapper and its plain version.

On the CPU the wrapper ``repro_torch.kernels.ops.flash_attention`` takes
the plain version ``attention_ref``; both are held against the reference's
Pallas kernel in interpret mode over the reference's own sweep. The CUDA
kernel itself runs only on the card: ``tests/test_torch_cuda_kernel.py``
(no JAX) and ``chip_smoke.py`` hold it against ``attention_ref`` there.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

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


@pytest.mark.parametrize("first,n", [(0, 20), (17, 20), (30, 7), (36, 1)])
def test_attention_ref_query_block_matches_reference_oracle(first, n):
    # a block of the queries with q_offset: the reference oracle's rows of
    # that block, the whole queries against the same keys
    q = both(randn(24, (3, 37, 16)))
    k, v = (both(randn(seed, (3, 37, 16))) for seed in (25, 26))
    close(tref.attention_ref(q[1][:, first:first + n], k[1], v[1], True, first),
          jref.attention_ref(q[0], k[0], v[0], True)[:, first:first + n], 1e-5)


@pytest.mark.parametrize("first,n", [(0, 10), (10, 10), (30, 10)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_wrapper_query_block_matches_pallas_interpret(first, n, dtype):
    # the wrapper's q_offset on grouped K/V: the reference kernel's rows of
    # the block, run on the whole queries in interpret mode
    q = both(randn(27, (2, 40, 6, 32)), dtype)
    k, v = (both(randn(seed, (2, 40, 2, 32)), dtype) for seed in (28, 29))
    kj, vj = (jnp.repeat(t[0], 3, axis=2) for t in (k, v))
    want = jops.flash_attention(q[0], kj, vj, causal=True, interpret=True)
    got = tops.flash_attention(q[1][:, first:first + n], k[1], v[1], causal=True, q_offset=first)
    close(got, want[:, first:first + n], KTOL[dtype])


@pytest.mark.parametrize("b,s,h,kv,hd", [(2, 37, 6, 2, 32), (1, 40, 4, 1, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_wrapper_matches_pallas_interpret(b, s, h, kv, hd, dtype, causal):
    # grouped K/V (KV < H heads) into the port's wrapper; the reference's
    # kernel takes them expanded, head h reading KV head h // (H // KV)
    q = both(randn(21, (b, s, h, hd)), dtype)
    k, v = (both(randn(seed, (b, s, kv, hd)), dtype) for seed in (22, 23))
    kj, vj = (jnp.repeat(t[0], h // kv, axis=2) for t in (k, v))
    want = jops.flash_attention(q[0], kj, vj, causal=causal, interpret=True)
    got = tops.flash_attention(q[1], k[1], v[1], causal=causal)
    assert got.shape == (b, s, h, hd) and got.dtype == q[1].dtype
    close(got, want, KTOL[dtype])


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, to follow the wrapper's
    card path without one."""

    @property
    def is_cuda(self):
        return True


def test_wrapper_hands_model_layout_to_kernel_unchanged(monkeypatch):
    # on the card the wrapper passes q (B,S,H,d) and grouped k/v (B,S,KV,d)
    # to the kernel as they are: the same storage and strides, no copy
    seen = []
    monkeypatch.setattr(tops.fa, "flash_attention_bshd",
                        lambda q, k, v, causal=True, q_offset=0:
                        seen.append((q, k, v, causal, q_offset)) or q)
    q = torch.zeros(2, 9, 14, 64, dtype=torch.bfloat16).as_subclass(_OnCard)
    k, v = (torch.zeros(2, 9, 2, 64, dtype=torch.bfloat16).as_subclass(_OnCard)
            for _ in range(2))
    tops.flash_attention(q, k, v, causal=True)
    assert len(seen) == 1
    for got, given in zip(seen[0][:3], (q, k, v)):
        assert got is given
        assert got.data_ptr() == given.data_ptr() and got.stride() == given.stride()
    assert seen[0][3] is True and seen[0][4] == 0
