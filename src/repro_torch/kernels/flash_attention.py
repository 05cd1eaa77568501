"""Bind and launch the hand-written flash-attention kernel.

The kernel is CUDA C++ for Hopper (``csrc/flash_attention.cu``), replacing
the Pallas TPU kernel ``repro.kernels.flash_attention``. ``LIBRARY.load()``
compiles it with ``nvcc`` for ``sm_90a`` on first use
(``repro_torch.kernels.build``).

Nothing here falls back: a failed build, an input the kernel does not take
or a failed launch raises. The kernel has no backward, so an input that
autograd tracks is refused too (train through
``set_attention_impl("plain")``). ``launches`` counts the kernel launches of this
process (callers reset it to 0 to count a run).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import CudaLibrary

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention_forward.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_forward.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("flash_attention.cu", _bind)


def _check(q, k, v):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash-attention kernel has no backward; for gradients run "
                           "attention plain with "
                           "repro_torch.models.attention.set_attention_impl('plain')")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"expected (BH, S, d) tensors, got {q.shape}, {k.shape}, {v.shape}")
    bh, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported; the kernel is built for {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}; need one of {DTYPES}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if sq < 1 or k.shape[1] < 1 or bh < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if bh > 65535:
        raise ValueError(f"batch*heads {bh} exceeds the grid's y limit 65535")


def flash_attention_bhsd(q, k, v, causal: bool = True):
    """q (BH, Sq, d), k/v (BH, Sk, d) on the card -> (BH, Sq, d) in q's dtype."""
    global launches
    _check(q, k, v)
    lib = LIBRARY.load()
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, sq, k.shape[1], d,
            int(q.dtype == torch.bfloat16), int(causal), 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()} ({err})")
    launches += 1
    return o
