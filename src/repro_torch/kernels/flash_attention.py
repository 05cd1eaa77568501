"""Bind and launch the hand-written flash-attention kernel.

The kernel is CUDA C++ for Hopper (``csrc/flash_attention.cu``), replacing
the Pallas TPU kernel ``repro.kernels.flash_attention``. It reads the model
layout, q (B, S, H, d) and grouped k/v (B, S, KV, d), through TMA tensor
maps, so its callers make no layout copies and do not expand K/V.
``LIBRARY.load()`` compiles it with ``nvcc`` for ``sm_90a`` on first use
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
MAX_SEQ = 65535 * 32  # q-tiles of 32 rows (fp32; bf16 tiles hold 128 or 192) on the grid's y

launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention_forward.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_forward.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("flash_attention.cu", _bind)


def _check(q, k, v):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash-attention kernel has no backward; for gradients run "
                           "attention plain with "
                           "repro_torch.models.attention.set_attention_impl('plain')")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q (B, Sq, H, d) and k/v (B, Sk, KV, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    kv = k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)} (KV heads must divide H)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported; the kernel is built for {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}; need one of {DTYPES}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary (TMA)")
    if sq < 1 or k.shape[1] < 1 or b < 1 or h < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if sq > MAX_SEQ:
        raise ValueError(f"{sq} queries exceed the grid's y limit of 65535 q-tiles")


def flash_attention_bshd(q, k, v, causal: bool = True):
    """The model layout on the card: q (B, Sq, H, d), k/v (B, Sk, KV, d) with
    KV dividing H (head h reads KV head h // (H // KV)) -> o (B, Sq, H, d)
    in q's dtype. Nothing is copied: the kernel reads these tensors as they
    are."""
    global launches
    _check(q, k, v)
    lib = LIBRARY.load()
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, k.shape[1], h,
            k.shape[2], d, int(q.dtype == torch.bfloat16), int(causal), 1.0 / math.sqrt(d),
            stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()} ({err})")
    launches += 1
    return o


def flash_attention_bhsd(q, k, v, causal: bool = True):
    """The reference's layout: q (BH, Sq, d), k/v (BH, Sk, d) on the card ->
    (BH, Sq, d), as ``flash_attention_bshd`` with one head per batch row."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"expected (BH, S, d) tensors, got {q.shape}, {k.shape}, {v.shape}")
    return flash_attention_bshd(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2),
                                causal=causal).squeeze(2)
