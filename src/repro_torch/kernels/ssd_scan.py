"""Bind and launch the hand-written SSD chunked-scan kernel.

The kernel is CUDA C++ for Hopper (``csrc/ssd_scan.cu``), replacing the
Pallas TPU kernel ``repro.kernels.ssd_scan``. ``LIBRARY.load()`` compiles
it with ``nvcc`` for ``sm_90a`` on first use (``repro_torch.kernels.build``).
It reads the model layout and writes the final state itself, so its wrapper
makes no layout copies. One call of ``ssd_scan_blhp`` issues three kernels
(chunk states, the recurrence over chunks, the outputs; see the source) and
counts as one launch; ``plan`` gives the chunking and the scratch the
wrapper allocates for them (the kernels' grids are chosen in the source).

Nothing here falls back: a failed build, an input the kernel does not take
or a failed launch raises. The kernel has no backward, so an input that
autograd tracks is refused too (train through ``set_ssd_impl("plain")``). ``launches`` counts the kernel launches of this
process (callers reset it to 0 to count a run).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels.build import CudaLibrary

HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (8, 16, 32, 64, 128)
MAX_CHUNK = 256
DTYPES = (torch.float32, torch.bfloat16)

launches = 0


class Plan(NamedTuple):
    """What one call needs from its wrapper: the chunk length and count (the
    last chunk ragged) and the scratch shapes."""
    chunk: int
    n_chunks: int
    states_shape: tuple  # (B, n_chunks, H, N, P) fp32: each chunk's state
    decay_shape: tuple   # (B, n_chunks, H) fp32: each chunk's total decay


def plan(b: int, l: int, h: int, p: int, n: int, chunk: int) -> Plan:
    q = min(chunk, l)
    nc = -(-l // q)
    return Plan(q, nc, (b, nc, h, n, p), (b, nc, h))


def _bind(lib: ctypes.CDLL) -> None:
    lib.ssd_scan_forward.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.ssd_scan_forward.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("ssd_scan.cu", _bind)


def _check(xb, dt, a_neg, bmat, cmat, chunk):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xb, dt, a_neg, bmat, cmat)):
        raise RuntimeError("the SSD scan kernel has no backward; for gradients run the scan "
                           "plain with repro_torch.models.ssm.set_ssd_impl('plain')")
    if xb.dim() != 4 or dt.dim() != 3 or a_neg.dim() != 1 or bmat.dim() != 3:
        raise ValueError(f"expected xb (B,L,H,P), dt (B,L,H), a_neg (H,), bmat/cmat (B,L,N); "
                         f"got {tuple(xb.shape)}, {tuple(dt.shape)}, {tuple(a_neg.shape)}, "
                         f"{tuple(bmat.shape)}")
    b, l, h, p = xb.shape
    n = bmat.shape[-1]
    if (dt.shape != (b, l, h) or a_neg.shape != (h,) or bmat.shape != (b, l, n)
            or cmat.shape != bmat.shape):
        raise ValueError(f"shapes do not agree: xb {tuple(xb.shape)}, dt {tuple(dt.shape)}, "
                         f"a_neg {tuple(a_neg.shape)}, bmat {tuple(bmat.shape)}, "
                         f"cmat {tuple(cmat.shape)}")
    if p not in HEAD_DIMS:
        raise ValueError(f"head_dim {p} not supported; the kernel is built for {HEAD_DIMS}")
    if n not in STATE_DIMS:
        raise ValueError(f"state dim {n} not supported; the kernel takes {STATE_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not supported; the kernel takes 1..{MAX_CHUNK}")
    if xb.dtype not in DTYPES or bmat.dtype != xb.dtype or cmat.dtype != xb.dtype:
        raise TypeError(f"xb/bmat/cmat dtypes {xb.dtype}, {bmat.dtype}, {cmat.dtype}; "
                        f"need one of {DTYPES}, the same for all three")
    if dt.dtype != torch.float32 or a_neg.dtype != torch.float32:
        raise TypeError(f"dt and a_neg must be float32, got {dt.dtype}, {a_neg.dtype}")
    tensors = (xb, dt, a_neg, bmat, cmat)
    if not (xb.is_cuda and all(t.device == xb.device for t in tensors)):
        raise ValueError("xb, dt, a_neg, bmat and cmat must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("xb, dt, a_neg, bmat and cmat must be contiguous")
    if b < 1 or l < 1 or h < 1:
        raise ValueError(f"empty scan: xb {tuple(xb.shape)}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the grid's y/z limit 65535")


def ssd_scan_blhp(xb, dt, a_neg, bmat, cmat, chunk: int):
    """Model layout on the card: xb (B,L,H,P), dt (B,L,H) fp32, a_neg (H,) fp32,
    bmat/cmat (B,L,N) in xb's dtype. Returns (y (B,L,H,P) in xb's dtype,
    final state (B,H,N,P) fp32), as ``repro_torch.models.ssm.ssd_chunked_ref``.
    Issues three kernels, counted as one launch."""
    global launches
    _check(xb, dt, a_neg, bmat, cmat, chunk)
    lib = LIBRARY.load()
    b, l, h, p = xb.shape
    n = bmat.shape[-1]
    pl = plan(b, l, h, p, n, chunk)
    y = torch.empty_like(xb)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=xb.device)
    states = torch.empty(pl.states_shape, dtype=torch.float32, device=xb.device)
    decay = torch.empty(pl.decay_shape, dtype=torch.float32, device=xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        err = lib.ssd_scan_forward(
            xb.data_ptr(), dt.data_ptr(), a_neg.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            y.data_ptr(), state.data_ptr(), states.data_ptr(), decay.data_ptr(), b, l, h, p, n,
            pl.chunk, pl.n_chunks, int(xb.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError("ssd_scan kernel launch failed: "
                           f"{lib.ssd_scan_error_string(err).decode()} ({err})")
    launches += 1
    return y, state
