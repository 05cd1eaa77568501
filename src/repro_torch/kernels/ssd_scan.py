"""Bind and launch the hand-written SSD chunked-scan kernel.

The kernel is CUDA C++ for Hopper (``csrc/ssd_scan.cu``), replacing the
Pallas TPU kernel ``repro.kernels.ssd_scan``. ``LIBRARY.load()`` compiles
it with ``nvcc`` for ``sm_90a`` on first use (``repro_torch.kernels.build``).
It reads the model layout and writes the final state itself, so its wrapper
makes no layout copies. One call of ``ssd_scan_blhp`` issues three kernels
(chunk states, the recurrence over chunks, the outputs; see the source) and
counts as one launch; ``plan`` gives the chunking and the scratch the
wrapper allocates for them (the kernels' grids are chosen in the source).

For a sequence split over ranks the same kernels run as two calls:
``ssd_states_blhp`` (chunk states and the recurrence: each chunk's entering
state, each chunk's total decay and the block's final state, from zero) and
``ssd_output_blhp`` (the outputs, from an optional initial state ``s_in``
of the block, which the output kernel folds into each chunk's entering
state as it loads it). Each call counts one in ``split_launches``.

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
split_launches = 0


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
    lib.ssd_scan_states.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.ssd_scan_states.restype = ctypes.c_int
    lib.ssd_scan_output.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.ssd_scan_output.restype = ctypes.c_int
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


def _check_carried(xb, pl: Plan, states, decay, final, s_in):
    """The states call's results (and ``s_in``) as the output call reads them."""
    b, _, h, p = xb.shape
    n = pl.states_shape[3]
    want = {"states": (states, pl.states_shape), "decay": (decay, pl.decay_shape),
            "final": (final, (b, h, n, p))}
    if s_in is not None:
        want["s_in"] = (s_in, (b, h, n, p))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got {tuple(t.shape)} {t.dtype}")
        if t.device != xb.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {xb.device}")


def _run(fn, *args):
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream(args[0].device).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
    if err != 0:
        raise RuntimeError("ssd_scan kernel launch failed: "
                           f"{LIBRARY.load().ssd_scan_error_string(err).decode()} ({err})")


def ssd_states_blhp(xb, dt, a_neg, bmat, chunk: int):
    """Launches 1-2 on a block of the sequence, in the model layout (as
    ``ssd_scan_blhp``). Returns (states (B,C,H,N,P): the state entering each
    of the C chunks, decay (B,C,H): each chunk's total decay, final
    (B,H,N,P): the block's final state), all fp32 and from a zero state, as
    ``repro_torch.models.ssm.ssd_states_ref``."""
    global split_launches
    _check(xb, dt, a_neg, bmat, bmat, chunk)
    lib = LIBRARY.load()
    b, l, h, p = xb.shape
    n = bmat.shape[-1]
    pl = plan(b, l, h, p, n, chunk)
    final = torch.empty((b, h, n, p), dtype=torch.float32, device=xb.device)
    states = torch.empty(pl.states_shape, dtype=torch.float32, device=xb.device)
    decay = torch.empty(pl.decay_shape, dtype=torch.float32, device=xb.device)
    _run(lib.ssd_scan_states, xb, dt, a_neg, bmat, final, states, decay, b, l, h, p, n,
         pl.chunk, pl.n_chunks, int(xb.dtype == torch.bfloat16))
    split_launches += 1
    return states, decay, final


def ssd_output_blhp(xb, dt, a_neg, bmat, cmat, chunk: int, states, decay, final, s_in=None):
    """Launch 3 on the block ``ssd_states_blhp`` ran on, from its results
    and the block's initial state ``s_in`` (B,H,N,P) fp32, or zero where it
    is None. Returns (y (B,L,H,P) in xb's dtype, the final state (B,H,N,P)
    fp32: ``final`` itself without ``s_in``), as
    ``repro_torch.models.ssm.ssd_output_ref``."""
    global split_launches
    _check(xb, dt, a_neg, bmat, cmat, chunk)
    if s_in is not None and torch.is_grad_enabled() and s_in.requires_grad:
        raise RuntimeError("the SSD scan kernel has no backward")
    lib = LIBRARY.load()
    b, l, h, p = xb.shape
    n = bmat.shape[-1]
    pl = plan(b, l, h, p, n, chunk)
    _check_carried(xb, pl, states, decay, final, s_in)
    y = torch.empty_like(xb)
    out = final if s_in is None else torch.empty_like(final)
    _run(lib.ssd_scan_output, xb, dt, a_neg, bmat, cmat, states, decay, final, s_in, y,
         None if s_in is None else out,
         b, l, h, p, n, pl.chunk, pl.n_chunks, int(xb.dtype == torch.bfloat16))
    split_launches += 1
    return y, out


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
