"""Bind and launch the hand-written RMSNorm kernels, forward and backward.

The kernels are CUDA C++ for Hopper (``csrc/rmsnorm.cu``), replacing the
Pallas TPU kernel ``repro.kernels.rmsnorm`` (forward only there: the
reference differentiates its inline norm math, so the backward kernel is
the port's own). ``LIBRARY.load()`` compiles them with ``nvcc`` for
``sm_90a`` on first use (``repro_torch.kernels.build``). The forward also
returns the rows' rstd, which the backward takes instead of recomputing it.

Nothing here falls back: a failed build, an input the kernels do not take or
a failed launch raises. ``fwd_launches`` and ``bwd_launches`` count the
calls of this process that launched each kernel (callers reset them to 0 to
count a run); a backward call launches the row pass and the small dgain
reduction, and counts once.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary

DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 8192
BLOCKS_PER_SM = 8  # blocks of the backward's row pass, each writing one row of dgain partials

fwd_launches = 0
bwd_launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.rmsnorm_forward.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.rmsnorm_forward.restype = ctypes.c_int
    lib.rmsnorm_backward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.rmsnorm_backward.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("rmsnorm.cu", _bind)


def _check(x, gain, *others):
    tensors = (x, gain) + others
    if x.dim() != 2 or gain.dim() != 1 or gain.shape[0] != x.shape[1]:
        raise ValueError(f"expected x (R, D) and gain (D,), got {tuple(x.shape)}, "
                         f"{tuple(gain.shape)}")
    r, d = x.shape
    if x.dtype not in DTYPES:
        raise TypeError(f"x dtype {x.dtype}; the kernels take {DTYPES}")
    if gain.dtype != torch.float32:
        raise TypeError(f"gain dtype {gain.dtype}; the kernels take float32 gains")
    vec = 16 // x.element_size()  # elements of one 16-byte vector
    if d % vec or not 1 <= d <= MAX_D:
        raise ValueError(f"row width {d} not supported; the kernels take multiples of {vec} "
                         f"up to {MAX_D} for {x.dtype}")
    if r < 1:
        raise ValueError(f"empty input: x {tuple(x.shape)}")
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("the RMSNorm kernels take tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the RMSNorm kernels take contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the RMSNorm kernels take 16-byte aligned tensors")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"rmsnorm {what} kernel launch failed: "
                           f"{lib.rmsnorm_error_string(err).decode()} ({err})")


def rmsnorm_fwd(x, gain, eps: float = 1e-6):
    """x (R, D) on the card, gain (D,) fp32 -> (y (R, D) in x's dtype,
    rstd (R,) fp32)."""
    global fwd_launches
    _check(x, gain)
    lib = LIBRARY.load()
    r, d = x.shape
    y = torch.empty_like(x)
    rstd = torch.empty((r,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_forward(x.data_ptr(), gain.data_ptr(), y.data_ptr(), rstd.data_ptr(),
                                  r, d, float(eps), int(x.dtype == torch.bfloat16), stream)
    _raise_on(lib, err, "forward")
    fwd_launches += 1
    return y, rstd


def rmsnorm_bwd(x, gain, rstd, dy):
    """The gradients of ``rmsnorm_fwd`` for the output gradient ``dy`` (R, D)
    in x's dtype: (dx (R, D) in x's dtype, dgain (D,) fp32)."""
    global bwd_launches
    _check(x, gain, rstd, dy)
    r, d = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if rstd.shape != (r,) or rstd.dtype != torch.float32:
        raise ValueError(f"rstd must be ({r},) float32, got {tuple(rstd.shape)} {rstd.dtype}")
    lib = LIBRARY.load()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = min(r, BLOCKS_PER_SM * sms)
    dx = torch.empty_like(x)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    dgain = torch.empty((d,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_backward(x.data_ptr(), gain.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
                                   dx.data_ptr(), partial.data_ptr(), dgain.data_ptr(), r, d,
                                   blocks, int(x.dtype == torch.bfloat16), stream)
    _raise_on(lib, err, "backward")
    bwd_launches += 1
    return dx, dgain
