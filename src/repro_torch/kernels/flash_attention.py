"""Build, bind and launch the hand-written flash-attention kernel.

The kernel is CUDA C++ for Hopper (``csrc/flash_attention.cu``), replacing
the Pallas TPU kernel ``repro.kernels.flash_attention``. It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface under ``build/`` at the root of the checkout, on first use, and
loaded with ``ctypes``. A library is named by the hash of its source, so an
edited source is never served by a stale build.

Nothing here falls back: a failed build, an input the kernel does not take
or a failed launch raises. ``launches`` counts the kernel launches of this
process (callers reset it to 0 to count a run).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = 0
build_log = ""  # nvcc's output of the build this process made (ptxas resource use)
_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
                       "default /usr/local/cuda/bin); the flash-attention kernel "
                       "is built from source on first use")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libflash_attention-{digest}.so"


def build() -> ctypes.CDLL:
    """Compile the kernel if this source has no library yet, then load it."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
            os.close(fd)
            try:
                res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                                     capture_output=True, text=True, timeout=900)
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed building {SOURCE}:\n"
                                       f"{res.stdout}{res.stderr}")
                build_log = res.stdout + res.stderr
                os.replace(tmp, out)  # atomic: a concurrent process never sees half a file
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(out))
        lib.flash_attention_forward.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_forward.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check(q, k, v):
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
    lib = build()
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
