"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface. It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under ``build/`` at the
root of the checkout, on first use, and loaded with ``ctypes``. A library is
named by the hash of its source, so an edited source is never served by a
stale build. Nothing here falls back: a missing ``nvcc`` or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
                       "default /usr/local/cuda/bin); the port's kernels are built "
                       "from source on first use")


class CudaLibrary:
    """One kernel source, built once per process and bound by ``bind``,
    which sets the ``argtypes``/``restype`` of the library's functions."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.log = ""  # nvcc's output of the build this process made (ptxas resource use)

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}-{digest}.so"

    def load(self) -> ctypes.CDLL:
        """Compile the source if it has no library yet, then load and bind it."""
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                out = self.path()
                if not out.exists():
                    self._compile(out)
                lib = ctypes.CDLL(str(out))
                self._bind(lib)
                self._lib = lib
        return self._lib

    def _compile(self, out: Path) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        try:
            res = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
                                 capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed building {self.source}:\n"
                                   f"{res.stdout}{res.stderr}")
            self.log = res.stdout + res.stderr
            os.replace(tmp, out)  # atomic: a concurrent process never sees half a file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
