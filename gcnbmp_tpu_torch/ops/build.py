"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  ``load_library``
compiles them with ``nvcc`` into ``ops/build/`` (listed in .gitignore) at
first use, names the library by a hash of its sources so an edited
source is rebuilt, and loads it with ctypes.  Nothing is built or loaded
at import time: the module imports on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "build")
SOURCES = ("fused_ggnn.cu",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# (argtypes) per C entry point; every pointer and the stream are c_void_p
_SIGNATURES = {
    "fused_ggnn_fwd": [_P] * 14 + [_I, _I, _I, _P],
    "fused_ggnn_readout_fwd": [_P] * 19 + [_I, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
# what the last build printed (ptxas register/shared-memory report) and
# how long it took; None when the library was already built
last_build_log: Optional[str] = None
last_build_seconds: Optional[float] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _library_path() -> str:
    digest = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgcnbmp_kernels_{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the sources if their library is missing; returns its path."""
    global last_build_log, last_build_seconds
    path = _library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_seconds = time.perf_counter() - t0
    last_build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{last_build_log}")
    os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, with argtypes
    set for every entry point.  Loaded once per process: the wrappers
    call this on every launch."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
