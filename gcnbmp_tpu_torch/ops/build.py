"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  ``load_library``
compiles each source with its own ``nvcc`` process, all started together,
into ``ops/build/`` (listed in .gitignore) at first use, names each
library by a hash of its source, the shared headers and the flags so an
edited source is rebuilt, and loads them with ctypes.  Nothing is built or
loaded at import time: the module imports on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import types
from typing import Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "build")
HEADERS = ("fused_ggnn_common.cuh",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# source -> {C entry point: argtypes}; every pointer and the stream are c_void_p
SOURCES = {
    "fused_ggnn.cu": {
        "fused_ggnn_fwd": [_P] * 14 + [_I] * 3 + [_P],
        "fused_ggnn_mid_fwd": [_P] * 15 + [_I] * 4 + [_P],
        "fused_ggnn_readout_fwd": [_P] * 19 + [_I] * 4 + [_P],
    },
    "fused_ggnn_bwd.cu": {
        "fused_ggnn_range_bwd": [_P] * 18 + [_I] * 4 + [_P],
        "fused_ggnn_readout_bwd": [_P] * 23 + [_I] * 4 + [_P],
    },
    "fused_mpnn.cu": {
        "fused_mpnn_fwd": [_P] * 16 + [_I] * 4 + [_P],
        "fused_mpnn_bwd": [_P] * 20 + [_I] * 4 + [_P],
    },
    "set2set.cu": {
        "fused_set2set_fwd": [_P] * 6 + [_I] * 4 + [_P],
        "fused_set2set_bwd": [_P] * 9 + [_I] * 4 + [_P],
        "set2set_bwd_ctas": [_I],
    },
}

_lib: Optional[types.SimpleNamespace] = None
# what the last build printed (ptxas register/shared-memory report, per
# source) and how long it took; None when every library was already built
last_build_log: Optional[str] = None
last_build_seconds: Optional[float] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _library_path(source: str) -> str:
    digest = hashlib.sha256()
    for name in (source, *HEADERS):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:12]}.so")


def build() -> Dict[str, str]:
    """Compile the sources whose library is missing, one nvcc per source,
    all at once; returns {source: library path}."""
    global last_build_log, last_build_seconds
    paths = {s: _library_path(s) for s in SOURCES}
    missing = [s for s, p in paths.items() if not os.path.exists(p)]
    if not missing:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for s in missing:
        tmp = f"{paths[s]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, s)]
        procs[s] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for s, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"== {s}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{s} (nvcc exit {proc.returncode})")
        else:
            os.replace(tmp, paths[s])
    last_build_seconds = time.perf_counter() - t0
    last_build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n"
                           f"{last_build_log}")
    return paths


def load_library() -> types.SimpleNamespace:
    """Build (at first use) and load the kernel libraries; returns their
    C entry points, with argtypes set, as attributes.  Loaded once per
    process: the wrappers call this on every launch."""
    global _lib
    if _lib is None:
        entries = {}
        for source, path in build().items():
            lib = ctypes.CDLL(path)
            for name, argtypes in SOURCES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                entries[name] = fn
        _lib = types.SimpleNamespace(**entries)
    return _lib
