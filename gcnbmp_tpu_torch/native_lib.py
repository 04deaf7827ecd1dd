"""Build and load the host-side C++ libraries of ``native/``.

The port's counterpart of gcnbmp_tpu/native_lib.py, for
``libgcnbmp_smiles.so`` (chem/native.py) and ``libgcnbmp_pack.so``
(data/native_pack.py).  It compiles ``native/<name>.cpp`` in place with
the C++ compiler into ``gcnbmp_tpu_torch/ops/build/`` (listed in
.gitignore), naming each library by a hash of its source and flags so an
edited source is rebuilt, and never writes into ``native/``.  As in the
JAX loader, a failed build or load is cached, so it is tried once per
process, and the caller falls back to its pure-Python twin (same graphs,
same batches) when the library is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Callable, Dict, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(ROOT, "native")
BUILD_DIR = os.path.join(ROOT, "gcnbmp_tpu_torch", "ops", "build")
# native/Makefile's flags
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_UNTRIED = object()
_cache: Dict[str, object] = {}


def _library_path(source: str) -> str:
    digest = hashlib.sha256()
    with open(source, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(CXXFLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"libgcnbmp_{stem}_{digest.hexdigest()[:12]}.so")


def _build(source: str) -> Optional[str]:
    """The library of ``source``, compiled if missing; None on failure."""
    try:
        path = _library_path(source)
        if os.path.exists(path):
            return path
        cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run([cxx, *CXXFLAGS, "-o", tmp, source], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, path)  # atomic: concurrent builders agree
        return path
    except Exception:
        return None


def load(stem: str, configure: Optional[Callable[[ctypes.CDLL], None]] = None,
         build: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building if needed) the library of ``native/<stem>.cpp``;
    None if unavailable.  The result, failure included, is cached per
    process; ``configure(lib)`` runs once on a successful load."""
    cached = _cache.get(stem, _UNTRIED)
    if cached is not _UNTRIED:
        return cached  # type: ignore[return-value]
    source = os.path.join(NATIVE_DIR, f"{stem}.cpp")
    path = None
    if os.path.exists(source):
        path = _build(source) if build else _library_path(source)
    lib = None
    if path is not None and os.path.exists(path):
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            lib = None
    if lib is not None and configure is not None:
        configure(lib)
    _cache[stem] = lib
    return lib
