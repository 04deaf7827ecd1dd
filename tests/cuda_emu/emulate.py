"""Build one CUDA source of the port with g++ against the CPU stand-in for
the CUDA runtime beside this file (``cuda_runtime.h``), so that its C
entry points run the kernels on the CPU.

``extern __shared__`` arrays and ``<<<...>>>`` launches are rewritten into
calls of the stand-in; everything else is compiled as written.

Each build is kept in a cache under the temporary directory, keyed by a
hash of the rewritten sources, the stand-in's headers and the compiler
command, so that a run builds each source once: the xdist workers share
it, one builds while the others wait on the entry's file lock.  Every
caller loads its own copy of the library, in its ``work`` directory, as
it did when it built its own.

The stand-in runs every CUDA thread of a block as an OS thread that
meets the others at barriers, so emulated launches in several processes
at once spend their time switching threads: every call into a library
of ``build_emulated`` takes one of ``SLOTS`` machine-wide slots (file
locks beside the cache), and waits, asleep, while the others are held."""

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

import pytest

from gcnbmp_tpu_torch.ops import build

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(tempfile.gettempdir(), "gcnbmp_tpu_torch_emulated")
SLOTS = 2  # emulated calls that run at once across the test processes


@contextlib.contextmanager
def _slot():
    """Hold one of the ``SLOTS`` file locks for the block."""
    os.makedirs(CACHE, exist_ok=True)
    while True:
        for i in range(SLOTS):
            f = open(os.path.join(CACHE, f"slot{i}.lock"), "w")
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except BlockingIOError:
                f.close()
                continue
            try:
                yield
            finally:
                f.close()  # releases the lock
            return
        time.sleep(0.02)


class _Library:
    """A loaded library whose every call holds a slot."""

    def __init__(self, handle):
        self._handle = handle

    def __getattr__(self, name):
        fn = getattr(self._handle, name)

        def call(*args):
            with _slot():
                return fn(*args)

        return call


def _rewritten(source, src_dir):
    """{file name: text} of ``source`` and the shared headers, rewritten
    for the stand-in; a .cu source becomes a .cpp."""
    files = {}
    for where, name in ((src_dir, source),
                        *((build.CSRC, h) for h in build.HEADERS)):
        with open(os.path.join(where, name)) as f:
            text = f.read()
        text = text.replace("extern __shared__ float smem[];",
                            "float* smem = emu::smem;")
        text = re.sub(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(",
                      r"emu_launch(\1, \2, ", text, flags=re.S)
        stem, ext = os.path.splitext(name)
        files[stem + ".cpp" if ext == ".cu" else name] = text
    return files


def _key(files, command):
    h = hashlib.sha256("\0".join(command).encode())
    for name in sorted(files):
        h.update(f"\0{name}\0{files[name]}".encode())
    for path in sorted(glob.glob(os.path.join(HERE, "*.h"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:32]


def build_emulated(source, work, entries=None, src_dir=build.CSRC):
    """g++-build ``<src_dir>/<source>`` (by default ``ops/csrc``) and the
    shared headers of ``ops/csrc``, or take the cached build of the same
    texts, into the directory ``work``; returns the loaded library with
    the argtypes of ``entries`` set (by default ``build.SOURCES[source]``;
    a test harness beside this file passes its own), each call in a slot.
    Skips the test without g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the emulated kernels")
    files = _rewritten(source, src_dir)
    stem = os.path.splitext(source)[0]
    command = ["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
               "-w", "-I", HERE]
    out = os.path.join(work, f"lib{stem}.so")
    entry = os.path.join(CACHE, _key(files, command))
    cached = os.path.join(entry, f"lib{stem}.so")
    os.makedirs(entry, exist_ok=True)
    with open(entry + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(cached):
            for name, text in files.items():
                with open(os.path.join(work, name), "w") as f:
                    f.write(text)
            subprocess.run(command + ["-o", out,
                                      os.path.join(work, stem + ".cpp")],
                           check=True)
            partial = f"{cached}.{os.getpid()}"
            shutil.copyfile(out, partial)
            os.replace(partial, cached)
        else:
            shutil.copyfile(cached, out)
    handle = ctypes.CDLL(out)
    for name, argtypes in (entries or build.SOURCES[source]).items():
        getattr(handle, name).argtypes = argtypes
        getattr(handle, name).restype = ctypes.c_int
    return _Library(handle)
