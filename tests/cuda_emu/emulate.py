"""Build one CUDA source of the port with g++ against the CPU stand-in for
the CUDA runtime beside this file (``cuda_runtime.h``), so that its C
entry points run the kernels on the CPU.

``extern __shared__`` arrays and ``<<<...>>>`` launches are rewritten into
calls of the stand-in; everything else is compiled as written."""

import ctypes
import os
import re
import shutil
import subprocess

import pytest

from gcnbmp_tpu_torch.ops import build

HERE = os.path.dirname(os.path.abspath(__file__))


def build_emulated(source, work, entries=None, src_dir=build.CSRC):
    """g++-build ``<src_dir>/<source>`` (by default ``ops/csrc``) and the
    shared headers of ``ops/csrc`` in the directory ``work``; returns the
    loaded library with the argtypes of ``entries`` set (by default
    ``build.SOURCES[source]``; a test harness beside this file passes its
    own).  Skips the test without g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the emulated kernels")
    for where, name in ((src_dir, source),
                        *((build.CSRC, h) for h in build.HEADERS)):
        with open(os.path.join(where, name)) as f:
            text = f.read()
        text = text.replace("extern __shared__ float smem[];",
                            "float* smem = emu::smem;")
        text = re.sub(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(",
                      r"emu_launch(\1, \2, ", text, flags=re.S)
        stem, ext = os.path.splitext(name)
        with open(os.path.join(work, stem + ".cpp" if ext == ".cu" else name),
                  "w") as f:
            f.write(text)
    stem = os.path.splitext(source)[0]
    out = os.path.join(work, f"lib{stem}.so")
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
                    "-w", "-I", HERE, "-o", out,
                    os.path.join(work, stem + ".cpp")], check=True)
    handle = ctypes.CDLL(out)
    for name, argtypes in (entries or build.SOURCES[source]).items():
        getattr(handle, name).argtypes = argtypes
        getattr(handle, name).restype = ctypes.c_int
    return handle
