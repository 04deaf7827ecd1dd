"""The GGNN reverse body's CUDA source, run on the CPU.

``gcnbmp_tpu_torch/ops/csrc/fused_ggnn_bwd.cu`` (K1b, K3 and K2b) is
compiled with g++ against a CPU stand-in for the CUDA runtime
(``tests/cuda_emu/cuda_runtime.h``: one thread per CUDA thread, barriers
for ``__syncthreads`` and the warp collectives), and its two C entry
points run on small packed batches.  Their gradients are held against the
plain PyTorch versions at chip_smoke.py's gradient bound, K3's halves
summed against K1b, and two K2b runs must give the same bits.  This checks
the body's indexing, synchronisation and arithmetic here; its speed, and
what nvcc makes of it, only the card can show (chip_smoke.py)."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gcnbmp_tpu_torch.ops import build
from gcnbmp_tpu_torch.ops import fused_ggnn as fg

T = fg.TILE
HERE = os.path.dirname(os.path.abspath(__file__))
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # chip_smoke.py's gradient bound
# (tiles, layers, hidden, crowded rows): the flagship widths, H=16, and rows
# with more nonzeros than the kernel's 16 neighbour slots
CASES = {"h32": (2, 3, 32, False), "h16": (2, 2, 16, False),
         "crowded": (1, 3, 32, True)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The backward source built with g++ against the CPU stand-in."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the emulated kernels")
    work = tmp_path_factory.mktemp("emulated_bwd")
    for name in ("fused_ggnn_bwd.cu", *build.HEADERS):
        with open(os.path.join(build.CSRC, name)) as f:
            text = f.read()
        text = text.replace("extern __shared__ float smem[];",
                            "float* smem = emu::smem;")
        text = re.sub(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(",
                      r"emu_launch(\1, \2, ", text, flags=re.S)
        stem, ext = os.path.splitext(name)
        (work / (stem + ".cpp" if ext == ".cu" else name)).write_text(text)
    out = work / "libbwd.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
                    "-w", "-I", os.path.join(HERE, "cuda_emu"), "-o", str(out),
                    str(work / "fused_ggnn_bwd.cpp")], check=True)
    handle = ctypes.CDLL(str(out))
    for name, argtypes in build.SOURCES["fused_ggnn_bwd.cu"].items():
        getattr(handle, name).argtypes = argtypes
        getattr(handle, name).restype = ctypes.c_int
    return handle


def _inputs(p, layers, hidden, crowd, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale=1.0: torch.as_tensor(
        (rng.standard_normal(s) * scale).astype(np.float32))
    adj = (rng.random((p, T, 4 * T)) < 0.008).astype(np.float32)
    if crowd:  # ~5% of the columns of every other row
        extra = rng.random(adj.shape) < 0.05
        extra[:, 1::2] = False
        adj[extra] = 1.0
        assert ((adj != 0).sum(-1) > 16).any()
    gru = {k: f32(*fg.gru_shape(k, hidden),
                  scale=0.1 if k[0] == "b" else fg.gru_shape(k, hidden)[0] ** -0.5)
           for k in fg.GRU_KEYS}
    mask = torch.as_tensor((rng.random((p, T)) < 0.8).astype(np.float32))
    readout = (mask, f32(2 * hidden, hidden, scale=0.2), f32(hidden, scale=0.1),
               f32(hidden, hidden, scale=0.2), f32(hidden, scale=0.1))
    return (f32(p, T, hidden), torch.as_tensor(adj),
            f32(layers, 4, hidden, hidden, scale=hidden ** -0.5),
            f32(layers, 4, hidden, scale=0.1), gru, readout, f32(p, T, hidden))


def _flat(result):
    out = []
    for x in result:
        out += [x[k] for k in fg.GRU_KEYS] if isinstance(x, dict) else [x]
    return out


def _assert_grads_close(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        bound = GRAD_RTOL * float(w.abs().max()) + GRAD_ATOL
        assert float((g - w).abs().max()) <= bound, f"tensor {i}"


def _range_bwd(lib, lo, hi, hin, adj, msg_w, msg_b, gru, dh_top):
    """fused_ggnn_range_bwd on CPU tensors, buffers and results as the
    wrapper's (``fused_ggnn_half_bwd``: full-size message gradients)."""
    p, _, hidden = hin.shape
    dh_bot, partial, grads, hs, shapes, sizes = fg._bwd_buffers(
        p, hi - lo, hidden, None, "cpu")
    err = lib.fused_ggnn_range_bwd(
        hin.data_ptr(), adj.data_ptr(), *fg._weight_ptrs(msg_w, msg_b, gru),
        dh_top.data_ptr(), dh_bot.data_ptr(), partial.data_ptr(),
        grads.data_ptr(), hs.data_ptr(), p, lo, hi, hidden, None)
    assert err == 0
    dmsg_w, dmsg_b, dgru, _ = fg._split_grads(grads, shapes, sizes)
    full_w, full_b = torch.zeros_like(msg_w), torch.zeros_like(msg_b)
    full_w[lo:hi], full_b[lo:hi] = dmsg_w, dmsg_b
    return dh_bot, full_w, full_b, dgru


def _readout_bwd(lib, layers, h0, adj, msg_w, msg_b, gru, readout, dg):
    p, _, hidden = h0.shape
    dh0, partial, grads, hs, shapes, sizes = fg._bwd_buffers(
        p, layers, hidden, hidden, "cpu")
    err = lib.fused_ggnn_readout_bwd(
        h0.data_ptr(), adj.data_ptr(), *fg._weight_ptrs(msg_w, msg_b, gru),
        *(x.data_ptr() for x in readout), dg.data_ptr(), dh0.data_ptr(),
        partial.data_ptr(), grads.data_ptr(), hs.data_ptr(), p, layers, hidden,
        hidden, None)
    assert err == 0
    dmsg_w, dmsg_b, dgru, rest = fg._split_grads(grads, shapes, sizes)
    return (dh0, dmsg_w, dmsg_b, dgru, *rest)


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_k1b_matches_plain(lib, case):
    p, layers, hidden, crowd = CASES[case]
    h0, adj, msg_w, msg_b, gru, _, dout = _inputs(p, layers, hidden, crowd, 1)
    _assert_grads_close(
        _range_bwd(lib, 0, layers, h0, adj, msg_w, msg_b, gru, dout),
        fg.fused_ggnn_bwd_reference(layers, h0, adj, msg_w, msg_b, gru, dout))


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_k3_halves_match_plain_and_sum_to_k1b(lib, case):
    p, layers, hidden, crowd = CASES[case]
    h0, adj, msg_w, msg_b, gru, _, dout = _inputs(p, layers, hidden, crowd, 2)
    split = layers // 2
    h_mid = fg.fused_ggnn_mid_reference(layers, h0, adj, msg_w, msg_b, gru)[1]
    top = _range_bwd(lib, split, layers, h_mid, adj, msg_w, msg_b, gru, dout)
    _assert_grads_close(top, fg.fused_ggnn_half_bwd_reference(
        split, layers, h_mid, adj, msg_w, msg_b, gru, dout))
    bottom = _range_bwd(lib, 0, split, h0, adj, msg_w, msg_b, gru, top[0])
    _assert_grads_close(bottom, fg.fused_ggnn_half_bwd_reference(
        0, split, h0, adj, msg_w, msg_b, gru, top[0]))
    summed = (bottom[0], top[1] + bottom[1], top[2] + bottom[2],
              {k: top[3][k] + bottom[3][k] for k in fg.GRU_KEYS})
    _assert_grads_close(summed, _range_bwd(lib, 0, layers, h0, adj, msg_w,
                                           msg_b, gru, dout))


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_k2b_matches_plain_and_repeats_bit_for_bit(lib, case):
    p, layers, hidden, crowd = CASES[case]
    h0, adj, msg_w, msg_b, gru, readout, dg = _inputs(p, layers, hidden, crowd, 3)
    got = _readout_bwd(lib, layers, h0, adj, msg_w, msg_b, gru, readout, dg)
    _assert_grads_close(got, fg.fused_ggnn_readout_bwd_reference(
        layers, h0, adj, msg_w, msg_b, gru, *readout, dg))
    again = _readout_bwd(lib, layers, h0, adj, msg_w, msg_b, gru, readout, dg)
    assert all(torch.equal(a, b) for a, b in zip(_flat(got), _flat(again)))
