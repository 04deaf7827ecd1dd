"""The H=64 GGNN reverse body (``fused_ggnn_bwd.cu``'s
``fused_ggnn_bwd_kernel64``: K1b) and the 3xTF32 products of
``fused_ggnn64.cuh``, run on the CPU.

The body takes every dense product on the tensor cores in 3xTF32; the
CPU stand-in for the CUDA runtime (``tests/cuda_emu``) emulates the TF32
rounding, the warp's m16n8k8 ``mma.sync`` and ``ldmatrix``.  K1b's
gradients are held against the plain PyTorch version at chip_smoke.py's
gradient bound on one tile at L=2 (``cuda_emu/ggnn_checks.py``); its
crowded case (rows over the kernel's 16 neighbour slots) and its L=3
case are ``test_torch_bwd_emulated64_crowded.py``'s and
``test_torch_bwd_emulated64_l3.py``'s, K3's and K2b's H=64 cases
``test_torch_bwd_emulated64_k3.py``'s and
``test_torch_bwd_emulated64_k2b.py``'s.  ``tests/cuda_emu/tc_harness.cu``
holds the three product orientations the bodies use against float64, and
the forward's product from an operand split once and kept (h and its
TF32 parts, ``split_store``) against the product split at load and
against the half-tile product with the correction terms apart (SEP, the
forward's form), bit for bit.  These
cases have files of their own, apart from ``test_torch_bwd_emulated.py``,
so that pytest-xdist's ``--dist loadfile`` can run them on other
workers."""

import ctypes
import os

import numpy as np
import pytest

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import build_emulated

# (tiles, layers, hidden, crowded rows)
CASES = {"h64": (1, 2, 64, False)}
HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The backward source built with g++ against the CPU stand-in."""
    return build_emulated("fused_ggnn_bwd.cu",
                          str(tmp_path_factory.mktemp("emulated_bwd64")))


@pytest.fixture(scope="module")
def tc_lib(tmp_path_factory):
    """The 3xTF32 product harness built with g++ against the CPU stand-in."""
    return build_emulated("tc_harness.cu", str(tmp_path_factory.mktemp("emu_tc")),
                          entries={"tc_products": [ctypes.c_void_p] * 8},
                          src_dir=HERE)


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_k1b_matches_plain(lib, case):
    gc.check_k1b(lib, CASES[case])


def _products(tc_lib, seed):
    """a, b (64, 64) of mixed magnitudes and the harness's products: a b,
    a b^T, a^T b, [a; b] b with [a; b] split at load and from its kept
    TF32 parts, and a b with SEP."""
    rng = np.random.default_rng(seed)
    a, b = (np.ascontiguousarray(rng.standard_normal((64, 64)) *
                                 np.exp(rng.uniform(-3, 3, (64, 64))),
                                 dtype=np.float32) for _ in range(2))
    outs = [np.full(shape, np.nan, np.float32)
            for shape in [(64, 64)] * 3 + [(128, 64)] * 2 + [(64, 64)]]
    assert tc_lib.tc_products(*(x.ctypes.data for x in (a, b, *outs))) == 0
    return a, b, outs


@pytest.mark.parametrize("orientation", ["x W", "x W^T", "a^T b"])
def test_emulated_3xtf32_products_match_float64(tc_lib, orientation):
    """Each product the H=64 bodies take on the tensor cores, on
    random (64, 64) operands of mixed magnitudes, within 1e-6 of the sum of
    |a||b| over each output's terms of the float64 product (TF32 alone
    keeps about 2^-11 of each term; 3xTF32 drops lo*lo and rounds lo)."""
    a, b, outs = _products(tc_lib, len(orientation))
    got = outs[["x W", "x W^T", "a^T b"].index(orientation)]
    x, y = {"x W": (a, b), "x W^T": (a, b.T), "a^T b": (a.T, b)}[orientation]
    x, y = x.astype(np.float64), y.astype(np.float64)
    want, scale = x @ y, np.abs(x) @ np.abs(y)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 1e-6 * scale).all()
    # plain TF32 (one product per step) would not hold that bound
    assert np.abs(got - want).max() < 1e-2 * np.abs(
        _tf32(x) @ _tf32(y) - want).max()


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds (ties away from zero)."""
    u = x.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32).astype(
        np.float64)


@pytest.mark.parametrize("seed", [0, 1])
def test_emulated_presplit_product_equals_split_at_load(tc_lib, seed):
    """The forward's x W over a tile of 128 rows whose x is read from the
    TF32 parts kept beside it (``tc_mma_split_a``, as the forward reads h)
    gives the bits of the same product splitting x where it loads it
    (``Tc::product_tile``), and its first half the bits of the half-tile
    product with the correction terms apart (``tc_mma``'s SEP, which the
    forward takes and the reverse body, short of registers, does not),
    which holds the float64 bound of the reverse body's products."""
    a, b, (_, _, _, tile_tc, tile_split, xw_sep) = _products(tc_lib, 10 + seed)
    assert np.isfinite(tile_split).all()
    assert np.array_equal(tile_split.view(np.uint32), tile_tc.view(np.uint32))
    assert np.array_equal(tile_split[:64].view(np.uint32), xw_sep.view(np.uint32))
    x, y = a.astype(np.float64), b.astype(np.float64)
    assert (np.abs(xw_sep - x @ y) <= 1e-6 * (np.abs(x) @ np.abs(y))).all()
