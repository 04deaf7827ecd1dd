"""The forward CUDA sources, and the column-list build, run on the CPU.

``gcnbmp_tpu_torch/ops/csrc/fused_ggnn.cu`` (K1, K1m, K2) and
``fused_mpnn.cu``'s K5 are compiled with g++ against the CPU stand-in for
the CUDA runtime (``tests/cuda_emu``) and run on one or two packed tiles
at L=3: GGNN at H=32 and 16 and on a tile whose rows exceed the kernels'
16 neighbour slots (the H=64 body, ``fused_ggnn64.cuh``, is
``test_torch_fwd_emulated64.py``'s), K5 tied and untied at C=32, at C=16
and on a crowded asymmetric tile.  Each output is held against its plain
PyTorch version at chip_smoke.py's bound (atol = rtol = 1e-4: f32 sums
in another order); K1m's h must equal K1's bit for bit, and a second run
must give the same bits (``cuda_emu/ggnn_checks.py``).  The column-list
build of ``fused_ggnn_common.cuh`` (``count_columns``) runs alone through
``tests/cuda_emu/columns_harness.cu`` on random and crowded row lists,
with int and 16-bit indices, and its lists must equal ones built in
numpy.  This checks the sources' indexing, synchronisation and arithmetic
here; their speed, and what nvcc makes of them, only the card can show
(chip_smoke.py)."""

import ctypes

import numpy as np
import pytest
import torch

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import HERE, build_emulated
from gcnbmp_tpu_torch.ops import fused_ggnn as fg
from gcnbmp_tpu_torch.ops import fused_mpnn as fm

T = fg.TILE
CAP, ROW_LEN = 16, 4 * T  # the kernels' NBR_CAP, and columns of the flat adjacency
LAYERS = 3
# GGNN: (tiles, hidden, crowded rows, layers)
GGNN_CASES = {"h32": (2, 32, False, LAYERS), "h16": (2, 16, False, LAYERS),
              "crowded": (1, 32, True, LAYERS)}
# K5: (tiles, channels, tied, crowded asymmetric tile)
MPNN_CASES = {"c32_untied": (2, 32, False, False), "c32_tied": (2, 32, True, False),
              "c16": (2, 16, True, False), "crowded": (1, 32, True, True)}


@pytest.fixture(scope="module")
def ggnn_lib(tmp_path_factory):
    return build_emulated("fused_ggnn.cu", str(tmp_path_factory.mktemp("emu_ggnn")))


@pytest.fixture(scope="module")
def mpnn_lib(tmp_path_factory):
    return build_emulated("fused_mpnn.cu", str(tmp_path_factory.mktemp("emu_mpnn")))


@pytest.fixture(scope="module")
def columns_lib(tmp_path_factory):
    p = ctypes.c_void_p
    return build_emulated("columns_harness.cu",
                          str(tmp_path_factory.mktemp("emu_columns")),
                          entries={"columns_int": [p] * 8, "columns_u16": [p] * 8},
                          src_dir=HERE)


@pytest.mark.parametrize("case", list(GGNN_CASES))
def test_emulated_k1_k1m_match_plain_and_k1m_h_is_k1s(ggnn_lib, case):
    gc.check_k1_k1m(ggnn_lib, GGNN_CASES[case], seed=len(case))


@pytest.mark.parametrize("case", list(GGNN_CASES))
def test_emulated_k2_matches_plain_and_repeats_bit_for_bit(ggnn_lib, case):
    gc.check_k2(ggnn_lib, GGNN_CASES[case], seed=10 + len(case))


def _mpnn_inputs(p, ch, tied, crowd, seed):
    """K5's arguments: runs of molecules of 5-30 atoms per tile with pad
    slots after them, symmetric bonds of four types inside each molecule,
    or a crowded asymmetric adjacency with values in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale: torch.as_tensor(
        (rng.standard_normal(s) * scale).astype(np.float32))
    adj = np.zeros((p, T, 4 * T), np.float32)
    mol_id = np.full((p, T), 999, np.int32)
    mask = np.zeros((p, T), np.float32)
    for t in range(p):
        start, mol = 0, 0
        while True:
            size = int(rng.integers(5, 31))
            if start + size > 112:
                break
            mol_id[t, start:start + size] = 100 * t + mol
            mask[t, start:start + size] = 1.0
            for i in range(start + 1, start + size):
                j, e = int(rng.integers(start, i)), int(rng.integers(4))
                adj[t, i, e * T + j] = adj[t, j, e * T + i] = 1.0
            start, mol = start + size, mol + 1
    if crowd:
        nz = rng.random(adj.shape) < 0.005
        nz[:, ::16] |= rng.random((p, T // 16, 4 * T)) < 0.05
        adj = (nz * rng.uniform(0.5, 1.5, adj.shape)).astype(np.float32)
        assert ((adj != 0).sum(-1) > CAP).sum() >= 4
    n = 1 if tied else LAYERS
    wt = f32(n, 4, ch, ch, scale=ch ** -0.5)
    m0t = f32(n, ch, ch, scale=0.3 * ch ** -0.5)
    gru = {k: f32(*fm.gru_stack_shape(k, n, ch),
                  scale=0.1 if k[0] == "b" else ch ** -0.5) for k in fg.GRU_KEYS}
    if tied:  # the tied model stacks its one set L times
        wt, m0t = wt.repeat(LAYERS, 1, 1, 1), m0t.repeat(LAYERS, 1, 1)
        gru = {k: v.repeat(LAYERS, *([1] * (v.dim() - 1))) for k, v in gru.items()}
    return (LAYERS, tied, f32(p, T, ch, scale=1.0), torch.as_tensor(adj),
            torch.as_tensor(mol_id), torch.as_tensor(mask), wt, m0t, gru)


def _k5(lib, n_layers, carry, h0, adj, mol_id, mask, wt, m0t, gru):
    p, _, ch = h0.shape
    out = torch.empty_like(h0)
    assert lib.fused_mpnn_fwd(
        h0.data_ptr(), adj.data_ptr(), mol_id.data_ptr(), mask.data_ptr(),
        *fm._weight_ptrs(wt, m0t, gru), out.data_ptr(), p, n_layers, ch,
        int(carry), None) == 0
    return out


@pytest.mark.parametrize("case", list(MPNN_CASES))
def test_emulated_k5_matches_plain_and_repeats_bit_for_bit(mpnn_lib, case):
    args = _mpnn_inputs(*MPNN_CASES[case], seed=20 + len(case))
    got = _k5(mpnn_lib, *args)
    gc.assert_close(got, fm.fused_mpnn_reference(*args), "K5")
    assert torch.equal(_k5(mpnn_lib, *args), got)


def _row_lists(pattern, seed):
    """One tile's row lists (nk, nv, nc): up to CAP ascending distinct
    columns per row, rows with more nonzeros (nc > CAP, listed apart by the
    build) and empty rows; "crowded" draws every row's columns from 24, so
    that many rows share a column."""
    rng = np.random.default_rng(seed)
    pool = np.arange(ROW_LEN) if pattern == "random" else rng.choice(ROW_LEN, 24, replace=False)
    nk = np.zeros((T, CAP), np.int32)
    nv = np.zeros((T, CAP), np.float32)
    nc = rng.integers(0, 21, T).astype(np.int32)
    nc[rng.random(T) < 0.1] = 0
    for i in range(T):
        m = min(int(nc[i]), CAP)
        nk[i, :m] = np.sort(rng.choice(pool, m, replace=False))
        nv[i, :m] = rng.uniform(0.5, 1.5, m)
    assert (nc > CAP).sum() >= 4 and (nc == 0).any()
    return nk, nv, nc


@pytest.mark.parametrize("entry", ["columns_int", "columns_u16"])
@pytest.mark.parametrize("pattern", ["random", "crowded"])
def test_emulated_column_build_matches_numpy(columns_lib, entry, pattern):
    nk, nv, nc = _row_lists(pattern, seed=len(entry) + len(pattern))
    cs = np.zeros(ROW_LEN + 1, np.int32)
    cr, cv = np.zeros(T * CAP, np.int32), np.zeros(T * CAP, np.float32)
    ov, ovn = np.zeros(T, np.int32), np.zeros(1, np.int32)
    assert getattr(columns_lib, entry)(
        *(a.ctypes.data for a in (nk, nv, nc, cs, cr, cv, ov, ovn))) == 0
    # in numpy: per column, the rows within CAP that list it, ascending
    rows = [[] for _ in range(ROW_LEN)]
    for i in range(T):
        if nc[i] <= CAP:
            for n in range(nc[i]):
                rows[nk[i, n]].append((i, nv[i, n]))
    want_cs = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    np.testing.assert_array_equal(cs, want_cs)
    flat = [x for r in rows for x in r]
    np.testing.assert_array_equal(cr[:len(flat)], [i for i, _ in flat])
    np.testing.assert_array_equal(cv[:len(flat)], np.float32([v for _, v in flat]))
    want_ov = np.flatnonzero(nc > CAP)
    assert int(ovn[0]) == len(want_ov)
    np.testing.assert_array_equal(ov[:len(want_ov)], want_ov)
