"""The MPNN family's backward CUDA sources run on the CPU.

``gcnbmp_tpu_torch/ops/csrc/fused_mpnn.cu`` (K5b) and ``set2set.cu``
(K4b, K4) are compiled with g++ against the CPU stand-in for the CUDA
runtime (``tests/cuda_emu``), and their entry points run on small
inputs: K5b on packed tiles of molecule runs with pad slots (tied and
untied weights, C = 32 and 16, and an asymmetric tile with crowded rows
and values other than 1), K4b on molecules spread over several CTAs, one
of them empty.  Every gradient is held against the plain PyTorch version
at chip_smoke.py's gradient bound, and a second run must give the same
bits.  K4's cases are ``test_torch_mpnn_emulated_k4.py``'s, a file of
their own so that pytest-xdist's ``--dist loadfile`` runs them on another
worker.  This checks the bodies' indexing, synchronisation and
arithmetic here; their speed, and what nvcc makes of them, only the card
can show (chip_smoke.py)."""

import numpy as np
import pytest
import torch

from cuda_emu.emulate import build_emulated
from gcnbmp_tpu_torch.ops import fused_mpnn as fm
from gcnbmp_tpu_torch.ops import set2set_kernel as sk
from gcnbmp_tpu_torch.ops.fused_ggnn import GRU_KEYS

T = fm.TILE
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # chip_smoke.py's gradient bound
# K5b: (tiles, layers, channels, tied, crowded asymmetric tile)
MPNN_CASES = {"c32_untied": (2, 3, 32, False, False),
              "c32_tied": (2, 3, 32, True, False),
              "c16": (2, 2, 16, True, False),
              "crowded": (1, 3, 32, True, True)}
# K4b: (molecules, n_max, channels); molecule 3 has no atoms; 60 molecules
# give the emulated card's warps (3 SMs of 16) two molecules each
S2S_CASES = [(13, 24, 32), (60, 24, 16), (9, 64, 32), (9, 64, 16)]
S2S_STEPS = 3


@pytest.fixture(scope="module")
def mpnn_lib(tmp_path_factory):
    return build_emulated("fused_mpnn.cu",
                          str(tmp_path_factory.mktemp("emulated_mpnn")))


@pytest.fixture(scope="module")
def s2s_lib(tmp_path_factory):
    return build_emulated("set2set.cu",
                          str(tmp_path_factory.mktemp("emulated_set2set")))


def _tiles(p, crowd, rng):
    """(adj_flat, mol_id, node_mask): runs of molecules of 5-30 atoms per
    tile, pad slots after them (mask 0, sentinel id), bonds of four types
    inside each molecule (symmetric, value 1), or a crowded asymmetric
    adjacency with values in [0.5, 1.5]."""
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
        assert ((adj != 0).sum(-1) > 16).sum() >= 4
    return torch.as_tensor(adj), torch.as_tensor(mol_id), torch.as_tensor(mask)


def _mpnn_inputs(p, layers, ch, tied, crowd, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale: torch.as_tensor(
        (rng.standard_normal(s) * scale).astype(np.float32))
    adj, mol_id, mask = _tiles(p, crowd, rng)
    n = 1 if tied else layers
    wt = f32(n, 4, ch, ch, scale=ch ** -0.5)
    m0t = f32(n, ch, ch, scale=0.3 * ch ** -0.5)
    gru = {k: f32(*fm.gru_stack_shape(k, n, ch),
                  scale=0.1 if k[0] == "b" else ch ** -0.5) for k in GRU_KEYS}
    if tied:  # the tied model stacks its one set L times
        wt, m0t = wt.repeat(layers, 1, 1, 1), m0t.repeat(layers, 1, 1)
        gru = {k: v.repeat(layers, *([1] * (v.dim() - 1)))
               for k, v in gru.items()}
    h0, dh = f32(p, T, ch, scale=1.0), f32(p, T, ch, scale=1.0)
    return (layers, tied, h0, adj, mol_id, mask, wt, m0t, gru), dh


def _mpnn_bwd(lib, args, dh):
    """fused_mpnn_bwd on CPU tensors, buffers and results as the wrapper's."""
    layers, carry, h0, adj, mol_id, mask, wt, m0t, gru = args
    p, _, ch = h0.shape
    dh0, partial, grads, hs = fm._bwd_buffers(p, layers, ch, "cpu")
    err = lib.fused_mpnn_bwd(
        h0.data_ptr(), adj.data_ptr(), mol_id.data_ptr(), mask.data_ptr(),
        *fm._weight_ptrs(wt, m0t, gru), dh.data_ptr(), dh0.data_ptr(),
        partial.data_ptr(), grads.data_ptr(), hs.data_ptr(), p, layers, ch,
        int(carry), None)
    assert err == 0
    return (dh0, *fm._split_grads(grads, layers, ch))


def _s2s_inputs(m, n_max, ch, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, n_max + 1, m)
    counts[-1] = n_max
    counts[3] = 0  # pair padding: a molecule with no atoms
    amask = (np.arange(n_max)[None] < counts[:, None]).astype(np.float32)
    f32 = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    atoms = f32(m, n_max, ch) * amask[..., None]
    return [torch.as_tensor(x) for x in (
        atoms, amask, f32(2 * ch, 4 * ch, scale=0.3), f32(ch, 4 * ch, scale=0.3),
        f32(1, 4 * ch, scale=0.1), f32(m, 2 * ch))]


def _s2s_bwd(lib, atoms, amask, wx, wh, b, dg):
    """fused_set2set_bwd on CPU tensors, buffers as the wrapper's."""
    m, n_max, ch = atoms.shape
    datoms = torch.empty_like(atoms)
    xs, partial, grads = sk._bwd_buffers(lib, m, ch, S2S_STEPS, "cpu")
    err = lib.fused_set2set_bwd(
        atoms.data_ptr(), amask.data_ptr(), wx.data_ptr(), wh.data_ptr(),
        b.data_ptr(), dg.data_ptr(), datoms.data_ptr(), xs.data_ptr(),
        partial.data_ptr(), grads.data_ptr(), m, n_max, ch, S2S_STEPS, None)
    assert err == 0
    return (datoms, *sk._split_grads(grads, ch))


def _flat(result):
    out = []
    for x in result:
        out += [x[k] for k in GRU_KEYS] if isinstance(x, dict) else [x]
    return out


def _assert_close_and_repeatable(got, again, want):
    got, again, want = _flat(got), _flat(again), _flat(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        bound = GRAD_RTOL * float(w.abs().max()) + GRAD_ATOL
        assert float((g - w).abs().max()) <= bound, f"tensor {i}"
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", list(MPNN_CASES))
def test_emulated_k5b_matches_plain_and_repeats_bit_for_bit(mpnn_lib, case):
    args, dh = _mpnn_inputs(*MPNN_CASES[case], seed=len(case))
    _assert_close_and_repeatable(_mpnn_bwd(mpnn_lib, args, dh),
                                 _mpnn_bwd(mpnn_lib, args, dh),
                                 fm.fused_mpnn_bwd_reference(*args, dh))


@pytest.mark.parametrize("m,n_max,ch", S2S_CASES)
def test_emulated_k4b_matches_plain_and_repeats_bit_for_bit(s2s_lib, m, n_max, ch):
    inputs = _s2s_inputs(m, n_max, ch, seed=n_max + ch)
    _assert_close_and_repeatable(
        _s2s_bwd(s2s_lib, *inputs), _s2s_bwd(s2s_lib, *inputs),
        sk.fused_set2set_bwd_reference(S2S_STEPS, *inputs))
