"""The H=128 forward body (``fused_ggnn128_fwd.cuh``: K1, K1m and K2 of
``gcnbmp_tpu_torch/ops/csrc/fused_ggnn.cu``) run on the CPU.

The source is compiled with g++ against the CPU stand-in for the CUDA
runtime (``tests/cuda_emu``), which runs the body's cluster of two CTAs
per tile together (each with its own shared memory, the peer's read
through ``cluster_map``) and emulates the warp's m16n8k8 TF32
``mma.sync`` and ``ldmatrix`` the body's 3xTF32 products are made of, and
runs on one packed tile: K1 and K1m at L=2 and on a tile whose rows
exceed the kernels' 16 neighbour slots, at L=3 (K1m's odd split:
``test_torch_fwd_emulated128_l3.py``), K2 at L=2 and on the crowded tile
(``test_torch_fwd_emulated128_k2.py``), files of their own so that
pytest-xdist's ``--dist loadfile`` runs them on other workers.  Each
output is held against its plain PyTorch version at chip_smoke.py's bound
(atol = rtol = 1e-4); K1m's h must equal K1's bit for bit, and a second
run must give the same bits (``cuda_emu/ggnn_checks.py``).  The stand-in traps when a staged weight
block holds another block than the body's sequence names at its take, so
the sequence of 52 weight blocks a layer is checked too.  K1m's h_mid
against the reverse body's forward is ``test_torch_fwd_emulated128_hmid.py``'s."""

import pytest

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import build_emulated

# (tiles, hidden, crowded rows, layers)
K1_CASES = {"h128": (1, 128, False, 2), "h128_crowded": (1, 128, True, 2)}


@pytest.fixture(scope="module")
def ggnn_lib(tmp_path_factory):
    return build_emulated("fused_ggnn.cu", str(tmp_path_factory.mktemp("emu_ggnn128")))


@pytest.mark.parametrize("case", list(K1_CASES))
def test_emulated_k1_k1m_match_plain_and_k1m_h_is_k1s(ggnn_lib, case):
    gc.check_k1_k1m(ggnn_lib, K1_CASES[case], seed=len(case))

