"""The H=64 forward body (``fused_ggnn64.cuh``: K1, K1m and K2 of
``gcnbmp_tpu_torch/ops/csrc/fused_ggnn.cu``) run on the CPU.

The source is compiled with g++ against the CPU stand-in for the CUDA
runtime (``tests/cuda_emu``), which emulates the warp's m16n8k8 TF32
``mma.sync`` and ``ldmatrix`` the body's 3xTF32 products are made of, and
runs on one packed tile at L=2 and 3 and on a tile whose rows exceed the
kernels' 16 neighbour slots.  Each output is held against its plain
PyTorch version at chip_smoke.py's bound (atol = rtol = 1e-4); K1m's h
must equal K1's bit for bit (``cuda_emu/ggnn_checks.py``).  The stand-in
traps when a staged weight panel is handed out under another name than it
was loaded with.  These cases have a file of their own, apart from
``test_torch_fwd_emulated.py``, and K2's cases another
(``test_torch_fwd_emulated64_k2.py``), so that pytest-xdist's ``--dist
loadfile`` can run them on other workers."""

import pytest

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import build_emulated

# (tiles, hidden, crowded rows, layers); L=3 is K1m's odd split
GGNN_CASES = {"h64": (1, 64, False, 2), "h64_crowded": (1, 64, True, 2),
              "h64_l3": (1, 64, False, 3)}


@pytest.fixture(scope="module")
def ggnn_lib(tmp_path_factory):
    return build_emulated("fused_ggnn.cu", str(tmp_path_factory.mktemp("emu_ggnn64")))


@pytest.mark.parametrize("case", list(GGNN_CASES))
def test_emulated_k1_k1m_match_plain_and_k1m_h_is_k1s(ggnn_lib, case):
    gc.check_k1_k1m(ggnn_lib, GGNN_CASES[case], seed=len(case))
