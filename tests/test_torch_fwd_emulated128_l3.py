"""K1 and K1m of the H=128 forward body (``fused_ggnn128_fwd.cuh``) at L=3,
K1m's odd split, run on the CPU as ``test_torch_fwd_emulated128.py`` runs
its other cases: built with g++ against the CPU stand-in for the CUDA
runtime (``tests/cuda_emu``), on one packed tile, held against their
plain PyTorch versions at chip_smoke.py's bound (atol = rtol = 1e-4),
K1m's h equal to K1's and a second run equal bit for bit
(``cuda_emu/ggnn_checks.py``).  A file of its own so that pytest-xdist's
``--dist loadfile`` runs it on another worker."""

import pytest

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import build_emulated

# (tiles, hidden, crowded rows, layers); L=3 is K1m's odd split
K1_CASES = {"h128_l3": (1, 128, False, 3)}


@pytest.fixture(scope="module")
def ggnn_lib(tmp_path_factory):
    return build_emulated("fused_ggnn.cu", str(tmp_path_factory.mktemp("emu_ggnn128_l3")))


@pytest.mark.parametrize("case", list(K1_CASES))
def test_emulated_k1_k1m_match_plain_and_k1m_h_is_k1s(ggnn_lib, case):
    gc.check_k1_k1m(ggnn_lib, K1_CASES[case], seed=len(case))
