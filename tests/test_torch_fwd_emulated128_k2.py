"""K2 of the H=128 forward body (``fused_ggnn128_fwd.cuh``) run on the CPU, as
``test_torch_fwd_emulated128.py`` runs K1 and K1m: built with g++ against
the CPU stand-in for the CUDA runtime (``tests/cuda_emu``), on one packed
tile at L=2 and on a tile whose rows exceed the kernels' 16 neighbour
slots, held against its plain PyTorch version at chip_smoke.py's bound
(atol = rtol = 1e-4), and a second run must give the same bits
(``cuda_emu/ggnn_checks.py``).  A file of its own so that pytest-xdist's
``--dist loadfile`` runs it on another worker."""

import pytest

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import build_emulated

# (tiles, hidden, crowded rows, layers)
K2_CASES = {"h128": (1, 128, False, 2), "h128_crowded": (1, 128, True, 2)}


@pytest.fixture(scope="module")
def ggnn_lib(tmp_path_factory):
    return build_emulated("fused_ggnn.cu", str(tmp_path_factory.mktemp("emu_ggnn128_k2")))


@pytest.mark.parametrize("case", list(K2_CASES))
def test_emulated_k2_matches_plain_and_repeats_bit_for_bit(ggnn_lib, case):
    gc.check_k2(ggnn_lib, K2_CASES[case], seed=10 + len(case))
