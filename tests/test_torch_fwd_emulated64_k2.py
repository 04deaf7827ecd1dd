"""K2 of the H=64 forward body (``fused_ggnn64.cuh``) run on the CPU, as
``test_torch_fwd_emulated64.py`` runs K1 and K1m: built with g++ against
the CPU stand-in for the CUDA runtime (``tests/cuda_emu``), on one packed
tile at L=2 and 3 and on a tile whose rows exceed the kernels' 16
neighbour slots, held against its plain PyTorch version at
chip_smoke.py's bound (atol = rtol = 1e-4), and a second run must give the
same bits (``cuda_emu/ggnn_checks.py``).  A file of its own so that
pytest-xdist's ``--dist loadfile`` runs it on another worker."""

import pytest

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import build_emulated

# (tiles, hidden, crowded rows, layers)
GGNN_CASES = {"h64": (1, 64, False, 2), "h64_crowded": (1, 64, True, 2),
              "h64_l3": (1, 64, False, 3)}


@pytest.fixture(scope="module")
def ggnn_lib(tmp_path_factory):
    return build_emulated("fused_ggnn.cu", str(tmp_path_factory.mktemp("emu_ggnn64_k2")))


@pytest.mark.parametrize("case", list(GGNN_CASES))
def test_emulated_k2_matches_plain_and_repeats_bit_for_bit(ggnn_lib, case):
    gc.check_k2(ggnn_lib, GGNN_CASES[case], seed=10 + len(case))
