"""K2b at H=64 (the reverse body of ``fused_ggnn64.cuh`` with the
readout's backward) on a tile whose rows exceed the kernel's 16
neighbour slots, run on the CPU against the CPU stand-in for
the CUDA runtime (``tests/cuda_emu``), as
``test_torch_bwd_emulated64_k2b.py`` runs its other cases: its gradients
against the plain PyTorch version at chip_smoke.py's gradient bound, and
two runs with the same bits (``cuda_emu/ggnn_checks.py``).  A file of its
own so that pytest-xdist's ``--dist loadfile`` runs it on another worker."""

import pytest

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import build_emulated

# (tiles, layers, hidden, crowded rows)
CASES = {"h64_crowded": (1, 2, 64, True)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The backward source built with g++ against the CPU stand-in."""
    return build_emulated("fused_ggnn_bwd.cu",
                          str(tmp_path_factory.mktemp("emulated_bwd64_k2b_crowded")))


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_k2b_matches_plain_and_repeats_bit_for_bit(lib, case):
    gc.check_k2b(lib, CASES[case])
