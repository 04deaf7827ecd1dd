"""K3 at H=64 (each half of the two-pass backward on the reverse body of
``fused_ggnn64.cuh``), run on the CPU against the CPU stand-in for the
CUDA runtime (``tests/cuda_emu``): each half's gradients against the
plain PyTorch version at chip_smoke.py's gradient bound, the halves summed
against K1b (``cuda_emu/ggnn_checks.py``), on one tile at L=2; the case
of a tile whose rows exceed the kernel's 16 neighbour slots is
``test_torch_bwd_emulated64_k3_crowded.py``'s and the L=3 case (the odd
split, whose top half starts at lo = 1 > 0)
``test_torch_bwd_emulated64_k3_l3.py``'s.  A file of its own, so that
pytest-xdist's ``--dist loadfile`` can run these cases beside the other
H=64 ones (``test_torch_bwd_emulated64.py``,
``test_torch_bwd_emulated64_k2b.py``)."""

import pytest

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import build_emulated

# (tiles, layers, hidden, crowded rows)
CASES = {"h64": (1, 2, 64, False)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The backward source built with g++ against the CPU stand-in."""
    return build_emulated("fused_ggnn_bwd.cu",
                          str(tmp_path_factory.mktemp("emulated_bwd64_k3")))


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_k3_halves_match_plain_and_sum_to_k1b(lib, case):
    gc.check_k3(lib, CASES[case])
