"""K2b at H=64 (the reverse body of ``fused_ggnn64.cuh`` with the
readout's backward), run on the CPU against the CPU stand-in for the CUDA
runtime (``tests/cuda_emu``): its gradients against the plain PyTorch
version at chip_smoke.py's gradient bound, and two runs with the same bits
(``cuda_emu/ggnn_checks.py``), on one tile at L=2; the case of a tile
whose rows exceed the kernel's 16 neighbour slots is
``test_torch_bwd_emulated64_k2b_crowded.py``'s and the L=3 case
``test_torch_bwd_emulated64_k2b_l3.py``'s.  A file of its own, so that
pytest-xdist's ``--dist loadfile`` can run these cases beside the other
H=64 ones (``test_torch_bwd_emulated64.py``,
``test_torch_bwd_emulated64_k3.py``)."""

import pytest

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import build_emulated

# (tiles, layers, hidden, crowded rows)
CASES = {"h64": (1, 2, 64, False)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The backward source built with g++ against the CPU stand-in."""
    return build_emulated("fused_ggnn_bwd.cu",
                          str(tmp_path_factory.mktemp("emulated_bwd64_k2b")))


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_k2b_matches_plain_and_repeats_bit_for_bit(lib, case):
    gc.check_k2b(lib, CASES[case])
