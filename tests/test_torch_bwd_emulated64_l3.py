"""K1b at H=64 (the reverse body of ``fused_ggnn64.cuh``) at L=3, run on
the CPU against the CPU stand-in for the CUDA runtime (``tests/cuda_emu``),
as ``test_torch_bwd_emulated64.py`` runs its L=2 case: its gradients
against the plain PyTorch version at chip_smoke.py's gradient bound
(``cuda_emu/ggnn_checks.py``).  A file of its own so that pytest-xdist's
``--dist loadfile`` runs it on another worker."""

import pytest

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import build_emulated

# (tiles, layers, hidden, crowded rows)
CASES = {"h64_l3": (1, 3, 64, False)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The backward source built with g++ against the CPU stand-in."""
    return build_emulated("fused_ggnn_bwd.cu",
                          str(tmp_path_factory.mktemp("emulated_bwd64_l3")))


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_k1b_matches_plain(lib, case):
    gc.check_k1b(lib, CASES[case])
