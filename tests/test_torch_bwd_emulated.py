"""The GGNN reverse body's CUDA source, run on the CPU.

``gcnbmp_tpu_torch/ops/csrc/fused_ggnn_bwd.cu`` (K1b, K3 and K2b) is
compiled with g++ against a CPU stand-in for the CUDA runtime
(``tests/cuda_emu/cuda_runtime.h``: one thread per CUDA thread, barriers
for ``__syncthreads`` and the warp collectives), and its two C entry
points run on small packed batches.  Their gradients are held against the
plain PyTorch versions at chip_smoke.py's gradient bound, K3's halves
summed against K1b, and two K2b runs must give the same bits
(``cuda_emu/ggnn_checks.py``).  The H=64 body's cases, whose products the
stand-in takes through its emulated tensor-core instructions, are
``test_torch_bwd_emulated64{,_k3,_k2b}.py``'s.
This checks the body's indexing, synchronisation and arithmetic here; its
speed, and what nvcc makes of it, only the card can show (chip_smoke.py)."""

import pytest

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import build_emulated

# (tiles, layers, hidden, crowded rows): the flagship widths, H=16 and rows
# with more nonzeros than the kernel's 16 neighbour slots
CASES = {"h32": (2, 3, 32, False), "h16": (2, 2, 16, False),
         "crowded": (1, 3, 32, True)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The backward source built with g++ against the CPU stand-in."""
    return build_emulated("fused_ggnn_bwd.cu",
                          str(tmp_path_factory.mktemp("emulated_bwd")))


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_k1b_matches_plain(lib, case):
    gc.check_k1b(lib, CASES[case])


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_k3_halves_match_plain_and_sum_to_k1b(lib, case):
    gc.check_k3(lib, CASES[case])


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_k2b_matches_plain_and_repeats_bit_for_bit(lib, case):
    gc.check_k2b(lib, CASES[case])
