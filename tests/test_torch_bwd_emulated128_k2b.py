"""K2b at H=128 (the reverse body of ``fused_ggnn128_bwd.cuh`` with the
readout's backward by column halves), run on the CPU against the CPU
stand-in for the CUDA runtime (``tests/cuda_emu``): on one tile at L=2,
its gradients against the plain PyTorch version at chip_smoke.py's
gradient bound, and a second run with the same bits
(``cuda_emu/ggnn_checks.py``).  A file of its own, so that pytest-xdist's
``--dist loadfile`` runs it beside the other H=128 reverse cases
(``test_torch_bwd_emulated128.py``, ``test_torch_bwd_emulated128_k3.py``)."""

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import build_emulated


def test_emulated_k2b_matches_plain_and_repeats_bit_for_bit_at_h128(tmp_path):
    lib = build_emulated("fused_ggnn_bwd.cu", str(tmp_path))
    # (tiles, layers, hidden, crowded rows)
    gc.check_k2b(lib, (1, 2, 128, False))
