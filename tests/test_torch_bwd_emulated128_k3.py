"""K3 at H=128 (each half of the two-pass backward on the reverse body of
``fused_ggnn128_bwd.cuh``), run on the CPU against the CPU stand-in for
the CUDA runtime (``tests/cuda_emu``): on one tile at L=2, the top half
[1, 2) from h_mid (a range that starts above layer 0, so the GRU state's
term survives in dh_mid) and the bottom half [0, 1), each against the
plain PyTorch version at chip_smoke.py's gradient bound, and the halves
summed against K1b (``cuda_emu/ggnn_checks.py``).  A file of its own, so
that pytest-xdist's ``--dist loadfile`` runs it beside the other H=128
reverse cases (``test_torch_bwd_emulated128.py``,
``test_torch_bwd_emulated128_k2b.py``)."""

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import build_emulated


def test_emulated_k3_halves_match_plain_and_sum_to_k1b_at_h128(tmp_path):
    lib = build_emulated("fused_ggnn_bwd.cu", str(tmp_path))
    # (tiles, layers, hidden, crowded rows)
    gc.check_k3(lib, (1, 2, 128, False))
