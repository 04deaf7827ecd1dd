"""K1m's h_mid at H=128 (``fused_ggnn128_fwd.cuh``, a cluster of two CTAs
per tile) against the reverse body's forward (F of
``fused_ggnn128_bwd.cuh``, one CTA per tile), both run on the CPU: each
source compiled with g++ against the CPU stand-in for the CUDA runtime
(``tests/cuda_emu``).  F keeps each layer's input h in hs, and the input
of layer split must equal K1m's h_mid bit for bit on a tile whose rows
exceed the kernels' 16 neighbour slots (``cuda_emu/ggnn_checks.py``): the
two bodies take every entry's terms in the same order.  A file of its own
so that pytest-xdist's ``--dist loadfile`` runs it on another worker."""

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import build_emulated


def test_emulated_k1m_hmid_is_the_reverse_forwards_layer_input(tmp_path):
    (tmp_path / "fwd").mkdir()
    (tmp_path / "bwd").mkdir()
    fwd = build_emulated("fused_ggnn.cu", str(tmp_path / "fwd"))
    bwd = build_emulated("fused_ggnn_bwd.cu", str(tmp_path / "bwd"))
    # (tiles, hidden, crowded rows, layers)
    gc.check_hmid_is_f_hs(fwd, bwd, (1, 128, True, 2), seed=5)
