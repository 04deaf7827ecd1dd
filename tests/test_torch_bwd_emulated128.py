"""K1b at H=128 (the reverse body of ``fused_ggnn128_bwd.cuh``:
``fused_ggnn_bwd.cu``'s ``fused_ggnn_bwd_kernel128``, its two launches: F,
the forward storing each layer's m, r, z and n, then R, the reverse that
reads them) run on the CPU.

The source is compiled with g++ against the CPU stand-in for the CUDA
runtime (``tests/cuda_emu``), which emulates the warp's m16n8k8 TF32
``mma.sync`` and ``ldmatrix`` the body's 3xTF32 products are made of, and
traps when a staged weight panel is handed out under another name than it
was loaded with, so the body's sequences of weight blocks (88 a layer in
the forward and 88 in the reverse) are checked too.  K1b's gradients are held against the plain
PyTorch version at chip_smoke.py's gradient bound
(``cuda_emu/ggnn_checks.py``) on one tile at L=2 whose rows exceed the
kernel's 16 neighbour slots (their transposed aggregation reads the
dense rows).  K3's and K2b's H=128 cases are
``test_torch_bwd_emulated128_k3.py``'s and
``test_torch_bwd_emulated128_k2b.py``'s, one case a file, so that
pytest-xdist's ``--dist loadfile`` runs them on other workers."""

from cuda_emu import ggnn_checks as gc
from cuda_emu.emulate import build_emulated


def test_emulated_k1b_matches_plain_at_h128_on_a_crowded_tile(tmp_path):
    lib = build_emulated("fused_ggnn_bwd.cu", str(tmp_path))
    # (tiles, layers, hidden, crowded rows)
    gc.check_k1b(lib, (1, 2, 128, True))
