"""K4 (``set2set.cu``'s Set2Set forward) run on the CPU, as
``test_torch_mpnn_emulated.py`` runs the MPNN family's backward sources:
compiled with g++ against the CPU stand-in for the CUDA runtime
(``tests/cuda_emu``), at C = 32 and 16, tables of 24, 64 and 128 atoms, 1,
3 and 4 steps, with one empty molecule, on launches where a CTA has
groups without a molecule and where each group walks several molecules;
its output is held against the plain version at chip_smoke.py's bound for
the forward kernels, and a second run must give the same bits.  A file of
its own so that pytest-xdist's ``--dist loadfile`` runs it on another
worker."""

import pytest
import torch

from cuda_emu.emulate import build_emulated
from gcnbmp_tpu_torch.ops import set2set_kernel as sk
from test_torch_mpnn_emulated import _s2s_inputs

# K4: (molecules, n_max, channels, steps); molecule 3 has no atoms.  The
# emulated card's 3 SMs get min(3, M) CTAs of ceil(M / CTAs) groups (at
# most 4): 7 and 5 molecules leave groups of a CTA without one, 40, 30
# and 13 make groups walk several molecules
K4_CASES = [(7, 24, 32, 3), (5, 64, 16, 1), (40, 24, 32, 3), (30, 128, 16, 4),
            (13, 128, 32, 1), (9, 64, 32, 4)]
ATOL = RTOL = 1e-4  # chip_smoke.py's bound for the forward kernels


@pytest.fixture(scope="module")
def s2s_lib(tmp_path_factory):
    return build_emulated("set2set.cu",
                          str(tmp_path_factory.mktemp("emulated_set2set_k4")))


def _s2s_fwd(lib, steps, atoms, amask, wx, wh, b):
    """fused_set2set_fwd on CPU tensors."""
    m, n_max, ch = atoms.shape
    out = torch.empty((m, 2 * ch))
    err = lib.fused_set2set_fwd(
        atoms.data_ptr(), amask.data_ptr(), wx.data_ptr(), wh.data_ptr(),
        b.data_ptr(), out.data_ptr(), m, n_max, ch, steps, None)
    assert err == 0
    return out


@pytest.mark.parametrize("m,n_max,ch,steps", K4_CASES)
def test_emulated_k4_matches_plain_and_repeats_bit_for_bit(s2s_lib, m, n_max,
                                                           ch, steps):
    inputs = _s2s_inputs(m, n_max, ch, seed=m + n_max + ch)[:5]
    got = _s2s_fwd(s2s_lib, steps, *inputs)
    want = sk.fused_set2set_reference(steps, *inputs)
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all())
    assert float(got[3, ch:].abs().max()) == 0.0  # the empty molecule's r
    assert torch.equal(got, _s2s_fwd(s2s_lib, steps, *inputs))


@pytest.mark.parametrize("operand", [0, 2, 3])
def test_emulated_k4_refuses_operands_off_16_byte_boundaries(s2s_lib, operand):
    """K4 copies atoms, wx and wh to shared memory in bulk: an operand one
    float off a 16-byte boundary is refused before any launch."""
    inputs = _s2s_inputs(5, 24, 32, seed=0)[:5]
    m, n_max, ch = inputs[0].shape
    shifted = torch.zeros(inputs[operand].numel() + 1)
    shifted[1:] = inputs[operand].reshape(-1)
    ptrs = [x.data_ptr() for x in inputs]
    ptrs[operand] = shifted.data_ptr() + 4
    out = torch.zeros((m, 2 * ch))
    assert s2s_lib.fused_set2set_fwd(*ptrs, out.data_ptr(), m, n_max, ch, 3,
                                     None) != 0
    assert float(out.abs().max()) == 0.0
