"""The fused Set2Set kernels' plain versions (K4, K4b) against the JAX
package's ``fused_set2set`` (Pallas in interpret mode on the CPU) and its
``jax.vjp``; ``gradcheck`` of ``FusedSet2SetFunction``; the slot table
(``gather_slot_table``, ``_device_slot_table``) against the JAX one,
values and gradient; the wrappers' CPU and other-device behaviour.  The
CUDA kernels are checked against these plain versions on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.ops import set2set_kernel as jsk
from gcnbmp_tpu.ops import slotgather as jsg
from gcnbmp_tpu_torch.models.packed import _device_slot_table
from gcnbmp_tpu_torch.ops import set2set_kernel as tsk
from gcnbmp_tpu_torch.ops import slotgather as tsg

torch.set_num_threads(1)

OUT_RTOL, OUT_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-5  # the JAX suite's bound (test_encoders.py:438-441)
STEPS = 3


def _inputs(m, n_max, ch, seed):
    """A masked atom table with one empty molecule (pair padding), LSTM
    weights in i|f|g|o order, and an upstream gradient."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, n_max + 1, m)
    counts[1] = 0
    counts[-1] = n_max
    amask = (np.arange(n_max)[None] < counts[:, None]).astype(np.float32)
    atoms = (rng.standard_normal((m, n_max, ch)) * amask[..., None]).astype(np.float32)
    f32 = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)
    wx = f32(2 * ch, 4 * ch, scale=(2 * ch) ** -0.5)
    wh = f32(ch, 4 * ch, scale=ch ** -0.5)
    b = f32(1, 4 * ch, scale=0.1)
    dg = f32(m, 2 * ch, scale=1.0)
    return atoms, amask, wx, wh, b, dg


CASES = [(24, 8), (64, 8), (24, 16), (64, 16)]


@pytest.mark.parametrize("n_max,ch", CASES)
def test_k4_plain_matches_jax(n_max, ch):
    atoms, amask, wx, wh, b, _ = _inputs(6, n_max, ch, seed=n_max + ch)
    with pltpu.force_tpu_interpret_mode():
        want = jsk.fused_set2set(STEPS, *map(jnp.asarray, (atoms, amask, wx, wh, b)))
    got = tsk.fused_set2set_reference(STEPS, *map(torch.as_tensor,
                                                  (atoms, amask, wx, wh, b)))
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    # the empty molecule: uniform attention over nothing, r = 0
    np.testing.assert_array_equal(got.numpy()[1, ch:], 0.0)


@pytest.mark.parametrize("n_max,ch", CASES)
def test_k4b_plain_matches_jax_vjp(n_max, ch):
    atoms, amask, wx, wh, b, dg = _inputs(6, n_max, ch, seed=2 * n_max + ch)
    jamask = jnp.asarray(amask)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, x, h, bb: jsk.fused_set2set(STEPS, a, jamask, x, h, bb),
                         *map(jnp.asarray, (atoms, wx, wh, b)))
        want = vjp(jnp.asarray(dg))
    got = tsk.fused_set2set_bwd_reference(STEPS, *map(torch.as_tensor, (
        atoms, amask, wx, wh, b, dg)))
    for name, a, w in zip(("datoms", "dwx", "dwh", "db"), got, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_plain_backward_matches_torch_autograd():
    atoms, amask, wx, wh, b, dg = _inputs(5, 24, 8, seed=9)
    wrt = [torch.as_tensor(x).requires_grad_(True) for x in (atoms, wx, wh, b)]
    out = tsk.fused_set2set_reference(STEPS, wrt[0], torch.as_tensor(amask), *wrt[1:])
    want = torch.autograd.grad(out, wrt, torch.as_tensor(dg))
    got = tsk.fused_set2set_bwd_reference(STEPS, *map(torch.as_tensor, (
        atoms, amask, wx, wh, b, dg)))
    for name, a, w in zip(("datoms", "dwx", "dwh", "db"), got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_fused_set2set_function_gradcheck():
    atoms, amask, wx, wh, b, _ = _inputs(3, 5, 2, seed=11)
    args = [torch.as_tensor(x).double().requires_grad_(True) for x in (atoms, wx, wh, b)]
    mask = torch.as_tensor(amask).double()
    fn = lambda a, x, h, bb: tsk.fused_set2set(STEPS, a, mask, x, h, bb)
    assert torch.autograd.gradcheck(fn, args)


def _packed_ids(seed=5):
    """Flat (ids, valid) of three tiles of 16 slots holding contiguous
    molecule runs, with tile padding carrying the sentinel id, and an
    absent molecule (pair padding)."""
    sizes = [[5, 7], [9, 4], [3, 6, 2]]
    ids, valid, m = [], [], 0
    for tile in sizes:
        for s in tile:
            ids += [m] * s
            valid += [1.0] * s
            m += 1
        pad = 16 - sum(tile)
        ids += [-1] * pad
        valid += [0.0] * pad
    num_mols = m + 1  # the last molecule has no atoms
    ids = np.array([num_mols if i < 0 else i for i in ids], np.int32)
    return ids, np.array(valid, np.float32), num_mols


@pytest.mark.parametrize("n_max", [8, 16])
def test_slot_table_matches_jax(n_max):
    ids, valid, num_mols = _packed_ids()
    j_slots, j_amask, j_over = jpacked._device_slot_table(
        jnp.asarray(ids), jnp.asarray(valid), num_mols, n_max)
    slots, amask, over = _device_slot_table(torch.as_tensor(ids),
                                            torch.as_tensor(valid), num_mols, n_max)
    np.testing.assert_array_equal(amask.numpy(), np.asarray(j_amask))
    assert bool(over) == bool(j_over) == (n_max < 9)
    real = np.asarray(j_amask) > 0  # pad entries are arbitrary but masked
    np.testing.assert_array_equal(slots.numpy()[real], np.asarray(j_slots)[real])

    rng = np.random.default_rng(n_max)
    flat = rng.standard_normal((ids.shape[0], 4)).astype(np.float32)
    g = rng.standard_normal((num_mols, n_max, 4)).astype(np.float32)
    j_row = jsg.identity_mol_row(num_mols)
    want, vjp = jax.vjp(lambda f: jsg.gather_slot_table(
        f, j_slots, j_amask, jnp.asarray(ids), j_row), jnp.asarray(flat))
    want_grad, = vjp(jnp.asarray(g))
    flat_t = torch.as_tensor(flat).requires_grad_(True)
    got = tsg.gather_slot_table(flat_t, slots, amask, torch.as_tensor(ids),
                                tsg.identity_mol_row(num_mols))
    got.backward(torch.as_tensor(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(flat_t.grad.numpy(), np.asarray(want_grad))


def test_slot_gather_backward_scales_by_fractional_masks():
    ids, valid, num_mols = _packed_ids()
    slots, amask, _ = _device_slot_table(torch.as_tensor(ids),
                                         torch.as_tensor(valid), num_mols, 16)
    amask = amask * 0.5
    flat = torch.randn(ids.shape[0], 3, dtype=torch.float64, requires_grad=True)
    fn = lambda f: tsg.gather_slot_table(f, slots, amask.double(),
                                         torch.as_tensor(ids),
                                         tsg.identity_mol_row(num_mols))
    assert torch.autograd.gradcheck(fn, (flat,))


def test_overflowing_molecule_turns_set2set_nan_in_both():
    """A molecule wider than the table poisons the output in the port's
    PackedSet2Set as in the JAX one (both modes)."""
    from gcnbmp_tpu_torch.models.packed import PackedSet2Set

    ids, valid, num_mols = _packed_ids()
    h = np.random.default_rng(0).standard_normal((3, 16, 4)).astype(np.float32)
    mol_id = ids.reshape(3, 16)
    node_mask = valid.reshape(3, 16)
    jmod = jpacked.PackedSet2Set(4, dense_n_max=8)
    args = (jnp.asarray(h), jnp.asarray(mol_id), jnp.asarray(node_mask), num_mols)
    params = jmod.init(jax.random.PRNGKey(0), *args)
    want = np.asarray(jmod.apply(params, *args))
    mod = PackedSet2Set(4, dense_n_max=8)
    from gcnbmp_tpu_torch.convert import from_jax_params

    from_jax_params(jax.tree_util.tree_map(np.array, params["params"]), mod)
    targs = (torch.as_tensor(h), torch.as_tensor(mol_id),
             torch.as_tensor(node_mask), num_mols)
    for fused in (False, True):
        got = mod(*targs, fused=fused).detach().numpy()
        assert np.isnan(want).all() and np.isnan(got).all()


def test_wrappers_on_cpu_launch_nothing():
    atoms, amask, wx, wh, b, dg = map(torch.as_tensor, _inputs(4, 24, 16, seed=1))
    tsk.fused_set2set.launches = tsk.fused_set2set_bwd.launches = 0
    before = tsk.FusedSet2SetFunction.backward_calls
    a = atoms.clone().requires_grad_(True)
    out = tsk.fused_set2set(STEPS, a, amask, wx, wh, b)
    out.backward(dg)
    assert out.shape == (4, 32) and a.grad.shape == atoms.shape
    assert tsk.FusedSet2SetFunction.backward_calls == before + 1
    datoms, dwx, dwh, db = tsk.fused_set2set_bwd(STEPS, atoms, amask, wx, wh, b, dg)
    assert dwx.shape == wx.shape and dwh.shape == wh.shape and db.shape == b.shape
    assert tsk.fused_set2set.launches == 0 and tsk.fused_set2set_bwd.launches == 0


@pytest.mark.parametrize("backward", [False, True])
def test_wrappers_raise_on_other_devices(backward):
    atoms, amask, wx, wh, b, dg = (torch.as_tensor(x).to("meta")
                                   for x in _inputs(4, 24, 16, seed=1))
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        if backward:
            tsk.fused_set2set_bwd(STEPS, atoms, amask, wx, wh, b, dg)
        else:
            tsk.fused_set2set(STEPS, atoms, amask, wx, wh, b)
    assert tsk.fused_set2set.launches == 0 and tsk.fused_set2set_bwd.launches == 0
