"""The fused MPNN kernels' plain versions (K5, K5b) against the JAX
package's ``fused_mpnn`` (Pallas in interpret mode on the CPU, as
tests/test_encoders.py runs it) and its ``jax.vjp``; ``gradcheck`` of
``FusedMPNNFunction``; the wrappers' CPU and other-device behaviour.  The
CUDA kernels are checked against these plain versions on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcnbmp_tpu.chem import GGNNFeaturizer, mol_from_smiles
from gcnbmp_tpu.data.dataset import PairDataset
from gcnbmp_tpu.data.packing import pack_pair_dataset_batch
from gcnbmp_tpu.ops import fused_mpnn as jfm
from gcnbmp_tpu_torch.ops import fused_mpnn as tfm
from gcnbmp_tpu_torch.ops.fused_ggnn import GRU_KEYS

torch.set_num_threads(1)

OUT_RTOL, OUT_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-5  # the JAX suite's bound (test_encoders.py:438-441)
T = 128
SMILES = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "C=O", "CCN",
          "Cn1cnc2c1c(=O)n(C)c(=O)n2C", "OCC(O)CO", "c1ccncc1"]


def _real_tiles(seed=7, pairs=30):
    """(adj_flat, mol_id, node_mask) of real packed molecules."""
    rng = np.random.default_rng(seed)
    f = GGNNFeaturizer()
    ds = PairDataset()
    for _ in range(pairs):
        ds.append(f(mol_from_smiles(SMILES[int(rng.integers(len(SMILES)))])),
                  f(mol_from_smiles(SMILES[int(rng.integers(len(SMILES)))])),
                  np.float32(0))
    b = pack_pair_dataset_batch(ds, list(range(pairs)))
    p = b.adj.shape[0]
    adj_flat = np.transpose(b.adj, (0, 2, 1, 3)).reshape(p, T, 4 * T)
    return (adj_flat.astype(np.float32), b.mol_id.astype(np.int32),
            b.node_mask.astype(np.float32))


def _crowded_tile(seed=3):
    """One tile with a random asymmetric adjacency (sparse, with eight
    rows above 16 nonzeros; values not 1) and molecule runs with pad
    slots."""
    rng = np.random.default_rng(seed)
    nz = rng.random((1, T, 4 * T)) < 0.005
    nz[:, ::16] |= rng.random((1, T // 16, 4 * T)) < 0.05
    adj = nz * rng.uniform(0.5, 1.5, (1, T, 4 * T))
    assert ((adj != 0).sum(-1) > 16).sum() >= 4
    mol_id = np.repeat(np.arange(6), [30, 20, 25, 15, 10, 28])[None].astype(np.int32)
    node_mask = (np.arange(T) < 100)[None].astype(np.float32)
    mol_id[:, 100:] = 99  # pad slots carry the sentinel id
    return adj.astype(np.float32), mol_id, node_mask


def _weights(hidden, n_layers, tied, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)
    n = 1 if tied else n_layers
    wt = f32(n, 4, hidden, hidden, scale=hidden ** -0.5)
    m0t = f32(n, hidden, hidden, scale=0.3 * hidden ** -0.5)
    gru = {k: f32(*tfm.gru_stack_shape(k, n, hidden),
                  scale=0.1 if k[0] == "b" else tfm.gru_stack_shape(k, n, hidden)[1] ** -0.5)
           for k in GRU_KEYS}
    if tied:  # the tied model stacks its one set L times
        wt, m0t = np.repeat(wt, n_layers, 0), np.repeat(m0t, n_layers, 0)
        gru = {k: np.repeat(v, n_layers, 0) for k, v in gru.items()}
    return wt, m0t, gru


def _case(tiles, hidden, n_layers, tied, seed):
    adj, mol_id, node_mask = _real_tiles() if tiles == "real" else _crowded_tile()
    rng = np.random.default_rng(seed + 100)
    h0 = rng.standard_normal((adj.shape[0], T, hidden)).astype(np.float32)
    dh = rng.standard_normal(h0.shape).astype(np.float32)
    return h0, adj, mol_id, node_mask, _weights(hidden, n_layers, tied, seed), dh


def _torch(x):
    return ({k: torch.as_tensor(v) for k, v in x.items()} if isinstance(x, dict)
            else torch.as_tensor(x))


def _jax_args(h0, adj, mol_id, node_mask, weights):
    wt, m0t, gru = weights
    molmat = tfm.build_molmat(torch.as_tensor(mol_id), torch.as_tensor(node_mask))
    return (jnp.asarray(h0), jnp.asarray(adj), jnp.asarray(molmat.numpy()),
            jnp.asarray(wt), jnp.asarray(m0t),
            {k: jnp.asarray(v) for k, v in gru.items()})


CASES = [("real", 8, 3, True), ("real", 8, 3, False), ("real", 16, 2, False),
         ("crowded", 8, 2, True), ("crowded", 16, 3, False)]


def test_build_molmat_matches_jax():
    _, mol_id, node_mask = _real_tiles()
    want = jfm.build_molmat(jnp.asarray(mol_id), jnp.asarray(node_mask))
    got = tfm.build_molmat(torch.as_tensor(mol_id), torch.as_tensor(node_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tiles,hidden,n_layers,tied", CASES)
def test_k5_plain_matches_jax(tiles, hidden, n_layers, tied):
    h0, adj, mol_id, node_mask, weights, _ = _case(tiles, hidden, n_layers, tied, 1)
    jh0, jadj, jmol, jwt, jm0t, jgru = _jax_args(h0, adj, mol_id, node_mask, weights)
    with pltpu.force_tpu_interpret_mode():
        want = jfm.fused_mpnn(n_layers, tied, jh0, jadj, jmol, jwt, jm0t, jgru)
    wt, m0t, gru = weights
    got = tfm.fused_mpnn_reference(n_layers, tied, *map(_torch, (
        h0, adj, mol_id, node_mask, wt, m0t, gru)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OUT_RTOL,
                               atol=OUT_ATOL)


def _flat(dh0, dwt, dm0t, dgru):
    return [("dh0", dh0), ("dwt", dwt), ("dm0t", dm0t)] + [
        (f"d{k}", dgru[k]) for k in GRU_KEYS]


@pytest.mark.parametrize("tiles,hidden,n_layers,tied", CASES)
def test_k5b_plain_matches_jax_vjp(tiles, hidden, n_layers, tied):
    h0, adj, mol_id, node_mask, weights, dh = _case(tiles, hidden, n_layers, tied, 2)
    jh0, jadj, jmol, jwt, jm0t, jgru = _jax_args(h0, adj, mol_id, node_mask, weights)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda h, w, m, g: jfm.fused_mpnn(
            n_layers, tied, h, jadj, jmol, w, m, g), jh0, jwt, jm0t, jgru)
        want = vjp(jnp.asarray(dh))
    wt, m0t, gru = weights
    got = tfm.fused_mpnn_bwd_reference(n_layers, tied, *map(_torch, (
        h0, adj, mol_id, node_mask, wt, m0t, gru, dh)))
    for (name, a), b in zip(_flat(*got), [x for _, x in _flat(*want)]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("tied", [True, False])
def test_plain_backward_matches_torch_autograd(tied):
    h0, adj, mol_id, node_mask, (wt, m0t, gru), dh = _case("crowded", 8, 3, tied, 3)
    wrt = [_torch(h0), _torch(wt), _torch(m0t)] + [_torch(gru[k]) for k in GRU_KEYS]
    for t in wrt:
        t.requires_grad_(True)
    out = tfm.fused_mpnn_reference(3, tied, wrt[0], _torch(adj), _torch(mol_id),
                                   _torch(node_mask), wrt[1], wrt[2],
                                   dict(zip(GRU_KEYS, wrt[3:])))
    want = torch.autograd.grad(out, wrt, _torch(dh))
    plain = [t.detach() for t in wrt]
    got = tfm.fused_mpnn_bwd_reference(3, tied, plain[0], _torch(adj),
                                       _torch(mol_id), _torch(node_mask),
                                       plain[1], plain[2],
                                       dict(zip(GRU_KEYS, plain[3:])), _torch(dh))
    for (name, a), b in zip(_flat(*got), want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("tied", [True, False])
def test_fused_mpnn_function_gradcheck(tied):
    g = torch.Generator().manual_seed(4)
    hidden, layers = 3, 2
    r = lambda *s: (torch.randn(*s, generator=g, dtype=torch.float64) * 0.5).requires_grad_()
    adj = (torch.rand(1, T, 4 * T, generator=g, dtype=torch.float64) < 0.02).double()
    mol_id = torch.repeat_interleave(torch.arange(4), torch.tensor([40, 30, 30, 28]))[None]
    node_mask = (torch.arange(T) < 110)[None].double()
    gru = {k: r(*tfm.gru_stack_shape(k, layers, hidden)) for k in GRU_KEYS}
    fn = lambda h0, wt, m0t, *gv: tfm.fused_mpnn(
        layers, tied, h0, adj, mol_id, node_mask, wt, m0t, dict(zip(GRU_KEYS, gv)))
    assert torch.autograd.gradcheck(
        fn, (r(1, T, hidden), r(layers, 4, hidden, hidden), r(layers, hidden, hidden),
             *(gru[k] for k in GRU_KEYS)))


def test_wrappers_on_cpu_launch_nothing():
    h0, adj, mol_id, node_mask, (wt, m0t, gru), dh = _case("crowded", 16, 2, False, 5)
    args = [_torch(a) for a in (h0, adj, mol_id, node_mask, wt, m0t, gru)]
    tfm.fused_mpnn.launches = tfm.fused_mpnn_bwd.launches = 0
    before = tfm.FusedMPNNFunction.backward_calls
    h0_t = args[0].clone().requires_grad_(True)
    out = tfm.fused_mpnn(2, False, h0_t, *args[1:])
    out.backward(_torch(dh))
    assert out.shape == (1, T, 16) and h0_t.grad.shape == (1, T, 16)
    res = tfm.fused_mpnn_bwd(2, False, *args, _torch(dh))
    assert res[1].shape == (2, 4, 16, 16) and set(res[3]) == set(GRU_KEYS)
    assert tfm.FusedMPNNFunction.backward_calls == before + 1
    assert tfm.fused_mpnn.launches == 0 and tfm.fused_mpnn_bwd.launches == 0


@pytest.mark.parametrize("backward", [False, True])
def test_wrappers_raise_on_other_devices(backward):
    h0, adj, mol_id, node_mask, (wt, m0t, gru), dh = _case("crowded", 16, 2, False, 6)
    meta = [_torch(a) for a in (h0, adj, mol_id, node_mask, wt, m0t)]
    meta = [t.to("meta") for t in meta] + [{k: v.to("meta") for k, v in _torch(gru).items()}]
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        if backward:
            tfm.fused_mpnn_bwd(2, False, *meta, _torch(dh).to("meta"))
        else:
            tfm.fused_mpnn(2, False, *meta)
    assert tfm.fused_mpnn.launches == 0 and tfm.fused_mpnn_bwd.launches == 0


def test_grad_layout_matches_kernel_order():
    """The summed gradient row splits into the shapes of the weights, in
    the order the CUDA kernel writes them (MpnnGradLayout)."""
    shapes = tfm._grad_shapes(8, 32)
    sizes = [int(np.prod(s)) for s in shapes]
    cc = 32 * 32
    assert sum(sizes) == 8 * 5 * cc + 3 * 8 * (3 * cc + 32)
    assert shapes[0] == (8, 4, 32, 32) and shapes[1] == (8, 32, 32)
    # per gate: w (L, 2C, C), u (L, C, C), b (L, C), gates z, r, n
    assert shapes[2:5] == [(8, 64, 32), (8, 32, 32), (8, 32)]
    assert [k[0] for k in GRU_KEYS] == ["w", "u", "b"] * 3
