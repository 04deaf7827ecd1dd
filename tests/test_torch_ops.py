"""Parity of the port's host encoding and plain ops with the JAX package.

Inputs are made with numpy from a seed and fed to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcnbmp_tpu.chem import GGNNFeaturizer, mol_from_smiles
from gcnbmp_tpu.data.dataset import PairDataset
from gcnbmp_tpu.data.packing import pack_pair_dataset_coo
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.ops import aggregate as jagg
from gcnbmp_tpu.ops import circular as jcirc
from gcnbmp_tpu_torch.data.wire import compact_coo_arrays
from gcnbmp_tpu_torch.models.packed import _segment_mol_sum, decode_compact_wire
from gcnbmp_tpu_torch.ops import aggregate as tagg
from gcnbmp_tpu_torch.ops.circular import circular_correlation

torch.set_num_threads(1)

SMILES = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "C=O",
          "Cn1cnc2c1c(=O)n(C)c(=O)n2C", "CC(C)Cc1ccc(cc1)C(C)C(=O)O"]
RTOL, ATOL = 1e-5, 1e-6


def _coo_batch(n_pairs=6, seed=0, num_tiles=None, edge_capacity=None):
    f = GGNNFeaturizer()
    rng = np.random.default_rng(seed)
    ds = PairDataset()
    for _ in range(n_pairs):
        s1, s2 = (SMILES[int(i)] for i in rng.integers(len(SMILES), size=2))
        ds.append(f(mol_from_smiles(s1)), f(mol_from_smiles(s2)),
                  np.float32(rng.integers(0, 2)))
    return pack_pair_dataset_coo(ds, list(range(n_pairs)), num_tiles=num_tiles,
                                 edge_capacity=edge_capacity)


def _gapped(batch, seed=1):
    """The batch with its real edges scattered among padding edges (as
    pair-local merged batches have them)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(batch.e_mask))
    for name in ("e_tile", "e_type", "e_src", "e_dst", "e_mask"):
        setattr(batch, name, getattr(batch, name)[order])
    return batch


@pytest.mark.parametrize("gapped", [False, True])
def test_compact_coo_arrays_bit_identical(gapped):
    batch = _coo_batch(num_tiles=4, edge_capacity=512)
    if gapped:
        batch = _gapped(batch)
    ours = compact_coo_arrays(batch)
    theirs = jpacked.compact_coo_arrays(batch)
    for a, b in zip(ours, theirs):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_decode_compact_wire_matches_jax():
    batch = _coo_batch(edge_capacity=512)
    nodes, e_packed, n_edges, left, _ = compact_coo_arrays(batch)
    num_mols = 2 * len(left)
    ours = decode_compact_wire(torch.as_tensor(nodes),
                               torch.as_tensor(e_packed),
                               torch.as_tensor(n_edges), num_mols)
    theirs = jpacked.decode_compact_wire(jnp.asarray(nodes),
                                         jnp.asarray(e_packed),
                                         jnp.asarray(n_edges), num_mols)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def _edge_args(batch, extra_bad=False):
    args = [batch.e_tile, batch.e_type, batch.e_src, batch.e_dst, batch.e_mask]
    if extra_bad:
        # out-of-range edges: beyond the array (dropped) and negative
        # (wrapped once, as JAX indexing does)
        p = batch.atom_ids.shape[0]
        bad = [np.array([p + 3, -1], np.int32), np.array([1, 3], np.int32),
               np.array([5, 127], np.int32), np.array([7, 127], np.int32),
               np.array([1.0, 1.0], np.float32)]
        args = [np.concatenate([a, b]) for a, b in zip(args, bad)]
    return args


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("extra_bad", [False, True])
def test_adj_from_coo_matches_jax(flat, extra_bad):
    batch = _coo_batch(num_tiles=5, edge_capacity=768)  # padding edges too
    args = _edge_args(batch, extra_bad)
    p, t = batch.atom_ids.shape
    jfn, tfn = ((jagg.adj_from_coo_flat, tagg.adj_from_coo_flat) if flat
                else (jagg.adj_from_coo, tagg.adj_from_coo))
    want = jfn(*(jnp.asarray(a) for a in args), num_tiles=p, tile=t)
    got = tfn(*(torch.as_tensor(a) for a in args), num_tiles=p, tile=t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_edge_type_aggregate_matches_jax():
    rng = np.random.default_rng(3)
    adj = (rng.random((2, 4, 16, 16)) < 0.1).astype(np.float32)
    msg = rng.standard_normal((2, 4, 16, 8)).astype(np.float32)
    want = jagg.edge_type_aggregate(jnp.asarray(adj), jnp.asarray(msg))
    got = tagg.edge_type_aggregate(torch.as_tensor(adj), torch.as_tensor(msg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [16, 32, 33])
def test_circular_correlation_matches_jax(d):
    rng = np.random.default_rng(d)
    a = rng.standard_normal((7, d)).astype(np.float32)
    b = rng.standard_normal((7, d)).astype(np.float32)
    want = jcirc.circular_correlation(jnp.asarray(a), jnp.asarray(b))
    got = circular_correlation(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)
    # and the definition, corr[k] = sum_d a[d] b[(d + k) % D]
    direct = np.stack([(a * np.roll(b, -k, axis=-1)).sum(-1) for k in range(d)], -1)
    np.testing.assert_allclose(got.numpy(), direct, rtol=1e-4, atol=1e-4)


def test_segment_mol_sum_with_padding_slots():
    batch = _coo_batch(num_tiles=5)
    assert (batch.mol_id == batch.num_mols).any()  # padding slots present
    rng = np.random.default_rng(4)
    g = rng.standard_normal(batch.atom_ids.shape + (8,)).astype(np.float32)
    want = jpacked._segment_mol_sum(jnp.asarray(g), jnp.asarray(batch.mol_id),
                                    batch.num_mols)
    got = _segment_mol_sum(torch.as_tensor(g), torch.as_tensor(batch.mol_id),
                           batch.num_mols)
    assert got.shape == (batch.num_mols, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
