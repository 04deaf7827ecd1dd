"""The port's dense packed batch against the JAX package's, on the CPU:

- ``pack_pair_dataset_batch`` array for array (dtype, shape, bytes) with
  and without ``num_tiles``, with the GWM supernode table, and with
  multi-hot labels; ``num_tiles``, ``num_edges`` and ``occupancy``;
- the JAX packer's two errors: a molecule larger than the tile, and
  ``num_tiles`` below what the batch needs;
- ``PackedCOOBatch.to_dense`` against the JAX ``to_dense``;
- the native dense route (``pack_pairs_native(..., want_dense=True)``,
  native/pack.cpp) byte for byte against the Python packer (skipped
  without g++, as tests/test_torch_host_layer.py is).

The dense predictors: tests/test_torch_dense_predictor.py; two train
steps and the iterator: tests/test_torch_dense_train.py."""

import os
import shutil

import numpy as np
import pandas as pd
import pytest

from gcnbmp_tpu.data import packing as jpacking
from gcnbmp_tpu.models import gwm as jgwm
from gcnbmp_tpu_torch.chem import GGNNFeaturizer, mol_from_smiles
from gcnbmp_tpu_torch.data import CSVPairParser
from gcnbmp_tpu_torch.data import packing as tpacking
from gcnbmp_tpu_torch.data.dataset import PairDataset
from gcnbmp_tpu_torch.models import gwm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_train.csv")
ARRAYS = ("atom_ids", "adj", "mol_id", "node_mask", "left_index",
          "right_index", "labels")


def _dataset(n, skip=0):
    """Pairs of synth546, parsed afresh: each package's packer caches its
    supernode vectors on the graphs it packs, so each gets its own."""
    df = pd.read_csv(PAIRS).iloc[skip:skip + n]
    return CSVPairParser().parse(df).dataset


def _multi_hot(n, classes=3, seed=4):
    rng = np.random.default_rng(seed)
    f = GGNNFeaturizer()
    smiles = ["CCO", "c1ccccc1O", "CC(=O)Nc1ccc(O)cc1", "C=O", "CCN",
              "CC(C)Cc1ccc(cc1)C(C)C(=O)O"]
    ds = PairDataset()
    for _ in range(n):
        ds.append(f(mol_from_smiles(smiles[int(rng.integers(len(smiles)))])),
                  f(mol_from_smiles(smiles[int(rng.integers(len(smiles)))])),
                  rng.integers(0, 2, size=classes).astype(np.float32))
    return ds


def _assert_same_batch(got, want):
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert got.num_mols == want.num_mols
    assert got.num_tiles == want.num_tiles
    assert got.num_edges == want.num_edges
    assert got.occupancy == want.occupancy


@pytest.mark.parametrize("supers", [False, True], ids=["plain", "supers"])
@pytest.mark.parametrize("num_tiles", [None, 11])
def test_pack_pair_dataset_batch_equals_jax(supers, num_tiles):
    idx = list(np.random.default_rng(1).permutation(24)[:20])
    got = tpacking.pack_pair_dataset_batch(
        _dataset(24), idx, num_tiles=num_tiles,
        supernode_fn=gwm.default_supernode_fn() if supers else None)
    want = jpacking.pack_pair_dataset_batch(
        _dataset(24), idx, num_tiles=num_tiles,
        supernode_fn=jgwm.default_supernode_fn() if supers else None)
    _assert_same_batch(got, want)
    assert got.adj.shape[1:] == (4, 128, 128)
    assert set(np.unique(got.adj)) <= {0.0, 1.0}
    assert (got.supers is None) == (not supers)
    if supers:
        assert got.supers.dtype == want.supers.dtype
        assert got.supers.tobytes() == want.supers.tobytes()
    if num_tiles is not None:
        assert got.num_tiles == num_tiles


def test_multi_hot_labels_equal_jax():
    ds = _multi_hot(10)
    got = tpacking.pack_pair_dataset_batch(ds, list(range(10)))
    want = jpacking.pack_pair_dataset_batch(ds, list(range(10)))
    assert got.labels.shape == (10, 3)
    _assert_same_batch(got, want)


def test_the_errors_of_the_jax_packer():
    """A molecule over the tile, and a tile count under the batch's need:
    the same exception and message as the JAX packer."""
    ds = _dataset(8)
    biggest = max(g.num_atoms for g in ds.graphs1 + ds.graphs2)
    for kwargs in (dict(tile=biggest - 1), dict(num_tiles=1)):
        with pytest.raises(ValueError) as want:
            jpacking.pack_pair_dataset_batch(ds, list(range(8)), **kwargs)
        with pytest.raises(ValueError) as got:
            tpacking.pack_pair_dataset_batch(ds, list(range(8)), **kwargs)
        assert str(got.value) == str(want.value)


def test_to_dense_equals_jax():
    """The COO batch's host-built dense form, against the JAX COO batch's
    ``to_dense`` and the dense packer of the same pairs."""
    ds, idx = _dataset(16), list(range(16))
    coo = tpacking.pack_pair_dataset_coo(ds, idx, num_tiles=9,
                                         edge_capacity=1024)
    got = coo.to_dense()
    want = jpacking.pack_pair_dataset_coo(ds, idx, num_tiles=9,
                                          edge_capacity=1024).to_dense()
    _assert_same_batch(got, want)
    assert got.adj.tobytes() == tpacking.pack_pair_dataset_batch(
        ds, idx, num_tiles=9).adj.tobytes()


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="the native packer is built with g++")
@pytest.mark.parametrize("num_tiles", [None, 14])
def test_native_dense_pack_equals_python(num_tiles):
    from gcnbmp_tpu_torch.data.native_pack import (
        PairDatasetCache, pack_pairs_native)

    ds = _dataset(40, skip=100)
    idx = list(np.random.default_rng(2).permutation(40)[:32])
    want = tpacking.pack_pair_dataset_batch(ds, idx, num_tiles=num_tiles)
    got = pack_pairs_native(PairDatasetCache(ds), idx, num_tiles=num_tiles,
                            want_dense=True, n_threads=2)
    assert isinstance(got, tpacking.PackedGraphBatch)
    _assert_same_batch(got, want)
    # the COO route of the same library is unchanged
    coo = pack_pairs_native(PairDatasetCache(ds), idx, num_tiles=num_tiles)
    assert isinstance(coo, tpacking.PackedCOOBatch)
    assert coo.to_dense().adj.tobytes() == want.adj.tobytes()
    multi = _multi_hot(6)
    _assert_same_batch(
        pack_pairs_native(PairDatasetCache(multi), list(range(6)),
                          want_dense=True),
        tpacking.pack_pair_dataset_batch(multi, list(range(6))))
