"""The port's own host layer (``gcnbmp_tpu_torch.chem``, ``.data``,
``.native_lib``) against the JAX package's: over the first 512 pairs of
synth546's drug test split, parsing, featurizing and COO packing are bit
for bit the JAX package's, with the native C++ parser and packer and
without them."""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from gcnbmp_tpu.chem import GGNNFeaturizer as JaxFeaturizer
from gcnbmp_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from gcnbmp_tpu.data import native_pack as jax_native_pack
from gcnbmp_tpu.data.packing import estimate_coo_capacities as jax_capacities
from gcnbmp_tpu.data.packing import max_atoms_lane_rounded as jax_max_atoms
from gcnbmp_tpu.data.packing import pack_pair_dataset_coo as jax_pack
from gcnbmp_tpu.data.packing import smallest_pair_index as jax_smallest
from gcnbmp_tpu.data.parsers import CSVPairParser as JaxParser
from gcnbmp_tpu_torch import native_lib
from gcnbmp_tpu_torch.chem import GGNNFeaturizer, mol_from_smiles
from gcnbmp_tpu_torch.data import native_pack
from gcnbmp_tpu_torch.data.packing import (
    estimate_coo_capacities, max_atoms_lane_rounded, pack_pair_dataset_coo,
    smallest_pair_index)
from gcnbmp_tpu_torch.data.parsers import CSVPairParser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_CSV = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_test.csv")
N = 512
GRAPH_FIELDS = ("atom_ids", "edge_src", "edge_dst", "edge_type")
BATCH_FIELDS = ("atom_ids", "mol_id", "node_mask", "e_tile", "e_type", "e_src",
                "e_dst", "e_mask", "left_index", "right_index", "labels")


@pytest.fixture(scope="module")
def frame():
    return pd.read_csv(TEST_CSV).head(N)


def _same_graphs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a.graphs1 + a.graphs2, b.graphs1 + b.graphs2):
        assert x.smiles == y.smiles
        for f in GRAPH_FIELDS:
            got, want = getattr(y, f), getattr(x, f)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f)
    for x, y in zip(a.labels, b.labels):
        np.testing.assert_array_equal(y, x)


def _same_batch(want, got):
    assert got.num_mols == want.num_mols
    for f in BATCH_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("native", [True, False])
def test_parse_featurize_and_pack_match_the_jax_package(frame, native):
    if native:
        assert native_pack.native_pack_available()
    want = JaxParser(use_native=native).parse(frame)
    got = CSVPairParser(use_native=native).parse(frame)
    assert got.fail_count == want.fail_count and len(got.dataset) == N
    np.testing.assert_array_equal(got.is_successful, want.is_successful)
    _same_graphs(want.dataset, got.dataset)
    ds, jds = got.dataset, want.dataset
    assert estimate_coo_capacities([ds], 256) == jax_capacities([jds], 256)
    assert max_atoms_lane_rounded([ds]) == jax_max_atoms([jds])
    assert smallest_pair_index(ds) == jax_smallest(jds)
    tiles, cap = estimate_coo_capacities([ds], 256)
    for start in (0, 256):
        idx = list(range(start, start + 256))
        jb = jax_pack(jds, idx, num_tiles=tiles, edge_capacity=cap)
        if native:
            tb = native_pack.pack_pairs_native(native_pack.PairDatasetCache(ds),
                                               idx, num_tiles=tiles,
                                               edge_capacity=cap)
        else:
            tb = pack_pair_dataset_coo(ds, idx, num_tiles=tiles,
                                       edge_capacity=cap)
        _same_batch(jb, tb)


def test_native_packer_matches_the_jax_native_packer(frame):
    ds = CSVPairParser().parse(frame).dataset
    idx = list(np.random.default_rng(0).permutation(N)[:300])
    want = jax_native_pack.pack_pairs_native(
        jax_native_pack.PairDatasetCache(ds), idx)
    _same_batch(want, native_pack.pack_pairs_native(
        native_pack.PairDatasetCache(ds), idx))


def test_featurizer_matches_on_kekulized_and_odd_smiles():
    smiles = ["C1=CC=CC=C1", "c1ccccc1", "[Na+].[Cl-]", "C[C@H](N)C(=O)O",
              "OC(=O)c1ccccc1O", "N#Cc1ccc2[nH]ccc2c1", "C%10CC%10"]
    for smi in smiles:
        want = JaxFeaturizer()(jax_mol_from_smiles(smi))
        got = GGNNFeaturizer()(mol_from_smiles(smi))
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{smi} {f}")
        wl = GGNNFeaturizer(mode="wl", radius=1)(mol_from_smiles(smi))
        jwl = JaxFeaturizer(mode="wl", radius=1)(jax_mol_from_smiles(smi))
        np.testing.assert_array_equal(wl.atom_ids, jwl.atom_ids, err_msg=smi)


def test_native_libraries_build_into_the_ignored_build_directory():
    for stem in ("smiles", "pack"):
        lib = native_lib.load(stem)
        assert lib is not None
        path = native_lib._library_path(os.path.join(native_lib.NATIVE_DIR,
                                                      f"{stem}.cpp"))
        assert os.path.dirname(path) == native_lib.BUILD_DIR
        assert os.path.exists(path)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "gcnbmp_tpu_torch/ops/build/" in f.read().split()


def test_without_a_compiler_the_python_parser_and_packer_take_over(tmp_path):
    """With no C++ compiler and an empty build directory the loader
    returns None once, and parsing and packing give the same batches."""
    code = f"""
import os, sys
import pandas as pd
from gcnbmp_tpu_torch import native_lib
native_lib.BUILD_DIR = {str(tmp_path)!r}
os.environ["CXX"] = {str(tmp_path / "no-such-compiler")!r}
from gcnbmp_tpu_torch.chem.native import native_available
from gcnbmp_tpu_torch.data import native_pack
from gcnbmp_tpu_torch.data.parsers import CSVPairParser
from gcnbmp_tpu_torch.data.wire import iter_coo_eval_batches
from gcnbmp_tpu_torch.data import estimate_coo_capacities
assert not native_available() and not native_pack.native_pack_available()
assert os.listdir({str(tmp_path)!r}) == []
ds = CSVPairParser().parse(pd.read_csv({TEST_CSV!r}).head(64)).dataset
tiles, cap = estimate_coo_capacities([ds], 32)
n = sum(v for _, v in iter_coo_eval_batches(ds, 32, tiles, cap))
print(len(ds), n)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["64", "64"]
