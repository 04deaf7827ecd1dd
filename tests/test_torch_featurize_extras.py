"""The port's parse cache, the dense featurizers and the padded batch's
dense-feature branch against the JAX package on the CPU, bit for bit:

- ``parse_pair_csv`` (graphs and labels) and ``CachedPairDataset`` (the
  same ``<csv>.cache.pkl`` and ``.meta``; read from the cache on a second
  load; re-parsed when the CSV's mtime or the parser's configuration
  changes); a cache the JAX package wrote, refused by the port's loader
  and re-parsed in a process where importing ``jax`` or ``gcnbmp_tpu``
  fails (tests/test_torch_import.py's block), and ``PairDataset.load``'s
  refusal of it;
- ``WeaveFeaturizer`` with and without pair features and
  ``DrugFPFeaturizer`` (with ``out_size``, and the ``max_atoms`` /
  ``out_size`` errors) on every SMILES of synth546's drug test split, and
  the helpers they run;
- ``make_batch`` on dense-featurized pairs: ``atom_feats1`` /
  ``atom_feats2`` as the JAX module pads them.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from gcnbmp_tpu.chem import featurize as jfeaturize
from gcnbmp_tpu.chem.smiles import mol_from_smiles as jmol_from_smiles
from gcnbmp_tpu.data import dataset as jdataset
from gcnbmp_tpu.data import parsers as jparsers
from gcnbmp_tpu_torch import chem
from gcnbmp_tpu_torch.chem import featurize
from gcnbmp_tpu_torch.chem.smiles import mol_from_smiles
from gcnbmp_tpu_torch.data import dataset, parse_pair_csv, parsers

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_import import BLOCKER  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "dataset", "sample", "sample200.csv")
SPLIT = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_test.csv")
GRAPH_FIELDS = ("atom_ids", "edge_src", "edge_dst", "edge_type",
                "atom_feats", "pair_feats")


def _assert_graphs_equal(got, want):
    for name in GRAPH_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.smiles == want.smiles


def _assert_datasets_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got.graphs1 + got.graphs2, want.graphs1 + want.graphs2):
        _assert_graphs_equal(g, w)
    np.testing.assert_array_equal(got.label_array(), want.label_array())
    assert got.smiles_pairs == want.smiles_pairs


@pytest.fixture(scope="module")
def split_smiles():
    df = pd.read_csv(SPLIT)
    return sorted(set(df["smiles_1"]) | set(df["smiles_2"]))


# ---------------------------------------------------------------------------
# parse_pair_csv and the cache


def test_parse_pair_csv_matches_jax():
    _assert_datasets_equal(parse_pair_csv(SAMPLE),
                           jparsers.parse_pair_csv(SAMPLE))


def test_cached_pair_dataset_follows_the_jax_rules(tmp_path):
    csv = str(tmp_path / "pairs.csv")
    pd.read_csv(SAMPLE).head(40).to_csv(csv, index=False)
    jcsv = str(tmp_path / "jpairs.csv")
    pd.read_csv(SAMPLE).head(40).to_csv(jcsv, index=False)
    os.utime(jcsv, ns=(os.stat(csv).st_atime_ns, os.stat(csv).st_mtime_ns))

    first = parsers.CachedPairDataset(csv)
    jfirst = jparsers.CachedPairDataset(jcsv)
    assert not first.from_cache and not jfirst.from_cache
    assert os.path.exists(csv + ".cache.pkl")
    # the same fingerprint, the CSV's path aside
    with open(csv + ".cache.pkl.meta") as f, \
            open(jcsv + ".cache.pkl.meta") as g:
        assert f.read() == g.read()
    second = parsers.CachedPairDataset(csv)
    assert second.from_cache and len(second) == 40
    _assert_datasets_equal(second.dataset, jfirst.dataset)
    assert second.data_list is second.dataset

    # a new mtime: re-parsed
    st = os.stat(csv)
    os.utime(csv, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert not parsers.CachedPairDataset(csv).from_cache
    assert parsers.CachedPairDataset(csv).from_cache
    # another parser configuration: re-parsed, then cached under it
    other = parsers.CSVPairParser(featurizer=featurize.GGNNFeaturizer())
    assert not parsers.CachedPairDataset(csv, parser=other).from_cache
    assert parsers.CachedPairDataset(csv, parser=other).from_cache
    assert not parsers.CachedPairDataset(csv).from_cache


def test_a_cache_the_jax_package_wrote_is_refused_and_reparsed(tmp_path):
    csv = str(tmp_path / "pairs.csv")
    pd.read_csv(SAMPLE).head(24).to_csv(csv, index=False)
    jparsers.CachedPairDataset(csv)  # the JAX package writes the cache
    with pytest.raises(pickle.UnpicklingError, match="gcnbmp_tpu.data"):
        dataset.PairDataset.load(csv + ".cache.pkl")
    code = BLOCKER + (
        "from gcnbmp_tpu_torch.data.parsers import CachedPairDataset\n"
        f"c = CachedPairDataset({csv!r})\n"
        "assert not c.from_cache and len(c) == 24\n"
        f"assert CachedPairDataset({csv!r}).from_cache\n"
        "assert not [m for m in sys.modules if m.startswith('jax')\n"
        "            or m.split('.')[0] == 'gcnbmp_tpu']\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    # the cache is the port's now, and holds the JAX parse's pairs
    _assert_datasets_equal(dataset.PairDataset.load(csv + ".cache.pkl"),
                           jparsers.parse_pair_csv(csv))


def test_dataset_load_refuses_globals_outside_the_port(tmp_path):
    path = str(tmp_path / "evil.pkl")
    with open(path, "wb") as f:
        pickle.dump(os.getcwd, f)  # names os.getcwd
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd|os.getcwd"):
        dataset.PairDataset.load(path)
    ok = str(tmp_path / "ok.pkl")
    ds = parse_pair_csv(SAMPLE)
    ds.save(ok)
    _assert_datasets_equal(dataset.PairDataset.load(ok), ds)


# ---------------------------------------------------------------------------
# the dense featurizers


@pytest.mark.parametrize("pair_features", [False, True],
                         ids=["atoms", "pairs"])
def test_weave_featurizer_matches_jax(split_smiles, pair_features):
    got_f = chem.WeaveFeaturizer(with_pair_features=pair_features)
    want_f = jfeaturize.WeaveFeaturizer(with_pair_features=pair_features)
    for smi in split_smiles:
        got = got_f(mol_from_smiles(smi))
        _assert_graphs_equal(got, want_f(jmol_from_smiles(smi)))
        assert got.atom_feats.shape == (got.num_atoms, 75)
        assert (got.atom_ids == -1).all()
        if pair_features:
            assert got.pair_feats.shape == (got.num_atoms,) * 2 + (14,)


def test_drugfp_featurizer_matches_jax(split_smiles):
    for out_size in (-1, 128):
        got_f = chem.DrugFPFeaturizer(out_size=out_size)
        want_f = jfeaturize.DrugFPFeaturizer(out_size=out_size)
        for smi in split_smiles:
            got = got_f(mol_from_smiles(smi))
            _assert_graphs_equal(got, want_f(jmol_from_smiles(smi)))
            assert got.atom_feats.shape[-1] == featurize.DRUGFP_NUM_FEATURES


def test_featurizer_helpers_match_jax(split_smiles):
    for smi in split_smiles[:120]:
        m, jm = mol_from_smiles(smi), jmol_from_smiles(smi)
        assert featurize._ring_bond_set(m) == jfeaturize._ring_bond_set(jm)
        for b in range(len(m.bonds)):
            np.testing.assert_array_equal(
                featurize.drugfp_bond_features(m, b),
                jfeaturize.drugfp_bond_features(jm, b))
        for i in range(m.num_atoms):
            assert featurize._hybridization(m, i) == \
                jfeaturize._hybridization(jm, i)
            np.testing.assert_array_equal(
                featurize.weave_atom_features(m, i),
                jfeaturize.weave_atom_features(jm, i))
        np.testing.assert_array_equal(featurize.weave_pair_features(m, 3),
                                      jfeaturize.weave_pair_features(jm, 3))


@pytest.mark.parametrize("make,match", [
    (lambda mod: mod.DrugFPFeaturizer(max_atoms=5), "max_atoms=5"),
    (lambda mod: mod.DrugFPFeaturizer(out_size=5), "out_size=5"),
    (lambda mod: mod.WeaveFeaturizer(max_atoms=5), "max_atoms=5"),
], ids=["drugfp-max-atoms", "drugfp-out-size", "weave-max-atoms"])
def test_dense_featurizer_errors_match_jax(make, match):
    smi = "CC(=O)Oc1ccccc1C(=O)O"
    with pytest.raises(jfeaturize.FeaturizeError) as want:
        make(jfeaturize)(jmol_from_smiles(smi))
    with pytest.raises(featurize.FeaturizeError, match=match) as got:
        make(featurize)(mol_from_smiles(smi))
    assert str(got.value) == str(want.value)


def test_dense_featurized_csv_parses_as_jax():
    got = parsers.CSVPairParser(featurizer=chem.DrugFPFeaturizer())
    want = jparsers.CSVPairParser(featurizer=jfeaturize.DrugFPFeaturizer())
    _assert_datasets_equal(got.parse(SAMPLE).dataset,
                           want.parse(SAMPLE).dataset)


# ---------------------------------------------------------------------------
# the padded batch's dense features


@pytest.mark.parametrize("featurizer", ["drugfp", "weave", "ggnn"])
@pytest.mark.parametrize("pad_to", [None, 64])
def test_make_batch_pads_dense_features_as_jax(featurizer, pad_to):
    makers = {"drugfp": "DrugFPFeaturizer", "weave": "WeaveFeaturizer",
              "ggnn": "GGNNFeaturizer"}
    ds = parsers.CSVPairParser(
        featurizer=getattr(featurize, makers[featurizer])()).parse(
            SAMPLE).dataset
    jds = jparsers.CSVPairParser(
        featurizer=getattr(jfeaturize, makers[featurizer])()).parse(
            SAMPLE).dataset
    idx = [3, 0, 17, 42, 5, 199, 100, 77]
    got = dataset.make_batch(ds, idx, pad_to=pad_to)
    want = jdataset.make_batch(jds, idx, pad_to=pad_to)
    for name in ("atoms1", "adj1", "mask1", "atoms2", "adj2", "mask2",
                 "labels", "atom_feats1", "atom_feats2"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.num_edges == want.num_edges
    if featurizer == "ggnn":
        assert got.atom_feats1 is None
    else:
        assert got.atom_feats1.shape[:2] == got.atoms1.shape
