"""The port's host-only analysis modules against the JAX package's on the
CPU: mol2vec (``gcnbmp_tpu_torch.chem.mol2vec``: sentences, identifier
tables, vectors), the molecule transforms (``chem.transforms``:
``kekulize``, ``add_explicit_hydrogens``) and the featurizer's ``add_hs`` /
``kekulize`` graphs, bit for bit over the SMILES of dataset/sample and
synth546; the classical baselines (``eval.baselines``: ``pair_features``,
``ecfp_features``, ``run_baseline``) equal to JAX's."""

import os

import numpy as np
import pandas as pd
import pytest

from gcnbmp_tpu.chem import GGNNFeaturizer as JaxFeaturizer
from gcnbmp_tpu.chem import mol2vec as jmol2vec
from gcnbmp_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from gcnbmp_tpu.chem import transforms as jtransforms
from gcnbmp_tpu.eval import baselines as jbaselines
from gcnbmp_tpu_torch import chem
from gcnbmp_tpu_torch.chem import GGNNFeaturizer, mol2vec, mol_from_smiles
from gcnbmp_tpu_torch.chem import transforms
from gcnbmp_tpu_torch.eval import baselines

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE_DRUGS = os.path.join(ROOT, "dataset", "sample", "drug_list.csv")
SYNTH_DRUGS = os.path.join(ROOT, "dataset", "synth546", "drug_list.csv")
GRAPH_FIELDS = ("atom_ids", "edge_src", "edge_dst", "edge_type")


def _smiles(which):
    path = SAMPLE_DRUGS if which == "sample" else SYNTH_DRUGS
    return list(pd.read_csv(path)["smiles"])


@pytest.fixture(scope="module", params=["sample", "synth546"])
def smiles(request):
    return _smiles(request.param)


def _same_mol(want, got):
    if want is None:
        assert got is None
        return
    assert got is not None
    assert len(got.atoms) == len(want.atoms)
    assert len(got.bonds) == len(want.bonds)
    for a, b in zip(want.atoms, got.atoms):
        assert (a.symbol, a.atomic_num, a.charge, a.aromatic, a.explicit_h,
                a.implicit_h) == (b.symbol, b.atomic_num, b.charge,
                                  b.aromatic, b.explicit_h, b.implicit_h)
    for a, b in zip(want.bonds, got.bonds):
        assert (a.a1, a.a2, int(a.order)) == (b.a1, b.a2, int(b.order))


def test_chem_exports_mol2vec_as_the_jax_package_does():
    for name in ("Mol2VecFeaturizer", "identifier_table_from_corpus",
                 "mol2vec_table", "morgan_sentence"):
        assert getattr(chem, name) is getattr(mol2vec, name)


@pytest.mark.parametrize("radius", [0, 1, 2])
def test_morgan_sentences_bit_identical(smiles, radius):
    for s in smiles:
        want = jmol2vec.morgan_sentence(jax_mol_from_smiles(s), radius)
        assert mol2vec.morgan_sentence(mol_from_smiles(s), radius) == want


@pytest.mark.parametrize("dim,radius,min_count", [(100, 1, 1), (16, 2, 2)])
def test_identifier_tables_and_vectors_bit_identical(smiles, dim, radius,
                                                     min_count):
    want = jmol2vec.identifier_table_from_corpus(
        [jax_mol_from_smiles(s) for s in smiles], dim=dim, radius=radius,
        min_count=min_count)
    got = mol2vec.identifier_table_from_corpus(
        [mol_from_smiles(s) for s in smiles], dim=dim, radius=radius,
        min_count=min_count)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    # a table without UNSEEN gets the same fallback vector
    partial = {k: v for k, v in list(want.items())[:5] if k != "UNSEEN"}
    jf = jmol2vec.Mol2VecFeaturizer(table=partial, radius=radius)
    f = mol2vec.Mol2VecFeaturizer(table=partial, radius=radius)
    for s in smiles[:50]:
        np.testing.assert_array_equal(f(mol_from_smiles(s)),
                                      jf(jax_mol_from_smiles(s)))


def test_mol2vec_table_bit_identical(smiles):
    bad = smiles[:3] + ["C1CC", "not a smiles"]
    want = jmol2vec.mol2vec_table(bad + smiles, dim=100, radius=1)
    got = mol2vec.mol2vec_table(bad + smiles, dim=100, radius=1)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_kekulize_and_explicit_hydrogens_bit_identical(smiles):
    n_kek = 0
    for s in smiles:
        jm, m = jax_mol_from_smiles(s), mol_from_smiles(s)
        jk, k = jtransforms.kekulize(jm), transforms.kekulize(m)
        _same_mol(jk, k)
        n_kek += jk is not None
        _same_mol(jtransforms.add_explicit_hydrogens(jm),
                  transforms.add_explicit_hydrogens(m))
    assert n_kek > 0


@pytest.mark.parametrize("add_hs,kekulize,mode", [
    (True, False, "atomic_number"), (False, True, "atomic_number"),
    (True, True, "atomic_number"), (True, True, "wl")])
def test_featurizer_add_hs_and_kekulize_graphs_bit_identical(
        smiles, add_hs, kekulize, mode):
    jf = JaxFeaturizer(mode=mode, radius=1, add_hs=add_hs, kekulize=kekulize)
    f = GGNNFeaturizer(mode=mode, radius=1, add_hs=add_hs, kekulize=kekulize)
    for s in smiles:
        try:
            want = jf(jax_mol_from_smiles(s))
        except ValueError as e:  # FeaturizeError: no Kekulé form
            with pytest.raises(ValueError, match="cannot kekulize"):
                f(mol_from_smiles(s))
            assert "cannot kekulize" in str(e)
            continue
        got = f(mol_from_smiles(s))
        assert got.smiles == want.smiles
        for name in GRAPH_FIELDS:
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert f.atom_vocab == jf.atom_vocab and f.fp_vocab == jf.fp_vocab


@pytest.mark.parametrize("n_bits,radius", [(2048, 2), (256, 1)])
def test_ecfp_features_equal(n_bits, radius):
    smi = _smiles("synth546")[:120] + ["not a smiles"]
    np.testing.assert_array_equal(
        baselines.ecfp_features(smi, n_bits=n_bits, radius=radius),
        jbaselines.ecfp_features(smi, n_bits=n_bits, radius=radius))


@pytest.mark.parametrize("mode", ["concat", "sum-prod"])
def test_pair_features_equal(mode):
    rng = np.random.default_rng(0)
    e1, e2 = rng.standard_normal((2, 7, 5)).astype(np.float32)
    np.testing.assert_array_equal(baselines.pair_features(e1, e2, mode),
                                  jbaselines.pair_features(e1, e2, mode))
    with pytest.raises(ValueError, match="unknown pair feature mode"):
        baselines.pair_features(e1, e2, "x")


@pytest.mark.parametrize("model", ["lr", "rf", "svm"])
def test_run_baseline_equal(model):
    pytest.importorskip("sklearn")
    rng = np.random.default_rng(1)
    smi = _smiles("synth546")[:80]
    fp = baselines.ecfp_features(smi, n_bits=128, radius=1)
    i, j = rng.integers(0, len(smi), (2, 160))
    bits = fp[i].sum(1) + fp[j].sum(1)
    y = (bits > np.median(bits)).astype(np.float32)
    args = (fp[i[:120]], fp[j[:120]], y[:120], fp[i[120:]], fp[j[120:]],
            y[120:])
    got = baselines.run_baseline(model, *args, feature_mode="sum-prod")
    want = jbaselines.run_baseline(model, *args, feature_mode="sum-prod")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    with pytest.raises(ValueError, match="unknown baseline model"):
        baselines.run_baseline("knn", *args)
