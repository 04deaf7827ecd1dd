"""The port's dataset generator against the JAX package's and the
committed files, on the CPU.

- ``python -m gcnbmp_tpu_torch.data.synth`` and
  ``gcnbmp_tpu_torch.cli.data_generator`` reproduce the committed
  dataset/synth546 drug list, rule statistics and ``drug``/``scaffold``
  splits byte for byte;
- the port's files equal those the JAX generator (examples/
  make_synth_drugbank.py, gcnbmp_tpu.cli.data_generator) writes into a
  temporary directory: the matrix, the multi-label pairs, the ``inter``,
  ``kaist`` and ``isc`` splits and the edgelist; the isc35000 subsample
  of chip_quality.py has the sha256 of the JAX flow's file;
- each function of ``data.splits`` against the JAX one on synth546's
  drugs, and the CLI's guards."""

import hashlib
import importlib.util
import os

import numpy as np
import pandas as pd
import pytest

from gcnbmp_tpu.cli import data_generator as jcli
from gcnbmp_tpu.data import splits as jsplits
from gcnbmp_tpu_torch.cli import data_generator as tcli
from gcnbmp_tpu_torch.data import splits as tsplits
from gcnbmp_tpu_torch.data import synth as tsynth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(ROOT, "dataset", "synth546")
# sha256 (first 16 hex digits) of the JAX generator's files on this tree
SHA = {
    "drug_drug_matrix.csv": "25c0cb2836c3237d",
    "pairs_multilabel.csv": "911c8a051ad1e7c7",
    "inter/ddi_inter_train.csv": "03b0184d22fbaddd",
    "inter/ddi_inter_valid.csv": "34978432842f38ac",
    "inter/ddi_inter_test.csv": "072ad8703a2d5007",
    "inter/isc35000_train.csv": "5a9fa29813fe672b",
    "kaist/ddi_train_multi.csv": "4f2fefc90164605e",
    "kaist/ddi_valid_multi.csv": "b88f32dc2c405b0f",
    "kaist/ddi_test_multi.csv": "1ccb59bcbc04b222",
}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _generate(synth_main, cli_main, out, isc=True):
    """The regen_data.sh steps with one package's generator into ``out``:
    the synth tree, then the inter, drug, scaffold, isc and kaist splits
    and the edgelist."""
    synth_main(["--out", out, "--multi-label"])
    base = ["--drug-list", os.path.join(out, "drug_list.csv"),
            "--matrix", os.path.join(out, "drug_drug_matrix.csv")]
    for split in ("inter", "drug", "scaffold"):
        assert cli_main(base + ["--split", split, "--out",
                                os.path.join(out, split), "--validate"]) == 0
    assert cli_main(base + ["--split", "isc", "--sizes", "10000,35000",
                            "--out", os.path.join(out, "isc"), "--edgelist",
                            os.path.join(out, "known.edgelist")]) == 0
    assert cli_main(["--split", "kaist", "--kaist-csv",
                     os.path.join(out, "pairs_multilabel.csv"), "--out",
                     os.path.join(out, "kaist")]) == 0


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    port, jax_ = str(root / "port"), str(root / "jax")
    _generate(tsynth.main, tcli.main, port)
    jsynth = _load("make_synth_drugbank",
                   os.path.join(ROOT, "examples", "make_synth_drugbank.py"))
    _generate(jsynth.main, jcli.main, jax_)
    return port, jax_


def _files(tree):
    return sorted(os.path.relpath(os.path.join(d, f), tree)
                  for d, _, fs in os.walk(tree) for f in fs)


def test_port_writes_the_jax_generators_files(trees):
    port, jax_ = trees
    assert _files(port) == _files(jax_)
    assert len(_files(port)) == 20
    for name in _files(jax_):
        assert _bytes(os.path.join(port, name)) == _bytes(os.path.join(jax_, name)), name


@pytest.mark.parametrize("name", ["drug_list.csv", "rule_stats.json",
                                  "labels.csv"]
                         + [f"{s}/ddi_{s}_{p}.csv" for s in ("drug", "scaffold")
                            for p in ("train", "valid", "test")])
def test_port_reproduces_the_committed_files(trees, name):
    assert _bytes(os.path.join(trees[0], name)) == _bytes(os.path.join(SYNTH, name))


def test_generated_files_have_the_recorded_sums(trees, tmp_path):
    chip_quality = _load("chip_quality", os.path.join(ROOT, "chip_quality.py"))
    inter = tmp_path / "inter"
    inter.mkdir()
    for p in ("train", "valid", "test"):
        (inter / f"ddi_inter_{p}.csv").write_bytes(
            _bytes(os.path.join(trees[0], "inter", f"ddi_inter_{p}.csv")))
    chip_quality.isc35000_subsample(str(inter))
    got = {}
    for name in SHA:
        where = tmp_path if name.startswith("inter/isc") else trees[0]
        got[name] = hashlib.sha256(_bytes(os.path.join(where, name))).hexdigest()[:16]
    assert got == SHA
    rows = len(pd.read_csv(inter / "isc35000_train.csv"))
    assert rows == 35000
    assert sorted(chip_quality.GENERATED) == sorted(
        set(chip_quality.GENERATED))  # no file listed twice


def test_kaist_mode_matches_the_jax_script(tmp_path):
    jsynth = _load("make_synth_drugbank",
                   os.path.join(ROOT, "examples", "make_synth_drugbank.py"))
    for n_types in (37, 86):
        args = ["--kaist", "--n-drugs", "60", "--max-pairs", "300",
                "--n-types", str(n_types)]
        jsynth.main(args + ["--out", str(tmp_path / f"jax{n_types}")])
        tsynth.main(args + ["--out", str(tmp_path / f"port{n_types}")])
        for name in ("drug_list.csv", "pairs_multilabel.csv", "labels.csv",
                     "rule_stats.json"):
            assert _bytes(tmp_path / f"port{n_types}" / name) == \
                _bytes(tmp_path / f"jax{n_types}" / name), (n_types, name)


# ---------------------------------------------------------------------------
# the splits module, function by function


@pytest.fixture(scope="module")
def drugs():
    df = pd.read_csv(os.path.join(SYNTH, "drug_list.csv"))
    rng = np.random.default_rng(3)
    n = len(df)
    mat = (rng.random((n, n)) < 0.3).astype(np.int64)
    mat = np.triu(mat, 1)
    return df, mat + mat.T


def _assert_split_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_murcko_scaffold_keys_match(drugs):
    df, _ = drugs
    keys = [tsplits.murcko_scaffold_key(s) for s in df["smiles"]]
    assert keys == [jsplits.murcko_scaffold_key(s) for s in df["smiles"]]
    assert tsplits.murcko_scaffold_key("CCO") == "" == \
        jsplits.murcko_scaffold_key("CCO")


@pytest.mark.parametrize("how", ["random", "scaffold", "stratified", "isc"])
def test_splits_match(drugs, how):
    df, mat = drugs
    ids = list(df["cid"])[:120]
    sub = mat[:120, :120]
    pairs, labels = tsplits.generate_pairs_from_matrix(sub, ids)
    jpairs, jlabels = jsplits.generate_pairs_from_matrix(sub, ids)
    np.testing.assert_array_equal(pairs, jpairs)
    np.testing.assert_array_equal(labels, jlabels)
    if how == "random":
        got = tsplits.random_split_by_drug(pairs, labels, ids, seed=5)
        want = jsplits.random_split_by_drug(pairs, labels, ids, seed=5)
    elif how == "scaffold":
        smiles = dict(zip(df["cid"], df["smiles"]))
        got = tsplits.scaffold_split_by_drug(pairs, labels, ids, smiles)
        want = jsplits.scaffold_split_by_drug(pairs, labels, ids, smiles)
        with pytest.raises(ValueError, match="sum to 1"):
            tsplits.scaffold_split_by_drug(pairs, labels, ids, smiles, 0.5,
                                           0.1, 0.1)
    elif how == "stratified":
        got = tsplits.stratified_interaction_split(pairs, labels, seed=9)
        want = jsplits.stratified_interaction_split(pairs, labels, seed=9)
    else:
        got = tsplits.interaction_scale_series(pairs, labels, (500, 1000, 10 ** 6))
        want = jsplits.interaction_scale_series(pairs, labels, (500, 1000, 10 ** 6))
        assert sorted(got) == [500, 1000]
    _assert_split_equal(got, want)
    for part in want:
        assert tsplits.split_statistics(got[part][1]) == \
            jsplits.split_statistics(want[part][1])


def test_kaist_split_dedupe_and_id_maps_match():
    df = pd.read_csv(os.path.join(SYNTH, "drug", "ddi_drug_valid.csv")).head(400)
    df = df.assign(label=np.where(df["label"] > 0, "a||b", "c"))
    doubled = pd.concat([df, df.rename(columns={
        "drugbank_id_1": "drugbank_id_2", "drugbank_id_2": "drugbank_id_1"})])
    got = tsplits.kaist_multilabel_split(doubled, seed=4)
    want = jsplits.kaist_multilabel_split(doubled, seed=4)
    assert sorted(got) == sorted(want)
    for k in want:
        pd.testing.assert_frame_equal(got[k], want[k])
    assert sum(len(v) for v in got.values()) == len(df)
    pairs = list(zip(doubled["drugbank_id_1"], doubled["drugbank_id_2"]))
    assert tsplits.dedupe_symmetric(pairs) == jsplits.dedupe_symmetric(pairs)
    drugs_df = pd.read_csv(os.path.join(SYNTH, "drug_list.csv"))
    assert tsplits.index_id_maps(drugs_df) == jsplits.index_id_maps(drugs_df)


def test_write_pair_csv_edgelist_and_validation_match(drugs, tmp_path):
    df, mat = drugs
    ids = list(df["cid"])[:40]
    pairs, labels = tsplits.generate_pairs_from_matrix(mat[:40, :40], ids)
    got = tsplits.write_pair_csv(str(tmp_path / "t.csv"), pairs, labels, df)
    want = jsplits.write_pair_csv(str(tmp_path / "j.csv"), pairs, labels, df)
    pd.testing.assert_frame_equal(got, want)
    assert _bytes(tmp_path / "t.csv") == _bytes(tmp_path / "j.csv")
    matrix = pd.DataFrame(mat[:40, :40], columns=ids)
    matrix.insert(0, "Unnamed: 0", range(40))
    assert tsplits.export_known_ddis_edgelist(matrix, str(tmp_path / "t.el")) == \
        jsplits.export_known_ddis_edgelist(matrix, str(tmp_path / "j.el"))
    assert _bytes(tmp_path / "t.el") == _bytes(tmp_path / "j.el")
    bad = df.head(6).copy()
    bad.loc[2, "smiles"] = "C1CC("
    assert tsplits.validate_drug_list(bad) == jsplits.validate_drug_list(bad) == [2]


def test_cli_drops_the_index_column_and_refuses_bad_input(drugs, tmp_path,
                                                          capsys):
    """A matrix saved with its pandas index keeps ``Unnamed: 0`` out of
    the labels; an unparseable SMILES under ``--validate`` exits 1; a
    kaist split without ``--kaist-csv`` and a drug split without the
    matrix are refused, in both packages alike."""
    df, mat = drugs
    df = df.head(30)
    ids = list(df["cid"])
    df.to_csv(tmp_path / "drugs.csv", index=False)
    pd.DataFrame(mat[:30, :30], columns=ids).to_csv(tmp_path / "m.csv")
    args = ["--drug-list", str(tmp_path / "drugs.csv"), "--matrix",
            str(tmp_path / "m.csv"), "--split", "inter"]
    assert tcli.main(args + ["--out", str(tmp_path / "t")]) == 0
    assert jcli.main(args + ["--out", str(tmp_path / "j")]) == 0
    for p in ("train", "valid", "test"):
        name = f"ddi_inter_{p}.csv"
        assert _bytes(tmp_path / "t" / name) == _bytes(tmp_path / "j" / name)
    full = pd.concat([pd.read_csv(tmp_path / "t" / f"ddi_inter_{p}.csv")
                      for p in ("train", "valid", "test")])
    assert len(full) == 30 * 29 // 2 and full["label"].sum() == np.triu(mat[:30, :30], 1).sum()
    bad = df.copy()
    bad.loc[0, "smiles"] = "C1CC("
    bad.to_csv(tmp_path / "bad.csv", index=False)
    bad_args = ["--drug-list", str(tmp_path / "bad.csv"), "--matrix",
                str(tmp_path / "m.csv"), "--validate", "--out", str(tmp_path / "b")]
    assert tcli.main(bad_args) == jcli.main(bad_args) == 1
    for cli in (tcli, jcli):
        with pytest.raises(SystemExit):
            cli.main(["--split", "kaist", "--out", str(tmp_path / "k")])
        with pytest.raises(SystemExit):
            cli.main(["--split", "drug", "--out", str(tmp_path / "k")])
    capsys.readouterr()
