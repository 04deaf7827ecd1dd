"""Fixed-embedding runs of the port (``gcnbmp_tpu_torch.train.fixed``,
``models.predictor.FixedEmbeddingPredictor``, the train CLI's
``--fixed-embeddings`` and the predict CLI on a fixed run) against the
JAX package on the CPU: the predictor's logits for every head and both
``symmetric`` modes (1e-5); ten Adam steps from the JAX function's
initial tree (losses 1e-5); the table readers and the pair join equal;
a run trained and scored through the port's CLIs whose probs the JAX
predict CLI gives alike on the converted params (1e-5); a multi-class
run's ``prob_class{c}`` columns; a run holding only ``params.msgpack``
refused, naming the file."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from flax import serialization

from gcnbmp_tpu.cli import predict as jax_predict_cli
from gcnbmp_tpu.models.heads import HEADS as JAX_HEADS
from gcnbmp_tpu.models.predictor import (
    FixedEmbeddingPredictor as JaxFixedEmbeddingPredictor)
from gcnbmp_tpu.train import fixed as jfixed
from gcnbmp_tpu_torch.cli import predict as predict_cli
from gcnbmp_tpu_torch.cli import train as train_cli
from gcnbmp_tpu_torch.convert import from_jax_params, load_params_npz
from gcnbmp_tpu_torch.models.predictor import FixedEmbeddingPredictor
from gcnbmp_tpu_torch.train import fixed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "dataset", "sample", "sample200.csv")
TOL = 1e-5
DIM = 12
HIDDEN = (8, 4)
HEAD_NAMES = ["hole", "ntn", "dist-mult", "mlp", "symmlp", "cosine"]


def _jax_predictor(sim_method, class_num=1, symmetric=None):
    kw = {"out_dim": class_num}
    if sim_method != "cosine":
        kw["hidden_dims"] = HIDDEN
    return JaxFixedEmbeddingPredictor(
        head=JAX_HEADS[sim_method](name="head", **kw), symmetric=symmetric)


def _vectors(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, DIM)).astype(np.float32),
            rng.standard_normal((n, DIM)).astype(np.float32))


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("symmetric", [None, "or", "and"])
@pytest.mark.parametrize("sim_method", HEAD_NAMES)
def test_fixed_predictor_logits_match_jax(sim_method, symmetric):
    e1, e2 = _vectors(9)
    class_num = 3 if sim_method in ("hole", "cosine") else 1
    jp = _jax_predictor(sim_method, class_num, symmetric)
    params = jp.init(jax.random.PRNGKey(1), e1[:2], e2[:2])["params"]
    want = np.asarray(jp.apply({"params": params}, e1, e2))
    model = fixed.build_fixed_predictor(sim_method, class_num, HIDDEN, DIM)
    model = FixedEmbeddingPredictor(model.head, symmetric)
    from_jax_params(_to_numpy(params), model)
    with torch.no_grad():
        got = model(torch.from_numpy(e1), torch.from_numpy(e2)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="symmetric"):
        FixedEmbeddingPredictor(model.head, "xor")


@pytest.mark.parametrize("sim_method", ["hole", "symmlp"])
def test_ten_steps_from_the_jax_init_match_jax(sim_method):
    """5 epochs of 2 steps (40 pairs, batch 16, the tail dropped): the
    last loss of each epoch, the trained tree and the metrics."""
    e1, e2 = _vectors(40, seed=3)
    y = (np.sum(e1 * e2, axis=1) > 0).astype(np.float32)
    val = tuple(x[:24] for x in (e2, e1, y))
    kw = dict(val=val, sim_method=sim_method, net_hidden_dims=HIDDEN,
              learning_rate=1e-2, epochs=5, batch_size=16, seed=7)
    want = jfixed.train_fixed_embedding_head(e1, e2, y, **kw)
    init = jfixed._build_fixed_predictor(sim_method, 1, HIDDEN).init(
        jax.random.PRNGKey(7), jnp.asarray(e1[:2]), jnp.asarray(e2[:2]))
    got = fixed.train_fixed_embedding_head(
        e1, e2, y, device="cpu", params=_to_numpy(init["params"]), **kw)
    np.testing.assert_allclose(got["losses"], want["losses"], atol=TOL,
                               rtol=0)
    for (path, a) in jax.tree_util.tree_leaves_with_path(want["params"]):
        node = got["params"]
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(a), atol=TOL, rtol=TOL)
    for split in ("train_metrics", "val_metrics"):
        for k, v in want[split].items():
            assert abs(got[split][k] - v) <= 1e-6, (split, k)


def test_batch_size_clamped_to_the_pair_count():
    e1, e2 = _vectors(6)
    y = np.array([0, 1, 0, 1, 1, 0], np.float32)
    got = fixed.train_fixed_embedding_head(
        e1, e2, y, net_hidden_dims=HIDDEN, epochs=3, batch_size=128,
        device="cpu")
    assert len(got["losses"]) == 3 and np.all(np.isfinite(got["losses"]))


@pytest.fixture
def tables(tmp_path):
    """An id -> vector table as a pickle and as the evaluate CLI's
    drug_list_with_representation.csv (space-joined floats), over
    sample200's drugbank ids."""
    df = pd.read_csv(SAMPLE)
    ids = sorted(set(df["drugbank_id_1"]) | set(df["drugbank_id_2"]))
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((len(ids), DIM)).astype(np.float32)
    # leave one id out, so some pairs do not join
    table = {i: v for i, v in zip(ids[1:], vecs[1:])}
    pkl = tmp_path / "table.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(table, f)
    csv = tmp_path / "drug_list_with_representation.csv"
    pd.DataFrame({"cid": list(table),
                  "entity": [" ".join(f"{x:.6g}" for x in v)
                             for v in table.values()]}).to_csv(csv, index=False)
    return str(pkl), str(csv), ids[0]


def test_table_readers_and_pair_join_equal_jax(tables, tmp_path):
    pkl, csv, missing = tables
    for path in (pkl, csv):
        want = jfixed.load_embedding_table(path)
        got = fixed.load_embedding_table(path)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    table = fixed.load_embedding_table(csv)
    want = jfixed.pair_embeddings(SAMPLE, table)
    got = fixed.pair_embeddings(SAMPLE, table)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    df = pd.read_csv(SAMPLE)
    n_missing = int(((df.drugbank_id_1 == missing)
                     | (df.drugbank_id_2 == missing)).sum())
    assert 0 < n_missing and len(got[2]) == len(df) - n_missing
    # numeric ids in a frame of int and float columns: iterrows reads them
    # as floats, and so does the port
    num = tmp_path / "numeric.csv"
    pd.DataFrame({"drugbank_id_1": [1, 2, 3], "drugbank_id_2": [2, 3, 1],
                  "label": [1.0, 0.0, 1.0]}).to_csv(num, index=False)
    ftable = {"1.0": np.ones(2, np.float32), "2.0": np.zeros(2, np.float32),
              "3.0": np.full(2, 3.0, np.float32)}
    want = jfixed.pair_embeddings(str(num), ftable)
    got = fixed.pair_embeddings(str(num), ftable)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _jax_run_from(port_run, jax_run):
    """The port's fixed run as the JAX package writes it: the same
    config.json and embeddings.npz, params.msgpack of the converted
    tree."""
    os.makedirs(jax_run)
    for name in ("config.json", "embeddings.npz"):
        with open(os.path.join(port_run, name), "rb") as f:
            data = f.read()
        with open(os.path.join(jax_run, name), "wb") as f:
            f.write(data)
    tree = load_params_npz(os.path.join(port_run, "params.npz"))
    with open(os.path.join(jax_run, "params.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(tree))


def test_train_then_predict_clis_match_jax_scoring(tables, tmp_path, capsys):
    _, csv, _ = tables
    run = str(tmp_path / "fixed_run")
    assert train_cli.main(["--train", SAMPLE, "--val", SAMPLE,
                           "--fixed-embeddings", csv, "--epochs", "3",
                           "--batch-size", "32", "--net-hidden-dims", "8,4",
                           "--device", "cpu", "--out", run]) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"roc_auc", "val/roc_auc", "val/prc_auc"} <= set(final)
    assert fixed.is_fixed_run(run) and not fixed.is_fixed_run(str(tmp_path))
    cfg = json.load(open(os.path.join(run, "config.json")))
    assert cfg == {"method": "fixed", "sim_method": "hole", "class_num": 1,
                   "net_hidden_dims": [8, 4], "emb_dim": DIM}
    metrics = json.load(open(os.path.join(run, "metrics.json")))
    assert len(metrics["losses"]) == 3
    assert metrics["val_metrics"]["roc_auc"] == final["val/roc_auc"]

    out = tmp_path / "preds.csv"
    assert predict_cli.main(["--input", SAMPLE, "--run", run, "--out",
                             str(out), "--device", "cpu"]) == 0
    got = pd.read_csv(out)
    jax_run = str(tmp_path / "jax_run")
    _jax_run_from(run, jax_run)
    jout = tmp_path / "jax_preds.csv"
    assert jax_predict_cli.main(["--input", SAMPLE, "--run", jax_run,
                                 "--out", str(jout)]) == 0
    want = pd.read_csv(jout)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) < len(pd.read_csv(SAMPLE))
    np.testing.assert_array_equal(got.drop(columns="prob").values,
                                  want.drop(columns="prob").values)
    np.testing.assert_allclose(got["prob"], want["prob"], atol=TOL, rtol=0)
    # the library call agrees with the JAX one on the same rows
    df = pd.read_csv(SAMPLE)
    probs, present = fixed.score_fixed_pairs(
        run, df.drugbank_id_1, df.drugbank_id_2, batch_size=7, device="cpu")
    jprobs, jpresent = jfixed.score_fixed_pairs(
        jax_run, df.drugbank_id_1, df.drugbank_id_2)
    np.testing.assert_array_equal(present, jpresent)
    np.testing.assert_allclose(probs, jprobs, atol=TOL, rtol=0)


def test_multiclass_run_scores_prob_class_columns_as_jax(tables, tmp_path):
    _, csv, _ = tables
    table = fixed.load_embedding_table(csv)
    model = fixed.build_fixed_predictor("ntn", 3, HIDDEN, DIM)
    from gcnbmp_tpu_torch.convert import init_module_params

    result = {"params": init_module_params(model, 11), "losses": [0.5]}
    run = str(tmp_path / "multi")
    fixed.save_fixed_run(run, result, sim_method="ntn", class_num=3,
                         net_hidden_dims=HIDDEN, table=table)
    jax_run = str(tmp_path / "jax_multi")
    _jax_run_from(run, jax_run)
    out, jout = tmp_path / "p.csv", tmp_path / "jp.csv"
    assert predict_cli.main(["--input", SAMPLE, "--run", run, "--out",
                             str(out), "--device", "cpu"]) == 0
    assert jax_predict_cli.main(["--input", SAMPLE, "--run", jax_run,
                                 "--out", str(jout)]) == 0
    got, want = pd.read_csv(out), pd.read_csv(jout)
    cols = [f"prob_class{c}" for c in range(3)]
    assert list(got.columns) == list(want.columns) and set(cols) <= set(got)
    np.testing.assert_allclose(got[cols], want[cols], atol=TOL, rtol=0)


def test_msgpack_only_run_refused_naming_the_file(tables, tmp_path):
    _, csv, _ = tables
    table = fixed.load_embedding_table(csv)
    model = fixed.build_fixed_predictor("hole", 1, HIDDEN, DIM)
    from gcnbmp_tpu_torch.convert import init_module_params

    run = str(tmp_path / "port")
    fixed.save_fixed_run(run, {"params": init_module_params(model, 2)},
                         sim_method="hole", class_num=1,
                         net_hidden_dims=HIDDEN, table=table)
    jax_run = str(tmp_path / "jax")
    _jax_run_from(run, jax_run)
    with pytest.raises(ValueError, match="params.msgpack.*flax"):
        predict_cli.main(["--input", SAMPLE, "--run", jax_run, "--device",
                          "cpu"])
    os.remove(os.path.join(jax_run, "params.msgpack"))
    with pytest.raises(FileNotFoundError, match="no params.npz"):
        fixed.load_fixed_run(jax_run, "cpu")
    # a fixed run's input needs the id columns
    bad = tmp_path / "smiles_only.csv"
    pd.read_csv(SAMPLE)[["smiles_1", "smiles_2"]].to_csv(bad, index=False)
    with pytest.raises(SystemExit, match="drugbank_id_1"):
        predict_cli.main(["--input", str(bad), "--run", run, "--device",
                          "cpu"])
