"""The port's evaluation path against the JAX package on the CPU: the
evaluate CLI (``gcnbmp_tpu_torch.cli.evaluate``) against the JAX
``evaluate_dataset`` on the same params, for GGNN + HolE, co-attention
``para`` + NTN, MPNN and a multi-label run; ``--similarity`` against
JAX ``similarity_csv``, ``--correlation-matrix`` against JAX
``embedding_ddi_correlation``; the evaluator's ``per_class``; the CLI's
refusals; and the predict CLI's ``--run`` against its
``--config``/``--params``.

The metrics are compared on sample200 without its repeated pairs: the
JAX evaluator gives a pair repeated at another batch position logits a
few ulps apart, where the port gives it the same logits, so a repeated
pair is a tie in one package and not in the other, and the AUCs differ
by a pair's weight (1e-4 here) whatever the precision.  The exports,
whose per-row e1, e2 and y are compared within 1e-5, are also compared
on the whole file, repeated pairs included."""

import json
import os
import re

import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.eval import analysis as janalysis
from gcnbmp_tpu.eval import evaluate as jeval
from gcnbmp_tpu.eval.similarity import similarity_csv as jsimilarity_csv
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli
from gcnbmp_tpu_torch.cli import predict
from gcnbmp_tpu_torch.convert import init_params, save_params_npz, to_jax_params
from gcnbmp_tpu_torch.data import CSVPairParser, get_class_labels
from gcnbmp_tpu_torch.eval.evaluate import PackedPairEvaluator
from gcnbmp_tpu_torch.models.packed import model_kwargs_from_config
from gcnbmp_tpu_torch.train.checkpoints import load_run

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "dataset", "sample", "sample200.csv")
CLASSES = os.path.join(ROOT, "dataset", "synth546", "labels.csv")
TOL = 1e-5
BATCH = 64

MODELS = {
    "ggnn_hole": dict(method="ggnn", sim_method="hole"),
    "coattention_para_ntn": dict(method="ggnn", sim_method="ntn",
                                 attn="para"),
    "mpnn": dict(method="mpnn", sim_method="hole", weight_tying=True),
}


@pytest.fixture
def sample(tmp_path):
    """sample200 with each (smiles_1, smiles_2) pair once."""
    path = tmp_path / "sample_unique.csv"
    df = pd.read_csv(SAMPLE)
    df.drop_duplicates(["smiles_1", "smiles_2"]).to_csv(path, index=False)
    return str(path)


def _config(**kw):
    base = dict(conv_layers=2, fp_hidden_dim=8, fp_out_dim=8,
                weight_tying=False, compute_path="coo", batch_size=BATCH)
    return JaxTrainConfig(**{**base, **kw})


def _write_run(run, cfg, seed=3):
    """A run directory as the train CLI writes it: config.json and a
    ``best`` checkpoint's params.npz of seeded weights."""
    os.makedirs(run / "best")
    (run / "config.json").write_text(cfg.to_json())
    kwargs = model_kwargs_from_config(json.loads(cfg.to_json()))
    save_params_npz(str(run / "best" / "params.npz"),
                    init_params(kwargs, seed))


def _multilabel_csv(path, sample):
    """The pairs with ||-joined labels drawn from the synth546 classes by
    a seeded rule; every class has positives and negatives."""
    classes = get_class_labels(CLASSES)
    rng = np.random.default_rng(5)
    df = pd.read_csv(sample)
    df["label"] = ["||".join(c for c in classes if rng.random() < 0.4)
                   for _ in range(len(df))]
    df.to_csv(path, index=False)
    return classes


def _embeddings(column):
    return np.stack([np.array(s.split(), np.float64) for s in column])


def _assert_metrics_close(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key == "per_class":
            assert sorted(got[key]) == sorted(w)
            for c in w:
                _assert_metrics_close(got[key][c], w[c])
        else:
            np.testing.assert_allclose(got[key], w, rtol=TOL, atol=TOL,
                                       err_msg=key)


def _jax_reference(run, cfg, test_csv, out, classes=None):
    """The JAX ``evaluate_dataset`` on the params the port serves."""
    _, model = load_run(str(run), "best", "cpu")
    res = CSVPairParser(multi_label_classes=classes).parse(str(test_csv))
    return jeval.evaluate_dataset(
        None, to_jax_params(model), res.dataset, out_dir=str(out),
        source_csv=str(test_csv), batch_size=BATCH, class_num=cfg.class_num,
        is_successful=res.is_successful, class_names=classes, train_cfg=cfg)


def _assert_exports_match(got_dir, want_dir, base, multilabel=False):
    for name in (f"{base}_e.csv", f"{base}_e_y.csv"):
        got, want = pd.read_csv(got_dir / name), pd.read_csv(want_dir / name)
        cols = list(got.columns)
        assert cols == list(want.columns)
        # e1 and e2 go in before the last column of the source CSV
        assert cols[cols.index("e1"):cols.index("e1") + 3] == ["e1", "e2",
                                                               "label"]
        for col in ("e1", "e2"):
            np.testing.assert_allclose(_embeddings(got[col]),
                                       _embeddings(want[col]), rtol=TOL,
                                       atol=TOL, err_msg=col)
        rest = [c for c in want.columns if c not in ("e1", "e2", "y")]
        pd.testing.assert_frame_equal(got[rest], want[rest])
        if "y" in want:
            parse = ((lambda s: json.loads(s)) if multilabel else float)
            np.testing.assert_allclose(
                np.array([parse(v) for v in got["y"]], np.float64),
                np.array([parse(v) for v in want["y"]], np.float64),
                rtol=TOL, atol=TOL)
    got = pd.read_csv(got_dir / "drug_list_with_representation.csv")
    want = pd.read_csv(want_dir / "drug_list_with_representation.csv")
    assert list(got["cid"]) == list(want["cid"])
    np.testing.assert_allclose(_embeddings(got["entity"]),
                               _embeddings(want["entity"]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_evaluate_cli_matches_jax_evaluate_dataset(tmp_path, model, capsys,
                                                   sample):
    cfg = _config(**MODELS[model])
    run = tmp_path / "run"
    _write_run(run, cfg)
    out = tmp_path / "eval"
    assert evaluate_cli.main(["--test", sample, "--run", str(run),
                              "--batch-size", str(BATCH), "--out", str(out),
                              "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _jax_reference(run, cfg, sample, tmp_path / "jax")
    got = json.loads((out / "eval_result.json").read_text())
    _assert_metrics_close(got, want.metrics)
    assert printed == got
    _assert_exports_match(out, tmp_path / "jax", "sample_unique")


@pytest.mark.parametrize("model", sorted(MODELS))
def test_evaluate_cli_exports_with_repeated_pairs_match_jax(tmp_path, model):
    """sample200 whole, its 40 repeated pairs included: a fault in the
    port's packing or batch positions would misplace a row here."""
    cfg = _config(**MODELS[model])
    run = tmp_path / "run"
    _write_run(run, cfg)
    out = tmp_path / "eval"
    assert evaluate_cli.main(["--test", SAMPLE, "--run", str(run),
                              "--batch-size", str(BATCH), "--out", str(out),
                              "--device", "cpu"]) == 0
    _jax_reference(run, cfg, SAMPLE, tmp_path / "jax")
    assert len(pd.read_csv(out / "sample200_e.csv")) == 200
    _assert_exports_match(out, tmp_path / "jax", "sample200")


def test_evaluate_cli_multilabel_per_class_matches_jax(tmp_path, capsys,
                                                       sample):
    data = tmp_path / "multi.csv"
    classes = _multilabel_csv(data, sample)
    cfg = _config(method="ggnn", sim_method="hole", class_num=len(classes))
    run = tmp_path / "run"
    _write_run(run, cfg)
    out = tmp_path / "eval"
    assert evaluate_cli.main(["--test", str(data), "--run", str(run),
                              "--labels-csv", CLASSES, "--batch-size",
                              str(BATCH), "--out", str(out),
                              "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = json.loads((out / "eval_result.json").read_text())
    assert sorted(got["per_class"]) == sorted(classes)
    assert "per_class" not in printed
    assert all(np.isfinite(v) for c in got["per_class"].values()
               for v in c.values())
    want = _jax_reference(run, cfg, data, tmp_path / "jax", classes)
    _assert_metrics_close(got, want.metrics)
    _assert_exports_match(out, tmp_path / "jax", "multi", multilabel=True)


def test_evaluator_passes_class_names_as_the_jax_one_does(sample):
    """The fault repaired here: the port's evaluator took no class names,
    so a multi-label evaluation lost ``per_class``."""
    classes = get_class_labels(CLASSES)
    df = pd.read_csv(sample).head(48)
    rng = np.random.default_rng(9)
    df["label"] = ["||".join(c for c in classes if rng.random() < 0.5)
                   for _ in range(len(df))]
    ds = CSVPairParser(multi_label_classes=classes).parse(df).dataset
    cfg = _config(method="ggnn", sim_method="hole", class_num=len(classes))
    kwargs = model_kwargs_from_config(json.loads(cfg.to_json()))
    tree = init_params(kwargs, 4)
    from gcnbmp_tpu_torch.train.checkpoints import served_predictor

    model = served_predictor(json.loads(cfg.to_json()), tree)
    got = PackedPairEvaluator(model, batch_size=16, class_num=len(classes),
                              device="cpu", class_names=classes).evaluate(ds)
    want = jeval.PackedPairEvaluator(cfg, tree, batch_size=16,
                                     class_num=len(classes),
                                     class_names=classes).evaluate(ds)
    assert sorted(got.metrics["per_class"]) == sorted(classes)
    _assert_metrics_close(got.metrics, want.metrics)
    # without class names neither has per_class, as the trainer calls it
    plain = PackedPairEvaluator(model, batch_size=16, class_num=len(classes),
                                device="cpu").evaluate(ds)
    assert "per_class" not in plain.metrics


@pytest.mark.parametrize("method", ["cosine", "jaccard", "extended-jaccard"])
def test_evaluate_cli_similarity_matches_jax(tmp_path, method):
    cfg = _config(**MODELS["ggnn_hole"])
    run = tmp_path / "run"
    _write_run(run, cfg)
    out = tmp_path / "eval"
    assert evaluate_cli.main(["--test", SAMPLE, "--run", str(run),
                              "--batch-size", str(BATCH), "--out", str(out),
                              "--similarity", method, "--device", "cpu"]) == 0
    got = pd.read_csv(out / f"similarity_{method}.csv", index_col=0)
    # the JAX CLI's matrix (:128-142) over the same embeddings: left ids
    # first, then right ones, each id's first embedding
    _, model = load_run(str(run), "best", "cpu")
    ds = CSVPairParser().parse(SAMPLE).dataset
    res = PackedPairEvaluator(model, batch_size=BATCH, device="cpu").evaluate(ds)
    ids = [p[0] for p in ds.smiles_pairs] + [p[1] for p in ds.smiles_pairs]
    uniq = {}
    for i, e in zip(ids, np.concatenate([res.e1, res.e2])):
        uniq.setdefault(i, e)
    want_path = tmp_path / "want.csv"
    jsimilarity_csv(np.stack(list(uniq.values())), list(uniq.keys()),
                    method=method, out_path=str(want_path))
    want = pd.read_csv(want_path, index_col=0)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert got.shape == (len(uniq), len(uniq))


def test_evaluate_cli_correlation_matches_jax(tmp_path):
    cfg = _config(**MODELS["ggnn_hole"])
    run = tmp_path / "run"
    _write_run(run, cfg)
    df = pd.read_csv(SAMPLE)
    cids = sorted(set(df["cid_1"]) | set(df["cid_2"]))[:40]
    rng = np.random.default_rng(1)
    mat = (rng.random((len(cids), len(cids))) < 0.3).astype(int)
    mat = np.maximum(mat, mat.T)
    pd.DataFrame(mat, index=cids, columns=cids).to_csv(tmp_path / "ddi.csv")
    out = tmp_path / "eval"
    assert evaluate_cli.main(["--test", SAMPLE, "--run", str(run),
                              "--batch-size", str(BATCH), "--out", str(out),
                              "--correlation-matrix", str(tmp_path / "ddi.csv"),
                              "--device", "cpu"]) == 0
    got = json.loads((out / "correlation.json").read_text())
    # the JAX CLI's per-drug embeddings (:160-170), cid columns first
    _, model = load_run(str(run), "best", "cpu")
    res = PackedPairEvaluator(model, batch_size=BATCH, device="cpu").evaluate(
        CSVPairParser().parse(SAMPLE).dataset)
    emb = {}
    for col, e in (("cid_1", res.e1), ("cid_2", res.e2)):
        for i, d in enumerate(df[col].astype(str)):
            emb.setdefault(d, e[i])
    keep = [i for i, d in enumerate(cids) if d in emb]
    corr, _, _ = janalysis.embedding_ddi_correlation(
        np.stack([emb[cids[i]] for i in keep]), mat[np.ix_(keep, keep)])
    assert got == {"pearson_correlation": corr, "n_drugs": len(keep)}
    assert np.isfinite(corr) and len(keep) == len(cids)


def _jax_run(port_run, jax_run, cfg):
    """The port's run as the JAX train CLI writes it: the same
    config.json, and ``best`` as an orbax checkpoint of the JAX
    ``Trainer``'s state holding the port's weights."""
    import dataclasses

    import jax
    from gcnbmp_tpu.data.parsers import CSVPairParser as JCSVPairParser
    from gcnbmp_tpu.train import Trainer as JaxTrainer
    from gcnbmp_tpu.train.checkpoints import save_checkpoint

    from gcnbmp_tpu_torch.convert import load_params_npz

    os.makedirs(jax_run)
    (jax_run / "config.json").write_text(cfg.to_json())
    ds = JCSVPairParser().parse(SAMPLE).dataset
    state = JaxTrainer(dataclasses.replace(cfg, scan_steps=1), ds,
                       None)._init_state()
    tree = load_params_npz(str(port_run / "best" / "params.npz"))
    state = dataclasses.replace(
        state, params=jax.tree_util.tree_map(jax.numpy.asarray, tree))
    save_checkpoint(str(jax_run / "best"), state)


def _svg_fills(svg):
    """An SVG's text with each atom's fill taken out, and the fills as
    (r, g, b) integers."""
    fills = re.findall(r'fill="#([0-9a-f]{6})"', svg)
    return (re.sub(r'fill="#[0-9a-f]{6}"', "fill", svg),
            [tuple(int(f[i:i + 2], 16) for i in (0, 2, 4)) for f in fills])


def _saliency_matches_the_jax_cli(tmp_path, cfg, run, sample_csv):
    """``--saliency gradient`` and ``integrated`` of the port's CLI
    against the JAX CLI on the same params: the same files, the same
    layout, each atom's colour (its map quantized to 255 steps) within one
    step.  (``bayes`` draws its noise from another generator in each
    package; tests/test_torch_saliency.py holds it at the same points.)"""
    from gcnbmp_tpu.cli import evaluate as jax_evaluate_cli

    _jax_run(run, tmp_path / "jax_run", cfg)
    for method in ("gradient", "integrated"):
        out, jout = tmp_path / f"eval_{method}", tmp_path / f"jax_{method}"
        flags = ["--test", sample_csv, "--saliency", method,
                 "--saliency-count", "3"]
        assert evaluate_cli.main(flags + ["--run", str(run), "--out",
                                          str(out), "--device", "cpu"]) == 0
        assert jax_evaluate_cli.main(flags + [
            "--run", str(tmp_path / "jax_run"), "--out", str(jout)]) == 0
        names = sorted(os.listdir(jout / "saliency"))
        assert sorted(os.listdir(out / "saliency")) == names
        assert len(names) == 6
        n_red = 0
        for name in names:
            got, gf = _svg_fills((out / "saliency" / name).read_text())
            want, wf = _svg_fills((jout / "saliency" / name).read_text())
            assert got == want and len(gf) == len(wf)
            assert max(abs(a - b) for x, y in zip(gf, wf)
                       for a, b in zip(x, y)) <= 1
            n_red += sum(g < 255 for _, g, _ in gf)
        assert n_red > 0


@pytest.mark.parametrize("case", ["saliency", "saliency_gwm", "platform",
                                  "no_labels_csv", "class_count",
                                  "missing_checkpoint", "unbuilt_width"])
def test_evaluate_cli_refusals(tmp_path, case, sample):
    """The CLI's refusals.  ``saliency``, refused until the port had
    ``eval.saliency``, now writes the SVGs the JAX CLI writes on the same
    params; ``saliency_gwm`` is refused after the metrics, as the JAX CLI
    refuses it (``GWMPairPredictor`` without supernode features)."""
    multi = case in ("no_labels_csv", "class_count")
    # GGNN's kernels are built for 16, 32 and 64: 48 is a width they refuse
    width = 48 if case == "unbuilt_width" else 8
    cfg = _config(method="ggnn-gwm" if case == "saliency_gwm" else "ggnn",
                  sim_method="hole", class_num=3 if multi else 1,
                  fp_hidden_dim=width, fp_out_dim=width)
    run = tmp_path / "run"
    _write_run(run, cfg)
    argv = ["--test", str(tmp_path / "absent.csv"), "--run", str(run),
            "--device", "cpu", "--out", str(tmp_path / "eval")]
    if case == "saliency":
        _saliency_matches_the_jax_cli(tmp_path, cfg, run, sample)
        return
    if case == "saliency_gwm":
        with pytest.raises(ValueError, match="supernode features"):
            evaluate_cli.main(argv[:1] + [sample] + argv[2:]
                              + ["--saliency", "integrated"])
        assert (tmp_path / "eval" / "eval_result.json").exists()
        assert not (tmp_path / "eval" / "saliency").exists()
        return
    if case == "platform":
        with pytest.raises(ValueError, match="--platform"):
            evaluate_cli.main(argv + ["--platform", "cpu"])
    elif case == "no_labels_csv":
        with pytest.raises(SystemExit, match="multi-label"):
            evaluate_cli.main(argv)
    elif case == "class_count":
        with pytest.raises(SystemExit, match="5 classes.*class_num=3"):
            evaluate_cli.main(argv + ["--labels-csv", CLASSES])
    elif case == "unbuilt_width":
        # on the card, before the CUDA check and any weight is read
        with pytest.raises(ValueError, match="fp_hidden_dim=48"):
            evaluate_cli.main([a if a != "cpu" else "cuda" for a in argv])
    else:
        os.makedirs(run / "final")
        os.rename(run / "best" / "params.npz", run / "final" / "params.npz")
        with pytest.raises(FileNotFoundError,
                           match="no checkpoint 'best'.*holds: final"):
            evaluate_cli.main(argv)
    # refused before any work: nothing written
    assert not (tmp_path / "eval").exists()


def test_predict_run_equals_predict_config_params(tmp_path):
    cfg = _config(**MODELS["coattention_para_ntn"])
    run = tmp_path / "run"
    _write_run(run, cfg)
    common = ["--input", SAMPLE, "--batch-size", "32", "--device", "cpu"]
    assert predict.main(common + ["--run", str(run), "--out",
                                  str(tmp_path / "a.csv")]) == 0
    assert predict.main(common + ["--config", str(run / "config.json"),
                                  "--params", str(run / "best" / "params.npz"),
                                  "--out", str(tmp_path / "b.csv")]) == 0
    a, b = pd.read_csv(tmp_path / "a.csv"), pd.read_csv(tmp_path / "b.csv")
    pd.testing.assert_frame_equal(a, b, check_exact=True)
    assert len(a) == 200
    for argv in (["--run", str(run), "--params", "x.npz"],
                 ["--config", str(run / "config.json")], []):
        with pytest.raises(SystemExit):
            predict.main(common + argv)


@pytest.mark.parametrize("family", ["mpnn", "para", "lt"])
def test_load_run_takes_the_serving_widths(tmp_path, family):
    """No Trainer over the test set: MPNN's Set2Set table is the JAX
    evaluator's 64 atoms wide whatever width training fitted, a
    co-attention model's atom table takes the dataset's width, and
    ``lt``'s the width its ``W1`` holds."""
    cfg = _config(**({"mpnn": MODELS["mpnn"],
                      "para": MODELS["coattention_para_ntn"]}.get(family)
                     or dict(method="ggnn", sim_method="ntn", attn="lt")))
    run = tmp_path / "run"
    os.makedirs(run / "best")
    (run / "config.json").write_text(cfg.to_json())
    kwargs = model_kwargs_from_config(json.loads(cfg.to_json()))
    # the widths a trainer fits to small training molecules
    kwargs.update({"mpnn": {"s2s_n_max": 16}, "para": {"coattn_n_max": 16},
                   "lt": {"coattn_n_max": 32}}[family])
    save_params_npz(str(run / "best" / "params.npz"), init_params(kwargs, 2))
    _, model = load_run(str(run), "best", "cpu")
    if family == "mpnn":
        assert model.encoder.readout_0.set2set.dense_n_max == 64
    else:
        assert model.table_width == {"para": None, "lt": 32}[family]
