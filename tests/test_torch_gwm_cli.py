"""GGNN-GWM through the port's CLIs on the CPU, and its refusals:

- the train CLI on coo, coo with scan mode and packed; ``final`` served
  by the predict CLI through ``--run`` and ``--config/--params`` alike,
  ``best`` scored by the evaluate CLI;
- the evaluate and predict CLIs on a GWM run against the JAX package's
  scoring of it: both take the padded ``PairEvaluator`` over
  ``GWMPairPredictor`` (gcnbmp_tpu/eval/evaluate.py:200-211), probs and
  AUROC and AUPRC within 1e-5, on sample200 without its repeated pairs;
- the GWM refusals, each naming the JAX package's reason.

The parity of the modules: tests/test_torch_gwm.py."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.eval import evaluate as jeval
from gcnbmp_tpu.models import gwm as jgwm
from gcnbmp_tpu.models import set_up_predictor
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli
from gcnbmp_tpu_torch.cli import predict
from gcnbmp_tpu_torch.cli import train as train_cli
from gcnbmp_tpu_torch.convert import init_params, save_params_npz
from gcnbmp_tpu_torch.data import CSVPairParser
from gcnbmp_tpu_torch.models import gwm
from gcnbmp_tpu_torch.models import packed as tpacked
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.config import TrainConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "dataset", "sample", "sample200.csv")
PROB_TOL = 1e-5
AUC_TOL = 1e-5
BATCH = 64


def _toy_csv(path, n=64):
    """Label 1 when both molecules hold an oxygen."""
    oxy = ["CCO", "CC(=O)O", "OCCO", "C=O", "COC"]
    nox = ["CC", "CCC", "c1ccccc1", "CCN"]
    rng = np.random.default_rng(7)
    rows = []
    for i in range(n):
        a = rng.choice(oxy if rng.random() < 0.5 else nox)
        b = rng.choice(oxy if rng.random() < 0.5 else nox)
        rows.append([i, i, a, b, int(a in oxy and b in oxy)])
    pd.DataFrame(rows, columns=["drugbank_id_1", "drugbank_id_2", "smiles_1",
                                "smiles_2", "label"]).to_csv(path, index=False)


@pytest.mark.parametrize("flags", [["--compute-path", "coo"],
                                   ["--compute-path", "coo", "--scan-steps",
                                    "2"],
                                   ["--compute-path", "packed",
                                    "--debug-checks"]],
                         ids=["coo", "coo-scan", "packed"])
def test_gwm_trains_serves_and_scores_through_the_clis(tmp_path, capsys,
                                                       flags):
    data, out = str(tmp_path / "toy.csv"), tmp_path / "run"
    _toy_csv(data)
    rc = train_cli.main([
        "--train", data, "--val", data, "--method", "ggnn-gwm",
        "--fp-hidden-dim", "8", "--fp-out-dim", "8", "--conv-layers", "2",
        "--batch-size", "16", "--lr", "5e-3", *flags, "--epochs", "3",
        "--patience", "100", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    log = json.loads((out / "log.json").read_text())
    losses = [e["main/loss"] for e in log]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(np.isfinite(e["val/roc_auc"]) for e in log)
    preds = {}
    for form, args in (("run", ["--run", str(out), "--checkpoint", "final"]),
                       ("pair", ["--config", str(out / "config.json"),
                                 "--params",
                                 str(out / "final" / "params.npz")])):
        path = tmp_path / f"{form}.csv"
        assert predict.main(["--input", data, *args, "--out", str(path),
                             "--device", "cpu"]) == 0
        preds[form] = pd.read_csv(path)["prob"].to_numpy()
    assert preds["run"].shape == (64,) and np.all(np.isfinite(preds["run"]))
    np.testing.assert_array_equal(preds["run"], preds["pair"])
    capsys.readouterr()
    assert evaluate_cli.main(["--test", data, "--run", str(out), "--device",
                              "cpu"]) == 0
    result = json.loads((out / "eval" / "eval_result.json").read_text())
    assert result["roc_auc"] > 0.9


def test_gwm_clis_match_the_jax_padded_scoring(tmp_path, capsys):
    sample = tmp_path / "sample_unique.csv"
    pd.read_csv(SAMPLE).drop_duplicates(["smiles_1", "smiles_2"]).to_csv(
        sample, index=False)
    cfg = JaxTrainConfig(method="ggnn-gwm", conv_layers=4, fp_hidden_dim=8,
                         fp_out_dim=8, weight_tying=False, compute_path="coo",
                         batch_size=BATCH)
    run = tmp_path / "run"
    os.makedirs(run / "best")
    (run / "config.json").write_text(cfg.to_json())
    kwargs = tpacked.model_kwargs_from_config(json.loads(cfg.to_json()))
    tree = init_params(kwargs, seed=3)
    save_params_npz(str(run / "best" / "params.npz"), tree)

    out = tmp_path / "eval"
    assert evaluate_cli.main(["--test", str(sample), "--run", str(run),
                              "--batch-size", str(BATCH), "--out", str(out),
                              "--device", "cpu"]) == 0
    got = json.loads((out / "eval_result.json").read_text())
    assert predict.main(["--input", str(sample), "--run", str(run),
                         "--out", str(tmp_path / "preds.csv"),
                         "--batch-size", str(BATCH), "--device", "cpu"]) == 0
    capsys.readouterr()

    # the JAX evaluate CLI's call for a GWM run: the padded predictor and
    # evaluator with the supernode function
    padded = set_up_predictor(method="ggnn-gwm", fp_hidden_dim=8,
                              fp_out_dim=8, conv_layers=4, weight_tying=False)
    res = CSVPairParser().parse(str(sample))
    want = jeval.evaluate_dataset(
        padded, jnp_tree(tree), res.dataset, batch_size=BATCH,
        supernode_fn=jgwm.default_supernode_fn(), train_cfg=cfg)
    want_p = 1.0 / (1.0 + np.exp(-want.logits.astype(np.float64)))
    exported = pd.read_csv(out / "sample_unique_e_y.csv")["y"].to_numpy()
    served = pd.read_csv(tmp_path / "preds.csv")["prob"].to_numpy()
    assert len(exported) == len(served) == len(want_p) == len(res.dataset)
    np.testing.assert_allclose(exported, want_p, rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(served, want_p, rtol=0, atol=PROB_TOL)
    for key in ("roc_auc", "prc_auc"):
        np.testing.assert_allclose(got[key], want.metrics[key], rtol=0,
                                   atol=AUC_TOL, err_msg=key)


def jnp_tree(tree):
    return {k: jnp_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


# (TrainConfig changes, the text the refusal holds)
GWM_REFUSALS = {
    "fused": (dict(compute_path="fused"),
              "ggnn-gwm rides compute_path 'packed' or 'coo'"),
    "padded": (dict(compute_path="padded"), None),  # trains
    "packed-scan": (dict(compute_path="packed", scan_steps=2),
                    "scan mode requires compute_path='coo'"),
    "attn": (dict(compute_path="coo", attn="para"), "without co-attention"),
    "aggregator": (dict(compute_path="coo", layer_aggregator="gru"),
                   "layer aggregator rides the packed GGNN only"),
    "dropout": (dict(compute_path="coo", fp_dropout_rate=0.1),
                "fp_dropout_rate"),
}


@pytest.mark.parametrize("case", sorted(GWM_REFUSALS))
def test_gwm_refusals_name_the_jax_reason(tmp_path, case):
    changes, text = GWM_REFUSALS[case]
    cfg = TrainConfig(method="ggnn-gwm", **changes)
    problems = loop.config_problems(cfg)
    if text is None:  # the padded layout trains GWM, as the JAX trainer does
        assert problems == []
        trainer = loop.Trainer(cfg, CSVPairParser().parse(SAMPLE).dataset,
                               device="cpu")
        assert isinstance(trainer.model, gwm.GWMPairPredictor)
        return
    assert len(problems) == 1 and text in problems[0]
    with pytest.raises(ValueError, match="configuration outside"):
        loop.Trainer(cfg, CSVPairParser().parse(SAMPLE).dataset, device="cpu")


@pytest.mark.parametrize("path", ["coo", "packed"])
def test_gwm_trains_on_coo_and_packed_at_any_width(path):
    cfg = TrainConfig(method="ggnn-gwm", compute_path=path, fp_hidden_dim=24,
                      scan_steps=10 if path == "coo" else 0)
    assert loop.config_problems(cfg) == []
    assert loop.kernel_problems(cfg, "cuda") == []  # GWM runs no kernel
    kwargs = tpacked.model_kwargs_from_config(json.loads(cfg.to_json()))
    assert kwargs["method"] == "ggnn-gwm"
    model = tpacked.make_packed_predictor(**kwargs)
    assert isinstance(model, gwm.PackedGWMPairPredictorCOOCompact)
    assert model.encoder.gwm_0.super_query.out_features == 8 * 24
    assert model.encoder.embed_super.in_features == 244


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_init_params_draw_the_flax_tree_of_gwm(tied):
    """``init_params`` gives the JAX predictor's parameter tree, key for
    key and shape for shape, drawn from flax's initializers: lecun-normal
    kernels, zero biases, the Normal(1.0) atom embedding."""
    import jax

    from gcnbmp_tpu.data.packing import (
        attach_supers_coo, pack_pair_dataset_coo)
    from gcnbmp_tpu.models import packed as jpacked

    cfg = dict(method="ggnn-gwm", fp_hidden_dim=16, fp_out_dim=16,
               conv_layers=3, weight_tying=tied)
    ds = CSVPairParser().parse(SAMPLE).dataset
    batch = attach_supers_coo(pack_pair_dataset_coo(ds, range(4)), ds,
                              list(range(4)), jgwm.default_supernode_fn())
    wire = jpacked.compact_gwm_arrays(batch)
    jtree = jpacked.make_packed_predictor(**cfg, coo=True, compact=True).init(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in wire))["params"]
    got = _flat(init_params(cfg, seed=1))
    want = _flat(jax.tree_util.tree_map(np.asarray, jtree))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert any(k.startswith("encoder/gwm_2/") for k in got) != tied
    for key, v in got.items():
        if key.endswith("/bias"):
            assert not v.any(), key
        elif key.endswith("embedding"):
            assert abs(v.std() - 1.0) < 0.15, key
        else:
            fan_in = v.shape[0]
            assert np.abs(v).max() <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6
            assert abs(v.std() * np.sqrt(fan_in) - 1.0) < 0.5, key


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out
