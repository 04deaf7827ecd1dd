"""The predictors, training and CLIs of the port's RelGCN, GIN, NFP and
GGNN with a layer aggregator, against the JAX package on the CPU:

- the compact-wire predictor of each method, and the co-attention
  predictor (``para`` + NTN) over RelGCN, against the JAX predictors:
  logits, loss and every parameter gradient;
- three train steps against the JAX coo train step for RelGCN and the
  ``gru`` aggregator;
- the configuration checks, the factory's refusals and the train,
  predict and evaluate CLIs on the new methods.

The encoders themselves: tests/test_torch_encoders.py.  Inputs are the
first pairs of dataset/synth546's drug train split at small widths;
weights come from ``convert.init_params`` with a seed."""


import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.data.packing import pack_pair_dataset_coo
from gcnbmp_tpu.data.parsers import CSVPairParser
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.train import loop as jloop
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli
from gcnbmp_tpu_torch.cli import predict
from gcnbmp_tpu_torch.cli import train as train_cli
from gcnbmp_tpu_torch.convert import (
    from_jax_params, init_params, named_to_tree, to_jax_params)
from gcnbmp_tpu_torch.data.wire import compact_coattn_arrays, compact_coo_arrays
from gcnbmp_tpu_torch.models import packed as tpacked
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.config import PRESETS, TrainConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_train.csv")
RTOL, ATOL = 1e-4, 1e-5  # outputs and gradients (test_torch_slice.py:35)
N_MAX = 32               # co-attention atom table width: bounds every molecule
# (name, make_packed_predictor kwargs): one predictor of each method
PREDICTORS = [
    ("relgcn", dict(method="relgcn")),
    ("gin-untied", dict(method="gin", weight_tying=False)),
    ("nfp", dict(method="nfp")),
    ("ggnn-gru", dict(method="ggnn", weight_tying=False,
                      layer_aggregator="gru")),
    ("ggnn-concat", dict(method="ggnn", weight_tying=False,
                         layer_aggregator="concat")),
]


def _dataset(n, skip=0):
    df = pd.read_csv(PAIRS).iloc[skip:skip + n]
    return CSVPairParser().parse(df).dataset


def _cfg(layers=3, hidden=8, out=8, **kw):
    return dict(fp_hidden_dim=hidden, fp_out_dim=out, conv_layers=layers, **kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                   err_msg=key)


def _grads(module):
    return named_to_tree({n: torch.zeros_like(p) if p.grad is None else p.grad
                          for n, p in module.named_parameters()})


# ---------------------------------------------------------------------------
# the predictors against the JAX ones


def _predictor_case(cfg, wire, labels, seed, port_kw=None):
    port_kw = port_kw or {}
    tree = init_params(dict(cfg, **port_kw), seed=seed)
    pred = jpacked.make_packed_predictor(**cfg, coo=True, compact=True)

    def jloss(params):
        logits = pred.apply({"params": params}, *(jnp.asarray(a) for a in wire))
        return jloop.sigmoid_cross_entropy(logits.reshape(labels.shape),
                                           jnp.asarray(labels)), logits

    (want_loss, want_logits), want = jax.value_and_grad(jloss, has_aux=True)(tree)
    model = from_jax_params(tree, tpacked.make_packed_predictor(**cfg, **port_kw))
    logits = model(*(torch.as_tensor(np.asarray(a)) for a in wire))
    loss = loop.sigmoid_cross_entropy(logits, torch.as_tensor(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL,
                               atol=ATOL)
    _assert_trees_close(_grads(model), want)


@pytest.mark.parametrize("name,kw", PREDICTORS,
                         ids=lambda x: x if isinstance(x, str) else "")
def test_compact_predictor_matches_jax(name, kw):
    batch = pack_pair_dataset_coo(_dataset(12), list(range(12)))
    labels = np.asarray(batch.labels, np.float32)
    _predictor_case(_cfg(**kw, sim_method="hole", out=16), compact_coo_arrays(batch),
                    labels, seed=7)


def test_coattention_over_relgcn_matches_jax():
    batch = pack_pair_dataset_coo(_dataset(12), list(range(12)))
    labels = np.asarray(batch.labels, np.float32)
    cfg = _cfg(method="relgcn", attn="para", sim_method="ntn",
               net_hidden_dims=(8,))
    _predictor_case(cfg, compact_coattn_arrays(batch, N_MAX), labels, seed=9,
                    port_kw=dict(coattn_n_max=N_MAX))


@pytest.mark.parametrize("kw", [dict(method="relgcn"),
                                dict(method="ggnn", weight_tying=False,
                                     layer_aggregator="gru")],
                         ids=["relgcn", "ggnn-gru"])
def test_three_train_steps_match_the_jax_coo_steps(kw):
    jcfg = JaxTrainConfig(**_cfg(**kw), compute_path="coo", learning_rate=1e-2,
                          batch_size=8)
    kwargs = predict.model_kwargs_from_config(json.loads(jcfg.to_json()))
    tree = init_params(kwargs, seed=4)
    batches = [pack_pair_dataset_coo(_dataset(8, skip=8 * i), list(range(8)))
               for i in range(3)]
    tx, _ = jloop.build_optimizer(jcfg, 1)
    pred = jpacked.make_packed_predictor(**kwargs, coo=True, compact=True)
    step = jloop.make_packed_coo_train_step(pred, tx)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(params)
    model = from_jax_params(tree, tpacked.make_packed_predictor(**kwargs))
    opt, _ = loop.build_optimizer(TrainConfig(**json.loads(jcfg.to_json())), 1,
                                  list(model.parameters()))
    for batch in batches:
        wire = compact_coo_arrays(batch)
        labels = np.asarray(batch.labels, np.float32)
        params, opt_state, want_loss, _ = step(
            params, opt_state, tuple(jnp.asarray(a) for a in wire),
            jnp.asarray(labels))
        loss = loop.train_step(model, opt, [torch.as_tensor(np.asarray(a))
                                            for a in wire],
                               torch.as_tensor(labels))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL,
                                   atol=ATOL)
    got, want, start = _flat(to_jax_params(model)), _flat(params), _flat(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        # three Adam steps move each weight by up to 3 lr: hold the moves
        np.testing.assert_allclose(got[k] - start[k], want[k] - start[k],
                                   rtol=1e-3, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# configurations, the factory, the CLIs


@pytest.mark.parametrize("preset", ["relgcn_binary", "gin_binary",
                                    "ggnn_multilabel_x37"])
def test_presets_train_on_coo(preset):
    cfg = TrainConfig(**{**json.loads(PRESETS[preset].to_json()),
                         "compute_path": "coo"})
    assert loop.config_problems(cfg) == []
    assert loop.kernel_problems(cfg, "cuda") == []
    jcfg = JaxTrainConfig(**json.loads(cfg.to_json()))
    assert jloop.packed_config_problems(jcfg) == []


@pytest.mark.parametrize("kw", [dict(method="relgcn"), dict(method="gin"),
                                dict(method="nfp"),
                                dict(method="ggnn", layer_aggregator="gru")],
                         ids=["relgcn", "gin", "nfp", "ggnn-gru"])
def test_new_methods_run_no_kernel_and_refuse_fused(kw):
    cfg = TrainConfig(**kw, compute_path="coo", fp_hidden_dim=24)
    assert loop.config_problems(cfg) == []
    assert loop.kernel_problems(cfg, "cuda") == []  # no kernel: any width
    fused = TrainConfig(**kw, compute_path="fused")
    problems = loop.config_problems(fused)
    assert len(problems) == 1 and "as in the JAX package" in problems[0]
    assert jloop.packed_config_problems(JaxTrainConfig(
        **kw, compute_path="fused")) != []


def test_factory_refuses_an_aggregator_on_other_methods_as_jax_does():
    with pytest.raises(ValueError, match="layer_aggregator"):
        tpacked.make_packed_predictor(method="relgcn", layer_aggregator="gru")
    with pytest.raises(ValueError, match="layer_aggregator"):
        jpacked.make_packed_predictor(method="relgcn", layer_aggregator="gru")
    assert "none" in tpacked.fused_form(32, 32, None, "gru")


def _toy_csv(path, n=64, labels=None):
    """Label 1 when both molecules hold an oxygen; with ``labels`` the
    multi-label form: the first class when both hold one, the second when
    either holds a nitrogen."""
    oxy = ["CCO", "CC(=O)O", "OCCO", "C=O", "COC"]
    nox = ["CC", "CCC", "c1ccccc1", "CCN"]
    rng = np.random.default_rng(7)
    rows = []
    for i in range(n):
        a = rng.choice(oxy if rng.random() < 0.5 else nox)
        b = rng.choice(oxy if rng.random() < 0.5 else nox)
        y = int(a in oxy and b in oxy)
        if labels is not None:
            on = [labels[0]] * y + [labels[1]] * ("N" in a + b)
            y = "||".join(on) if on else labels[2]
        rows.append([i, i, a, b, y])
    pd.DataFrame(rows, columns=["drugbank_id_1", "drugbank_id_2", "smiles_1",
                                "smiles_2", "label"]).to_csv(path, index=False)


@pytest.mark.parametrize("flags", [["--method", "relgcn"],
                                   ["--method", "gin", "--weight-tying", "false"],
                                   ["--method", "nfp"],
                                   ["--layer-aggregator", "gru", "--multi"]],
                         ids=["relgcn", "gin", "nfp", "ggnn-gru-multilabel"])
def test_train_predict_and_evaluate_clis(tmp_path, capsys, flags):
    multi = flags[-1] == "--multi"
    flags = [f for f in flags if f != "--multi"]
    extra = []
    if multi:
        classes = ["oxy", "nitro", "none"]
        pd.DataFrame({"label": classes}).to_csv(tmp_path / "labels.csv",
                                                index=False)
        extra = ["--labels-csv", str(tmp_path / "labels.csv")]
        _toy_csv(tmp_path / "toy.csv", labels=classes)
    else:
        _toy_csv(tmp_path / "toy.csv")
    data, out = str(tmp_path / "toy.csv"), tmp_path / "run"
    rc = train_cli.main([
        "--train", data, "--val", data, *flags, "--fp-hidden-dim", "8",
        "--fp-out-dim", "8", "--conv-layers", "2", "--batch-size", "16",
        "--lr", "5e-3", "--compute-path", "coo", "--epochs", "3",
        "--patience", "100", "--device", "cpu", "--out", str(out), *extra])
    assert rc == 0
    log = json.loads((out / "log.json").read_text())
    losses = [e["main/loss"] for e in log]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["method"] == (flags[1] if flags[0] == "--method" else "ggnn")
    # a multi-label run serves too, where the JAX CLI raises computing
    # metrics over its placeholder labels
    rc = predict.main(["--input", data, "--run", str(out), "--checkpoint",
                       "final", "--out", str(tmp_path / "preds.csv"),
                       "--device", "cpu"])
    assert rc == 0
    preds = pd.read_csv(tmp_path / "preds.csv")
    probs = preds.filter(like="prob").to_numpy()
    assert probs.shape == (64, 3 if multi else 1)
    assert np.all((probs >= 0) & (probs <= 1))
    capsys.readouterr()
    rc = evaluate_cli.main(["--test", data, "--run", str(out), "--device",
                            "cpu", *extra])
    assert rc == 0
    result = json.loads((out / "eval" / "eval_result.json").read_text())
    assert np.isfinite(result["roc_auc"])
    if multi:
        assert sorted(result["per_class"]) == sorted(classes)
