"""The port's MPNN family (EdgeNet + Set2Set + HolE) against the JAX
package on the CPU: the plain ``PackedMPNN`` encoder against the JAX
module, the compact predictor (the kernels' plain versions) against the
JAX one on its XLA path and on its fused Pallas path in interpret mode,
outputs and every parameter gradient; MPNN with ``para`` co-attention on
coo against the JAX ``PackedCoattnPairPredictor`` the same two ways (K5's
h feeds both the Set2Set table and the co-attention's, and K5b takes the
sum of both gradients) and one coo train step against the JAX step; the
parameter tree and its initializers; the training configuration, the
train CLI and the predict CLI."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcnbmp_tpu.data.packing import max_atoms_lane_rounded, pack_pair_dataset_coo
from gcnbmp_tpu.data.parsers import CSVPairParser
from gcnbmp_tpu.eval.evaluate import PackedPairEvaluator as JaxEvaluator
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.train import loop as jloop
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu_torch.cli import predict
from gcnbmp_tpu_torch.cli import train as train_cli
from gcnbmp_tpu_torch.convert import (
    from_jax_params, init_params, load_params_npz, named_to_tree,
    save_params_npz, to_jax_params)
from gcnbmp_tpu_torch.data.wire import compact_coattn_arrays, compact_coo_arrays
from gcnbmp_tpu_torch.models.packed import make_packed_predictor
from gcnbmp_tpu_torch.ops import fused_mpnn as tfm
from gcnbmp_tpu_torch.ops import set2set_kernel as tsk
from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.config import TrainConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "dataset", "sample", "sample200.csv")
OUT_RTOL, OUT_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-5  # the JAX suite's bound (test_encoders.py:438-441)
S2S_N_MAX = 32  # bounds every molecule of the sample's first pairs


def _dataset(n):
    return CSVPairParser().parse(pd.read_csv(SAMPLE).head(n)).dataset


def _cfg(layers, hidden, tied):
    return dict(fp_hidden_dim=hidden, fp_out_dim=hidden, conv_layers=layers,
                weight_tying=tied, method="mpnn")


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_close(got, want, rtol, atol):
    got, want = _flat_tree(got), _flat_tree(want)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                   err_msg=key)


def _torch_grads(model):
    return named_to_tree({n: p.grad for n, p in model.named_parameters()})


# ---------------------------------------------------------------------------
# the parameter tree


@pytest.mark.parametrize("tied", [True, False])
def test_param_tree_matches_flax_and_lstm_kernels_are_orthogonal(tied):
    cfg = _cfg(3, 16, tied)
    batch = pack_pair_dataset_coo(_dataset(4), list(range(4)))
    args = [jnp.asarray(a) for a in compact_coo_arrays(batch)]
    flax_tree = jpacked.make_packed_predictor(**cfg, coo=True, compact=True).init(
        jax.random.PRNGKey(0), *args)["params"]
    tree = init_params(cfg, seed=0)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), t)
    assert shapes(tree) == shapes(flax_tree)
    lstm = tree["encoder"]["readout_0"]["set2set"]["lstm"]
    for gate in "ifgo":
        w = lstm[f"h{gate}"]["kernel"]
        np.testing.assert_allclose(w.T @ w, np.eye(16), atol=1e-5)
        assert not np.allclose(lstm[f"i{gate}"]["kernel"].T @ lstm[f"i{gate}"]["kernel"],
                               np.eye(16), atol=0.1)  # input kernels: lecun-normal
    back = to_jax_params(from_jax_params(tree, make_packed_predictor(**cfg)))
    _assert_trees_close(back, tree, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the encoder and the slice against the JAX package


@pytest.mark.parametrize("tied", [True, False])
def test_plain_encoder_matches_jax_packed_mpnn(tied):
    cfg = _cfg(3, 8, tied)
    batch = pack_pair_dataset_coo(_dataset(8), list(range(8)))
    adj = batch.to_dense().adj
    tree = init_params(cfg, seed=21 + tied)
    enc = jpacked.PackedMPNN(out_dim=8, hidden_dim=8, n_layers=3,
                             weight_tying=tied, s2s_n_max=S2S_N_MAX)
    jargs = (jnp.asarray(batch.atom_ids), jnp.asarray(adj),
             jnp.asarray(batch.mol_id), jnp.asarray(batch.node_mask), batch.num_mols)

    def jloss(params):
        g, aux = enc.apply({"params": params}, *jargs)
        return jnp.sum(g ** 2) + jnp.sum(aux["atoms"] ** 2), (g, aux["atoms"])

    (_, (want_g, want_atoms)), want_grads = jax.value_and_grad(
        jloss, has_aux=True)(tree["encoder"])
    model = make_packed_predictor(**cfg, s2s_n_max=S2S_N_MAX)
    from_jax_params(tree, model)
    p, t = batch.atom_ids.shape
    t_adj = adj_from_coo(*(torch.as_tensor(a) for a in (
        batch.e_tile, batch.e_type, batch.e_src, batch.e_dst, batch.e_mask)),
        num_tiles=p, tile=t)
    g, aux = model.encoder(torch.as_tensor(batch.atom_ids), t_adj,
                           torch.as_tensor(batch.mol_id),
                           torch.as_tensor(batch.node_mask), batch.num_mols)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(want_g),
                               rtol=OUT_RTOL, atol=OUT_ATOL)
    np.testing.assert_allclose(aux["atoms"].detach().numpy(), np.asarray(want_atoms),
                               rtol=OUT_RTOL, atol=OUT_ATOL)
    ((g ** 2).sum() + (aux["atoms"] ** 2).sum()).backward()
    _assert_trees_close(_torch_grads(model.encoder), want_grads, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("jax_path", ["xla", "pallas"])
@pytest.mark.parametrize("tied", [True, False])
def test_slice_logits_and_grads_match_jax(tied, jax_path):
    cfg = _cfg(2, 8, tied)
    batch = pack_pair_dataset_coo(_dataset(12), list(range(12)))
    wire = compact_coo_arrays(batch)
    labels = np.asarray(batch.labels, np.float32)
    tree = init_params(cfg, seed=5 + tied)
    pred = jpacked.make_packed_predictor(**cfg, coo=True, compact=True,
                                         s2s_n_max=S2S_N_MAX)

    def jloss(params):
        logits = pred.apply({"params": params}, *(jnp.asarray(a) for a in wire))
        return jloop.sigmoid_cross_entropy(logits, jnp.asarray(labels)), logits

    fused = jax_path == "pallas"
    saved = jpacked.MPNN_FUSED, jpacked.SET2SET_PALLAS
    jpacked.MPNN_FUSED = jpacked.SET2SET_PALLAS = fused
    try:
        with pltpu.force_tpu_interpret_mode():
            (want_loss, want_logits), want = jax.value_and_grad(
                jloss, has_aux=True)(tree)
    finally:
        jpacked.MPNN_FUSED, jpacked.SET2SET_PALLAS = saved
    model = from_jax_params(tree, make_packed_predictor(**cfg, s2s_n_max=S2S_N_MAX))
    before = (tfm.FusedMPNNFunction.backward_calls,
              tsk.FusedSet2SetFunction.backward_calls)
    logits = model(*(torch.as_tensor(np.asarray(a)) for a in wire))
    loss = loop.sigmoid_cross_entropy(logits, torch.as_tensor(labels))
    loss.backward()
    # the predictor's path went through both autograd functions
    assert (tfm.FusedMPNNFunction.backward_calls,
            tsk.FusedSet2SetFunction.backward_calls) == (before[0] + 1, before[1] + 1)
    np.testing.assert_allclose(logits.detach().numpy().ravel(),
                               np.asarray(want_logits).ravel(),
                               rtol=OUT_RTOL, atol=OUT_ATOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    _assert_trees_close(_torch_grads(model), want, GRAD_RTOL, GRAD_ATOL)


# ---------------------------------------------------------------------------
# MPNN with co-attention on coo

COATTN_GRAD_RTOL, COATTN_GRAD_ATOL = 1e-4, 1e-6


def _coattn_cfg(tied):
    return dict(_cfg(2, 8, tied), attn="para", sim_method="ntn",
                net_hidden_dims=(8,))


@pytest.mark.parametrize("jax_path", ["xla", "pallas"])
@pytest.mark.parametrize("tied", [True, False])
def test_coattention_logits_and_grads_match_jax(tied, jax_path):
    """Logits within 1e-5 and every gradient within 1e-4 max|want| +
    1e-6; the predictor's path runs each autograd function once, so
    K5b's dh is the Set2Set and the co-attention gradients summed."""
    cfg = _coattn_cfg(tied)
    batch = pack_pair_dataset_coo(_dataset(12), list(range(12)))
    wire = compact_coattn_arrays(batch, S2S_N_MAX)
    labels = np.asarray(batch.labels, np.float32)
    tree = init_params(dict(cfg, coattn_n_max=S2S_N_MAX), seed=9 + tied)
    pred = jpacked.make_packed_predictor(**cfg, coo=True, compact=True,
                                         s2s_n_max=S2S_N_MAX)

    def jloss(params):
        logits = pred.apply({"params": params}, *(jnp.asarray(a) for a in wire))
        return jloop.sigmoid_cross_entropy(logits.reshape(labels.shape),
                                           jnp.asarray(labels)), logits

    fused = jax_path == "pallas"
    saved = jpacked.MPNN_FUSED, jpacked.SET2SET_PALLAS
    jpacked.MPNN_FUSED = jpacked.SET2SET_PALLAS = fused
    try:
        with pltpu.force_tpu_interpret_mode():
            (want_loss, want_logits), want = jax.value_and_grad(
                jloss, has_aux=True)(tree)
    finally:
        jpacked.MPNN_FUSED, jpacked.SET2SET_PALLAS = saved
    model = from_jax_params(tree, make_packed_predictor(
        **cfg, s2s_n_max=S2S_N_MAX, coattn_n_max=S2S_N_MAX))
    before = (tfm.FusedMPNNFunction.backward_calls,
              tsk.FusedSet2SetFunction.backward_calls)
    logits = model(*(torch.as_tensor(np.asarray(a)) for a in wire))
    loss = loop.sigmoid_cross_entropy(logits, torch.as_tensor(labels))
    loss.backward()
    assert (tfm.FusedMPNNFunction.backward_calls,
            tsk.FusedSet2SetFunction.backward_calls) == (before[0] + 1,
                                                         before[1] + 1)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    got, want = _flat_tree(_torch_grads(model)), _flat_tree(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        bound = COATTN_GRAD_RTOL * float(np.abs(w).max()) + COATTN_GRAD_ATOL
        assert float(np.abs(got[key] - w).max()) <= bound, key


def test_coattention_train_step_matches_the_jax_coo_step():
    jcfg = JaxTrainConfig(method="mpnn", sim_method="ntn", attn="para",
                          conv_layers=2, fp_hidden_dim=8, fp_out_dim=8,
                          weight_tying=True, compute_path="coo",
                          learning_rate=1e-2, batch_size=12)
    batch = pack_pair_dataset_coo(_dataset(12), list(range(12)))
    wire = compact_coattn_arrays(batch, S2S_N_MAX)
    labels = np.asarray(batch.labels, np.float32)
    kwargs = dict(predict.model_kwargs_from_config(json.loads(jcfg.to_json())),
                  s2s_n_max=S2S_N_MAX)
    tree = init_params(dict(kwargs, coattn_n_max=S2S_N_MAX), seed=5)
    tx, _ = jloop.build_optimizer(jcfg, 1)
    pred = jpacked.make_packed_predictor(**kwargs, coo=True, compact=True)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    step = jloop.make_packed_coo_train_step(pred, tx)
    want_params, _, want_loss, _ = step(
        params, tx.init(params), tuple(jnp.asarray(a) for a in wire),
        jnp.asarray(labels))
    model = from_jax_params(tree, make_packed_predictor(
        **kwargs, coattn_n_max=S2S_N_MAX))
    opt, _ = loop.build_optimizer(TrainConfig(**json.loads(jcfg.to_json())),
                                  1, list(model.parameters()))
    loss = loop.train_step(model, opt, [torch.as_tensor(np.asarray(a))
                                        for a in wire],
                           torch.as_tensor(labels))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    got, want, start = (_flat_tree(t) for t in (to_jax_params(model),
                                                want_params, tree))
    assert sorted(got) == sorted(want)
    for k in want:
        # one Adam step moves each weight by about lr: hold the moves
        np.testing.assert_allclose(got[k] - start[k], want[k] - start[k],
                                   rtol=1e-3, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# what the port trains, the CLIs


QUALITY_ROW = dict(method="mpnn", sim_method="hole", conv_layers=4,
                   weight_tying=True, fp_hidden_dim=32, fp_out_dim=32,
                   batch_size=2048, learning_rate=2e-3, compute_path="coo",
                   compute_dtype="bfloat16", augment=True)


def test_config_problems_accept_the_quality_row_and_reject_fused_mpnn():
    assert loop.config_problems(TrainConfig(**QUALITY_ROW)) == []
    assert loop.config_problems(TrainConfig(**dict(QUALITY_ROW, compute_dtype="float32"))) == []
    # as the JAX package: the fused path is GGNN-only
    jax_cfg = JaxTrainConfig(**dict(QUALITY_ROW, compute_path="fused"))
    assert any("GGNN-only" in p for p in jloop.packed_config_problems(jax_cfg))
    # MPNN trains on packed too (K5 and K4, on the compact-COO predictor)
    assert loop.config_problems(TrainConfig(**dict(QUALITY_ROW, compute_path="packed"))) == []
    problems = loop.config_problems(TrainConfig(**dict(QUALITY_ROW, compute_path="fused")))
    assert len(problems) == 1 and "compute_path" in problems[0]
    assert "GGNN-only, as in the JAX package" in problems[0]
    # the padded MPNN trains, as in the JAX package (no kernel there)
    assert loop.config_problems(TrainConfig(**dict(QUALITY_ROW, compute_path="padded"))) == []


def test_model_kwargs_from_config_builds_mpnn():
    d = json.loads(TrainConfig(**QUALITY_ROW).to_json())
    kwargs = predict.model_kwargs_from_config(d)
    assert kwargs["method"] == "mpnn" and kwargs["conv_layers"] == 4
    model = make_packed_predictor(**kwargs)
    assert model.encoder.readout_0.set2set.dense_n_max == 64  # the JAX evaluator's


def _toy_csv(path, n=96):
    """Label 1 when both molecules hold an oxygen."""
    oxy = ["CCO", "CC(=O)O", "OCCO", "C=O", "COC"]
    nox = ["CC", "CCC", "c1ccccc1", "CCN"]
    rng = np.random.default_rng(7)
    rows = []
    for i in range(n):
        if rng.random() < 0.5:
            rows.append([i, i, rng.choice(oxy), rng.choice(oxy), 1])
        else:
            rows.append([i, i, rng.choice(nox),
                         rng.choice(oxy if rng.random() < 0.5 else nox), 0])
    pd.DataFrame(rows, columns=["drugbank_id_1", "drugbank_id_2", "smiles_1",
                                "smiles_2", "label"]).to_csv(path, index=False)


def test_train_cli_trains_mpnn_and_its_params_serve(tmp_path, capsys):
    data = tmp_path / "toy.csv"
    _toy_csv(data)
    out = tmp_path / "run"
    rc = train_cli.main([
        "--train", str(data), "--val", str(data), "--method", "mpnn",
        "--fp-hidden-dim", "8", "--fp-out-dim", "8", "--conv-layers", "2",
        "--weight-tying", "true", "--batch-size", "16", "--lr", "5e-3",
        "--compute-path", "coo", "--compute-dtype", "bfloat16",
        "--epochs", "3", "--patience", "100", "--device", "cpu",
        "--out", str(out)])
    assert rc == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    log = json.loads((out / "log.json").read_text())
    assert final == log[-1] and len(log) == 3
    losses = [e["main/loss"] for e in log]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert np.isfinite(log[-1]["val/loss"]) and np.isfinite(log[-1]["val/roc_auc"])
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["method"] == "mpnn" and cfg["compute_path"] == "coo"
    rc = predict.main(["--input", str(data), "--config", str(out / "config.json"),
                       "--params", str(out / "final" / "params.npz"),
                       "--out", str(tmp_path / "preds.csv"), "--device", "cpu"])
    assert rc == 0
    probs = pd.read_csv(tmp_path / "preds.csv")["prob"].to_numpy()
    assert len(probs) == 96 and np.all((probs >= 0) & (probs <= 1))


def test_trainer_fits_the_set2set_table_to_its_data():
    ds = _dataset(16)
    cfg = TrainConfig(**dict(QUALITY_ROW, fp_hidden_dim=8, fp_out_dim=8,
                             conv_layers=2, batch_size=8))
    trainer = loop.Trainer(cfg, ds, _dataset(8), device="cpu")
    n_max = trainer.model.encoder.readout_0.set2set.dense_n_max
    assert n_max == max_atoms_lane_rounded([ds]) and n_max < 64


def test_predict_cli_matches_jax_evaluator(tmp_path):
    cfg = JaxTrainConfig(method="mpnn", sim_method="hole", conv_layers=2,
                         fp_hidden_dim=8, fp_out_dim=8, weight_tying=False,
                         compute_path="coo")
    kwargs = predict.model_kwargs_from_config(json.loads(cfg.to_json()))
    tree = init_params(kwargs, seed=13)
    want = JaxEvaluator(cfg, tree, batch_size=12).evaluate(_dataset(24))
    (tmp_path / "config.json").write_text(cfg.to_json())
    save_params_npz(str(tmp_path / "params.npz"), tree)
    pd.read_csv(SAMPLE).head(24).to_csv(tmp_path / "in.csv", index=False)
    rc = predict.main([
        "--input", str(tmp_path / "in.csv"), "--out", str(tmp_path / "out.csv"),
        "--config", str(tmp_path / "config.json"),
        "--params", str(tmp_path / "params.npz"),
        "--batch-size", "12", "--device", "cpu"])
    assert rc == 0
    probs = pd.read_csv(tmp_path / "out.csv")["prob"].to_numpy()
    np.testing.assert_allclose(probs, 1.0 / (1.0 + np.exp(-want.logits)),
                               rtol=OUT_RTOL, atol=OUT_ATOL)
    back = load_params_npz(str(tmp_path / "params.npz"))
    _assert_trees_close(back, tree, rtol=0, atol=0)
