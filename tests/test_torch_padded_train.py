"""Training and scoring on the padded layout against the JAX package on
the CPU:

- three padded train steps (``train_step`` with the padded predictor,
  ``deterministic=False``) against the JAX ``make_train_step`` at dropout
  0, from the same weights on the same batches, for the flagship GGNN
  (untied, HolE), GGNN-GWM and ``siamese=False`` with ``symmetric``: each
  loss within 1e-5.  The readout width is 32, where both packages compute
  HolE by FFT (tests/test_torch_packed_train.py says why);
- dropout in the trainer: two runs of two steps from the same seed give
  the same bits, and dropout moves the loss;
- batch normalization: the JAX padded step raises
  ``ScopeCollectionNotFound`` and the port refuses it by name;
- the train CLI with ``--preset ggnn_hole_binary`` and no
  ``--compute-path`` (the padded default), the evaluate and predict CLIs
  on its run against the JAX ``evaluate_dataset`` on the same params
  (probs, AUROC and AUPRC within 1e-5); the options of the padded layout
  through the train CLI's flags; a padded snapshot restored bit for bit."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.data.dataset import make_batch as jmake_batch
from gcnbmp_tpu.data.parsers import CSVPairParser as JCSVPairParser
from gcnbmp_tpu.eval import evaluate as jeval
from gcnbmp_tpu.models import gwm as jgwm
from gcnbmp_tpu.models import set_up_predictor as jset_up_predictor
from gcnbmp_tpu.train import loop as jloop
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli
from gcnbmp_tpu_torch.cli import predict
from gcnbmp_tpu_torch.cli import train as train_cli
from gcnbmp_tpu_torch.convert import from_jax_params, init_params, load_params_npz
from gcnbmp_tpu_torch.data import CSVPairParser
from gcnbmp_tpu_torch.data.dataset import make_batch, padded_args
from gcnbmp_tpu_torch.models.predictor import (
    PairPredictor, padded_kwargs_from_config, set_up_predictor)
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.checkpoints import restore_checkpoint
from gcnbmp_tpu_torch.train.config import TrainConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_train.csv")
SAMPLE = os.path.join(ROOT, "dataset", "sample", "sample200.csv")
ATOL = RTOL = 1e-5
STEPS = [
    ("flagship", dict(method="ggnn", weight_tying=False)),
    ("gwm", dict(method="ggnn-gwm")),
    ("not-siamese-symmetric", dict(method="ggnn", siamese=False,
                                   symmetric="or")),
]


def _dataset(n, skip=0, parser=CSVPairParser):
    df = pd.read_csv(PAIRS).iloc[skip:skip + n]
    return parser().parse(df).dataset


@pytest.mark.parametrize("name,kw", STEPS, ids=[s[0] for s in STEPS])
def test_three_padded_train_steps_match_the_jax_steps(name, kw):
    jcfg = JaxTrainConfig(**kw, fp_hidden_dim=8, fp_out_dim=32, conv_layers=2,
                          learning_rate=1e-2, batch_size=8)
    kwargs = padded_kwargs_from_config(json.loads(jcfg.to_json()))
    tree = init_params(kwargs, seed=8, padded=True)
    gwm = kw["method"] == "ggnn-gwm"
    tx, _ = jloop.build_optimizer(jcfg, 1)
    step = jloop.make_train_step(jset_up_predictor(**kwargs), tx,
                                 uses_supernodes=gwm)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(params)
    model = from_jax_params(tree, set_up_predictor(**kwargs))
    opt, _ = loop.build_optimizer(TrainConfig(**json.loads(jcfg.to_json())),
                                  1, list(model.parameters()))
    gen = torch.Generator().manual_seed(1)
    got, want = [], []
    for i in range(3):
        jds = _dataset(8, 8 * i, JCSVPairParser)
        jb = jmake_batch(jds, list(range(8)), pad_to=24, supernode_fn=(
            jgwm.default_supernode_fn() if gwm else None))
        supers = (jnp.asarray(jb.super1), jnp.asarray(jb.super2)) if gwm else ()
        params, opt_state, loss, _ = step(
            params, opt_state, *(jnp.asarray(getattr(jb, n)) for n in (
                "atoms1", "adj1", "atoms2", "adj2", "mask1", "mask2")),
            supers, jnp.asarray(jb.labels), jax.random.PRNGKey(i))
        want.append(float(loss))
        batch = make_batch(_dataset(8, 8 * i), list(range(8)), pad_to=24,
                           supernode_fn=getattr(model, "supernode_fn", None))
        args, kwargs_t, labels = padded_args(batch, "cpu", gwm)
        got.append(float(loop.train_step(
            model, opt, args, labels, deterministic=False, generator=gen,
            **kwargs_t)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_trainer_dropout_draws_from_its_seeded_generator():
    ds = _dataset(32)
    runs = []
    for rate in (0.3, 0.3, 0.0):
        cfg = TrainConfig(fp_hidden_dim=8, fp_out_dim=8, conv_layers=2,
                          fp_dropout_rate=rate, batch_size=16, seed=3)
        trainer = loop.Trainer(cfg, ds, device="cpu")
        state = loop.TrainState(trainer.model, trainer.optimizer, 0, 0,
                                float("inf"), 0)
        losses = []
        trainer._padded_epoch(0, state, losses)
        runs.append(torch.stack(losses))
        assert state.step == 2
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], runs[2])


def test_batch_normalization_is_the_jax_fault_and_refused():
    from flax.errors import ScopeCollectionNotFound

    jcfg = JaxTrainConfig(fp_hidden_dim=8, fp_out_dim=8, conv_layers=1,
                          fp_batch_normalization=True, batch_size=4)
    ds = _dataset(4, parser=JCSVPairParser)
    trainer = jloop.Trainer(jcfg, ds)
    state = trainer._init_state()
    tx, _ = jloop.build_optimizer(jcfg, 1)
    step = jloop.make_train_step(trainer.predictor, tx)
    jb = jmake_batch(ds, list(range(4)), pad_to=trainer.pad_to)
    with pytest.raises(ScopeCollectionNotFound, match="batch_stats"):
        step(state.params, tx.init(state.params),
             *(jnp.asarray(getattr(jb, n)) for n in (
                 "atoms1", "adj1", "atoms2", "adj2", "mask1", "mask2")),
             (), jnp.asarray(jb.labels), jax.random.PRNGKey(0))
    cfg = TrainConfig(fp_hidden_dim=8, fp_out_dim=8, conv_layers=1,
                      fp_batch_normalization=True)
    for path in loop.LAYOUTS:
        problems = loop.config_problems(
            dataclasses.replace(cfg, compute_path=path))
        assert any("ScopeCollectionNotFound" in p for p in problems), path
    with pytest.raises(ValueError, match="ScopeCollectionNotFound"):
        loop.Trainer(cfg, _dataset(4), device="cpu")


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


def test_flagship_preset_trains_padded_by_default_and_scores_as_jax(
        tmp_path, capsys):
    data, out = str(tmp_path / "toy.csv"), tmp_path / "run"
    _toy_csv(data)
    assert train_cli.main([
        "--train", data, "--val", data, "--preset", "ggnn_hole_binary",
        "--epochs", "2", "--patience", "100", "--lr", "5e-3",
        "--device", "cpu", "--out", str(out)]) == 0
    config = json.loads((out / "config.json").read_text())
    assert config["compute_path"] == "padded"
    log = json.loads((out / "log.json").read_text())
    assert len(log) == 2 and all(np.isfinite(e["main/loss"])
                                 and np.isfinite(e["val/roc_auc"])
                                 for e in log)
    # scored as the JAX evaluate CLI scores a padded run
    sample = tmp_path / "sample_unique.csv"
    pd.read_csv(SAMPLE).drop_duplicates(["smiles_1", "smiles_2"]).to_csv(
        sample, index=False)
    ev = tmp_path / "eval"
    assert evaluate_cli.main(["--test", str(sample), "--run", str(out),
                              "--batch-size", "64", "--out", str(ev),
                              "--device", "cpu"]) == 0
    assert predict.main(["--input", str(sample), "--run", str(out),
                         "--out", str(tmp_path / "p.csv"), "--batch-size",
                         "64", "--device", "cpu"]) == 0
    capsys.readouterr()
    jcfg = JaxTrainConfig.from_json((out / "config.json").read_text())
    tree = load_params_npz(str(out / "best" / "params.npz"))
    want = jeval.evaluate_dataset(
        jset_up_predictor(**padded_kwargs_from_config(config)),
        jax.tree_util.tree_map(jnp.asarray, tree),
        JCSVPairParser().parse(str(sample)).dataset, batch_size=64,
        train_cfg=jcfg)
    want_p = 1.0 / (1.0 + np.exp(-want.logits.astype(np.float64)))
    exported = pd.read_csv(ev / "sample_unique_e_y.csv")["y"].to_numpy()
    served = pd.read_csv(tmp_path / "p.csv")["prob"].to_numpy()
    np.testing.assert_allclose(exported, want_p, rtol=0, atol=1e-5)
    np.testing.assert_allclose(served, want_p, rtol=0, atol=1e-5)
    got = json.loads((ev / "eval_result.json").read_text())
    for key in ("roc_auc", "prc_auc"):
        assert abs(got[key] - want.metrics[key]) <= 1e-5, key


@pytest.mark.parametrize("flags", [
    ["--symmetric", "or"], ["--dropout", "0.1"], ["--concat-hidden"],
    ["--attn", "para", "--sim-method", "ntn"],
    ["--method", "ggnn-gwm", "--dropout", "0.1"],
    ["--method", "mpnn", "--attn", "alter"]],
    ids=["symmetric", "dropout", "concat-hidden", "para-ntn", "gwm-dropout",
         "mpnn-alter"])
def test_padded_options_train_through_the_cli(tmp_path, flags):
    data, out = str(tmp_path / "toy.csv"), tmp_path / "run"
    _toy_csv(data)
    assert train_cli.main([
        "--train", data, "--val", data, "--fp-hidden-dim", "8",
        "--fp-out-dim", "8", "--conv-layers", "2", "--batch-size", "16",
        "--lr", "5e-3", *flags, "--compute-path", "padded", "--epochs", "3",
        "--patience", "100", "--device", "cpu", "--out", str(out)]) == 0
    losses = [e["main/loss"] for e in json.loads(
        (out / "log.json").read_text())]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert predict.main(["--input", data, "--run", str(out), "--checkpoint",
                         "final", "--out", str(tmp_path / "p.csv"),
                         "--device", "cpu"]) == 0
    assert np.all(np.isfinite(pd.read_csv(tmp_path / "p.csv")["prob"]))


def test_padded_snapshot_restores_bit_for_bit(tmp_path):
    data, out = str(tmp_path / "toy.csv"), tmp_path / "run"
    _toy_csv(data)
    assert train_cli.main([
        "--train", data, "--fp-hidden-dim", "8", "--fp-out-dim", "8",
        "--conv-layers", "2", "--batch-size", "16", "--epochs", "2",
        "--dropout", "0.2", "--device", "cpu", "--out", str(out)]) == 0
    cfg = TrainConfig.from_json((out / "config.json").read_text())
    trainer = loop.Trainer(cfg, CSVPairParser().parse(data).dataset,
                           device="cpu")
    assert isinstance(trainer.model, PairPredictor)
    state = loop.TrainState(trainer.model, trainer.optimizer, 0, 0,
                            float("inf"), 0)
    restore_checkpoint(str(out / "snapshot_epoch_2"), state)
    assert state.epoch == 2 and state.step == 2 * 4
    with np.load(out / "snapshot_epoch_2" / "params.npz") as z:
        for name, p in trainer.model.named_parameters():
            key = name.replace(".", "/")
            want = z[key[:-len("weight")] + "kernel"].T \
                if key.endswith("/weight") else z[key]
            assert np.array_equal(p.detach().numpy(), want), name
