"""Training on the ``packed`` compute path against the JAX package on the
CPU.  The port trains ``packed`` on its wire-compact COO predictor, the
adjacency built on the device; the JAX trainer on dense batches built on
the host:

- two train steps per method (GGNN, MPNN, RelGCN, GIN, NFP, GGNN with
  the ``gru`` aggregator, GGNN-GWM): the port's steps on its compact
  batches against the JAX packed train steps (``make_packed_train_step``,
  ``make_packed_gwm_train_step``) on the dense batches of the same pairs,
  from the same weights: each loss within 1e-5.  The readout
  width is 32, where both packages compute HolE's circular correlation
  by FFT: at D <= 16 the JAX package takes a time-domain product instead
  (not ported, ROADMAP "Out of scope"), which gives a pair whose
  embedding is all zero (GWM's final ReLU) exact zeros where the FFT
  gives 1e-7, and Adam's first step turns such a gradient element of
  ~1e-7 into a move of the full learning rate;
- the train CLI on ``packed`` for the kernel encoders, and a snapshot
  restored into a fresh ``Trainer`` bit for bit.

The batches and predictors: tests/test_torch_packed_path.py."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.data.packing import (
    pack_pair_dataset_batch as jpack_pair_dataset_batch)
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.train import loop as jloop
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu_torch.cli import predict
from gcnbmp_tpu_torch.cli import train as train_cli
from gcnbmp_tpu_torch.convert import from_jax_params, init_params
from gcnbmp_tpu_torch.data import CSVPairParser
from gcnbmp_tpu_torch.data.packing import (
    attach_supers_coo, pack_pair_dataset_coo)
from gcnbmp_tpu_torch.models import packed as tpacked
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.checkpoints import restore_checkpoint
from gcnbmp_tpu_torch.train.config import TrainConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_train.csv")
ATOL = RTOL = 1e-5
STEPS = [
    ("ggnn", dict(method="ggnn")),
    ("mpnn", dict(method="mpnn")),
    ("relgcn", dict(method="relgcn")),
    ("gin-untied", dict(method="gin", weight_tying=False)),
    ("nfp", dict(method="nfp")),
    ("ggnn-gru", dict(method="ggnn", weight_tying=False,
                      layer_aggregator="gru")),
    ("ggnn-gwm", dict(method="ggnn-gwm", weight_tying=False)),
]


def _dataset(n, skip=0):
    df = pd.read_csv(PAIRS).iloc[skip:skip + n]
    return CSVPairParser().parse(df).dataset


@pytest.mark.parametrize("name,kw", STEPS, ids=[s[0] for s in STEPS])
def test_two_packed_train_steps_match_the_jax_steps(name, kw):
    jcfg = JaxTrainConfig(**kw, fp_hidden_dim=8, fp_out_dim=32, conv_layers=2,
                          compute_path="packed", learning_rate=1e-2,
                          batch_size=8)
    kwargs = tpacked.model_kwargs_from_config(json.loads(jcfg.to_json()))
    tree = init_params(kwargs, seed=8)
    tx, _ = jloop.build_optimizer(jcfg, 1)
    jpred = jpacked.make_packed_predictor(**kwargs)
    gwm = kw["method"] == "ggnn-gwm"
    step = (jloop.make_packed_gwm_train_step if gwm
            else jloop.make_packed_train_step)(jpred, tx)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(params)
    model = from_jax_params(tree, tpacked.make_packed_predictor(**kwargs))
    opt, _ = loop.build_optimizer(TrainConfig(**json.loads(jcfg.to_json())),
                                  1, list(model.parameters()))
    got, want = [], []
    for i in range(2):
        ds, idx = _dataset(8, skip=8 * i), list(range(8))
        jbatch = jpack_pair_dataset_batch(
            ds, idx, supernode_fn=model.supernode_fn if gwm else None)
        jwire = (jbatch.atom_ids, jbatch.adj) \
            + ((jbatch.supers,) if gwm else ()) \
            + (jbatch.mol_id, jbatch.node_mask, jbatch.left_index,
               jbatch.right_index)
        labels = np.asarray(jbatch.labels, np.float32)
        params, opt_state, loss, _ = step(
            params, opt_state, *(jnp.asarray(a) for a in jwire),
            jnp.asarray(labels))
        want.append(float(loss))
        batch = pack_pair_dataset_coo(ds, idx)
        if gwm:
            batch = attach_supers_coo(batch, ds, idx, model.supernode_fn)
        wire = model.wire_encoder([ds])(batch)
        got.append(float(loop.train_step(
            model, opt, [torch.as_tensor(np.asarray(a)) for a in wire],
            torch.as_tensor(labels))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


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


@pytest.mark.parametrize("method", ["ggnn", "mpnn", "relgcn"])
def test_train_cli_on_packed_serves_and_resumes(tmp_path, method):
    data, out = str(tmp_path / "toy.csv"), tmp_path / "run"
    _toy_csv(data)
    flags = ["--train", data, "--val", data, "--method", method,
             "--fp-hidden-dim", "8", "--fp-out-dim", "8", "--conv-layers", "2",
             "--batch-size", "16", "--lr", "5e-3", "--compute-path", "packed",
             "--scan-steps", "2", "--debug-checks", "--patience", "100",
             "--device", "cpu", "--out", str(out)]
    assert train_cli.main(flags + ["--epochs", "4"]) == 0
    log = json.loads((out / "log.json").read_text())
    losses = [e["main/loss"] for e in log]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(np.isfinite(e["val/roc_auc"]) for e in log)
    assert predict.main(["--input", data, "--run", str(out), "--checkpoint",
                         "final", "--out", str(tmp_path / "p.csv"),
                         "--device", "cpu"]) == 0
    assert np.all(np.isfinite(pd.read_csv(tmp_path / "p.csv")["prob"]))
    # the packed run trains the compact-COO predictor, and its snapshot
    # restores into a fresh trainer bit for bit
    cfg = TrainConfig.from_json((out / "config.json").read_text())
    trainer = loop.Trainer(cfg, CSVPairParser().parse(data).dataset,
                           device="cpu")
    assert isinstance(trainer.model, tpacked.PackedPairPredictorCOOCompact)
    state = loop.TrainState(trainer.model, trainer.optimizer, 0, 0,
                            float("inf"), 0)
    restore_checkpoint(str(out / "snapshot_epoch_4"), state)
    assert state.epoch == 4 and state.step == 4 * 4
    with np.load(out / "snapshot_epoch_4" / "params.npz") as z:
        for name, p in trainer.model.named_parameters():
            key = name.replace(".", "/")
            want = z[key[:-len("weight")] + "kernel"].T \
                if key.endswith("/weight") else z[key]
            assert np.array_equal(p.detach().numpy(), want), name
