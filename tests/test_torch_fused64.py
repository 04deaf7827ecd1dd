"""The ``ref_scale_fused64`` slice at a small depth on the CPU: the train
CLI with the row's widths and path (``--fp-hidden-dim 64 --fp-out-dim 64
--compute-path fused``, scan mode), at L=2 and ``--scan-steps 2``, against
the JAX ``Trainer`` on the same flags (its fused kernels in interpret
mode) from the same initial tree, in each of the port's three kernel
forms (K2/K2b, K1 + the plain readout with K1b, K1m with K3 twice).  On
the CPU the wrappers run their plain versions; the H=64 kernel bodies
themselves are held against those in tests/test_torch_fwd_emulated64.py,
tests/test_torch_bwd_emulated64{,_k3,_k2b}.py and on the card (chip_smoke.py
phases 3a and 19)."""

import json

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcnbmp_tpu.data.parsers import CSVPairParser as JaxParser
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu.train.loop import Trainer as JaxTrainer
from gcnbmp_tpu_torch import convert
from gcnbmp_tpu_torch.cli import train as train_cli
from gcnbmp_tpu_torch.models import packed as tpacked
from gcnbmp_tpu_torch.ops import fused_ggnn as tfg

torch.set_num_threads(1)

PAIRS = "dataset/synth546/drug/ddi_drug_{}.csv"
TOL = 1e-4  # epoch means over steps whose f32 sums run in another order
# the row's flags (scripts/quality_battery_r3.sh:33-44) cut to L=2, scan 2,
# batch 16 and 2 epochs: 32 train pairs, 64 with augmentation, 4 steps of
# 16 per epoch in 2 chunks of 2
FLAGS = ["--method", "ggnn", "--conv-layers", "2", "--fp-hidden-dim", "64",
         "--fp-out-dim", "64", "--weight-tying", "false", "--compute-path",
         "fused", "--scan-steps", "2", "--batch-size", "16", "--lr", "2e-3",
         "--epochs", "2", "--patience", "10", "--augment", "--no-eval-train",
         "--seed", "0"]
JAX_CONFIG = dict(method="ggnn", conv_layers=2, fp_hidden_dim=64,
                  fp_out_dim=64, weight_tying=False, compute_path="fused",
                  scan_steps=2, batch_size=16, learning_rate=2e-3, epochs=2,
                  early_stop_patience=10, augment=True, eval_train=False,
                  seed=0, plot_reports=False)
# form -> (FUSED_READOUT, TWOPASS, the autograd function whose backward runs)
FORMS = {"K2/K2b": (True, False, tfg.FusedGGNNReadoutFunction),
         "K1/K1b": (False, False, tfg.FusedGGNNFunction),
         "K1m/K3": (False, True, tfg.FusedGGNNFunction)}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The CSVs, the JAX trainer's initial tree and its epoch log."""
    tmp = tmp_path_factory.mktemp("fused64")
    train = pd.read_csv(PAIRS.format("train")).head(32)
    val = pd.read_csv(PAIRS.format("valid")).head(32)
    train.to_csv(tmp / "train.csv", index=False)
    val.to_csv(tmp / "val.csv", index=False)
    jtrainer = JaxTrainer(JaxTrainConfig(**JAX_CONFIG, out_dir=str(tmp / "j")),
                          JaxParser().parse(train).dataset,
                          JaxParser().parse(val).dataset)
    tree = jax.tree_util.tree_map(np.asarray, jtrainer._init_state().params)
    with pltpu.force_tpu_interpret_mode():
        log = jtrainer.fit()["log"]
    return tmp, tree, log


@pytest.mark.parametrize("form", list(FORMS))
def test_train_cli_at_h64_follows_the_jax_trainer(jax_run, tmp_path,
                                                  monkeypatch, form):
    tmp, tree, want = jax_run
    fused_readout, twopass, fn = FORMS[form]
    monkeypatch.setattr(tpacked, "FUSED_READOUT", fused_readout)
    monkeypatch.setattr(tfg, "TWOPASS", twopass)
    # the port's trainer draws its initial weights through convert.init_params
    monkeypatch.setattr(convert, "init_params", lambda cfg, seed, **kw: tree)
    assert tpacked.fused_form(64, 64).startswith(form)
    calls = fn.backward_calls
    out = tmp_path / "run"
    assert train_cli.main(["--train", str(tmp / "train.csv"), "--val",
                           str(tmp / "val.csv"), *FLAGS, "--device", "cpu",
                           "--out", str(out)]) == 0
    assert fn.backward_calls == calls + 8  # one backward per step
    got = json.loads((out / "log.json").read_text())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in ("main/loss", "val/loss", "val/roc_auc"):
            np.testing.assert_allclose(g[key], w[key], rtol=TOL, atol=TOL,
                                       err_msg=f"{form} epoch {w['epoch']} {key}")
    cfg = json.loads((out / "config.json").read_text())
    assert (cfg["fp_hidden_dim"], cfg["fp_out_dim"], cfg["scan_steps"],
            cfg["compute_path"]) == (64, 64, 2, "fused")
