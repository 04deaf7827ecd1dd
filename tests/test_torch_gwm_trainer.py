"""The port's ``Trainer`` on GGNN-GWM against the JAX ``Trainer`` on the
CPU, from the same initial parameters: the JAX trainer draws them with
``jax.random``, the port's ``convert.init_params`` from numpy's
generator, so a seed gives each package other weights.  GWM's quality
depends on that draw (the scale of the first logits), so the test loads
the JAX trainer's initial tree into the port's model and holds every
epoch's train loss, val loss and val AUROC against the JAX trainer's
log: the batches, their order, the steps and the evaluation agree."""

import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.data.parsers import CSVPairParser as JaxParser
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu.train.loop import Trainer as JaxTrainer
from gcnbmp_tpu_torch.convert import from_jax_params, init_params
from gcnbmp_tpu_torch.data import CSVPairParser
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.config import TrainConfig

torch.set_num_threads(1)

PAIRS = "dataset/synth546/drug/ddi_drug_{}.csv"
TOL = 1e-4  # epoch means over steps whose f32 sums run in another order


@pytest.mark.parametrize("layout", ["coo", "packed"])
def test_trainer_from_the_jax_initial_tree_follows_the_jax_trainer(
        tmp_path, layout):
    import jax

    train = pd.read_csv(PAIRS.format("train")).head(192)
    val = pd.read_csv(PAIRS.format("valid")).head(64)
    kw = dict(method="ggnn-gwm", conv_layers=2, fp_hidden_dim=8,
              fp_out_dim=32, compute_path=layout, batch_size=64,
              learning_rate=2e-3, epochs=3, early_stop_patience=100,
              augment=True, eval_train=False, seed=0, prefetch=0,
              plot_reports=False)
    jtrainer = JaxTrainer(JaxTrainConfig(**kw, out_dir=str(tmp_path / "j")),
                          JaxParser().parse(train).dataset,
                          JaxParser().parse(val).dataset)
    tree = jax.tree_util.tree_map(np.asarray, jtrainer._init_state().params)
    want = jtrainer.fit()["log"]
    trainer = loop.Trainer(TrainConfig(**kw, out_dir=str(tmp_path / "t")),
                           CSVPairParser().parse(train).dataset,
                           CSVPairParser().parse(val).dataset, device="cpu")
    from_jax_params(tree, trainer.model)
    got = trainer.fit()["log"]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("main/loss", "val/loss", "val/roc_auc", "val/prc_auc"):
            np.testing.assert_allclose(g[key], w[key], rtol=TOL, atol=TOL,
                                       err_msg=f"epoch {w['epoch']} {key}")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_init_draws_match_the_jax_trainer_in_distribution(tmp_path):
    """At the GWM quality row's widths (L=4 tied, H=D=32, HolE), the port's
    ``init_params`` over seeds 0-7 against the JAX trainer's initial tree
    (``jax.random``, the padded predictor's ``init``) over the same seeds:
    per parameter, pooled over the seeds, the same mean and spread within
    four standard errors, and zero biases.  The initial logit scale on 256
    pairs depends on the draw far more than on the package, so it is
    printed (``-s``) and held only loosely: each package's median within
    a factor of 2 of the other's."""
    import dataclasses

    import jax

    from gcnbmp_tpu_torch.data.packing import (
        attach_supers_coo, pack_pair_dataset_coo)
    from gcnbmp_tpu_torch.models import packed as tpacked

    seeds = range(8)
    df = pd.read_csv(PAIRS.format("train")).head(256)
    cfg = dict(method="ggnn-gwm", fp_hidden_dim=32, fp_out_dim=32,
               conv_layers=4, weight_tying=True, sim_method="hole")
    jtrainer = JaxTrainer(JaxTrainConfig(**cfg, seed=0, plot_reports=False,
                                         out_dir=str(tmp_path)),
                          JaxParser().parse(df.head(8)).dataset)
    model = tpacked.make_packed_predictor(**cfg)
    ds = CSVPairParser().parse(df).dataset
    idx = list(range(len(ds)))
    batch = attach_supers_coo(pack_pair_dataset_coo(ds, idx), ds, idx,
                              model.supernode_fn)
    wire = [torch.as_tensor(np.asarray(a))
            for a in model.wire_encoder([ds])(batch)]
    labels = torch.as_tensor(batch.labels)
    draws = {"port": [], "jax": []}
    scale = {"port": [], "jax": []}
    for seed in seeds:
        jtrainer.config = dataclasses.replace(jtrainer.config, seed=seed)
        for name, tree in (
                ("port", init_params(cfg, seed)),
                ("jax", jax.tree_util.tree_map(
                    np.asarray, jtrainer._init_state().params))):
            draws[name].append(_flat(tree))
            from_jax_params(tree, model)
            with torch.no_grad():
                logits = model(*wire)
            loss = loop.sigmoid_cross_entropy(logits, labels)
            scale[name].append((float(logits.std()), float(loss)))
    assert sorted(draws["port"][0]) == sorted(draws["jax"][0])
    for key in draws["jax"][0]:
        got = np.concatenate([d[key].ravel() for d in draws["port"]])
        want = np.concatenate([d[key].ravel() for d in draws["jax"]])
        if key.endswith("/bias"):
            assert not got.any() and not want.any(), key
            continue
        se = want.std() / np.sqrt(want.size)
        assert abs(got.mean() - want.mean()) <= 4 * np.sqrt(2) * se, key
        assert abs(got.std() / want.std() - 1) <= 4 / np.sqrt(want.size), key
    for name in scale:
        print(f"{name} initial logit std / loss over seeds 0-7: "
              + ", ".join(f"{s:.3f}/{v:.4f}" for s, v in scale[name]))
    med = {n: np.median([s for s, _ in scale[n]]) for n in scale}
    assert 0.5 <= med["port"] / med["jax"] <= 2.0, med
