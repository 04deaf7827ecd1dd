"""The port's training slice against the JAX package on the CPU: the
predictor's loss and gradients against ``jax.grad`` of the fused train
path, the losses, schedules and optimizer chain against optax, the
metrics against the scikit-learn ones, the autograd plumbing of the
fused kernels, and the train CLI end to end."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcnbmp_tpu.data.packing import pack_pair_dataset_coo
from gcnbmp_tpu.data.parsers import CSVPairParser
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.train import loop as jloop
from gcnbmp_tpu.train import metrics as jmetrics
from gcnbmp_tpu.train import schedules as jsched
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu_torch.cli import predict
from gcnbmp_tpu_torch.cli import train as train_cli
from gcnbmp_tpu_torch.convert import (
    from_jax_params, init_params, load_params_npz, named_to_tree, to_jax_params)
from gcnbmp_tpu_torch.data.wire import compact_coo_arrays, packed_coo_batch_iterator
from gcnbmp_tpu_torch.eval.evaluate import PackedPairEvaluator
from gcnbmp_tpu_torch.models.packed import make_packed_predictor
from gcnbmp_tpu_torch.ops import fused_ggnn as tfg
from gcnbmp_tpu_torch.train import loop, metrics, schedules
from gcnbmp_tpu_torch.train.config import PRESETS, TrainConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "dataset", "sample", "sample200.csv")
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5  # the JAX suite's gradient bound
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7


def _dataset(n):
    return CSVPairParser().parse(pd.read_csv(SAMPLE).head(n)).dataset


def _cfg(layers, hidden, tied):
    return dict(fp_hidden_dim=hidden, fp_out_dim=hidden, conv_layers=layers,
                weight_tying=tied)


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# the fault: gradients must reach every parameter through the kernel path


def test_every_parameter_gets_a_gradient_through_the_fused_backward():
    cfg = _cfg(3, 16, False)
    batch = pack_pair_dataset_coo(_dataset(8), list(range(8)))
    model = from_jax_params(init_params(cfg, seed=1), make_packed_predictor(**cfg))
    before = tfg.FusedGGNNReadoutFunction.backward_calls
    logits = model(*(torch.as_tensor(np.asarray(a))
                     for a in compact_coo_arrays(batch)))
    loss = loop.sigmoid_cross_entropy(logits, torch.as_tensor(batch.labels))
    loss.backward()
    assert tfg.FusedGGNNReadoutFunction.backward_calls == before + 1
    names = [n for n, _ in model.named_parameters()]
    for required in ("encoder.embed.embedding", "encoder.gru.W_z.weight",
                     "encoder.readout_0.i.dense.weight"):
        assert required in names
    assert [f"encoder.update_{l}.message.dense.weight" in names
            for l in range(3)] == [True] * 3
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert float(p.grad.abs().sum()) > 0, name


@pytest.mark.parametrize("layers,hidden,tied", [(3, 16, True), (3, 16, False),
                                                (2, 32, False)])
def test_predictor_loss_and_grads_match_jax_fused(layers, hidden, tied):
    cfg = _cfg(layers, hidden, tied)
    batch = pack_pair_dataset_coo(_dataset(12), list(range(12)))
    wire = compact_coo_arrays(batch)
    labels = np.asarray(batch.labels, np.float32)
    tree = init_params(cfg, seed=layers + hidden)
    pred = jpacked.make_packed_predictor(**cfg, coo=True, compact=True)

    def jloss(params):
        logits = jpacked.fused_compact_logits(
            pred, params, *(jnp.asarray(a) for a in wire))
        return jloop.sigmoid_cross_entropy(logits, jnp.asarray(labels))

    with pltpu.force_tpu_interpret_mode():
        want_loss, want = jax.value_and_grad(jloss)(tree)
    model = from_jax_params(tree, make_packed_predictor(**cfg))
    loss = loop.sigmoid_cross_entropy(
        model(*(torch.as_tensor(np.asarray(a)) for a in wire)),
        torch.as_tensor(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    got = _flat_tree(named_to_tree({n: p.grad for n, p in model.named_parameters()}))
    want = _flat_tree(want)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=key)


def test_to_jax_params_inverts_from_jax_params():
    cfg = _cfg(2, 16, False)
    tree = init_params(cfg, seed=4)
    back = to_jax_params(from_jax_params(tree, make_packed_predictor(**cfg)))
    a, b = _flat_tree(tree), _flat_tree(back)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# losses, schedules and the optimizer against optax


@pytest.mark.parametrize("name,kwargs", [("sigmoid_ce", {}), ("hinge", {}),
                                         ("focal", {"gamma": 2.0, "alpha": 0.25}),
                                         ("focal", {"gamma": 1.5, "alpha": 0.75})])
@pytest.mark.parametrize("shape", [(16,), (8, 5)])
def test_losses_match_jax(name, kwargs, shape):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    labels = rng.integers(-1, 2, shape).astype(np.float32)  # -1 ignored
    want = jloop.make_loss(name, **kwargs)(jnp.asarray(logits), jnp.asarray(labels))
    got = loop.make_loss(name, **kwargs)(torch.as_tensor(logits),
                                         torch.as_tensor(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # all labels ignored: the denominator is max(#valid, 1)
    none = np.full(shape, -1.0, np.float32)
    assert float(loop.make_loss(name, **kwargs)(
        torch.as_tensor(logits), torch.as_tensor(none))) == 0.0


@pytest.mark.parametrize("clr", [None, "triangular", "triangular2", "exp_range"])
def test_schedules_match_jax(clr):
    if clr is None:
        want = jsched.exponential_shift_schedule(1e-3, (10, 20, 30), 7, rate=0.5)
        got = schedules.exponential_shift_schedule(1e-3, (10, 20, 30), 7, rate=0.5)
    else:
        want = jsched.cyclical_schedule(1e-3, 6e-3, 50, mode=clr, gamma=0.999)
        got = schedules.cyclical_schedule(1e-3, 6e-3, 50, mode=clr, gamma=0.999)
    for step in list(range(0, 260, 7)) + [69, 70, 71, 139, 140, 210]:
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("grad_clip,weight_decay,lasso",
                         [(0.0, 0.0, 0.0), (2.0, 1e-2, 1e-3)])
def test_optimizer_matches_optax_on_identical_gradients(grad_clip, weight_decay,
                                                        lasso):
    cfg = JaxTrainConfig(learning_rate=1e-2, lr_shift_strategy=3,
                         grad_clip=grad_clip, weight_decay=weight_decay,
                         lasso=lasso)
    steps_per_epoch = 1  # the lr halves after step 25: the run crosses it
    tx, _ = jloop.build_optimizer(cfg, steps_per_epoch)
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (3,), "c": (2, 2, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    tparams = [torch.as_tensor(params[k]).clone() for k in sorted(shapes)]
    opt, _ = loop.build_optimizer(TrainConfig(**json.loads(cfg.to_json())),
                                  steps_per_epoch, tparams)
    for step in range(30):
        # norms above and below the clip threshold, exact zeros included
        scale = 3.0 if step % 3 == 0 else 0.1
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        grads["b"][step % 3] = 0.0
        updates, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.as_tensor(grads[k]) for k in sorted(shapes)])
        for k, t in zip(sorted(shapes), tparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[k]),
                                       rtol=OPT_RTOL, atol=OPT_ATOL,
                                       err_msg=f"{k} after step {step}")
    assert opt.count == 30


def test_presets_match_jax():
    from gcnbmp_tpu.train.config import PRESETS as JAX_PRESETS

    assert sorted(PRESETS) == sorted(JAX_PRESETS)
    for name, cfg in PRESETS.items():
        assert json.loads(cfg.to_json()) == json.loads(JAX_PRESETS[name].to_json())
    assert json.loads(TrainConfig().to_json()) == json.loads(JaxTrainConfig().to_json())


# ---------------------------------------------------------------------------
# metrics against scikit-learn


def _metric_data(seed, shape, tie_decimals=1):
    rng = np.random.default_rng(seed)
    logits = np.round(rng.standard_normal(shape) * 2, tie_decimals)  # ties
    labels = (rng.random(shape) < 0.4).astype(np.int64)
    return logits, labels


def _assert_metrics_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        if k == "per_class":
            assert got[k].keys() == want[k].keys()
            for c in want[k]:
                for m in want[k][c]:
                    np.testing.assert_allclose(got[k][c][m], want[k][c][m],
                                               rtol=1e-12, err_msg=f"{c} {m}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("seed,n,decimals", [(0, 50, 1), (1, 300, 0), (2, 7, 2)])
def test_binary_metrics_match_sklearn(seed, n, decimals):
    logits, labels = _metric_data(seed, (n,), decimals)
    _assert_metrics_equal(metrics.compute_metrics(logits, labels),
                          jmetrics.compute_metrics(logits, labels))


def test_binary_metrics_single_class_match_sklearn():
    logits = np.array([0.3, -1.0, 2.0, 0.3])
    for labels in (np.zeros(4, np.int64), np.ones(4, np.int64)):
        _assert_metrics_equal(metrics.compute_metrics(logits, labels),
                              jmetrics.compute_metrics(logits, labels))


def test_multilabel_metrics_match_sklearn():
    logits, labels = _metric_data(5, (40, 6))
    labels[:, 1] = 0   # degenerate columns: skipped by the AUCs
    labels[:, 4] = 1
    names = [f"c{i}" for i in range(6)]
    _assert_metrics_equal(
        metrics.compute_metrics(logits, labels, class_num=6, class_names=names),
        jmetrics.compute_metrics(logits, labels, class_num=6, class_names=names))


# ---------------------------------------------------------------------------
# what the port trains, the batch iterator, the CLI


# the refusals that stay once every packed-family encoder trains on coo
# and packed: the fused path for what its kernels do not compute (GWM
# included), which the JAX package refuses alike, what ROADMAP names, the
# packed layouts' refusals of the options only the padded layout has (the
# JAX reason, and the way to the padded layout) and batch normalization,
# which the JAX trainer cannot step; the padded layout itself trains
@pytest.mark.parametrize("field,value,cites", [
    pytest.param("compute_path", "padded", None,
                 id="compute_path-padded-ROADMAP queue 1, item"),
    ("method", "ggnn-gwm", "as in the JAX package"),
    ("attn", "para", "co-attention (use compute_path='coo')"),
    ("method", "gin", "as in the JAX package"),
    pytest.param("fp_batch_normalization", True, "ScopeCollectionNotFound",
                 id="fp_batch_normalization-True-ROADMAP queue 1, item"),
    ("layer_aggregator", "concat", "ROADMAP queue 2"),
    # the fused path: the JAX package's refusal (multi-device training
    # rides coo or packed; tests/test_torch_multi_device.py trains it)
    pytest.param("multi_device", True,
                 "multi_device requires compute_path 'packed' or 'coo'",
                 id="multi_device-True-ROADMAP queue 1, item"),
    pytest.param("concat_hidden", True, "use compute_path='padded'",
                 id="concat_hidden-True-ROADMAP queue 1, item"),
    pytest.param("siamese", False, "use compute_path='padded'",
                 id="siamese-False-ROADMAP queue 1, item"),
    pytest.param("fp_dropout_rate", 0.1, "use compute_path='padded'",
                 id="fp_dropout_rate-0.1-ROADMAP queue 1, item"),
    pytest.param("symmetric", "or", "use compute_path='padded'",
                 id="symmetric-or-ROADMAP queue 1, item")])
def test_config_problems_name_their_roadmap_item(field, value, cites):
    base = TrainConfig(compute_path="fused")
    assert loop.config_problems(base) == []
    cfg = TrainConfig(**{**json.loads(base.to_json()), field: value})
    problems = loop.config_problems(cfg)
    if cites is None:  # the padded layout trains the same configuration
        assert problems == []
        from gcnbmp_tpu_torch.models.predictor import PairPredictor

        trainer = loop.Trainer(cfg, _dataset(4), device="cpu")
        assert isinstance(trainer.model, PairPredictor)
        return
    assert len(problems) == 1 and field in problems[0]
    assert cites in problems[0]
    if cites == "use compute_path='padded'":
        # the JAX package's own reason for the packed layouts
        jax_cfg = JaxTrainConfig(**{**json.loads(cfg.to_json())})
        reasons = jloop.packed_config_problems(jax_cfg)
        assert len(reasons) == 1 and reasons[0] in problems[0]
    with pytest.raises(ValueError, match=field):
        loop.Trainer(cfg, _dataset(4), device="cpu")


@pytest.mark.parametrize("flags,match", [
    (["--method", "gin"], "method"), (["--compute-path", "padded"], "compute_path"),
    (["--fixed-embeddings", "emb.csv"], "fixed-embeddings"),
    (["--platform", "cpu"], "platform"), (["--resume", "x"], "resume")])
def test_train_cli_rejects_unported_options_before_any_work(tmp_path, flags,
                                                            match):
    """Unported options name their ROADMAP item (the fused path's refusal
    of GIN, the JAX package's reason); ``--platform``, a JAX-only flag
    refused for good, is refused as the evaluate CLI refuses it; a resume
    path that holds no checkpoint is named.  Both before any CSV is read.  The padded layout
    passes the checks and reads its CSV, and so does the fixed-embedding
    route (``--fixed-embeddings``, refused until the port had
    ``train.fixed``; tests/test_torch_fixed.py trains it): it reads its
    table, then its train CSV."""
    argv = ["--train", str(tmp_path / "missing.csv"), "--compute-path", "fused",
            "--device", "cpu", "--out", str(tmp_path / "run"), *flags]
    resume = flags[0] == "--resume"
    fixed = flags[0] == "--fixed-embeddings"
    if fixed:
        pd.DataFrame({"cid": ["DB00001"], "entity": ["0.5 1.5"]}).to_csv(
            tmp_path / flags[1], index=False)
        argv[argv.index(flags[1])] = str(tmp_path / flags[1])
    padded = flags == ["--compute-path", "padded"] or fixed
    with pytest.raises(FileNotFoundError if resume or padded else ValueError,
                       match="missing.csv" if padded else match) as e:
        train_cli.main(argv)
    if resume:
        assert "--resume x: no params.npz" in str(e.value)
    elif flags[1] == "gin":
        assert "GGNN-only, as in the JAX package" in str(e.value)
    elif flags[0] == "--platform":
        assert str(e.value) == ("--platform selects a JAX platform; the port "
                                "runs on --device cuda|cpu")
    elif not padded:
        assert "ROADMAP queue 1, item" in str(e.value)
    assert not (tmp_path / "run").exists()


def test_batch_iterator_matches_the_jax_one():
    ds = _dataset(40)
    from gcnbmp_tpu_torch.data import estimate_coo_capacities

    tiles, cap = estimate_coo_capacities([ds], 8)
    want = list(jloop.packed_coo_batch_iterator(
        ds, 8, tiles, cap, np.random.default_rng(3), pack_workers=2))
    cache = []
    got = list(packed_coo_batch_iterator(ds, 8, tiles, cap,
                                         np.random.default_rng(3),
                                         pack_workers=2, pack_cache=cache))
    assert len(got) == len(want) == 5 and len(cache) == 5
    for a, b in zip(got, want):
        for x, y in zip(compact_coo_arrays(a), compact_coo_arrays(b)):
            np.testing.assert_array_equal(x, y)
    # a filled cache yields its batches reshuffled, without packing
    again = list(packed_coo_batch_iterator(ds, 8, tiles, cap,
                                           np.random.default_rng(4),
                                           pack_cache=cache))
    assert sorted(map(id, again)) == sorted(map(id, cache))
    # pair-local packing (the multi-device co-attention path), the same
    # batches as the JAX iterator's; with a supernode table it is refused
    want = list(jloop.packed_coo_batch_iterator(
        ds, 8, tiles, cap, np.random.default_rng(5), pairlocal_parts=2))
    got = list(packed_coo_batch_iterator(ds, 8, tiles, cap,
                                         np.random.default_rng(5),
                                         pairlocal_parts=2))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        for x, y in zip(compact_coo_arrays(a), compact_coo_arrays(b)):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="attach_supers_coo"):
        next(packed_coo_batch_iterator(ds, 8, tiles, cap,
                                       np.random.default_rng(0),
                                       supernode_fn=lambda smiles: None,
                                       pairlocal_parts=2))


def _toy_csv(path, n=120):
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


def test_train_cli_learns_and_its_params_serve(tmp_path, capsys):
    from gcnbmp_tpu.cli import train as jax_train_cli

    data = tmp_path / "toy.csv"
    _toy_csv(data)
    flags = ["--train", str(data), "--val", str(data), "--fp-hidden-dim", "8",
             "--conv-layers", "2", "--batch-size", "16", "--lr", "5e-3",
             "--patience", "100"]
    out = tmp_path / "run"
    rc = train_cli.main([*flags, "--epochs", "4", "--compute-path", "fused",
                         "--device", "cpu", "--out", str(out)])
    assert rc == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    log = json.loads((out / "log.json").read_text())
    assert final == log[-1] and len(log) == 4
    # the JAX trainer's log.json and config.json, one epoch on its COO path
    jout = tmp_path / "jax_run"
    assert jax_train_cli.main([*flags, "--epochs", "1", "--compute-path", "coo",
                               "--out", str(jout)]) == 0
    capsys.readouterr()
    jlog = json.loads((jout / "log.json").read_text())
    assert sorted(log[-1]) == sorted(jlog[-1])
    assert sorted(json.loads((out / "config.json").read_text())) == sorted(
        json.loads((jout / "config.json").read_text()))
    losses = [e["main/loss"] for e in log]
    assert losses[-1] < losses[0] and np.all(np.isfinite(losses))
    assert log[-1]["train/roc_auc"] > 0.9
    for ckpt in ("snapshot_epoch_2", "snapshot_epoch_4", "best", "final"):
        assert (out / ckpt / "params.npz").exists(), ckpt
        assert (out / ckpt / "opt_state.npz").exists(), ckpt
    with np.load(out / "final" / "opt_state.npz") as z:
        assert int(z["epoch"]) == 4 and int(z["step"]) == int(z["count"]) == 4 * 7
    cfg = TrainConfig.from_json((out / "config.json").read_text())
    assert cfg.compute_path == "fused" and cfg.conv_layers == 2

    # final/params.npz serves through the predict CLI with the evaluator's logits
    kwargs = predict.model_kwargs_from_config(json.loads((out / "config.json").read_text()))
    model = from_jax_params(load_params_npz(str(out / "final" / "params.npz")),
                            make_packed_predictor(**kwargs))
    ds = CSVPairParser().parse(str(data)).dataset
    res = PackedPairEvaluator(model, batch_size=16, device="cpu").evaluate(ds)
    assert res.metrics["roc_auc"] > 0.9
    rc = predict.main(["--input", str(data), "--config", str(out / "config.json"),
                       "--params", str(out / "final" / "params.npz"),
                       "--out", str(tmp_path / "preds.csv"), "--device", "cpu"])
    assert rc == 0
    probs = pd.read_csv(tmp_path / "preds.csv")["prob"].to_numpy()
    np.testing.assert_allclose(probs, 1.0 / (1.0 + np.exp(-res.logits)),
                               rtol=1e-5, atol=1e-6)
