"""The port's run management on the CPU: checkpoint restore
(``train.checkpoints.restore_checkpoint``) bit for bit, the train CLI's
``--resume``, the refusal of a checkpoint of another model, the
trainer's ``profile_epoch`` and ``debug_checks`` (``PackedCOOBatch.validate``
against the JAX one, the finiteness check), and multi-label training:
one step against the JAX step, and the train CLI with ``--labels-csv``
followed by the evaluate CLI."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.data.packing import pack_pair_dataset_coo as jax_pack
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.train import loop as jloop
from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli
from gcnbmp_tpu_torch.cli import train as train_cli
from gcnbmp_tpu_torch.convert import (
    from_jax_params, init_params, load_params_npz, named_to_tree)
from gcnbmp_tpu_torch.data import CSVPairParser, get_class_labels
from gcnbmp_tpu_torch.data import wire
from gcnbmp_tpu_torch.data.packing import pack_pair_dataset_coo
from gcnbmp_tpu_torch.data.wire import compact_coo_arrays
from gcnbmp_tpu_torch.models.packed import make_packed_predictor
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.checkpoints import restore_checkpoint
from gcnbmp_tpu_torch.train.config import TrainConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "dataset", "sample", "sample200.csv")
CLASSES = os.path.join(ROOT, "dataset", "synth546", "labels.csv")
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5  # the JAX suite's gradient bound
OXY = ["CCO", "CC(=O)O", "OCCO", "C=O", "COC"]
NOX = ["CC", "CCC", "c1ccccc1", "CCN"]


def _toy_csv(path, n=96, multilabel=False):
    """Label 1 when both molecules hold an oxygen; multi-label: the
    synth546 classes, class c set by a seeded rule on the pair."""
    rng = np.random.default_rng(7)
    classes = get_class_labels(CLASSES)
    rows = []
    for i in range(n):
        a = rng.choice(OXY if rng.random() < 0.5 else NOX)
        b = rng.choice(OXY if rng.random() < 0.5 else NOX)
        if multilabel:
            label = "||".join(c for j, c in enumerate(classes)
                              if (i + j) % 3 == 0 or (a in OXY and j == 0))
        else:
            label = int(a in OXY and b in OXY)
        rows.append([i, i + 1, a, b, label])
    pd.DataFrame(rows, columns=["drugbank_id_1", "drugbank_id_2", "smiles_1",
                                "smiles_2", "label"]).to_csv(path, index=False)


def _cfg(out, **kw):
    base = dict(conv_layers=2, fp_hidden_dim=8, fp_out_dim=8,
                weight_tying=False, compute_path="coo", batch_size=16,
                learning_rate=5e-3, epochs=2, snapshot_interval=1,
                eval_train=False, out_dir=str(out), plot_reports=False)
    return TrainConfig(**{**base, **kw})


def _datasets(tmp_path):
    _toy_csv(tmp_path / "toy.csv")
    ds = CSVPairParser().parse(str(tmp_path / "toy.csv")).dataset
    return ds, ds


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _state(trainer):
    return loop.TrainState(trainer.model, trainer.optimizer, 0, 0,
                           float("inf"), 0)


# ---------------------------------------------------------------------------
# restore


def test_restore_round_trips_bit_for_bit(tmp_path):
    train_ds, val_ds = _datasets(tmp_path)
    cfg = _cfg(tmp_path / "run")
    loop.Trainer(cfg, train_ds, val_ds, device="cpu").fit()
    ckpt = tmp_path / "run" / "snapshot_epoch_1"
    fresh = loop.Trainer(cfg, train_ds, val_ds, device="cpu")
    state = restore_checkpoint(str(ckpt), _state(fresh))
    want = _flat(load_params_npz(str(ckpt / "params.npz")))
    got = _flat(named_to_tree(dict(fresh.model.named_parameters())))
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    names = [n for n, _ in fresh.model.named_parameters()]
    with np.load(ckpt / "opt_state.npz") as z:
        for prefix, moments in (("mu", fresh.optimizer.mu),
                                ("nu", fresh.optimizer.nu)):
            got = _flat(named_to_tree(dict(zip(names, moments))))
            assert sorted(got) == sorted(want)
            for key in want:
                assert np.array_equal(got[key], z[f"{prefix}/{key}"]), key
            assert any(np.any(v != 0) for v in got.values())
        steps = len(train_ds) // cfg.batch_size
        assert (fresh.optimizer.count, state.step, state.epoch) == (
            int(z["count"]), int(z["step"]), 1) == (steps, steps, 1)
        assert state.best_val_loss == float(z["best_val_loss"])
        assert state.epochs_since_best == int(z["epochs_since_best"]) == 0


@pytest.mark.parametrize("change,match", [
    ({"fp_hidden_dim": 16}, "'encoder/embed/embedding' has shape"),
    ({"sim_method": "ntn"}, "lacks tensor 'head/bilinear"),
])
def test_a_checkpoint_of_another_model_is_refused(tmp_path, change, match):
    train_ds, val_ds = _datasets(tmp_path)
    cfg = _cfg(tmp_path / "run", epochs=1)
    loop.Trainer(cfg, train_ds, val_ds, device="cpu").fit()
    other = loop.Trainer(dataclasses.replace(cfg, **change), train_ds,
                         val_ds, device="cpu")
    before = [p.detach().clone() for p in other.model.parameters()]
    with pytest.raises(ValueError, match=match):
        restore_checkpoint(str(tmp_path / "run" / "snapshot_epoch_1"),
                           _state(other))
    # refused before anything was copied
    for b, p in zip(before, other.model.parameters()):
        assert torch.equal(b, p)


def test_train_cli_resume_continues_the_schedule(tmp_path, capsys):
    _toy_csv(tmp_path / "toy.csv")
    flags = ["--train", str(tmp_path / "toy.csv"), "--val",
             str(tmp_path / "toy.csv"), "--fp-hidden-dim", "8",
             "--fp-out-dim", "8", "--conv-layers", "2", "--batch-size", "16",
             "--lr", "5e-3", "--clr", "triangular", "--compute-path", "coo",
             "--no-eval-train", "--device", "cpu"]
    whole, part = tmp_path / "whole", tmp_path / "part"
    assert train_cli.main(flags + ["--epochs", "4", "--out", str(whole)]) == 0
    assert train_cli.main(flags + ["--epochs", "4", "--out", str(part),
                                   "--resume",
                                   str(whole / "snapshot_epoch_2")]) == 0
    capsys.readouterr()
    full = json.loads((whole / "log.json").read_text())
    resumed = json.loads((part / "log.json").read_text())
    # only the epochs the resumed run trained are logged, and the cyclical
    # learning rate (a function of the step) goes on from the restored step
    assert [e["epoch"] for e in resumed] == [3, 4]
    assert [e["lr"] for e in resumed] == [e["lr"] for e in full[2:]]
    assert full[0]["lr"] < full[1]["lr"] < full[2]["lr"]
    assert all(np.isfinite(e["main/loss"]) for e in resumed)
    with np.load(whole / "final" / "opt_state.npz") as a, \
            np.load(part / "final" / "opt_state.npz") as b:
        for key in ("count", "step", "epoch"):
            assert int(a[key]) == int(b[key]), key
        assert int(b["count"]) == 4 * (96 // 16)
    cfg = json.loads((part / "config.json").read_text())
    assert cfg["resume"] == str(whole / "snapshot_epoch_2")


# ---------------------------------------------------------------------------
# profile_epoch


def test_profile_epoch_writes_a_trace(tmp_path):
    train_ds, val_ds = _datasets(tmp_path)
    cfg = _cfg(tmp_path / "run", epochs=2, profile_epoch=1)
    loop.Trainer(cfg, train_ds, val_ds, device="cpu").fit()
    traces = os.listdir(tmp_path / "run" / "profile")
    assert traces == ["epoch_1.trace.json"]
    with open(tmp_path / "run" / "profile" / traces[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    # the epoch's backward ran inside the trace
    assert any("Backward" in n for n in names)


# ---------------------------------------------------------------------------
# debug_checks


def _corrupt(batch, case):
    real = np.flatnonzero(batch.e_mask > 0)
    e = int(real[0])
    if case == "e_tile":
        batch.e_tile[e] = batch.num_tiles
    elif case == "e_type":
        batch.e_type[e] = 4
    elif case == "e_src":
        batch.e_src[e] = -1
    elif case == "e_dst":
        batch.e_dst[e] = 128
    elif case == "e_mask":
        batch.e_mask[-1] = 0.5
    elif case == "node_mask":
        batch.node_mask[0, 0] = 0.0
    elif case == "index":
        batch.left_index[0] = batch.num_mols
    elif case == "padded_slot":
        tile = int(batch.e_tile[e])
        batch.e_src[e] = int(np.flatnonzero(batch.node_mask[tile] == 0)[0])
    return batch


@pytest.mark.parametrize("case", ["e_tile", "e_type", "e_src", "e_dst",
                                  "e_mask", "node_mask", "index",
                                  "padded_slot"])
def test_validate_raises_the_jax_errors(case):
    ds = CSVPairParser().parse(pd.read_csv(SAMPLE).head(12)).dataset
    idx = list(range(12))
    got_batch = pack_pair_dataset_coo(ds, idx, edge_capacity=1024)
    want_batch = jax_pack(ds, idx, edge_capacity=1024)
    assert got_batch.validate() is got_batch
    want_batch.validate()
    with pytest.raises(ValueError) as want:
        _corrupt(want_batch, case).validate()
    with pytest.raises(ValueError) as got:
        _corrupt(got_batch, case).validate()
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("invalid PackedCOOBatch: ")


def test_debug_checks_pass_a_clean_epoch_and_refuse_a_corrupted_batch(
        tmp_path, monkeypatch):
    train_ds, val_ds = _datasets(tmp_path)
    cfg = _cfg(tmp_path / "run", epochs=1, debug_checks=True)
    result = loop.Trainer(cfg, train_ds, val_ds, device="cpu").fit()
    assert result["state"].epoch == 1
    real = wire.packed_coo_batch_iterator
    steps = []
    real_step = loop.train_step

    def corrupted(*args, **kwargs):
        for i, b in enumerate(real(*args, **kwargs)):
            if i == 2:
                b.e_src[int(np.flatnonzero(b.e_mask > 0)[0])] = 200
            yield b

    monkeypatch.setattr(wire, "packed_coo_batch_iterator", corrupted)
    monkeypatch.setattr(loop, "train_step",
                        lambda *a, **k: steps.append(1) or real_step(*a, **k))
    trainer = loop.Trainer(dataclasses.replace(
        cfg, out_dir=str(tmp_path / "run2")), train_ds, val_ds, device="cpu")
    with pytest.raises(ValueError, match=r"e_src: 1 edges out of \[0, 128\)"):
        trainer.fit()
    assert len(steps) == 2  # the corrupted batch never reached a step


def test_debug_checks_name_a_non_finite_parameter(tmp_path, monkeypatch):
    train_ds, val_ds = _datasets(tmp_path)
    cfg = _cfg(tmp_path / "run", epochs=1, debug_checks=True)
    trainer = loop.Trainer(cfg, train_ds, val_ds, device="cpu")
    real_step = loop.train_step
    calls = []

    def poisoning_step(model, *args, **kwargs):
        loss = real_step(model, *args, **kwargs)
        calls.append(1)
        if len(calls) == 3:  # an update that overflowed one weight
            with torch.no_grad():
                model.head.mlp.out.weight[0, 0] = float("nan")
        return loss

    monkeypatch.setattr(loop, "train_step", poisoning_step)
    with pytest.raises(FloatingPointError,
                       match=r"in head\.mlp\.out\.weight at epoch 0 step 2"):
        trainer.fit()
    # without debug_checks the same run goes on
    calls.clear()
    loop.Trainer(dataclasses.replace(cfg, debug_checks=False,
                                     out_dir=str(tmp_path / "run2")),
                 train_ds, val_ds, device="cpu").fit()


# ---------------------------------------------------------------------------
# multi-label


def test_multilabel_train_step_matches_the_jax_step(tmp_path):
    _toy_csv(tmp_path / "multi.csv", n=24, multilabel=True)
    classes = get_class_labels(CLASSES)
    ds = CSVPairParser(multi_label_classes=classes).parse(
        str(tmp_path / "multi.csv")).dataset
    batch = pack_pair_dataset_coo(ds, list(range(16)))
    wire_args = compact_coo_arrays(batch)
    labels = np.asarray(batch.labels, np.float32)
    assert labels.shape == (16, len(classes))
    kwargs = dict(conv_layers=2, fp_hidden_dim=8, fp_out_dim=8,
                  weight_tying=False, class_num=len(classes))
    tree = init_params(kwargs, seed=6)
    jloss = jloop.make_loss("focal", gamma=2.0, alpha=0.75)
    pred = jpacked.make_packed_predictor(**kwargs, coo=True, compact=True)

    def loss_fn(params):
        logits = pred.apply({"params": params},
                            *(jnp.asarray(a) for a in wire_args))
        return jloss(logits, jnp.asarray(labels))

    want_loss, want = jax.value_and_grad(loss_fn)(tree)
    model = from_jax_params(tree, make_packed_predictor(**kwargs))
    cfg = TrainConfig(loss="focal", focal_alpha=0.75, class_num=len(classes))
    opt, _ = loop.build_optimizer(cfg, 1, list(model.parameters()))
    loss = loop.train_step(
        model, opt, [torch.as_tensor(np.asarray(a)) for a in wire_args],
        torch.as_tensor(labels), loop.make_loss("focal", gamma=2.0,
                                                alpha=0.75),
        class_num=len(classes))
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    got = _flat(named_to_tree({n: p.grad for n, p in model.named_parameters()}))
    want = _flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=key)


def test_multilabel_train_cli_then_evaluate_cli(tmp_path, capsys):
    data = tmp_path / "multi.csv"
    _toy_csv(data, multilabel=True)
    out = tmp_path / "run"
    assert train_cli.main([
        "--train", str(data), "--val", str(data), "--labels-csv", CLASSES,
        "--preset", "ggnn_multilabel_x86", "--conv-layers", "2",
        "--fp-hidden-dim", "8", "--fp-out-dim", "8", "--batch-size", "16",
        "--scan-steps", "2", "--epochs", "3", "--patience", "100",
        "--no-eval-train", "--device", "cpu", "--out", str(out)]) == 0
    capsys.readouterr()
    cfg = json.loads((out / "config.json").read_text())
    assert (cfg["class_num"], cfg["loss"], cfg["compute_path"]) == (
        5, "focal", "coo")
    log = json.loads((out / "log.json").read_text())
    assert len(log) == 3 and all(np.isfinite(e["val/loss"]) for e in log)
    assert log[-1]["main/loss"] < log[0]["main/loss"]
    assert evaluate_cli.main(["--test", str(data), "--run", str(out),
                              "--labels-csv", CLASSES, "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    result = json.loads((out / "eval" / "eval_result.json").read_text())
    assert sorted(result["per_class"]) == sorted(get_class_labels(CLASSES))
    assert all(np.isfinite(v) for c in result["per_class"].values()
               for v in c.values())
    assert printed == {k: v for k, v in result.items() if k != "per_class"}
    y = pd.read_csv(out / "eval" / "multi_e_y.csv")["y"]
    assert len(json.loads(y[0])) == 5
