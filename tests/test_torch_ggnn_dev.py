"""The GGNN-dev encoders (``--method ggnn-dev*``) in the port against the
JAX package on the CPU: the four update rules (``gru``, ``fuse``,
``gate``, ``self_loop``) with the sum pool, ``concat_hidden`` and the
last layer's readout, tied and untied, masked and ``mask=None`` (outputs
and the per-layer readouts within 1e-5, every gradient within 1e-4
max|want| + 1e-6); the dropout draws against ``layers.dropout`` with a
seeded ``torch.Generator``; three padded train steps of each method
against the JAX ``make_train_step`` (losses within 1e-5); and the train
CLI on ``ggnn-dev-gate``, then the predict and evaluate CLIs against the
JAX ``evaluate_dataset`` on the same params."""

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
from gcnbmp_tpu.models import ggnn_dev as jggnn_dev
from gcnbmp_tpu.models import set_up_predictor as jset_up_predictor
from gcnbmp_tpu.train import loop as jloop
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli
from gcnbmp_tpu_torch.cli import predict
from gcnbmp_tpu_torch.cli import train as train_cli
from gcnbmp_tpu_torch.convert import (
    from_jax_params, init_module_params, init_params, load_params_npz,
    named_to_tree)
from gcnbmp_tpu_torch.data import CSVPairParser
from gcnbmp_tpu_torch.data.dataset import make_batch, padded_args
from gcnbmp_tpu_torch.models import ggnn_dev, layers
from gcnbmp_tpu_torch.models.predictor import (
    padded_kwargs_from_config, set_up_predictor)
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.config import TrainConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_train.csv")
SAMPLE = os.path.join(ROOT, "dataset", "sample", "sample200.csv")
ATOL = RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
H, D, L = 8, 6, 3
METHODS = {"gru": "ggnn-dev", "fuse": "ggnn-dev-fuse",
           "gate": "ggnn-dev-gate", "self_loop": "ggnn-dev-self-loop"}


def _dataset(n, skip=0, parser=CSVPairParser):
    return parser().parse(pd.read_csv(PAIRS).iloc[skip:skip + n]).dataset


@pytest.fixture(scope="module")
def batch():
    return jmake_batch(_dataset(6, parser=JCSVPairParser), list(range(6)),
                       fill_batch_to=8)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _side(batch, masked=True):
    a, adj, m = batch.atoms1, batch.adj1, batch.mask1
    jm, tm = (jnp.asarray(m), torch.as_tensor(m)) if masked else (None, None)
    return ((jnp.asarray(a), jnp.asarray(adj), jm),
            (torch.as_tensor(a), torch.as_tensor(adj), tm))


SHAPES = {"tied-sumpool": dict(weight_tying=True),
          "untied-sumpool-nomask": dict(weight_tying=False),
          "untied-concat": dict(weight_tying=False, concat_hidden=True),
          "tied-readout-nomask": dict(sum_pool_readout=False)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", METHODS)
def test_ggnn_dev_matches_jax(batch, variant, shape):
    """g (H wide under the sum pool, L*D with concat_hidden, else D), the
    per-layer readouts and states, and every gradient of a seeded
    projection of g and the readouts."""
    (ja, jadj, jm), (ta, tadj, tm) = _side(batch, "nomask" not in shape)
    kw = dict(out_dim=D, hidden_dim=H, n_layers=L, update_variant=variant,
              **SHAPES[shape])
    jmod, tmod = jggnn_dev.GGNNDev(**kw), ggnn_dev.GGNNDev(**kw)
    params = jmod.init(jax.random.PRNGKey(1), ja, jadj, jm)["params"]
    params = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(2), x.shape),
        params)
    from_jax_params(jax.tree_util.tree_map(np.asarray, params), tmod)

    def jout(p):
        g, aux = jmod.apply({"params": p}, ja, jadj, jm)
        return [g] + aux["g_list"] + aux["h_list"]

    want = [np.asarray(x) for x in jout(params)]
    rng = np.random.default_rng(3)
    ws = [rng.standard_normal(x.shape).astype(np.float32) for x in want]
    want_grads = _flat(jax.grad(lambda p: sum(
        jnp.sum(x * w) for x, w in zip(jout(p), ws)))(params))
    g, aux = tmod(ta, tadj, tm)
    got = [g] + aux["g_list"] + aux["h_list"]
    assert tmod.out_width == g.shape[-1] == (
        L * D if "concat" in shape else H if "sumpool" in shape else D)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.detach().numpy(), y, rtol=RTOL,
                                   atol=ATOL)
    sum((x * torch.as_tensor(w)).sum() for x, w in zip(got, ws)).backward()
    got_grads = _flat(named_to_tree(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in tmod.named_parameters()}))
    assert sorted(got_grads) == sorted(want_grads)
    for key, gw in want_grads.items():
        bound = GRAD_RTOL * float(np.abs(gw).max()) + GRAD_ATOL
        assert float(np.abs(got_grads[key] - gw).max()) <= bound, key


@pytest.mark.parametrize("variant", METHODS)
def test_ggnn_dev_dropout_draws(batch, variant, monkeypatch):
    """In training each layer draws one mask from the generator, in
    layer order, the bits ``layers.dropout`` gives from the same seed:
    over r·h under ``fuse`` (f·z added after), over the updated h
    otherwise."""
    _, (ta, tadj, tm) = _side(batch)
    model = ggnn_dev.GGNNDev(out_dim=D, hidden_dim=H, n_layers=L,
                             dropout_rate=0.4, update_variant=variant,
                             weight_tying=False)
    from_jax_params(init_module_params(model, 0), model)
    seen = []
    real = ggnn_dev.dropout

    def spy(x, rate, deterministic, generator):
        out = real(x, rate, deterministic, generator)
        seen.append((x.detach().clone(), out.detach().clone()))
        return out

    monkeypatch.setattr(ggnn_dev, "dropout", spy)
    with torch.no_grad():
        _, aux = model(ta, tadj, tm, False, torch.Generator().manual_seed(7))
    assert len(seen) == L
    gen = torch.Generator().manual_seed(7)
    h = aux["h0"]
    for step, (x, out) in enumerate(seen):
        assert torch.equal(layers.dropout(x, 0.4, False, gen), out)
        assert (out == 0).any() and (out != 0).any()
        if variant == "fuse":
            m = getattr(model, f"update_{step}")(h, tadj)
            cat = torch.cat([h, m], dim=-1)
            torch.testing.assert_close(x, torch.sigmoid(model.fuse_r(cat)) * h)
            torch.testing.assert_close(aux["h_list"][step], out + torch.sigmoid(
                model.fuse_f(cat)) * torch.tanh(model.fuse_z(cat)))
        else:
            assert torch.equal(out, aux["h_list"][step])
        h = aux["h_list"][step]


@pytest.mark.parametrize("variant", METHODS)
def test_three_padded_train_steps_match_the_jax_steps(variant):
    """GGNN-dev with its sum pool: g is H = 32 wide, where both packages
    compute HolE by FFT."""
    jcfg = JaxTrainConfig(method=METHODS[variant], fp_hidden_dim=32,
                          fp_out_dim=8, conv_layers=2, weight_tying=False,
                          learning_rate=1e-2, batch_size=8)
    kwargs = padded_kwargs_from_config(json.loads(jcfg.to_json()))
    tree = init_params(kwargs, seed=8, padded=True)
    tx, _ = jloop.build_optimizer(jcfg, 1)
    step = jloop.make_train_step(jset_up_predictor(**kwargs), tx)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(params)
    model = from_jax_params(tree, set_up_predictor(**kwargs))
    opt, _ = loop.build_optimizer(TrainConfig(**json.loads(jcfg.to_json())),
                                  1, list(model.parameters()))
    gen = torch.Generator().manual_seed(1)
    got, want = [], []
    for i in range(3):
        jb = jmake_batch(_dataset(8, 8 * i, JCSVPairParser), list(range(8)),
                         pad_to=24)
        params, opt_state, loss, _ = step(
            params, opt_state, *(jnp.asarray(getattr(jb, n)) for n in (
                "atoms1", "adj1", "atoms2", "adj2", "mask1", "mask2")),
            (), jnp.asarray(jb.labels), jax.random.PRNGKey(i))
        want.append(float(loss))
        args, kw, labels = padded_args(
            make_batch(_dataset(8, 8 * i), list(range(8)), pad_to=24), "cpu")
        got.append(float(loop.train_step(model, opt, args, labels,
                                         deterministic=False, generator=gen,
                                         **kw)))
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


def test_ggnn_dev_gate_trains_and_scores_through_the_clis(tmp_path, capsys):
    """``--method ggnn-dev-gate`` trains on the padded layout (refused on
    the packed ones, as JAX's ``PACKED_ENCODERS`` has no GGNN-dev), then
    the predict and evaluate CLIs score its run as the JAX evaluator
    does on the same params: probs within 1e-5, AUROC and AUPRC within
    1e-5."""
    data, out = str(tmp_path / "toy.csv"), tmp_path / "run"
    _toy_csv(data)
    flags = ["--method", "ggnn-dev-gate", "--fp-hidden-dim", "32",
             "--fp-out-dim", "8", "--conv-layers", "2", "--batch-size", "16",
             "--lr", "5e-3"]
    with pytest.raises(ValueError, match="ggnn-dev-gate"):
        train_cli.main(["--train", data, *flags, "--compute-path", "coo",
                        "--device", "cpu", "--out", str(tmp_path / "coo")])
    assert train_cli.main(["--train", data, "--val", data, *flags,
                           "--epochs", "3", "--patience", "100", "--device",
                           "cpu", "--out", str(out)]) == 0
    config = json.loads((out / "config.json").read_text())
    assert config["compute_path"] == "padded"
    losses = [e["main/loss"] for e in json.loads(
        (out / "log.json").read_text())]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
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
