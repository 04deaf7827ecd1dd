"""The port's padded predictors against the JAX package's on the CPU:

- ``set_up_predictor``'s parameter tree (``convert.init_params(...,
  padded=True)``) against the flax predictor's, key for key and shape for
  shape, and the converter's round trip;
- ``PairPredictor`` with ``symmetric`` or/and, ``siamese=False``,
  ``mask_padding=False`` and co-attention ``para`` and ``alter``, over
  GGNN and RelGCN, and ``GWMPairPredictor`` (tied, and untied with
  ``symmetric``): logits and g1/g2 within 1e-5, every parameter gradient
  of the loss within 1e-4 max|want| + 1e-6, on a padded batch of synth546
  drug train pairs with the JAX params carried across;
- ``predict_proba``, the registry's refusals, the padded ``PairEvaluator``
  against the JAX one, and the entry twin against
  ``__graft_entry__.entry()``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import __graft_entry__
from gcnbmp_tpu.data.dataset import make_batch as jmake_batch
from gcnbmp_tpu.data.parsers import CSVPairParser as JCSVPairParser
from gcnbmp_tpu.eval import evaluate as jeval
from gcnbmp_tpu.models import gwm as jgwm
from gcnbmp_tpu.models import set_up_predictor as jset_up_predictor
from gcnbmp_tpu.train import loop as jloop
from gcnbmp_tpu_torch import entry
from gcnbmp_tpu_torch.convert import (
    from_jax_params, init_params, named_to_tree, to_jax_params)
from gcnbmp_tpu_torch.data import CSVPairParser
from gcnbmp_tpu_torch.eval.evaluate import PairEvaluator
from gcnbmp_tpu_torch.models.predictor import (
    PairPredictor, predict_proba, set_up_predictor)
from gcnbmp_tpu_torch.train import loop

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_train.csv")
ATOL = RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
BASE = dict(fp_hidden_dim=8, fp_out_dim=8, conv_layers=2)
PREDICTORS = [
    ("ggnn-symmetric-or", dict(symmetric="or", weight_tying=False)),
    ("ggnn-symmetric-and", dict(symmetric="and")),
    ("ggnn-not-siamese", dict(siamese=False)),
    ("ggnn-live-padding", dict(mask_padding=False, concat_hidden=True)),
    ("ggnn-para-ntn", dict(attn_model="para", sim_method="ntn")),
    ("ggnn-alter-notsiamese", dict(attn_model="alter", siamese=False,
                                   symmetric="or")),
    ("relgcn-para", dict(method="relgcn", attn_model="para")),
    ("mpnn-concat", dict(method="mpnn", concat_hidden=True)),
    ("gwm-tied", dict(method="ggnn-gwm")),
    ("gwm-untied-symmetric", dict(method="ggnn-gwm", weight_tying=False,
                                  symmetric="and", class_num=2,
                                  sim_method="mlp", net_hidden_dims=(8,))),
]


@pytest.fixture(scope="module")
def batch():
    ds = JCSVPairParser().parse(pd.read_csv(PAIRS).head(6)).dataset
    return jmake_batch(ds, list(range(6)), fill_batch_to=8,
                       supernode_fn=jgwm.default_supernode_fn())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _args(batch, gwm_model, to):
    names = ("atoms1", "adj1", "atoms2", "adj2", "mask1", "mask2")
    args = [to(getattr(batch, n)) for n in names]
    kw = ({"super1": to(batch.super1), "super2": to(batch.super2)}
          if gwm_model else {})
    return args, kw


def _jax_params(jmodel, batch, gwm_model):
    args, kw = _args(batch, gwm_model, jnp.asarray)
    params = jmodel.init(jax.random.PRNGKey(0), *args, **kw)["params"]
    # non-zero biases, so every term shows in the gradients
    return jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(2), x.shape),
        params)


@pytest.mark.parametrize("name,kw", PREDICTORS, ids=[p[0] for p in PREDICTORS])
def test_predictor_matches_jax(batch, name, kw):
    kw = dict(BASE, **kw)
    gwm_model = kw.get("method") == "ggnn-gwm"
    jmodel = jset_up_predictor(**kw)
    params = _jax_params(jmodel, batch, gwm_model)
    tree = jax.tree_util.tree_map(np.asarray, params)
    shapes = lambda t: {k: v.shape for k, v in _flat(t).items()}
    assert shapes(init_params(kw, seed=1, padded=True)) == shapes(tree)
    model = from_jax_params(tree, set_up_predictor(**kw))
    back = to_jax_params(model)
    assert all(np.array_equal(a, _flat(tree)[k])
               for k, a in _flat(back).items())
    labels = np.asarray(batch.labels, np.float32)
    if kw.get("class_num", 1) > 1:
        labels = np.stack([labels, 1 - labels], -1) * (labels >= 0)[:, None]
    jargs, jkw = _args(batch, gwm_model, jnp.asarray)

    def jloss(p):
        logits, aux = jmodel.apply({"params": p}, *jargs, **jkw,
                                   return_aux=True)
        logits = logits.reshape(labels.shape)
        return jloop.sigmoid_cross_entropy(logits, labels), (logits, aux)

    (want_loss, (want, aux)), want_grads = jax.value_and_grad(
        jloss, has_aux=True)(params)
    targs, tkw = _args(batch, gwm_model, torch.as_tensor)
    got, got_aux = model(*targs, **tkw, return_aux=True)
    got = got.reshape(labels.shape)
    loss = loop.sigmoid_cross_entropy(got, torch.as_tensor(labels))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    for key in ("g1", "g2"):
        np.testing.assert_allclose(got_aux[key].detach().numpy(),
                                   np.asarray(aux[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL,
                               atol=ATOL)
    loss.backward()
    got_grads = _flat(named_to_tree(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in model.named_parameters()}))
    want_grads = _flat(want_grads)
    assert sorted(got_grads) == sorted(want_grads)
    for key, g in want_grads.items():
        bound = GRAD_RTOL * float(np.abs(g).max()) + GRAD_ATOL
        assert float(np.abs(got_grads[key] - g).max()) <= bound, key


def test_predict_proba_and_the_registry(batch):
    model = from_jax_params(init_params(BASE, seed=3, padded=True),
                            set_up_predictor(**BASE))
    args, _ = _args(batch, False, torch.as_tensor)
    probs, (g1, g2) = predict_proba(model, *args)
    torch.testing.assert_close(probs, torch.sigmoid(model(*args)))
    assert g1.shape == g2.shape == (8, 8)
    assert isinstance(model, PairPredictor) and model.siamese
    for method in ("ggnn-dev", "ggnn-dev-fuse", "ggnn-dev-gate",
                   "ggnn-dev-self-loop"):
        dev_model = from_jax_params(
            init_params(dict(BASE, method=method), seed=3, padded=True),
            set_up_predictor(**dict(BASE, method=method)))
        assert dev_model(*args).shape == (8, 1)
    with pytest.raises(ValueError, match="unknown encoder"):
        set_up_predictor(method="gcn")
    with pytest.raises(ValueError, match="supernode"):
        gwm_model = set_up_predictor(method="ggnn-gwm", **BASE)
        gwm_model(*args)


@pytest.mark.parametrize("method", ["ggnn", "ggnn-gwm"])
def test_pair_evaluator_matches_jax(method):
    """The padded evaluator over sample200 at batch 64 (fill rows in its
    last batch, each dataset's own bucket), GWM with its supernode rows:
    logits, labels and embeddings within 1e-5, AUROC and AUPRC within
    1e-5."""
    sample = os.path.join(ROOT, "dataset", "sample", "sample200.csv")
    kw = dict(BASE, method=method, weight_tying=False)
    tree = init_params(kw, seed=5, padded=True)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    supers = jgwm.default_supernode_fn() if method == "ggnn-gwm" else None
    want = jeval.PairEvaluator(jset_up_predictor(**kw), jtree, batch_size=64,
                               supernode_fn=supers).evaluate(
        JCSVPairParser().parse(sample).dataset)
    got = PairEvaluator(from_jax_params(tree, set_up_predictor(**kw)),
                        batch_size=64, device="cpu").evaluate(
        CSVPairParser().parse(sample).dataset)
    for key in ("logits", "labels", "e1", "e2"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    for key in ("roc_auc", "prc_auc"):
        assert abs(got.metrics[key] - want.metrics[key]) <= 1e-5, key


def test_entry_twin_matches_graft_entry():
    jfn, jargs = __graft_entry__.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    forward, args = entry.entry(device="cpu")
    assert isinstance(forward, PairPredictor)
    assert [tuple(a.shape) for a in args] == [tuple(a.shape)
                                              for a in jargs[1:]]
    for a, b in zip(args, jargs[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    from_jax_params(jax.tree_util.tree_map(np.asarray, jargs[0]), forward)
    with torch.no_grad():
        got = forward(*args)
    assert got.shape == want.shape == (8, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_entry_runs_on_the_card_only_when_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        entry.entry()  # cuda by default, and no fallback to the CPU
