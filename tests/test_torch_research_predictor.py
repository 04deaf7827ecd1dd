"""The research predictor (``ResearchPairPredictor``) in the port against
the JAX package on the CPU, on the cases of tests/test_research_predictor.py:
GGNN-dev encoders (``sum_pool_readout=False``), co-attention over the
first and last layers' atom states (2H wide), the four combinations of
the side LSTMs (``s_lstm_1``/``s_lstm_2``) and the interaction LSTM
(``i_lstm``) with an MLP head reading left = [g1, s1] and right = [i, s2,
g2]; and a HolE head with a second encoder (``siamese=False``) and
``nie`` co-attention.  Logits within 1e-5; every gradient of a seeded
projection within 1e-4 max|want| + 1e-6; the flax tree's names."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcnbmp_tpu.chem import GGNNFeaturizer as JGGNNFeaturizer
from gcnbmp_tpu.chem import mol_from_smiles as jmol_from_smiles
from gcnbmp_tpu.data.dataset import PairDataset as JPairDataset
from gcnbmp_tpu.data.dataset import make_batch as jmake_batch
from gcnbmp_tpu.models.coattention import build_coattention as jbuild
from gcnbmp_tpu.models.ggnn_dev import GGNNDev as JGGNNDev
from gcnbmp_tpu.models.heads import HolEHead as JHolEHead
from gcnbmp_tpu.models.heads import MLPHead as JMLPHead
from gcnbmp_tpu.models.predictor import (
    ResearchPairPredictor as JResearchPairPredictor)
from gcnbmp_tpu_torch.convert import from_jax_params, named_to_tree
from gcnbmp_tpu_torch.models.coattention import build_coattention
from gcnbmp_tpu_torch.models.ggnn_dev import GGNNDev
from gcnbmp_tpu_torch.models.heads import HolEHead, MLPHead
from gcnbmp_tpu_torch.models.predictor import ResearchPairPredictor

torch.set_num_threads(1)

ATOL = RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PAIRS = [("CCO", "c1ccccc1", 1), ("CC(=O)O", "C=O", 0),
         ("OCCN", "CC(C)O", 1), ("c1ccncc1", "CCCl", 0)]


@pytest.fixture(scope="module")
def batch():
    f = JGGNNFeaturizer()
    ds = JPairDataset()
    for s1, s2, y in PAIRS:
        ds.append(f(jmol_from_smiles(s1)), f(jmol_from_smiles(s2)),
                  np.float32(y))
    return jmake_batch(ds, list(range(len(PAIRS))))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _check(jpred, pred, batch):
    names = ("atoms1", "adj1", "atoms2", "adj2", "mask1", "mask2")
    jargs = [jnp.asarray(getattr(batch, n)) for n in names]
    targs = [torch.as_tensor(getattr(batch, n)) for n in names]
    params = jpred.init(jax.random.PRNGKey(0), *jargs)["params"]
    params = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(2), x.shape),
        params)
    tree = jax.tree_util.tree_map(np.asarray, params)
    from_jax_params(tree, pred)
    want = np.asarray(jpred.apply({"params": params}, *jargs))
    w = np.random.default_rng(3).standard_normal(want.shape).astype(np.float32)
    want_grads = _flat(jax.grad(lambda p: jnp.sum(
        jpred.apply({"params": p}, *jargs) * w))(params))
    got = pred(*targs)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    (got * torch.as_tensor(w)).sum().backward()
    got_grads = _flat(named_to_tree(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in pred.named_parameters()}))
    assert sorted(got_grads) == sorted(want_grads)
    for key, g in want_grads.items():
        bound = GRAD_RTOL * float(np.abs(g).max()) + GRAD_ATOL
        assert float(np.abs(got_grads[key] - g).max()) <= bound, key
    return tree


@pytest.mark.parametrize("s_lstm,i_lstm", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_research_predictor_mlp_matches_jax(batch, s_lstm, i_lstm):
    jpred = JResearchPairPredictor(
        encoder=JGGNNDev(out_dim=8, hidden_dim=8, n_layers=3,
                         sum_pool_readout=False, name="encoder"),
        head=JMLPHead(out_dim=1, hidden_dims=(8,), name="head"),
        coattention=jbuild("para", hidden_dim=16, out_dim=8),
        use_s_lstm=s_lstm, use_i_lstm=i_lstm)
    encoder = GGNNDev(out_dim=8, hidden_dim=8, n_layers=3,
                      sum_pool_readout=False)
    coattention = build_coattention("para", 16, 8)
    left, right = ResearchPairPredictor.head_widths(
        encoder, coattention, s_lstm, i_lstm, mlp=True)
    pred = ResearchPairPredictor(
        encoder, MLPHead(left, 1, (8,), right_dim=right), coattention,
        use_s_lstm=s_lstm, use_i_lstm=i_lstm)
    tree = _check(jpred, pred, batch)
    assert ("s_lstm_1" in tree) == s_lstm and ("s_lstm_2" in tree) == s_lstm
    assert ("i_lstm" in tree) == i_lstm
    assert tree["head"]["mlp"]["hidden_0"]["kernel"].shape[0] == left + right


def test_research_predictor_pair_head_and_nonsiamese_match_jax(batch):
    """A HolE head reads (g1, g2) alone, the side LSTM's output unused by
    the logits (its gradient zero in both packages)."""
    jpred = JResearchPairPredictor(
        encoder=JGGNNDev(out_dim=8, hidden_dim=8, n_layers=2,
                         sum_pool_readout=False, name="encoder"),
        encoder2=JGGNNDev(out_dim=8, hidden_dim=8, n_layers=2,
                          sum_pool_readout=False, name="encoder2"),
        head=JHolEHead(out_dim=1, hidden_dims=(), name="head"),
        coattention=jbuild("nie", hidden_dim=16, out_dim=8),
        use_s_lstm=True)
    make = lambda: GGNNDev(out_dim=8, hidden_dim=8, n_layers=2,
                           sum_pool_readout=False)
    coattention = build_coattention("nie", 16, 8)
    left, _ = ResearchPairPredictor.head_widths(make(), coattention, True,
                                                False, mlp=False)
    pred = ResearchPairPredictor(make(), HolEHead(left, 1, ()), coattention,
                                 encoder2=make(), use_s_lstm=True)
    tree = _check(jpred, pred, batch)
    assert "encoder2" in tree and "s_lstm_1" in tree
