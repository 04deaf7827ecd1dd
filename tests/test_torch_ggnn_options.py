"""GGNN's research options in the port against the JAX package on the
CPU: each block of ``models.ggnn_extras`` (masked self-attention, the
edge network, the input-less LSTM, set2vec), and the padded GGNN with
each option (``use_attention`` tied and untied, the edge-network
message, the set2vec readout, the BiLSTM context), alone and with
``concat_hidden``, tied and untied layers, masked and ``mask=None``;
then the factories' pass-through of ``attention``/``context`` and their
refusals.  Inputs: a padded batch of synth546 drug train pairs
(``make_batch`` of the JAX package, two fill rows of pad atoms) and
numpy-seeded tensors; weights carried by ``convert.from_jax_params``.
Outputs within rtol = atol = 1e-5, every parameter gradient of a seeded
projection within 1e-4 max|want| + 1e-6."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.data.dataset import make_batch as jmake_batch
from gcnbmp_tpu.data.parsers import CSVPairParser
from gcnbmp_tpu.models import ggnn as jggnn
from gcnbmp_tpu.models import ggnn_extras as jextras
from gcnbmp_tpu.models import set_up_predictor as jset_up_predictor
from gcnbmp_tpu_torch.convert import (
    from_jax_params, init_module_params, init_params, named_to_tree)
from gcnbmp_tpu_torch.models import ggnn, ggnn_extras
from gcnbmp_tpu_torch.models.predictor import set_up_predictor

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_train.csv")
ATOL = RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
H, D, L = 8, 6, 3


@pytest.fixture(scope="module")
def batch():
    ds = CSVPairParser().parse(pd.read_csv(PAIRS).head(6)).dataset
    return jmake_batch(ds, list(range(6)), fill_batch_to=8)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _check(jmod, tmod, jargs, targs, index=0):
    """Init ``jmod``, load its params (nudged, so biases are non-zero)
    into ``tmod``, and hold output ``index`` (or the only one) and the
    gradients of sum(out * w) against each other."""
    params = jmod.init(jax.random.PRNGKey(1), *jargs)["params"]
    params = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(2), x.shape),
        params)
    from_jax_params(jax.tree_util.tree_map(np.asarray, params), tmod)

    def pick(out):
        return out[index] if isinstance(out, tuple) else out

    def jout(p):
        return pick(jmod.apply({"params": p}, *jargs))

    want = np.asarray(jout(params))
    w = np.random.default_rng(3).standard_normal(want.shape).astype(np.float32)
    want_grads = _flat(jax.grad(lambda p: jnp.sum(jout(p) * w))(params))
    got = pick(tmod(*targs))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    (got * torch.as_tensor(w)).sum().backward()
    got_grads = _flat(named_to_tree(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in tmod.named_parameters()}))
    assert sorted(got_grads) == sorted(want_grads)
    for key, g in want_grads.items():
        bound = GRAD_RTOL * float(np.abs(g).max()) + GRAD_ATOL
        assert float(np.abs(got_grads[key] - g).max()) <= bound, key
    return got


def _side(batch, masked=True):
    a, adj, m = batch.atoms1, batch.adj1, batch.mask1
    jm, tm = (jnp.asarray(m), torch.as_tensor(m)) if masked else (None, None)
    return ((jnp.asarray(a), jnp.asarray(adj), jm),
            (torch.as_tensor(a), torch.as_tensor(adj), tm))


def _states(batch, width, seed=5):
    h = np.random.default_rng(seed).standard_normal(
        batch.atoms1.shape + (width,)).astype(np.float32)
    return jnp.asarray(h), torch.as_tensor(h)


# ---------------------------------------------------------------------------
# the blocks


def test_masked_self_attention_matches_jax(batch):
    """Pad atoms and atoms without a bond get a uniform softmax over all
    N slots (every energy -9e15), as in the JAX module."""
    jh, th = _states(batch, H)
    jadj, tadj = jnp.asarray(batch.adj1), torch.as_tensor(batch.adj1)
    assert (batch.adj1.sum(axis=(1, 3)) == 0).any()  # rows with no bond
    out = _check(jextras.MaskedSelfAttention(H),
                 ggnn_extras.MaskedSelfAttention(H, H), (jh, jadj),
                 (th, tadj))
    lonely = torch.as_tensor(batch.adj1.sum(axis=(1, 3)) == 0)
    assert torch.isfinite(out).all() and lonely.any()


@pytest.mark.parametrize("n_hidden", [0, 1])
def test_edge_network_matches_jax(batch, n_hidden):
    """The non-edge term M_0 sum_j h_j runs over every padded slot."""
    jh, th = _states(batch, H)
    jadj, tadj = jnp.asarray(batch.adj1), torch.as_tensor(batch.adj1)
    _check(jextras.GGNNEdgeNetwork(H, 5, n_hidden),
           ggnn_extras.GGNNEdgeNetwork(H, 5, n_hidden), (jh, jadj),
           (th, tadj))


@pytest.mark.parametrize("index", [0, 1], ids=["m", "c"])
def test_lstm_without_input_matches_jax(index):
    rng = np.random.default_rng(6)
    m = rng.standard_normal((5, 2 * H)).astype(np.float32)
    c = rng.standard_normal((5, H)).astype(np.float32)
    _check(jextras.LSTMWithoutInput(H), ggnn_extras.LSTMWithoutInput(2 * H, H),
           (jnp.asarray(m), jnp.asarray(c)),
           (torch.as_tensor(m), torch.as_tensor(c)), index=index)


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("steps,hidden", [(3, 0), (2, 1)])
def test_set2vec_matches_jax(batch, masked, steps, hidden):
    """Energies -9e15 off the mask, softmax, then times the mask; the
    fill rows' all-pad molecules read nothing under a mask."""
    jh, th = _states(batch, 2 * H)
    (_, _, jm), (_, _, tm) = _side(batch, masked)
    kw = dict(num_timesteps=steps, num_output_hidden_layers=hidden,
              output_hidden_dim=7)
    _check(jextras.Set2Vec(2 * H, D, **kw),
           ggnn_extras.Set2Vec(2 * H, D, **kw), (jh, jm), (th, tm))


# ---------------------------------------------------------------------------
# GGNN with each option

OPTIONS = {
    "attention": dict(use_attention=True),
    "attention-untied": dict(use_attention=True, attention_tying=False),
    "edge_network": dict(message_function="edge_network"),
    "set2vec": dict(readout_function="set2vec", num_timesteps=2,
                    num_output_hidden_layers=1, output_hidden_dim=5),
    "context": dict(context=True),
    "all": dict(use_attention=True, attention_tying=False, context=True,
                message_function="edge_network", readout_function="set2vec"),
}
SHAPES = {"tied": dict(weight_tying=True),
          "untied-concat": dict(weight_tying=False, concat_hidden=True),
          "untied-concat-nomask": dict(weight_tying=False,
                                       concat_hidden=True),
          "tied-nomask": dict(weight_tying=True)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("option", OPTIONS)
def test_ggnn_option_matches_jax(batch, option, shape):
    (ja, jadj, jm), (ta, tadj, tm) = _side(batch, "nomask" not in shape)
    kw = dict(out_dim=D, hidden_dim=H, n_layers=L, **OPTIONS[option],
              **SHAPES[shape])
    out = _check(jggnn.GGNN(**kw), ggnn.GGNN(**kw), (ja, jadj, jm),
                 (ta, tadj, tm))
    assert out.shape == (8, D * (L if "concat" in shape else 1))


def test_context_runs_over_every_padded_slot(batch):
    """The BiLSTM takes no sequence lengths: padding a molecule's slots
    changes its real atoms' context states (the backward direction reads
    the pad first), as in the reference."""
    _, (ta, tadj, tm) = _side(batch)
    torch.manual_seed(0)
    model = ggnn.GGNN(out_dim=D, hidden_dim=H, n_layers=1, context=True)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.5)
    wide_a = torch.nn.functional.pad(ta, (0, 3))
    wide_adj = torch.nn.functional.pad(tadj, (0, 3, 0, 3))
    n = ta.shape[1]
    h0 = model(ta, tadj, tm)[1]["h0"]
    wide_h0 = model(wide_a, wide_adj, torch.nn.functional.pad(tm, (0, 3)))[
        1]["h0"][:, :n]
    half = H // 2
    torch.testing.assert_close(wide_h0[..., :half], h0[..., :half])
    assert not torch.allclose(wide_h0[..., half:], h0[..., half:])


def test_init_params_draws_the_new_leaves_from_their_flax_initializers():
    """Set2Vec's raw attention weights glorot-uniform, the context
    BiLSTM's hidden kernels orthogonal, its input kernels lecun-normal."""
    model = ggnn.GGNN(out_dim=D, hidden_dim=32, n_layers=1, context=True,
                      readout_function="set2vec")
    tree = init_module_params(model, seed=0)
    w1 = tree["readout_0"]["attention_w1"]  # (64, 64)
    limit = np.sqrt(6.0 / (64 + 64))
    assert np.abs(w1).max() <= limit
    assert abs(float(w1.std()) - limit / np.sqrt(3.0)) < 0.05 * limit
    assert tree["readout_0"]["attention_v"].shape == (64, 1)
    for cell in ("OptimizedLSTMCell_0", "OptimizedLSTMCell_1"):
        for gate in "ifgo":
            w = tree[cell][f"h{gate}"]["kernel"]  # (16, 16)
            np.testing.assert_allclose(w.T @ w, np.eye(16), atol=1e-5)
            x = tree[cell][f"i{gate}"]["kernel"]  # (32, 16), fan-in 32
            assert abs(float(x.std()) - 32 ** -0.5) < 0.25 * 32 ** -0.5


# ---------------------------------------------------------------------------
# the factories


@pytest.mark.parametrize("opts", [dict(attention="gat"), dict(context=True),
                                  dict(attention="gat", context=True)])
def test_set_up_predictor_passes_the_research_options(batch, opts):
    """``attention`` and ``context`` reach the GGNN through both
    factories: the same tree and logits as the JAX predictor."""
    (ja, jadj, jm), (ta, tadj, tm) = _side(batch)
    b = batch
    kw = dict(method="ggnn", fp_hidden_dim=H, fp_out_dim=D, conv_layers=2,
              sim_method="hole", net_hidden_dims=(4,), **opts)
    jpred = jset_up_predictor(**kw)
    args = (ja, jadj, jnp.asarray(b.atoms2), jnp.asarray(b.adj2), jm,
            jnp.asarray(b.mask2))
    params = jpred.init(jax.random.PRNGKey(0), *args)["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    pred = from_jax_params(tree, set_up_predictor(**kw))
    assert sorted(_flat(tree)) == sorted(_flat(init_params(kw, 0,
                                                           padded=True)))
    want = np.asarray(jpred.apply({"params": params}, *args))
    got = pred(ta, tadj, torch.as_tensor(b.atoms2), torch.as_tensor(b.adj2),
               tm, torch.as_tensor(b.mask2))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)


REFUSALS = [("relgcn", dict(attention="gat")), ("gin", dict(context=True)),
            ("mpnn", dict(update_attention=True)),
            ("nfp", dict(attention="gat", context=True)),
            ("ggnn-dev-gate", dict(context=True))]


@pytest.mark.parametrize("method,opts", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_other_encoders_refuse_the_research_options(method, opts):
    """The JAX factory's refusal, word for word."""
    kw = dict(method=method, fp_hidden_dim=H, fp_out_dim=D, conv_layers=2,
              **opts)
    with pytest.raises(ValueError) as want:
        jset_up_predictor(**kw)
    with pytest.raises(ValueError) as got:
        set_up_predictor(**kw)
    assert str(got.value) == str(want.value)
    assert "GGNN-only options" in str(got.value)


def test_update_attention_stays_refused():
    """The reference cannot run it; both packages raise the same text."""
    with pytest.raises(NotImplementedError) as got:
        set_up_predictor(method="ggnn", update_attention=True)
    with pytest.raises(NotImplementedError) as want:
        jggnn.GGNN(out_dim=D, update_attention=True).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 3), jnp.int32),
            jnp.zeros((1, 4, 3, 3)))
    assert str(got.value) == str(want.value)
