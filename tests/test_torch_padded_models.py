"""The port's padded modules against the JAX package's on the CPU: the
GGNN (tied and untied, ``concat_hidden``, each of the 8 layer aggregator
modes, mask and ``mask=None``, float atoms), the four readouts, RelGCN,
GIN, NFP and MPNN (mask and None) and GGNN_GWM, each on a padded batch of
synth546 drug train pairs (``make_batch`` of the JAX package) with the
flax params carried across: outputs within 1e-5, every parameter
gradient of a seeded projection of the output within 1e-4 max|want| +
1e-6.  Also the GGNN's refusals and dropout (identity in eval; the keep
rate, the scale, and equal bits from equal generator seeds)."""

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
from gcnbmp_tpu.models import gin as jgin
from gcnbmp_tpu.models import gwm as jgwm
from gcnbmp_tpu.models import mpnn as jmpnn
from gcnbmp_tpu.models import nfp as jnfp
from gcnbmp_tpu.models import readouts as jreadouts
from gcnbmp_tpu.models import relgcn as jrelgcn
from gcnbmp_tpu_torch.convert import (
    from_jax_params, init_module_params, named_to_tree)
from gcnbmp_tpu_torch.models import ggnn_extras
from gcnbmp_tpu_torch.models import ggnn, gin, gwm, layers, mpnn, nfp, readouts, relgcn

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_train.csv")
ATOL = RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
H, D, L = 8, 8, 3


@pytest.fixture(scope="module")
def batch():
    ds = CSVPairParser().parse(pd.read_csv(PAIRS).head(6)).dataset
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


def _check(jmod, tmod, jargs, targs, jkw=None, tkw=None, init_args=None):
    """Init ``jmod`` on ``init_args`` (default ``jargs``), load its params
    into ``tmod``, and hold the output (or its first element) and the
    gradients of sum(out * w) of both modules against each other."""
    jkw, tkw = jkw or {}, tkw or {}
    params = jmod.init(jax.random.PRNGKey(1),
                       *(init_args or jargs), **jkw)["params"]
    params = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(2), x.shape),
        params)  # non-zero biases, so every term shows in the gradients
    tree = jax.tree_util.tree_map(np.asarray, params)
    from_jax_params(tree, tmod)

    def jout(p):
        out = jmod.apply({"params": p}, *jargs, **jkw)
        return out[0] if isinstance(out, tuple) else out

    want = np.asarray(jout(params))
    w = np.random.default_rng(3).standard_normal(want.shape).astype(np.float32)
    want_grads = _flat(jax.grad(lambda p: jnp.sum(jout(p) * w))(params))
    got = tmod(*targs, **tkw)
    got = got[0] if isinstance(got, tuple) else got
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


def _side(batch, k=1):
    a, adj, m = (getattr(batch, f"{n}{k}") for n in ("atoms", "adj", "mask"))
    return (jnp.asarray(a), jnp.asarray(adj), jnp.asarray(m)), (
        torch.as_tensor(a), torch.as_tensor(adj), torch.as_tensor(m))


@pytest.mark.parametrize("tied,concat,masked", [
    (True, False, True), (False, False, True), (True, False, False),
    (False, True, True), (False, True, False)],
    ids=["tied", "untied", "tied-nomask", "untied-concat",
         "untied-concat-nomask"])
def test_ggnn_matches_jax(batch, tied, concat, masked):
    (ja, jadj, jm), (ta, tadj, tm) = _side(batch)
    kw = dict(out_dim=D, hidden_dim=H, n_layers=L, weight_tying=tied,
              concat_hidden=concat)
    jm, tm = (jm, tm) if masked else (None, None)
    out = _check(jggnn.GGNN(**kw), ggnn.GGNN(**kw), (ja, jadj, jm),
                 (ta, tadj, tm))
    assert out.shape == (8, D * (L if concat else 1))


@pytest.mark.parametrize("mode", ggnn_extras.MODES)
def test_ggnn_layer_aggregators_match_jax(batch, mode):
    (ja, jadj, jm), (ta, tadj, tm) = _side(batch)
    kw = dict(out_dim=D, hidden_dim=H, n_layers=L, weight_tying=False,
              layer_aggregator=mode)
    _check(jggnn.GGNN(**kw), ggnn.GGNN(**kw), (ja, jadj, jm), (ta, tadj, tm))


def test_ggnn_float_atoms_skip_the_embedding(batch):
    """Float atoms are taken as embedded states; the tree still holds the
    embedding (initialized on integer atoms), which gets no gradient."""
    (ja, jadj, jm), (ta, tadj, tm) = _side(batch)
    h = np.random.default_rng(5).standard_normal(
        ja.shape + (H,)).astype(np.float32)
    kw = dict(out_dim=D, hidden_dim=H, n_layers=L, weight_tying=False)
    _check(jggnn.GGNN(**kw), ggnn.GGNN(**kw), (jnp.asarray(h), jadj, jm),
           (torch.as_tensor(h), tadj, tm), init_args=(ja, jadj, jm))


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "nomask"])
def test_readouts_match_jax(masked):
    rng = np.random.default_rng(7)
    h = rng.standard_normal((4, 10, H)).astype(np.float32)
    h0 = rng.standard_normal((4, 10, H)).astype(np.float32)
    mask = (np.arange(10)[None] < np.array([[3], [10], [1], [6]])).astype(
        np.float32)
    jm, tm = (jnp.asarray(mask), torch.as_tensor(mask)) if masked else (
        None, None)
    jh, th = jnp.asarray(h), torch.as_tensor(h)
    jh0, th0 = jnp.asarray(h0), torch.as_tensor(h0)
    _check(jreadouts.CommonGGNNReadout(D), readouts.CommonGGNNReadout(
        2 * H, D), (jh, jh0, jm), (th, th0, tm))
    _check(jreadouts.CommonGGNNReadout(D, nobias=True, activation=jnp.tanh,
                                       activation_agg=jnp.tanh),
           readouts.CommonGGNNReadout(H, D, nobias=True,
                                      activation=torch.tanh,
                                      activation_agg=torch.tanh),
           (jh, None, jm), (th, None, tm))
    _check(jreadouts.Set2Set(H), readouts.Set2Set(H), (jh, jm), (th, tm))
    _check(jreadouts.MPNNReadout(D, H), readouts.MPNNReadout(D, H), (jh, jm),
           (th, tm))
    _check(jreadouts.NFPReadout(D), readouts.NFPReadout(H, D), (jh, jm),
           (th, tm))
    _check(jggnn.GatedReadout(D), ggnn.GatedReadout(H, H, D), (jh, jh0, jm),
           (th, th0, tm))


ENCODERS = [
    ("relgcn", lambda: jrelgcn.RelGCN(out_dim=D, hidden_dim=H, n_layers=L),
     lambda: relgcn.RelGCN(out_dim=D, hidden_dim=H, n_layers=L)),
    ("relgcn-scaled",
     lambda: jrelgcn.RelGCN(out_dim=D, hidden_dim=H, n_layers=2,
                            scale_adj=True),
     lambda: relgcn.RelGCN(out_dim=D, hidden_dim=H, n_layers=2,
                           scale_adj=True)),
    ("gin-tied", lambda: jgin.GIN(out_dim=D, hidden_dim=H, n_layers=L,
                                  dropout_ratio=0.0),
     lambda: gin.GIN(out_dim=D, hidden_dim=H, n_layers=L, dropout_ratio=0.0)),
    ("gin-untied-concat",
     lambda: jgin.GIN(out_dim=D, hidden_dim=H, n_layers=L, dropout_ratio=0.0,
                      weight_tying=False, concat_hidden=True),
     lambda: gin.GIN(out_dim=D, hidden_dim=H, n_layers=L, dropout_ratio=0.0,
                     weight_tying=False, concat_hidden=True)),
    ("nfp", lambda: jnfp.NFP(out_dim=D, hidden_dim=H, n_layers=L),
     lambda: nfp.NFP(out_dim=D, hidden_dim=H, n_layers=L)),
    ("nfp-concat", lambda: jnfp.NFP(out_dim=D, hidden_dim=H, n_layers=2,
                                    concat_hidden=True),
     lambda: nfp.NFP(out_dim=D, hidden_dim=H, n_layers=2,
                     concat_hidden=True)),
    ("mpnn-tied", lambda: jmpnn.MPNN(out_dim=D, hidden_dim=H, n_layers=2),
     lambda: mpnn.MPNN(out_dim=D, hidden_dim=H, n_layers=2)),
    ("mpnn-untied-concat",
     lambda: jmpnn.MPNN(out_dim=D, hidden_dim=H, n_layers=2,
                        weight_tying=False, concat_hidden=True),
     lambda: mpnn.MPNN(out_dim=D, hidden_dim=H, n_layers=2,
                       weight_tying=False, concat_hidden=True)),
]


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("name,jax_enc,port_enc", ENCODERS,
                         ids=[e[0] for e in ENCODERS])
def test_padded_encoders_match_jax(batch, name, jax_enc, port_enc, masked):
    (ja, jadj, jm), (ta, tadj, tm) = _side(batch, 2)
    jm, tm = (jm, tm) if masked else (None, None)
    _check(jax_enc(), port_enc(), (ja, jadj, jm), (ta, tadj, tm))


def test_mpnn_background_without_mask_depends_on_the_pad(batch):
    """mask=None sums EdgeNet's non-edge background over every padded
    slot, as the reference does: more padding, other states."""
    torch.manual_seed(0)
    net = mpnn.EdgeNet(H)
    _, (ta, tadj, tm) = _side(batch)
    h = torch.randn(ta.shape + (H,))
    wide_h = torch.cat([h, torch.randn(h.shape[0], 4, H)], dim=1)
    wide_adj = torch.nn.functional.pad(tadj, (0, 4, 0, 4))
    wide_m = torch.nn.functional.pad(tm, (0, 4))
    n = ta.shape[1]
    same = net(wide_h, wide_adj, wide_m)[:, :n]
    torch.testing.assert_close(same, net(h, tadj, tm))
    assert not torch.allclose(net(wide_h, wide_adj)[:, :n], net(h, tadj))


@pytest.mark.parametrize("tied,concat,masked", [
    (True, False, True), (False, False, False), (False, True, True)],
    ids=["tied", "untied-nomask", "untied-concat"])
def test_ggnn_gwm_matches_jax(batch, tied, concat, masked):
    (ja, jadj, jm), (ta, tadj, tm) = _side(batch)
    s = batch.super1
    kw = dict(out_dim=D, hidden_dim=H, hidden_dim_super=H, n_layers=2,
              weight_tying=tied, concat_hidden=concat)
    jm, tm = (jm, tm) if masked else (None, None)
    _check(jgwm.GGNN_GWM(**kw), gwm.GGNN_GWM(**kw),
           (ja, jadj, jnp.asarray(s), jm),
           (ta, tadj, torch.as_tensor(s), tm))


# ---------------------------------------------------------------------------
# refusals and dropout


@pytest.mark.parametrize("kw,match", [
    pytest.param(dict(use_attention=True), None, id="kw0-item 9"),
    pytest.param(dict(context=True), None, id="kw1-item 9"),
    pytest.param(dict(message_function="edge_network"), None,
                 id="kw2-item 9"),
    pytest.param(dict(readout_function="set2vec"), None, id="kw3-item 9"),
    (dict(batch_normalization=True), "ScopeCollectionNotFound")])
def test_ggnn_refuses_what_the_port_lacks(batch, kw, match):
    """Batch normalization and ``update_attention`` stay refused; the
    research options, refused until the port had them, build and run
    (tests/test_torch_ggnn_options.py holds them against JAX)."""
    if match is None:
        _, (ta, tadj, tm) = _side(batch)
        model = ggnn.GGNN(out_dim=D, hidden_dim=H, n_layers=2, **kw)
        from_jax_params(init_module_params(model, 0), model)
        g, _ = model(ta, tadj, tm)
        assert g.shape == (8, D) and torch.isfinite(g).all()
    else:
        with pytest.raises(ValueError, match=match):
            ggnn.GGNN(out_dim=D, hidden_dim=H, **kw)
    with pytest.raises(NotImplementedError, match="update_with_attention"):
        ggnn.GGNN(out_dim=D, hidden_dim=H, update_attention=True)


def test_dropout_keep_rate_scale_and_bits():
    x = torch.ones(200_000)
    assert layers.dropout(x, 0.3) is x  # deterministic: identity
    with pytest.raises(ValueError, match="Generator"):
        layers.dropout(x, 0.3, deterministic=False)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(11)
        outs.append(layers.dropout(x, 0.3, False, gen))
    assert torch.equal(outs[0], outs[1])
    kept = outs[0] != 0
    p = 0.7
    se = np.sqrt(p * (1 - p) / x.numel())
    assert abs(kept.float().mean().item() - p) < 4 * se
    torch.testing.assert_close(outs[0][kept], torch.full_like(
        outs[0][kept], 1 / p))


def test_ggnn_dropout_in_training_only(batch):
    _, (ta, tadj, tm) = _side(batch)
    torch.manual_seed(0)
    model = ggnn.GGNN(out_dim=D, hidden_dim=H, n_layers=L, dropout_rate=0.5)
    for p in model.parameters():
        torch.nn.init.normal_(p)
    ref = model(ta, tadj, tm)[0]
    torch.testing.assert_close(model(ta, tadj, tm, deterministic=True)[0], ref)
    gens = [torch.Generator().manual_seed(4) for _ in range(2)]
    a = model(ta, tadj, tm, False, gens[0])[0]
    b = model(ta, tadj, tm, False, gens[1])[0]
    assert torch.equal(a, b) and not torch.allclose(a, ref)
