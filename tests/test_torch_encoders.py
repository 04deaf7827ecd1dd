"""The port's remaining packed encoders against the JAX package on the
CPU: RelGCN, GIN (tied and untied), NFP and GGNN with each layer
aggregator mode.

- the parameter tree of each against the flax predictor's, its
  initializers (the GRU aggregator's hidden kernels orthogonal) and the
  converter's round trip;
- each plain encoder against the JAX packed module on the dense
  adjacency: the molecule embeddings, the last layer's atom states and
  every parameter gradient; RelGCN's edge layout and NFP's degree rule.

Their predictors, training and CLIs: tests/test_torch_encoders_slice.py.
Inputs are the first pairs of dataset/synth546's drug train split at
small widths; weights come from ``convert.init_params`` with a seed.  No
kernel computes these encoders, in either package."""


import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.data.packing import pack_pair_dataset_coo
from gcnbmp_tpu.data.parsers import CSVPairParser
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu_torch.convert import (
    from_jax_params, init_params, named_to_tree, to_jax_params)
from gcnbmp_tpu_torch.data.wire import compact_coattn_arrays, compact_coo_arrays
from gcnbmp_tpu_torch.models import ggnn_extras
from gcnbmp_tpu_torch.models import packed as tpacked
from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_train.csv")
RTOL, ATOL = 1e-4, 1e-5  # outputs and gradients (test_torch_slice.py:35)
N_MAX = 32               # co-attention atom table width: bounds every molecule
# (name, make_packed_predictor kwargs); a JAX module's kwargs by method
ENCODERS = [
    ("relgcn", dict(method="relgcn")),
    ("gin-tied", dict(method="gin", weight_tying=True)),
    ("gin-untied", dict(method="gin", weight_tying=False)),
    ("nfp", dict(method="nfp")),
] + [(f"ggnn-{m}", dict(method="ggnn", weight_tying=False,
                        layer_aggregator=m)) for m in ggnn_extras.MODES]


def _dataset(n, skip=0):
    df = pd.read_csv(PAIRS).iloc[skip:skip + n]
    return CSVPairParser().parse(df).dataset


def _cfg(layers=3, hidden=8, out=8, **kw):
    return dict(fp_hidden_dim=hidden, fp_out_dim=out, conv_layers=layers, **kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                   err_msg=key)


def _grads(module):
    return named_to_tree({n: torch.zeros_like(p) if p.grad is None else p.grad
                          for n, p in module.named_parameters()})


def _jax_encoder(kw, out, hidden, layers, **extra):
    method = kw["method"]
    common = dict(out_dim=out, hidden_dim=hidden, n_layers=layers)
    if method == "relgcn":
        return jpacked.PackedRelGCN(**common, **extra)
    if method == "gin":
        return jpacked.PackedGIN(**common, weight_tying=kw["weight_tying"])
    if method == "nfp":
        return jpacked.PackedNFP(**common)
    return jpacked.PackedGGNN(**common, weight_tying=kw["weight_tying"],
                              layer_aggregator=kw["layer_aggregator"])


# ---------------------------------------------------------------------------
# the parameter tree


@pytest.mark.parametrize("name,kw", ENCODERS + [
    ("relgcn-para", dict(method="relgcn", attn="para", sim_method="ntn"))],
    ids=lambda x: x if isinstance(x, str) else "")
def test_param_tree_matches_flax_and_round_trips(name, kw):
    cfg = _cfg(**kw, class_num=2)
    batch = pack_pair_dataset_coo(_dataset(4), list(range(4)))
    if "attn" in kw:
        wire, port_kw = compact_coattn_arrays(batch, N_MAX), dict(coattn_n_max=N_MAX)
    else:
        wire, port_kw = compact_coo_arrays(batch), {}
    flax_tree = jpacked.make_packed_predictor(**cfg, coo=True, compact=True).init(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in wire))["params"]
    tree = init_params(dict(cfg, **port_kw), seed=1)
    shapes = lambda t: {k: v.shape for k, v in _flat(t).items()}
    assert shapes(tree) == shapes(flax_tree)
    back = to_jax_params(from_jax_params(
        tree, tpacked.make_packed_predictor(**cfg, **port_kw)))
    _assert_trees_close(back, tree, rtol=0, atol=0)
    if kw.get("layer_aggregator", "").startswith(("gru", "lstm")):
        cells = tree["encoder"]["layer_aggregator"]
        gates = "rzn" if kw["layer_aggregator"].startswith("gru") else "ifgo"
        for cell in ("rnn_fwd", "rnn_bwd"):
            for gate in gates:
                w = cells[cell][f"h{gate}"]["kernel"]
                np.testing.assert_allclose(w.T @ w, np.eye(8), atol=1e-5)


# ---------------------------------------------------------------------------
# the plain encoders against the JAX packed modules


@pytest.mark.parametrize("name,kw", ENCODERS + [
    ("relgcn-scaled", dict(method="relgcn", scale_adj=True))],
    ids=lambda x: x if isinstance(x, str) else "")
def test_encoder_matches_the_jax_packed_module(name, kw):
    kw = dict(kw)
    scale = kw.pop("scale_adj", False)
    batch = pack_pair_dataset_coo(_dataset(8), list(range(8)))
    adj = batch.to_dense().adj
    tree = init_params(_cfg(**kw), seed=len(name))["encoder"]
    extra = {"scale_adj": True} if scale else {}
    enc = _jax_encoder(kw, 8, 8, 3, **extra)
    jargs = (jnp.asarray(batch.atom_ids), jnp.asarray(adj),
             jnp.asarray(batch.mol_id), jnp.asarray(batch.node_mask),
             batch.num_mols)

    def jloss(params):
        g, aux = enc.apply({"params": params}, *jargs)
        return jnp.sum(g ** 2) + jnp.sum(aux["atoms"] ** 2), (g, aux["atoms"])

    (_, (want_g, want_atoms)), want_grads = jax.value_and_grad(
        jloss, has_aux=True)(tree)
    model = tpacked.make_packed_predictor(**_cfg(**kw))
    from_jax_params(init_params(_cfg(**kw), seed=len(name)), model)
    model.encoder.scale_adj = scale
    p, t = batch.atom_ids.shape
    t_adj = adj_from_coo(*(torch.as_tensor(a) for a in (
        batch.e_tile, batch.e_type, batch.e_src, batch.e_dst, batch.e_mask)),
        num_tiles=p, tile=t)
    g, aux = model.encoder(torch.as_tensor(batch.atom_ids), t_adj,
                           torch.as_tensor(batch.mol_id),
                           torch.as_tensor(batch.node_mask), batch.num_mols)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(want_g),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux["atoms"].detach().numpy(),
                               np.asarray(want_atoms), rtol=RTOL, atol=ATOL)
    ((g ** 2).sum() + (aux["atoms"] ** 2).sum()).backward()
    _assert_trees_close(_grads(model.encoder), want_grads)


def test_relgcn_edge_axis_is_the_minor_one():
    """``edge`` lays its 4 * C outputs out (C, edge): output c * 4 + e is
    channel c of edge type e.  Splitting it (edge, C) computes another
    function; this holds the port to the reference layout."""
    from gcnbmp_tpu_torch.models.relgcn import RelGCNUpdate

    upd = RelGCNUpdate(2, 3)
    with torch.no_grad():
        upd.edge.dense.weight.zero_()
        upd.edge.dense.bias.copy_(torch.arange(12, dtype=torch.float32))
        getattr(upd, "self").dense.weight.zero_()
        getattr(upd, "self").dense.bias.zero_()
    adj = torch.zeros(1, 4, 2, 2)
    adj[0, 1, 0, 1] = 1.0  # atom 0 hears atom 1 over edge type 1
    out = upd(torch.zeros(1, 2, 2), adj)
    np.testing.assert_array_equal(out[0, 0].detach().numpy(), [1.0, 5.0, 9.0])


def test_nfp_atom_without_a_degree_linear_gets_the_bias_sum():
    """Degrees above max_degree + 1 select no linear: every linear still
    adds its bias, so the atom gets sigmoid(sum of biases), 0.5 at the
    zero initialization, as in the JAX module."""
    from gcnbmp_tpu_torch.models.nfp import NFPUpdate

    upd = NFPUpdate(2, 2, max_degree=1)
    with torch.no_grad():
        for d in (1, 2):
            getattr(upd, f"linear_d{d}").dense.bias.zero_()
    h = torch.ones(1, 3, 2)
    out = upd(h, torch.ones(1, 3, 3), torch.tensor([[3, 3, 5]]))
    np.testing.assert_array_equal(out.detach().numpy(), np.full((1, 3, 2), 0.5))


def test_unknown_aggregator_raises_as_in_jax():
    with pytest.raises(NotImplementedError, match="self-attn"):
        ggnn_extras.LayerAggregator("self-attn", 8, 3)
    problems = tpacked.model_problems("ggnn", "hole", None, "self-attn")
    assert len(problems) == 1 and "modes" in problems[0]
