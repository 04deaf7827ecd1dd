"""MPNN's ``ggnn`` forms in the port against the JAX package on the CPU:
``message_func='ggnn'`` (a GGNN message, the GRU reading [h ‖ m]) and
``readout_func='ggnn'`` (the common readout over [h ‖ h0], per layer
under ``concat_hidden`` too), alone and together, tied and untied.

- The padded ``MPNN`` against the JAX module on a padded batch of
  synth546 drug train pairs, masked and ``mask=None``: g within 1e-5,
  every gradient within 1e-4 max|want| + 1e-6.
- The packed ``PackedMPNN`` against the JAX module: its plain stack on
  the dense tile adjacency, and ``encode`` (the predictors' path: K5 and
  the common readout for EdgeNet, K4 for the Set2Set readout, through
  their plain twins here) against the JAX module's fused branch in
  interpret mode and its XLA path: g and the per-atom states within
  1e-5, every gradient within 1e-4 max|want| + 1e-6.
- The trees swap: the packed and padded modules take each other's
  weights and give each molecule the same g (masked padded batch)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcnbmp_tpu.data.dataset import make_batch as jmake_batch
from gcnbmp_tpu.data.packing import pack_pair_dataset_coo
from gcnbmp_tpu.data.parsers import CSVPairParser
from gcnbmp_tpu.models import mpnn as jmpnn
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu_torch.convert import (
    from_jax_params, init_module_params, named_to_tree, to_jax_params)
from gcnbmp_tpu_torch.models import mpnn, packed
from gcnbmp_tpu_torch.ops import fused_mpnn as tfm
from gcnbmp_tpu_torch.ops import set2set_kernel as tsk
from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_train.csv")
ATOL = RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
H, D, L = 8, 6, 3
N_MAX = 32  # bounds every molecule of the first pairs
FORMS = {"ggnn-message": dict(message_func="ggnn"),
         "ggnn-readout": dict(readout_func="ggnn"),
         "ggnn-both": dict(message_func="ggnn", readout_func="ggnn")}


def _dataset(n):
    return CSVPairParser().parse(pd.read_csv(PAIRS).head(n)).dataset


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _nudged(params):
    """Non-zero biases, so every term shows in the gradients."""
    return jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(2), x.shape),
        params)


def _hold(got_outs, want_outs, model, want_grads):
    for x, y in zip(got_outs, want_outs):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(y),
                                   rtol=RTOL, atol=ATOL)
    got = _flat(named_to_tree({n: torch.zeros_like(p) if p.grad is None
                               else p.grad
                               for n, p in model.named_parameters()}))
    want = _flat(want_grads)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        bound = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL
        assert float(np.abs(got[key] - w).max()) <= bound, key


@pytest.fixture(scope="module")
def padded():
    return jmake_batch(_dataset(6), list(range(6)), fill_batch_to=8)


@pytest.fixture(scope="module")
def packed_batch():
    return pack_pair_dataset_coo(_dataset(8), list(range(8)))


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("tied,concat", [(True, False), (False, True)],
                         ids=["tied", "untied-concat"])
@pytest.mark.parametrize("form", FORMS)
def test_padded_mpnn_form_matches_jax(padded, form, tied, concat, masked):
    a, adj, m = padded.atoms1, padded.adj1, padded.mask1
    jm, tm = (jnp.asarray(m), torch.as_tensor(m)) if masked else (None, None)
    kw = dict(out_dim=D, hidden_dim=H, n_layers=L, weight_tying=tied,
              concat_hidden=concat, **FORMS[form])
    jmod, tmod = jmpnn.MPNN(**kw), mpnn.MPNN(**kw)
    jargs = (jnp.asarray(a), jnp.asarray(adj), jm)
    params = _nudged(jmod.init(jax.random.PRNGKey(1), *jargs)["params"])
    from_jax_params(jax.tree_util.tree_map(np.asarray, params), tmod)
    want = np.asarray(jmod.apply({"params": params}, *jargs)[0])
    w = np.random.default_rng(3).standard_normal(want.shape).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(
        jmod.apply({"params": p}, *jargs)[0] * w))(params)
    g, _ = tmod(torch.as_tensor(a), torch.as_tensor(adj), tm)
    assert g.shape == (8, D * (L if concat else 1)) == (8, tmod.out_width)
    (g * torch.as_tensor(w)).sum().backward()
    _hold([g], [want], tmod, grads)


def _packed_inputs(b):
    p, t = b.atom_ids.shape
    edges = [torch.as_tensor(x) for x in (b.e_tile, b.e_type, b.e_src,
                                          b.e_dst, b.e_mask)]
    tensors = [torch.as_tensor(x) for x in (b.atom_ids, b.mol_id,
                                            b.node_mask)]
    dense = adj_from_coo(*edges, num_tiles=p, tile=t)
    return tensors, edges, dense


FORMS_PACKED = dict(FORMS, edgenet=dict())


# tests/test_torch_mpnn.py holds EdgeNet with Set2Set on both routes
ROUTES = [(form, route) for form in FORMS for route in ("plain", "encode")]


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("form,route", ROUTES,
                         ids=[f"{f}-{r}" for f, r in ROUTES])
def test_packed_mpnn_form_matches_jax(packed_batch, form, tied, route):
    """``encode`` of EdgeNet with the ggnn readout is K5 -> common readout
    -> segment sum, against the JAX fused branch (interpret mode); the
    ggnn message takes the plain stack in both packages, and its Set2Set
    readout K4, as JAX's readout runs its Pallas kernel."""
    b = packed_batch
    kw = dict(out_dim=D, hidden_dim=H, n_layers=L, weight_tying=tied,
              **FORMS_PACKED[form])
    jmod = jpacked.PackedMPNN(**kw, s2s_n_max=N_MAX)
    tmod = packed.PackedMPNN(**kw, s2s_n_max=N_MAX)
    jargs = (jnp.asarray(b.atom_ids), jnp.asarray(b.to_dense().adj),
             jnp.asarray(b.mol_id), jnp.asarray(b.node_mask), b.num_mols)
    saved = jpacked.MPNN_FUSED, jpacked.SET2SET_PALLAS
    jpacked.MPNN_FUSED = jpacked.SET2SET_PALLAS = route == "encode"
    try:
        params = _nudged(jmod.init(jax.random.PRNGKey(1), *jargs)["params"])
        rng = np.random.default_rng(3)
        w_g = rng.standard_normal((b.num_mols, D)).astype(np.float32)
        w_h = rng.standard_normal(b.atom_ids.shape + (H,)).astype(np.float32)

        def jloss(p):
            g, aux = jmod.apply({"params": p}, *jargs)
            return jnp.sum(g * w_g) + jnp.sum(aux["atoms"] * w_h), (
                g, aux["atoms"])

        with pltpu.force_tpu_interpret_mode():
            (_, want), grads = jax.value_and_grad(jloss, has_aux=True)(params)
    finally:
        jpacked.MPNN_FUSED, jpacked.SET2SET_PALLAS = saved
    from_jax_params(jax.tree_util.tree_map(np.asarray, params), tmod)
    (atom_ids, mol_id, mask), edges, dense = _packed_inputs(b)
    before = (tfm.FusedMPNNFunction.backward_calls,
              tsk.FusedSet2SetFunction.backward_calls)
    if route == "plain":
        g, aux = tmod(atom_ids, dense, mol_id, mask, b.num_mols)
        h = aux["atoms"]
    else:
        g, h = tmod.encode(atom_ids, edges, mol_id, mask, b.num_mols,
                           return_atoms=True)
    ((g * torch.as_tensor(w_g)).sum() + (h * torch.as_tensor(w_h)).sum()
     ).backward()
    kernels = (route == "encode" and tmod.message_func == "edgenet",
               route == "encode" and tmod.readout_func == "set2set")
    assert (tfm.FusedMPNNFunction.backward_calls - before[0],
            tsk.FusedSet2SetFunction.backward_calls - before[1]) == kernels
    _hold([g, h], want, tmod, grads)


@pytest.mark.parametrize("form", FORMS_PACKED)
def test_packed_and_padded_trees_swap(packed_batch, form):
    """A tree drawn for the padded MPNN loads into the packed one and back
    unchanged, and both give each molecule the same g."""
    b = packed_batch
    kw = dict(out_dim=D, hidden_dim=H, n_layers=L, weight_tying=False,
              **FORMS_PACKED[form])
    pad_model = mpnn.MPNN(**kw)
    tree = init_module_params(pad_model, 4)
    from_jax_params(tree, pad_model)
    pack_model = from_jax_params(tree, packed.PackedMPNN(**kw,
                                                         s2s_n_max=N_MAX))
    assert sorted(_flat(to_jax_params(pack_model))) == sorted(_flat(tree))
    (atom_ids, mol_id, mask), edges, _ = _packed_inputs(b)
    with torch.no_grad():
        g = pack_model.encode(atom_ids, edges, mol_id, mask, b.num_mols)
        jb = jmake_batch(_dataset(8), list(range(8)))
        for side, index in ((1, b.left_index), (2, b.right_index)):
            want, _ = pad_model(*(torch.as_tensor(getattr(jb, f"{n}{side}"))
                                  for n in ("atoms", "adj", "mask")))
            np.testing.assert_allclose(g[torch.as_tensor(index).long()],
                                       want, rtol=RTOL, atol=ATOL)
