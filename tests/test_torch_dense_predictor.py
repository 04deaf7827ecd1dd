"""The port's dense packed predictors against the JAX package's, on the
CPU, on the same dense batch (``pack_pair_dataset_batch``) and weights
(``convert.from_jax_params``):

- ``PackedPairPredictor`` (``make_packed_predictor(..., compact=False)``)
  against the JAX dense ``PackedPairPredictor`` for GGNN in the K2, K1 and
  two-pass (K1m/K3) forms of the kernel path (the wrappers' plain
  versions here), MPNN (K5, K4), RelGCN, GIN, NFP and GGNN with the
  ``gru`` layer aggregator; ``PackedPairPredictorCOO`` over
  ``coo_batch_args`` and ``PackedGWMPairPredictor`` against theirs:
  logits within atol = rtol = 1e-5 (GIN rtol 1e-4, as
  tests/test_torch_packed_path.py holds it), every gradient within
  1e-4 max|want| + 1e-6.

``fused_pair_logits`` and the kernel wrappers on the dense adjacency:
tests/test_torch_dense_fused.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.data import packing as jpacking
from gcnbmp_tpu.models import gwm as jgwm
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.train import loop as jloop
from gcnbmp_tpu_torch.convert import from_jax_params, init_params, named_to_tree
from gcnbmp_tpu_torch.data import CSVPairParser
from gcnbmp_tpu_torch.data import packing as tpacking
from gcnbmp_tpu_torch.models import gwm
from gcnbmp_tpu_torch.models import packed as tpacked
from gcnbmp_tpu_torch.ops import fused_ggnn as fg
from gcnbmp_tpu_torch.train import loop

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_train.csv")
ATOL = RTOL = 1e-5
GIN_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
N_PAIRS = 10
# (id, make_packed_predictor kwargs, FUSED_READOUT, TWOPASS)
PREDICTORS = [
    ("ggnn-k2", dict(method="ggnn", weight_tying=False), True, False),
    ("ggnn-k1", dict(method="ggnn"), False, False),
    ("ggnn-twopass", dict(method="ggnn", weight_tying=False), False, True),
    ("mpnn", dict(method="mpnn"), True, False),
    ("relgcn", dict(method="relgcn"), True, False),
    ("gin-untied", dict(method="gin", weight_tying=False), True, False),
    ("nfp", dict(method="nfp"), True, False),
    ("ggnn-gru", dict(method="ggnn", weight_tying=False,
                      layer_aggregator="gru"), True, False),
]


def _dataset(n=N_PAIRS, skip=0):
    df = pd.read_csv(PAIRS).iloc[skip:skip + n]
    return CSVPairParser().parse(df).dataset


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_grads_close(model, want):
    got = _flat(named_to_tree(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in model.named_parameters()}))
    want = _flat(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        bound = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL
        err = float(np.abs(got[key] - w).max())
        assert err <= bound, f"{key}: {err} > {bound}"


class _form:
    """The GGNN kernel path's form for the duration of a block."""

    def __init__(self, fused_readout, twopass):
        self.flags = (fused_readout, twopass)

    def __enter__(self):
        self.saved = (tpacked.FUSED_READOUT, fg.TWOPASS)
        tpacked.FUSED_READOUT, fg.TWOPASS = self.flags

    def __exit__(self, *exc):
        tpacked.FUSED_READOUT, fg.TWOPASS = self.saved


def _jax_loss_and_grads(jpred, tree, args, labels, apply=None):
    apply = apply or (lambda p, *a: jpred.apply({"params": p}, *a))

    def jloss(params):
        logits = apply(params, *(jnp.asarray(a) for a in args))
        return jloop.sigmoid_cross_entropy(
            logits.reshape(labels.shape), jnp.asarray(labels)), logits

    (loss, logits), grads = jax.value_and_grad(jloss, has_aux=True)(tree)
    return float(loss), np.asarray(logits), grads


def _port_loss(model, args, labels, fn=None):
    logits = (fn or model)(*(a if torch.is_tensor(a) else
                             torch.as_tensor(np.asarray(a)) for a in args))
    loss = loop.sigmoid_cross_entropy(logits, torch.as_tensor(labels))
    loss.backward()
    return loss.item(), logits.detach().numpy()


@pytest.mark.parametrize("name,kw,fused_readout,twopass", PREDICTORS,
                         ids=[p[0] for p in PREDICTORS])
def test_dense_predictor_matches_jax(name, kw, fused_readout, twopass):
    cfg = dict(kw, fp_hidden_dim=16, fp_out_dim=16, conv_layers=2,
               sim_method="hole")
    batch = tpacking.pack_pair_dataset_batch(_dataset(),
                                             list(range(N_PAIRS)))
    args = tpacked.dense_batch_args(batch)
    labels = np.asarray(batch.labels, np.float32)
    tree = init_params(cfg, seed=6)
    jpred = jpacked.make_packed_predictor(**cfg)
    assert isinstance(jpred, jpacked.PackedPairPredictor)
    want_loss, want_logits, want = _jax_loss_and_grads(jpred, tree, args,
                                                       labels)
    model = from_jax_params(
        tree, tpacked.make_packed_predictor(**cfg, compact=False))
    assert isinstance(model, tpacked.PackedPairPredictor)
    launches = (fg.fused_ggnn_mid.launches, fg.fused_ggnn.launches)
    with _form(fused_readout, twopass):
        loss, logits = _port_loss(model, args, labels)
    # on the CPU the wrappers run their plain versions and count nothing
    assert (fg.fused_ggnn_mid.launches, fg.fused_ggnn.launches) == launches
    rtol = GIN_RTOL if kw["method"] == "gin" else RTOL
    np.testing.assert_allclose(logits, want_logits, rtol=rtol, atol=ATOL)
    np.testing.assert_allclose(loss, want_loss, rtol=rtol, atol=ATOL)
    _assert_grads_close(model, want)


@pytest.mark.parametrize("method", ["ggnn", "relgcn"])
def test_coo_predictor_matches_jax(method):
    cfg = dict(method=method, fp_hidden_dim=16, fp_out_dim=16, conv_layers=2,
               weight_tying=False, sim_method="hole")
    batch = tpacking.pack_pair_dataset_coo(_dataset(), list(range(N_PAIRS)),
                                           num_tiles=8, edge_capacity=640)
    args = tpacked.coo_batch_args(batch)
    labels = np.asarray(batch.labels, np.float32)
    tree = init_params(cfg, seed=2)
    jpred = jpacked.make_packed_predictor(**cfg, coo=True)
    assert isinstance(jpred, jpacked.PackedPairPredictorCOO)
    want_loss, want_logits, want = _jax_loss_and_grads(jpred, tree, args,
                                                       labels)
    model = from_jax_params(tree, tpacked.make_packed_predictor(
        **cfg, coo=True, compact=False))
    assert isinstance(model, tpacked.PackedPairPredictorCOO)
    loss, logits = _port_loss(model, args, labels)
    np.testing.assert_allclose(logits, want_logits, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL, atol=ATOL)
    _assert_grads_close(model, want)


@pytest.mark.parametrize("weight_tying", [True, False],
                         ids=["tied", "untied"])
def test_gwm_predictor_matches_jax(weight_tying):
    cfg = dict(method="ggnn-gwm", fp_hidden_dim=16, fp_out_dim=16,
               conv_layers=2, weight_tying=weight_tying, sim_method="hole")
    idx = list(range(N_PAIRS))
    batch = tpacking.pack_pair_dataset_batch(
        _dataset(), idx, supernode_fn=gwm.default_supernode_fn())
    jbatch = jpacking.pack_pair_dataset_batch(
        _dataset(), idx, supernode_fn=jgwm.default_supernode_fn())
    assert batch.supers.tobytes() == jbatch.supers.tobytes()
    args = (batch.atom_ids, batch.adj, batch.supers, batch.mol_id,
            batch.node_mask, batch.left_index, batch.right_index)
    labels = np.asarray(batch.labels, np.float32)
    tree = init_params(cfg, seed=3)
    jpred = jpacked.make_packed_predictor(**cfg)
    assert isinstance(jpred, jgwm.PackedGWMPairPredictor)
    want_loss, want_logits, want = _jax_loss_and_grads(jpred, tree, args,
                                                       labels)
    model = from_jax_params(tree, tpacked.make_packed_predictor(
        **cfg, compact=False))
    assert isinstance(model, gwm.PackedGWMPairPredictor)
    loss, logits = _port_loss(model, args, labels)
    np.testing.assert_allclose(logits, want_logits, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL, atol=ATOL)
    _assert_grads_close(model, want)
    with pytest.raises(ValueError, match="dense packed or wire-compact"):
        tpacked.make_packed_predictor(**cfg, coo=True, compact=False)
