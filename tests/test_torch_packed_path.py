"""The ``packed`` compute path of the port against the JAX package on
the CPU.  The JAX trainer ships a ``packed`` batch's dense (P, 4, T, T)
adjacency from the host; the port trains ``packed`` on its wire-compact
COO predictor, the adjacency built on the device from the edges.  So:

- the port's COO batch, decoded from its compact wire with the dense
  adjacency built from its edges (``adj_from_coo``), against the JAX
  ``pack_pair_dataset_batch``, array for array (``supers`` included), and
  the port's ``packed_coo_batch_iterator`` against the JAX
  ``packed_batch_iterator``: the same pairs in the same order;
- the port's predictor for ``packed`` on its compact wire against the
  JAX dense ``PackedPairPredictor`` on the dense batch, for GGNN (the
  kernel wrappers on their plain versions, in the K2 form and the K1
  form), MPNN (K5, K4), RelGCN, GIN, NFP and GGNN with the ``gru``
  aggregator: logits within atol = rtol = 1e-5 (GIN: rtol 1e-4, as
  tests/test_torch_encoders_slice.py holds it: its unnormalized sums make
  logits of hundreds, whose f32 sums in another order differ by a few
  1e-5 relative), every gradient within 1e-4 max|want| + 1e-6;
- the configurations the port trains against the JAX package's, case
  for case.

Two train steps per method against the JAX packed steps:
tests/test_torch_packed_train.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.data.packing import (
    pack_pair_dataset_batch as jpack_pair_dataset_batch)
from gcnbmp_tpu.models import gwm as jgwm
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.train import loop as jloop
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu_torch.convert import from_jax_params, init_params, named_to_tree
from gcnbmp_tpu_torch.data import CSVPairParser, estimate_coo_capacities
from gcnbmp_tpu_torch.data.packing import (
    attach_supers_coo, pack_pair_dataset_coo)
from gcnbmp_tpu_torch.data.wire import (
    compact_coo_arrays, packed_coo_batch_iterator)
from gcnbmp_tpu_torch.models import gwm
from gcnbmp_tpu_torch.models import packed as tpacked
from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.config import TrainConfig

torch.set_num_threads(1)

PAIRS = "dataset/synth546/drug/ddi_drug_train.csv"
ATOL = RTOL = 1e-5
GIN_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# (id, make_packed_predictor kwargs, the GGNN kernel form's FUSED_READOUT)
PREDICTORS = [
    ("ggnn-k2", dict(method="ggnn"), True),
    ("ggnn-k1-untied", dict(method="ggnn", weight_tying=False), False),
    ("mpnn", dict(method="mpnn"), True),
    ("relgcn", dict(method="relgcn"), True),
    ("gin-untied", dict(method="gin", weight_tying=False), True),
    ("nfp", dict(method="nfp"), True),
    ("ggnn-gru", dict(method="ggnn", weight_tying=False,
                      layer_aggregator="gru"), True),
]


def _dataset(n, skip=0):
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    df = pd.read_csv(os.path.join(root, PAIRS)).iloc[skip:skip + n]
    return CSVPairParser().parse(df).dataset


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_grads_close(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        bound = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL
        err = float(np.abs(got[key] - w).max())
        assert err <= bound, f"{key}: {err} > {bound}"


def _as_dense(batch):
    """The port's COO batch as the JAX dense batch holds it: decoded from
    the compact wire, the adjacency built from the decoded edges."""
    nodes, e_packed, n_edges, left, right = (
        torch.as_tensor(np.asarray(a)) for a in compact_coo_arrays(batch))
    atom_ids, mol_id, node_mask, *edges = tpacked.decode_compact_wire(
        nodes, e_packed, n_edges, batch.num_mols)
    p, t = atom_ids.shape
    adj = adj_from_coo(*edges, num_tiles=p, tile=t)
    return tuple(a.numpy() for a in (atom_ids, adj, mol_id, node_mask, left,
                                     right)) + (batch.labels,)


def _dense_arrays(b):
    return (b.atom_ids, b.adj, b.mol_id, b.node_mask, b.left_index,
            b.right_index, b.labels)


# ---------------------------------------------------------------------------
# the batch


@pytest.mark.parametrize("supers", [False, True], ids=["plain", "supers"])
@pytest.mark.parametrize("num_tiles", [None, 9])
def test_dense_batch_equals_jax(supers, num_tiles):
    """The port's packed-path batch holds, once on the device, the JAX
    dense batch bit for bit."""
    ds = _dataset(24)
    idx = list(np.random.default_rng(1).permutation(24)[:20])
    got = pack_pair_dataset_coo(ds, idx, num_tiles=num_tiles)
    if supers:
        got = attach_supers_coo(got, ds, idx, gwm.default_supernode_fn())
    want = jpack_pair_dataset_batch(
        ds, idx, num_tiles=num_tiles,
        supernode_fn=jgwm.default_supernode_fn() if supers else None)
    for a, b in zip(_as_dense(got), _dense_arrays(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()
    assert (got.supers is None) == (not supers)
    if supers:
        assert got.supers.tobytes() == want.supers.tobytes()
    assert (got.num_mols, got.num_edges) == (want.num_mols, want.num_edges)


def test_packed_batch_iterator_matches_the_jax_one():
    """The port's iterator gives the JAX dense iterator's pairs in its
    order for the same generator, with the same supernode tables, and
    ``reuse_packs`` keeps them."""
    ds = _dataset(40)
    tiles, cap = estimate_coo_capacities([ds], 8)
    fn, jfn = gwm.default_supernode_fn(), jgwm.default_supernode_fn()
    want = list(jloop.packed_batch_iterator(ds, 8, tiles,
                                            np.random.default_rng(3),
                                            supernode_fn=jfn))
    cache = []
    got = list(packed_coo_batch_iterator(ds, 8, tiles, cap,
                                         np.random.default_rng(3),
                                         supernode_fn=fn, pack_workers=2,
                                         pack_cache=cache))
    assert len(got) == len(want) == len(cache) == 5
    for a, b in zip(got, want):
        for x, y in zip(_as_dense(a), _dense_arrays(b)):
            assert x.tobytes() == y.tobytes()
        assert a.supers.tobytes() == b.supers.tobytes()
    # the cache keeps the batches with their supernode tables
    assert all(c.supers is not None for c in cache)
    again = list(packed_coo_batch_iterator(ds, 8, tiles, cap,
                                           np.random.default_rng(4),
                                           pack_cache=cache))
    assert sorted(a.supers.tobytes() for a in again) == \
        sorted(a.supers.tobytes() for a in got)


# ---------------------------------------------------------------------------
# the predictor against the JAX dense one


@pytest.mark.parametrize("name,kw,fused_readout", PREDICTORS,
                         ids=[p[0] for p in PREDICTORS])
def test_dense_predictor_matches_jax(name, kw, fused_readout):
    """What the port trains for ``packed`` (its compact-COO predictor)
    against the JAX dense predictor on the same pairs and weights."""
    cfg = dict(kw, fp_hidden_dim=8, fp_out_dim=8, conv_layers=3,
               sim_method="hole")
    ds = _dataset(12)
    jbatch = jpack_pair_dataset_batch(ds, list(range(12)))
    jwire = _dense_arrays(jbatch)[:-1]
    batch = pack_pair_dataset_coo(ds, list(range(12)))
    labels = np.asarray(jbatch.labels, np.float32)
    tree = init_params(cfg, seed=6)
    jpred = jpacked.make_packed_predictor(**cfg)
    assert isinstance(jpred, jpacked.PackedPairPredictor)

    def jloss(params):
        logits = jpred.apply({"params": params},
                             *(jnp.asarray(a) for a in jwire))
        return jloop.sigmoid_cross_entropy(logits.reshape(labels.shape),
                                           jnp.asarray(labels)), logits

    (want_loss, want_logits), want = jax.value_and_grad(jloss, has_aux=True)(
        tree)
    trainer_model = tpacked.make_packed_predictor(**cfg)
    assert isinstance(trainer_model, tpacked.PackedPairPredictorCOOCompact)
    saved = tpacked.FUSED_READOUT
    tpacked.FUSED_READOUT = fused_readout
    try:
        model = from_jax_params(tree, trainer_model)
        logits = model(*(torch.as_tensor(np.asarray(a))
                         for a in model.wire_encoder([ds])(batch)))
        loss = loop.sigmoid_cross_entropy(logits, torch.as_tensor(labels))
        loss.backward()
    finally:
        tpacked.FUSED_READOUT = saved
    rtol = GIN_RTOL if kw["method"] == "gin" else RTOL
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               rtol=rtol, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=rtol,
                               atol=ATOL)
    _assert_grads_close(named_to_tree(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in model.named_parameters()}), want)


# ---------------------------------------------------------------------------
# what the port trains, against the JAX package


METHODS = ["ggnn", "mpnn", "relgcn", "gin", "nfp", "ggnn-gwm"]


def _jax_refuses(cfg: JaxTrainConfig) -> bool:
    """The JAX trainer's refusal of a packed-family configuration: its
    ``packed_config_problems`` (co-attention allowed on coo only), then
    its factory's, as the Trainer calls them (loop.py:773-832); on the
    padded layout only ``set_up_predictor``'s (loop.py:702-718)."""
    if cfg.compute_path == "padded":
        from gcnbmp_tpu.models import set_up_predictor

        try:
            set_up_predictor(
                method=cfg.method, attn_model=cfg.attn,
                layer_aggregator=cfg.layer_aggregator,
                fp_dropout_rate=cfg.fp_dropout_rate)
        except ValueError:
            return True
        return False
    coo = cfg.compute_path in ("coo", "fused")
    if jloop.packed_config_problems(
            cfg, allow_attn=cfg.compute_path == "coo"):
        return True
    try:
        jpacked.make_packed_predictor(
            method=cfg.method, compact=coo,
            attn=cfg.attn if coo else None,
            layer_aggregator=cfg.layer_aggregator)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("method", METHODS)
def test_config_problems_refuse_what_jax_refuses(method):
    """Every combination of layout, scan mode, co-attention, layer
    aggregator and dropout: the port refuses exactly what the JAX
    trainer refuses (MPNN with co-attention on coo included: it trains
    through K5/K5b and K4/K4b)."""
    cases = 0
    for path in ("fused", "coo", "packed", "padded"):
        for scan in (0, 4):
            for attn in (None, "para"):
                for agg in (None, "gru"):
                    for dropout in (0.0, 0.1):
                        kw = dict(method=method, compute_path=path,
                                  scan_steps=scan, attn=attn,
                                  layer_aggregator=agg,
                                  fp_dropout_rate=dropout)
                        port = loop.config_problems(TrainConfig(**kw))
                        assert bool(port) == _jax_refuses(
                            JaxTrainConfig(**kw)), (kw, port)
                        cases += 1
    assert cases == 64
    assert loop.config_problems(TrainConfig(method=method)) == []  # padded
