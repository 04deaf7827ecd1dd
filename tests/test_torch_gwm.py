"""The port's GGNN-GWM (models/gwm.py) against the JAX package on the CPU:

- the supernode features of every drug of dataset/synth546, bit for bit;
- ``segment_softmax`` and its gradient, with an empty molecule and the
  pad segment;
- the encoder, and the pair predictor, tied and untied, against the JAX
  wire-compact COO predictor and against the JAX dense one (which the
  JAX trainer runs for ``packed``, where the port runs its compact
  predictor): logits, loss and every parameter gradient;
- three train steps on coo and one scan chunk of two steps against the
  JAX steps, the supernode table through ``stage_chunk`` bit for bit.

The CLIs and the refusals: tests/test_torch_gwm_cli.py.  Inputs are the
first pairs of dataset/synth546's drug train split at H = D = 8; weights
come from ``convert.init_params`` with a seed."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.data.packing import (
    attach_supers_coo as jattach_supers_coo,
    pack_pair_dataset_batch as jpack_pair_dataset_batch,
    pack_pair_dataset_coo as jpack_pair_dataset_coo)
from gcnbmp_tpu.models import gwm as jgwm
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.train import loop as jloop
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu_torch.convert import (
    from_jax_params, init_params, named_to_tree, to_jax_params)
from gcnbmp_tpu_torch.data import CSVPairParser, estimate_coo_capacities
from gcnbmp_tpu_torch.data.packing import (
    attach_supers_coo, pack_pair_dataset_coo)
from gcnbmp_tpu_torch.data.wire import compact_gwm_arrays, scan_chunk_iterator
from gcnbmp_tpu_torch.models import gwm
from gcnbmp_tpu_torch.models import packed as tpacked
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.config import TrainConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_train.csv")
DRUGS = os.path.join(ROOT, "dataset", "synth546", "drug_list.csv")
ATOL = RTOL = 1e-5           # logits and losses
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # per tensor: rtol * max|want| + atol


def _dataset(n, skip=0):
    df = pd.read_csv(PAIRS).iloc[skip:skip + n]
    return CSVPairParser().parse(df).dataset


def _cfg(tied=True, layers=3, **kw):
    return dict(method="ggnn-gwm", fp_hidden_dim=8, fp_out_dim=8,
                conv_layers=layers, weight_tying=tied, sim_method="hole",
                **kw)


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


def _grads(module):
    return named_to_tree({n: torch.zeros_like(p) if p.grad is None else p.grad
                          for n, p in module.named_parameters()})


def _coo_batch(ds, n, fn, capacities=(None, None)):
    idx = list(range(n))
    tiles, cap = capacities
    return attach_supers_coo(pack_pair_dataset_coo(
        ds, idx, num_tiles=tiles, edge_capacity=cap), ds, idx, fn)


# ---------------------------------------------------------------------------
# supernode features and the segment softmax


def test_supernode_features_of_every_synth546_drug_equal_jax_bit_for_bit():
    smiles = pd.read_csv(DRUGS)["smiles"].tolist()
    fn, jfn = gwm.default_supernode_fn(), jgwm.default_supernode_fn()
    got = np.stack([fn(s) for s in smiles])
    want = np.stack([jfn(s) for s in smiles])
    assert got.shape == (len(smiles), gwm.DEFAULT_N_SUPER_FEATURE) == \
        (len(smiles), 244)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert np.abs(got).sum(1).min() > 0  # every drug parses
    # the memo hands out one read-only array per SMILES
    assert fn(smiles[0]) is fn(smiles[0]) and not fn(smiles[0]).flags.writeable
    for bad in ("", "C1CC", "not a smiles"):
        np.testing.assert_array_equal(fn(bad), jfn(bad))
        assert not fn(bad).any()


def test_segment_softmax_and_its_gradient_match_jax():
    rng = np.random.default_rng(0)
    n, k, segments = 40, 3, 6
    # segment 2 has no row, segment 4 only invalid rows, segment 5 is the
    # pad segment (invalid rows)
    ids = rng.choice([0, 1, 3, 4, 5], size=n).astype(np.int32)
    valid = ((ids != 4) & (ids != 5)).astype(np.float32)
    valid[rng.random(n) < 0.2] = 0.0
    scores = rng.normal(size=(n, k)).astype(np.float32) * 3
    cot = rng.normal(size=(n, k)).astype(np.float32)

    def jf(s):
        return jnp.sum(jpacked.segment_softmax(s, jnp.asarray(ids),
                                               jnp.asarray(valid), segments)
                       * cot)

    want = np.asarray(jpacked.segment_softmax(
        jnp.asarray(scores), jnp.asarray(ids), jnp.asarray(valid), segments))
    want_g = np.asarray(jax.grad(jf)(jnp.asarray(scores)))
    s = torch.tensor(scores, requires_grad=True)
    got = tpacked.segment_softmax(s, torch.as_tensor(ids),
                                  torch.as_tensor(valid), segments)
    (got * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(s.grad.numpy(), want_g, rtol=0, atol=1e-6)
    assert np.isfinite(got.detach().numpy()).all()
    assert not got.detach().numpy()[valid == 0].any()
    sums = np.zeros((segments, k))
    np.add.at(sums, ids, got.detach().numpy())
    np.testing.assert_allclose(sums[[0, 1, 3]], 1.0, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the encoder and the predictors against the JAX ones


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("layout", ["coo", "dense"])
def test_gwm_predictor_matches_jax(tied, layout):
    ds = _dataset(12)
    fn = gwm.default_supernode_fn()
    cfg = _cfg(tied)
    tree = init_params(cfg, seed=5)
    batch = _coo_batch(ds, 12, fn)
    wire = compact_gwm_arrays(batch)
    jfn = jgwm.default_supernode_fn()
    if layout == "coo":
        jpred = jpacked.make_packed_predictor(**cfg, coo=True, compact=True)
        # the JAX package's own compact wire equals the port's
        jbatch = jattach_supers_coo(jpack_pair_dataset_coo(ds, range(12)), ds,
                                    list(range(12)), jfn)
        jwire = jpacked.compact_gwm_arrays(jbatch)
        for a, b in zip(wire, jwire):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    else:
        jbatch = jpack_pair_dataset_batch(ds, list(range(12)),
                                          supernode_fn=jfn)
        jwire = (jbatch.atom_ids, jbatch.adj, jbatch.supers, jbatch.mol_id,
                 jbatch.node_mask, jbatch.left_index, jbatch.right_index)
        jpred = jpacked.make_packed_predictor(**cfg)
    labels = np.asarray(batch.labels, np.float32)
    assert isinstance(jpred, (jgwm.PackedGWMPairPredictorCOOCompact,
                              jgwm.PackedGWMPairPredictor))

    def jloss(params):
        logits = jpred.apply({"params": params},
                             *(jnp.asarray(a) for a in jwire))
        return jloop.sigmoid_cross_entropy(logits.reshape(labels.shape),
                                           jnp.asarray(labels)), logits

    (want_loss, want_logits), want = jax.value_and_grad(jloss, has_aux=True)(
        tree)
    model = from_jax_params(tree, tpacked.make_packed_predictor(**cfg))
    logits = model(*(torch.as_tensor(np.asarray(a)) for a in wire))
    loss = loop.sigmoid_cross_entropy(logits, torch.as_tensor(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL,
                               atol=ATOL)
    _assert_grads_close(_grads(model), want)
    assert sorted(_flat(to_jax_params(model))) == sorted(_flat(tree))


def test_gwm_encoder_matches_the_jax_module():
    """PackedGGNN_GWM alone on the dense layout: g, the atoms' and the
    supernodes' last states, and every gradient of sum(g^2)."""
    ds = _dataset(10)
    batch = jpack_pair_dataset_batch(ds, list(range(10)),
                                     supernode_fn=jgwm.default_supernode_fn())
    enc = gwm.PackedGGNN_GWM(8, 8, 8, n_layers=2, weight_tying=False)
    from gcnbmp_tpu_torch.convert import init_module_params

    tree = init_module_params(enc, seed=2)
    jenc = jgwm.PackedGGNN_GWM(out_dim=8, hidden_dim=8, hidden_dim_super=8,
                               n_layers=2, weight_tying=False)
    args = (batch.atom_ids, batch.adj, batch.supers, batch.mol_id,
            batch.node_mask)

    def jf(params):
        g, aux = jenc.apply({"params": params},
                            *(jnp.asarray(a) for a in args), batch.num_mols)
        return jnp.sum(g ** 2), (g, aux)

    (_, (want_g, want_aux)), want = jax.value_and_grad(jf, has_aux=True)(tree)
    from_jax_params(tree, enc)
    g, aux = enc(*(torch.as_tensor(a) for a in args), batch.num_mols)
    (g ** 2).sum().backward()
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(want_g),
                               rtol=RTOL, atol=ATOL)
    for key in ("atoms", "super"):
        np.testing.assert_allclose(aux[key].detach().numpy(),
                                   np.asarray(want_aux[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    _assert_grads_close(_grads(enc), want)
    with pytest.raises(ValueError, match="dropout_ratio=0"):
        gwm.PackedGGNN_GWM(8, dropout_ratio=0.1)


# ---------------------------------------------------------------------------
# training against the JAX steps


def _start(jcfg, seed):
    kwargs = tpacked.model_kwargs_from_config(json.loads(jcfg.to_json()))
    tree = init_params(kwargs, seed=seed)
    tx, _ = jloop.build_optimizer(jcfg, 1)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = from_jax_params(tree, tpacked.make_packed_predictor(**kwargs))
    opt, _ = loop.build_optimizer(TrainConfig(**json.loads(jcfg.to_json())), 1,
                                  list(model.parameters()))
    pred = jpacked.make_packed_predictor(**kwargs, coo=True, compact=True)
    return pred, tx, params, tx.init(params), model, opt


@pytest.mark.parametrize("scan", [False, True], ids=["steps", "scan-chunk"])
def test_gwm_train_steps_match_the_jax_steps(scan):
    """Three coo train steps, or one scan chunk of two, from the same
    weights: each step's loss within 1e-5 of the JAX step's.  The scan
    chunk goes through ``stage_chunk``, which carries the f32 supernode
    table by its bits."""
    jcfg = JaxTrainConfig(**_cfg(False, layers=2), compute_path="coo",
                          learning_rate=1e-2, batch_size=8,
                          scan_steps=2 if scan else 0)
    pred, tx, params, opt_state, model, opt = _start(jcfg, seed=4)
    fn = model.supernode_fn
    dss = [_dataset(8, skip=8 * i) for i in range(2 if scan else 3)]
    # one shape for every batch of the chunk
    capacities = estimate_coo_capacities(dss, 8)
    batches = [_coo_batch(d, 8, fn, capacities) for d in dss]
    got, want = [], []
    if scan:
        (stacked, labels, _), = scan_chunk_iterator(batches, 2,
                                                    compact_gwm_arrays)
        step = jloop.make_packed_scan_train_step(pred, tx)
        params, opt_state, losses = step(
            params, opt_state, tuple(jnp.asarray(a) for a in stacked),
            jnp.asarray(labels))
        want = np.asarray(losses).tolist()
        args, tlabels = loop.stage_chunk(stacked, labels, "cpu")
        assert args[3].dtype == torch.float32
        assert args[3].numpy().tobytes() == stacked[3].tobytes()
        for i in range(2):
            got.append(float(loop.train_step(model, opt, [a[i] for a in args],
                                             tlabels[i])))
    else:
        step = jloop.make_packed_coo_train_step(pred, tx)
        for batch in batches:
            wire = compact_gwm_arrays(batch)
            labels = np.asarray(batch.labels, np.float32)
            params, opt_state, loss, _ = step(
                params, opt_state, tuple(jnp.asarray(a) for a in wire),
                jnp.asarray(labels))
            want.append(float(loss))
            got.append(float(loop.train_step(
                model, opt, [torch.as_tensor(np.asarray(a)) for a in wire],
                torch.as_tensor(labels))))
    # each loss after the first reads the weights the steps before it
    # updated
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
