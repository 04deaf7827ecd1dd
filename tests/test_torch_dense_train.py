"""Training on dense packed batches against the JAX package on the CPU:

- two steps of ``train.loop.train_step`` on the port's dense predictor
  (``make_packed_predictor(..., compact=False)``) over its dense batches,
  against the JAX ``make_packed_train_step`` with ``fused`` off (XLA's
  plain stack) and on (``fused_pair_logits``, its Pallas kernels in
  interpret mode), and GGNN-GWM against ``make_packed_gwm_train_step``,
  from the same weights on the same pairs: each loss within 1e-5, every
  parameter after the two steps within 1e-4 max|want| + 1e-6.  The
  readout width is 32, where both packages compute HolE by FFT (see
  tests/test_torch_packed_train.py);
- ``packed_batch_iterator`` against the JAX one: the same pairs in the
  same order for the same generator, the supernode tables with them."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcnbmp_tpu.models import gwm as jgwm
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.train import loop as jloop
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu_torch.convert import from_jax_params, init_params, named_to_tree
from gcnbmp_tpu_torch.data import CSVPairParser
from gcnbmp_tpu_torch.data import packing as tpacking
from gcnbmp_tpu_torch.models import gwm
from gcnbmp_tpu_torch.models import packed as tpacked
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.config import TrainConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_train.csv")
ATOL = RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
BATCH = 6
# (id, TrainConfig fields, the JAX step's ``fused``)
STEPS = [
    ("ggnn", dict(method="ggnn", weight_tying=False, fp_hidden_dim=32), False),
    ("ggnn-fused", dict(method="ggnn", weight_tying=False, fp_hidden_dim=32),
     True),
    ("ggnn-gwm", dict(method="ggnn-gwm", weight_tying=False,
                      fp_hidden_dim=8), False),
]


def _dataset(n, skip=0):
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


def _dense_args(batch, with_supers):
    return ((batch.atom_ids, batch.adj)
            + ((batch.supers,) if with_supers else ())
            + (batch.mol_id, batch.node_mask, batch.left_index,
               batch.right_index))


@pytest.mark.parametrize("name,kw,fused", STEPS, ids=[s[0] for s in STEPS])
def test_two_dense_train_steps_match_the_jax_steps(name, kw, fused):
    jcfg = JaxTrainConfig(**kw, fp_out_dim=32, conv_layers=2,
                          compute_path="packed", learning_rate=1e-2,
                          batch_size=BATCH)
    kwargs = tpacked.model_kwargs_from_config(json.loads(jcfg.to_json()))
    tree = init_params(kwargs, seed=8)
    gwm_model = kw["method"] == "ggnn-gwm"
    tx, _ = jloop.build_optimizer(jcfg, 1)
    jpred = jpacked.make_packed_predictor(**kwargs)
    step = (jloop.make_packed_gwm_train_step(jpred, tx) if gwm_model
            else jloop.make_packed_train_step(jpred, tx, fused=fused))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(params)
    model = from_jax_params(tree, tpacked.make_packed_predictor(
        **kwargs, compact=False))
    opt, _ = loop.build_optimizer(TrainConfig(**json.loads(jcfg.to_json())),
                                  1, list(model.parameters()))
    got, want = [], []
    for i in range(2):
        idx = list(range(BATCH))
        batch = tpacking.pack_pair_dataset_batch(
            _dataset(BATCH, skip=BATCH * i), idx,
            supernode_fn=model.supernode_fn if gwm_model else None)
        jbatch = tpacking.pack_pair_dataset_batch(
            _dataset(BATCH, skip=BATCH * i), idx,
            supernode_fn=jgwm.default_supernode_fn() if gwm_model else None)
        labels = np.asarray(batch.labels, np.float32)
        jargs = [jnp.asarray(a) for a in _dense_args(jbatch, gwm_model)]
        if fused:
            with pltpu.force_tpu_interpret_mode():
                params, opt_state, loss, _ = step(params, opt_state, *jargs,
                                                  jnp.asarray(labels))
                loss = float(loss)
        else:
            params, opt_state, loss, _ = step(params, opt_state, *jargs,
                                              jnp.asarray(labels))
        want.append(float(loss))
        got.append(float(loop.train_step(
            model, opt, [torch.as_tensor(a)
                         for a in _dense_args(batch, gwm_model)],
            torch.as_tensor(labels))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    got_p = _flat(named_to_tree({n: p.detach()
                                 for n, p in model.named_parameters()}))
    want_p = _flat(jax.tree_util.tree_map(np.asarray, params))
    assert sorted(got_p) == sorted(want_p)
    for key, w in want_p.items():
        moved = np.abs(w - _flat(tree)[key]).max()
        bound = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL
        err = float(np.abs(got_p[key] - w).max())
        assert err <= bound, f"{key}: {err} > {bound} (moved {moved})"


@pytest.mark.parametrize("supers", [False, True], ids=["plain", "supers"])
def test_packed_batch_iterator_matches_the_jax_one(supers):
    ds, jds = _dataset(28), _dataset(28)
    tiles = 9
    got = list(loop.packed_batch_iterator(
        ds, 8, tiles, np.random.default_rng(3),
        supernode_fn=gwm.default_supernode_fn() if supers else None))
    want = list(jloop.packed_batch_iterator(
        jds, 8, tiles, np.random.default_rng(3),
        supernode_fn=jgwm.default_supernode_fn() if supers else None))
    assert len(got) == len(want) == 3  # the tail batch dropped
    for a, b in zip(got, want):
        assert isinstance(a, tpacking.PackedGraphBatch)
        assert a.num_tiles == tiles
        for name in ("atom_ids", "adj", "mol_id", "node_mask", "left_index",
                     "right_index", "labels"):
            assert getattr(a, name).tobytes() == getattr(b, name).tobytes()
        assert (a.supers is None) == (not supers)
        if supers:
            assert a.supers.tobytes() == b.supers.tobytes()
