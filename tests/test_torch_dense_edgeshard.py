"""The port's dense edgeshard loss and step (``parallel.edgeshard``
``make_edgeshard_loss``, ``make_edgeshard_train_step`` and
``shard_packed_batch`` over ``data.packing.pack_pair_dataset_batch``)
over 2 gloo ranks, on the CPU, the rank bodies in
tests/torch_parallel_ranks.py (``dense_cases``), as
tests/test_torch_parallel.py runs the COO forms:

- each rank's loss and the gradients summed over the ranks, the same
  bits on both ranks, against the port's single-device dense predictor
  on the whole batch and the JAX single-device loss (loss 1e-5, every
  gradient 1e-4 max|want| + 1e-6), and against JAX's own
  ``make_edgeshard_loss`` (``shard_map`` over 2 virtual CPU devices): GGNN
  (the kernel path's plain versions), with pad pairs and a pad tile,
  and RelGCN;
- two steps of ``make_edgeshard_train_step`` against JAX's
  ``make_edgeshard_train_step`` with Adam at the same learning rate:
  step losses within 1e-5, the parameters after them within the
  gradient bound, the same bits on both ranks."""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.parallel import edgeshard as jes
from gcnbmp_tpu_torch.chem import GGNNFeaturizer, mol_from_smiles
from gcnbmp_tpu_torch.convert import (
    flat_npz, from_jax_params, init_params, named_to_tree)
from gcnbmp_tpu_torch.data import packing as tpacking
from gcnbmp_tpu_torch.data.dataset import PairDataset
from gcnbmp_tpu_torch.models import packed as tpacked
from gcnbmp_tpu_torch.parallel.mesh import launch
from gcnbmp_tpu_torch.train.loop import sigmoid_cross_entropy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks  # noqa: E402

torch.set_num_threads(1)

SMILES = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "C=O",
          "Cn1cnc2c1c(=O)n(C)c(=O)n2C", "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
          "CCN(CC)CC", "OCC(O)CO"]
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LR = 1e-2
N_DEV = 2
MODEL = dict(method="ggnn", fp_hidden_dim=16, fp_out_dim=16, conv_layers=2,
             weight_tying=False, sim_method="hole")


def _batches(n_pairs, seed, num_tiles=None):
    rng = np.random.default_rng(seed)
    f = GGNNFeaturizer()
    ds = PairDataset()
    for _ in range(2 * n_pairs):
        ds.append(f(mol_from_smiles(SMILES[int(rng.integers(len(SMILES)))])),
                  f(mol_from_smiles(SMILES[int(rng.integers(len(SMILES)))])),
                  np.float32(rng.integers(0, 2)))
    return [tpacking.pack_pair_dataset_batch(
        ds, list(range(i * n_pairs, (i + 1) * n_pairs)), num_tiles=num_tiles)
        for i in range(2)]


def _case(name, n_pairs, seed, num_tiles=None, **model):
    kwargs = dict(MODEL, **model)
    return dict(name=name, kwargs=kwargs, tree=init_params(kwargs, 5),
                batches=_batches(n_pairs, seed, num_tiles), lr=LR)


CASES = [_case("ggnn", 16, 0), _case("ggnn-pad", 15, 1, num_tiles=7),
         _case("relgcn", 16, 2, method="relgcn")]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dense"))
    path = os.path.join(tmp, "cases.pkl")
    with open(path, "wb") as f:
        pickle.dump(CASES, f)
    launch(torch_parallel_ranks.dense_cases, N_DEV, (path, tmp), timeout=240)
    out = []
    for r in range(N_DEV):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _args(batch):
    return tuple(jnp.asarray(a) for a in tpacked.dense_batch_args(batch))


def _jax_single(case):
    pred = jpacked.make_packed_predictor(**case["kwargs"])
    batch = case["batches"][0]
    labels = jnp.asarray(batch.labels)

    def loss(p):
        logits = pred.apply({"params": p}, *_args(batch))
        return sigmoid_ce(jnp.reshape(logits, labels.shape), labels)

    tree = jax.tree_util.tree_map(jnp.asarray, case["tree"])
    value, grads = jax.jit(jax.value_and_grad(loss))(tree)
    return float(value), flat_npz(jax.tree_util.tree_map(np.asarray, grads))


def sigmoid_ce(logits, labels):
    per, valid = jes.sigmoid_ce_elements(logits, labels)
    return jnp.sum(per * valid) / jnp.maximum(jnp.sum(valid), 1.0)


def _mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:N_DEV]), ("graph",))


def _jax_sharded(case):
    """JAX's ``make_edgeshard_loss`` (``shard_map``) and its gradients."""
    pred = jpacked.make_packed_predictor(**case["kwargs"])
    mesh = _mesh()
    loss = jes.make_edgeshard_loss(pred, mesh, axis="graph")
    args = jes.shard_packed_batch(case["batches"][0], mesh, axis="graph")
    tree = jax.tree_util.tree_map(jnp.asarray, case["tree"])
    value, grads = jax.jit(jax.value_and_grad(
        lambda p: loss(p, *args)))(tree)
    return float(value), flat_npz(jax.tree_util.tree_map(np.asarray, grads))


def _close(got, want, what, rtol=GRAD_RTOL):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=0, atol=rtol * float(np.abs(w).max()) + GRAD_ATOL,
            err_msg=f"{what}: {k}")


def _port(rank_result):
    loss, grads, losses, params = rank_result
    as_flat = lambda d: flat_npz(named_to_tree(
        {k: torch.as_tensor(v) for k, v in d.items()}))
    return loss, as_flat(grads), losses, as_flat(params)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_dense_edgeshard_loss_matches_single_device_and_jax(ranks, name):
    case = next(c for c in CASES if c["name"] == name)
    first = ranks[0][name]
    for other in ranks[1:]:
        assert other[name][0] == first[0] and other[name][2] == first[2]
        for k, v in first[1].items():
            np.testing.assert_array_equal(other[name][1][k], v, err_msg=k)
        for k, v in first[3].items():
            np.testing.assert_array_equal(other[name][3][k], v, err_msg=k)
    loss, grads, _, _ = _port(first)
    # the port's own single-device dense predictor on the whole batch
    model = from_jax_params(case["tree"], tpacked.make_packed_predictor(
        **case["kwargs"], compact=False))
    batch = case["batches"][0]
    single = sigmoid_cross_entropy(
        model(*(torch.as_tensor(a) for a in tpacked.dense_batch_args(batch))),
        torch.as_tensor(batch.labels))
    np.testing.assert_allclose(loss, single.item(), rtol=LOSS_RTOL, atol=0)
    for what, (want_loss, want_grads) in (("JAX single device",
                                           _jax_single(case)),
                                          ("JAX shard_map",
                                           _jax_sharded(case))):
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL,
                                   err_msg=what)
        _close(grads, want_grads, what)


def test_dense_edgeshard_steps_match_jax(ranks):
    case = CASES[0]
    _, _, losses, params = _port(ranks[0][case["name"]])
    pred = jpacked.make_packed_predictor(**case["kwargs"])
    tx = optax.adam(LR)
    mesh = _mesh()
    step = jes.make_edgeshard_train_step(pred, tx, mesh, axis="graph")
    p = jax.tree_util.tree_map(jnp.asarray, case["tree"])
    state = tx.init(p)
    want_losses = []
    for batch in case["batches"]:
        p, state, loss = step(p, state, *jes.shard_packed_batch(
            batch, mesh, axis="graph"))
        want_losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _close(params, flat_npz(jax.tree_util.tree_map(np.asarray, p)),
           "parameters after two steps")
