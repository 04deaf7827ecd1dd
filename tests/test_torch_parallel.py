"""The port's graph-sharded training layer against the JAX package's on
the CPU.

- bit for bit, no process started: ``assign_pairs_balanced``,
  ``pack_pair_dataset_coo_pairlocal``, ``pad_partition_coo`` (with and
  without a pinned capacity, pairs and tiles padded or not),
  ``pad_partition_coattn``, ``pad_partition_coattn_pairlocal``,
  ``pad_partition_gwm`` and ``pad_packed_global`` over seeded batches;
  ``stack_sharded_batches`` and ``local_wire`` against the partition;
- every edgeshard loss over 2 gloo ranks (``tests/torch_parallel_ranks.py``
  ``loss_cases``) against the JAX single-device loss and every parameter
  gradient from the same weights (loss 1e-5; gradients 1e-4 max|want| +
  1e-6): COO binary, multi-hot, with pad pairs and pad tiles, RelGCN,
  focal and hinge, the dense loss (the port's rides the COO shards; the
  JAX one dense tiles), co-attention global and pair-local (phantom pad
  pairs), GWM; GGNN and MPNN also against JAX's own ``shard_map`` over 2
  virtual CPU devices (MPNN's sharded loss differs from its
  single-device one in JAX, and the port follows the sharded one); at 4
  ranks the COO loss and the data- plus tensor-parallel step of the
  padded predictor (against the port's single-device step).  The summed
  gradients must be the same bits on every rank; a scan chunk of three
  steps and the three steps one by one leave the same bits on every
  rank, at 2 and 4 ranks.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcnbmp_tpu.data import packing as jpacking
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.parallel import edgeshard as jes
from gcnbmp_tpu_torch.chem import GGNNFeaturizer, mol_from_smiles
from gcnbmp_tpu_torch.convert import from_jax_params, init_params
from gcnbmp_tpu_torch.data import packing as tpacking
from gcnbmp_tpu_torch.data.dataset import PairDataset
from gcnbmp_tpu_torch.data.wire import (
    compact_coattn_arrays, compact_coo_arrays, compact_gwm_arrays)
from gcnbmp_tpu_torch.models.gwm import default_supernode_fn
from gcnbmp_tpu_torch.models.predictor import set_up_predictor
from gcnbmp_tpu_torch.parallel import edgeshard as tes
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
N_MAX = 24
SUPERS = default_supernode_fn()


def _ds(n, seed=0, classes=None):
    rng = np.random.default_rng(seed)
    f = GGNNFeaturizer()
    ds = PairDataset()
    for _ in range(n):
        s1 = SMILES[int(rng.integers(len(SMILES)))]
        s2 = SMILES[int(rng.integers(len(SMILES)))]
        y = (rng.integers(0, 2, size=classes).astype(np.float32) if classes
             else np.float32(rng.integers(0, 2)))
        ds.append(f(mol_from_smiles(s1)), f(mol_from_smiles(s2)), y)
    return ds


def _equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"array {i}")


# ---------------------------------------------------------------------------
# host side, bit for bit


@pytest.mark.parametrize("n,parts,seed,fixed", [
    (16, 2, 0, False), (15, 4, 1, False), (13, 2, 2, True), (9, 8, 3, True),
    (32, 4, 4, True)])
def test_pairlocal_packer_matches_jax(n, parts, seed, fixed):
    ds = _ds(n, seed)
    idx = list(np.random.default_rng(seed).permutation(n))
    caps = {}
    if fixed:
        tpp, ecpp = tpacking.estimate_coo_capacities([ds], -(-n // parts))
        caps = dict(tiles_per_part=tpp, edge_capacity_per_part=ecpp)
    got, gmeta = tpacking.pack_pair_dataset_coo_pairlocal(ds, idx, parts,
                                                          **caps)
    want, wmeta = jpacking.pack_pair_dataset_coo_pairlocal(ds, idx, parts,
                                                           **caps)
    assert vars(gmeta) == vars(wmeta)
    assert got.num_mols == want.num_mols
    fields = ("atom_ids", "mol_id", "node_mask", "e_tile", "e_type", "e_src",
              "e_dst", "e_mask", "left_index", "right_index", "labels")
    _equal([getattr(got, k) for k in fields], [getattr(want, k) for k in fields])
    costs = list(np.random.default_rng(seed).integers(0, 50, size=n))
    assert tpacking.assign_pairs_balanced(costs, parts) == \
        jpacking.assign_pairs_balanced(costs, parts)
    with pytest.raises(ValueError, match="at least one pair per part"):
        tpacking.pack_pair_dataset_coo_pairlocal(ds, idx[:parts - 1], parts)


@pytest.mark.parametrize("n,n_dev,seed,cap", [
    (16, 2, 0, None), (15, 4, 1, None), (13, 2, 2, 1024), (16, 4, 3, 512)])
def test_partitioners_match_jax(n, n_dev, seed, cap):
    ds = _ds(n, seed)
    idx = list(range(n))
    coo = tpacking.pack_pair_dataset_coo(ds, idx)
    _equal(tes.pad_partition_coo(coo, n_dev, cap),
           jes.pad_partition_coo(coo, n_dev, cap))
    _equal(tes.pad_partition_coattn(coo, n_dev, N_MAX, cap),
           jes.pad_partition_coattn(coo, n_dev, N_MAX, cap))
    gwm = tpacking.attach_supers_coo(tpacking.pack_pair_dataset_coo(ds, idx),
                                     ds, idx, SUPERS)
    _equal(tes.pad_partition_gwm(gwm, n_dev, cap),
           jes.pad_partition_gwm(gwm, n_dev, cap))
    assert tes.GWM_SUPERS_INDEX == jes.GWM_SUPERS_INDEX
    pl, meta = tpacking.pack_pair_dataset_coo_pairlocal(ds, idx, n_dev)
    _equal(tes.pad_partition_coattn_pairlocal(pl, meta, N_MAX),
           jes.pad_partition_coattn_pairlocal(pl, meta, N_MAX))
    dense = jpacking.pack_pair_dataset_batch(ds, idx)
    _equal(tes.pad_packed_global(dense, n_dev),
           jes.pad_packed_global(dense, n_dev))
    if cap is not None:
        with pytest.raises(ValueError, match="edge_capacity_per_shard"):
            tes.pad_partition_coo(coo, n_dev, 0)


class _Mesh:
    """The one-axis mesh's interface that the host helpers read."""

    def __init__(self, n, rank):
        self.n, self.rank = n, rank

    def get_group(self, axis):
        return None

    def __getitem__(self, axis):
        return type("Axis", (), {"size": lambda _: self.n})()

    def get_local_rank(self, axis):
        return self.rank


@pytest.mark.parametrize("form", ["coo", "coattn", "pairlocal", "gwm"])
def test_rank_wires_decode_to_the_partition(form):
    """Each rank's wire decodes to its block of the partition (tiles,
    global molecule ids, real edges in order, pairs, labels, slot
    tables), and ``stack_sharded_batches`` stacks the ranks' wires."""
    from gcnbmp_tpu_torch.models.packed import decode_compact_wire

    n_dev, ds = 2, _ds(15, 5)
    coo = tpacking.pack_pair_dataset_coo(ds, list(range(15)))
    if form == "coattn":
        arrays = tes.pad_partition_coattn(coo, n_dev, N_MAX)
    elif form == "pairlocal":
        pl, meta = tpacking.pack_pair_dataset_coo_pairlocal(
            ds, list(range(15)), n_dev)
        arrays = tes.pad_partition_coattn_pairlocal(pl, meta, N_MAX)
    elif form == "gwm":
        arrays = tes.pad_partition_gwm(tpacking.attach_supers_coo(
            coo, ds, list(range(15)), SUPERS), n_dev)
    else:
        arrays = tes.pad_partition_coo(coo, n_dev)
    gwm = form == "gwm"
    base = [a for i, a in enumerate(arrays)
            if not (gwm and i == tes.GWM_SUPERS_INDEX)]
    for rank in range(n_dev):
        wire, labels = tes.local_wire(arrays, rank, n_dev)
        block = [np.split(a, n_dev)[rank] for a in base]
        num_mols = (arrays[tes.GWM_SUPERS_INDEX].shape[0] if gwm
                    else 2 * len(block[8]) * n_dev)
        (atom_ids, mol_id, node_mask, e_tile, e_type, e_src, e_dst,
         e_mask) = (x.numpy() for x in decode_compact_wire(
             *(torch.as_tensor(np.asarray(a)) for a in wire[:3]), num_mols))
        np.testing.assert_array_equal(atom_ids, block[0])
        np.testing.assert_array_equal(node_mask, block[7])
        np.testing.assert_array_equal(mol_id[node_mask > 0],
                                      block[6][block[7] > 0])
        real = block[5] > 0
        for got, want in ((e_tile, block[1]), (e_type, block[2]),
                          (e_src, block[3]), (e_dst, block[4])):
            np.testing.assert_array_equal(got[e_mask > 0], want[real])
        rest = wire[4:] if gwm else wire[3:]
        _equal(rest, block[8:-1])
        np.testing.assert_array_equal(labels, block[-1])
        if gwm:
            np.testing.assert_array_equal(wire[3],
                                          arrays[tes.GWM_SUPERS_INDEX])
        stacked, slabels = tes.stack_sharded_batches(
            [arrays, arrays], _Mesh(n_dev, rank))
        _equal([s[1] for s in stacked], wire)
        np.testing.assert_array_equal(slabels[0], labels)


# ---------------------------------------------------------------------------
# the losses over gloo ranks


MODEL = dict(method="ggnn", fp_hidden_dim=8, fp_out_dim=8, conv_layers=2,
             weight_tying=False, sim_method="hole")


def _case(name, form, ds, n_pairs, n_dev, loss="sigmoid_ce", **model):
    """A loss case: its model kwargs and weights, the unsharded batch (the
    JAX reference's) and the partition the ranks take."""
    kwargs = dict(MODEL, **model)
    idx = list(range(n_pairs))
    form_kwargs, meta = {}, None
    if form == "pairlocal":
        batch, meta = tpacking.pack_pair_dataset_coo_pairlocal(ds, idx, n_dev)
        form_kwargs = {"pair_local": True}
    else:
        batch = tpacking.pack_pair_dataset_coo(ds, idx)
        if form == "gwm":
            batch = tpacking.attach_supers_coo(batch, ds, idx, SUPERS)
    loss_kwargs = {"gamma": 2.0, "alpha": 0.25} if loss == "focal" else {}
    return dict(name=name, form=form, form_kwargs=form_kwargs,
                kwargs=kwargs, tree=init_params(kwargs, 5), batch=batch,
                meta=meta, n_max=N_MAX, loss=loss, loss_kwargs=loss_kwargs,
                ds=ds, idx=idx)


def _cases_world2():
    ds16, ds13 = _ds(16, 0), _ds(15, 1)
    multi = _ds(16, 2, classes=3)
    return [
        _case("coo", "coo", ds16, 16, 2),
        _case("coo-pad", "coo", ds13, 15, 2),
        _case("coo-multihot", "coo", multi, 16, 2, class_num=3),
        _case("relgcn", "coo", ds16, 16, 2, method="relgcn"),
        _case("focal", "coo", ds16, 16, 2, loss="focal"),
        _case("hinge", "coo", ds16, 16, 2, loss="hinge"),
        _case("dense", "dense", ds16, 16, 2),
        _case("coattn", "coattn", ds16, 16, 2, attn="para"),
        _case("coattn-pairlocal", "pairlocal", _ds(13, 3), 13, 2,
              attn="para"),
        _case("gwm", "gwm", ds16, 16, 2, method="ggnn-gwm"),
        _moved_biases(_case("mpnn", "coo", ds16, 16, 2, method="mpnn")),
        _scan_case(2),
    ]


def _moved_biases(case):
    """The case with every bias of its initial weights drawn off zero."""
    rng = np.random.default_rng(11)

    def move(tree):
        return {k: move(v) if isinstance(v, dict) else
                (v + rng.normal(0, 0.3, v.shape).astype(v.dtype)
                 if k == "bias" else v) for k, v in tree.items()}

    case["tree"] = move(case["tree"])
    return case


def _dp_case():
    kwargs = dict(method="ggnn", fp_hidden_dim=8, fp_out_dim=8,
                  conv_layers=2, weight_tying=False, sim_method="hole",
                  class_num=1)
    from gcnbmp_tpu_torch.entry import _example_batch

    atoms, adj, mask, labels = _example_batch(batch=8, n_atoms=12, seed=3)
    return dict(name="dp", form="dp", kwargs=kwargs,
                tree=init_params(kwargs, 5, padded=True),
                batch=(atoms, adj, atoms, adj, mask, mask, labels))


def _scan_case(n_dev):
    """Three COO batches for a scan chunk of 3 over ``n_dev`` ranks."""
    ds = _ds(48, 6)
    tiles, cap = tpacking.estimate_coo_capacities([ds], 16)
    batches = [tpacking.pack_pair_dataset_coo(
        ds, list(range(i, i + 16)), num_tiles=tiles, edge_capacity=cap)
        for i in (0, 16, 32)]
    cap = ((cap + 127) // 128) * 128
    return dict(name="scan", form="scan", kwargs=MODEL,
                tree=init_params(MODEL, 5), batches=batches,
                argses=[tes.pad_partition_coo(b, n_dev, cap)
                        for b in batches])


def _run_ranks(tmp, cases, n_dev):
    path = os.path.join(tmp, "cases.pkl")
    with open(path, "wb") as f:
        pickle.dump([{k: v for k, v in c.items()
                      if k not in ("ds", "idx", "batches")} for c in cases], f)
    launch(torch_parallel_ranks.loss_cases, n_dev, (path, tmp), timeout=240)
    out = []
    for r in range(n_dev):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    cases = _cases_world2()
    return {c["name"]: c for c in cases}, _run_ranks(
        str(tmp_path_factory.mktemp("world2")), cases, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    cases = [_case("coo", "coo", _ds(16, 4), 16, 4), _dp_case(),
             _scan_case(4),
             dict(name="global", form="global",
                  array=np.arange(24, dtype=np.float32).reshape(8, 3))]
    return {c["name"]: c for c in cases}, _run_ranks(
        str(tmp_path_factory.mktemp("world4")), cases, 4)


def _jax_single(case):
    """The JAX single-device loss and gradients (numpy tree) of a case:
    the compact predictor over the unsharded batch, the global
    element-mean; the dense loss over JAX's dense batch of the pairs."""
    kw, elem = case["kwargs"], jes.elementwise_loss_for(
        case["loss"], **case["loss_kwargs"])
    batch, tree = case["batch"], jax.tree_util.tree_map(jnp.asarray,
                                                         case["tree"])
    if case["form"] == "dense":
        dense = jpacking.pack_pair_dataset_batch(case["ds"], case["idx"])
        pred = jpacked.make_packed_predictor(**kw)
        args = tuple(jnp.asarray(a) for a in (
            dense.atom_ids, dense.adj, dense.mol_id, dense.node_mask,
            dense.left_index, dense.right_index))
        labels = jnp.asarray(dense.labels)
    else:
        pred = jpacked.make_packed_predictor(**kw, coo=True, compact=True)
        wire = (compact_gwm_arrays(batch) if case["form"] == "gwm"
                else compact_coattn_arrays(batch, N_MAX)
                if "attn" in kw else compact_coo_arrays(batch))
        args = tuple(jnp.asarray(np.asarray(a)) for a in wire)
        labels = jnp.asarray(batch.labels)

    def loss(p):
        logits = jnp.reshape(pred.apply({"params": p}, *args), labels.shape)
        per, valid = elem(logits, labels)
        return jnp.sum(per * valid) / jnp.maximum(jnp.sum(valid), 1.0)

    value, grads = jax.jit(jax.value_and_grad(loss))(tree)
    return float(value), jax.tree_util.tree_map(np.asarray, grads)


def _jax_sharded_loss(case, n_dev=2):
    """The JAX edgeshard COO loss over ``n_dev`` virtual CPU devices
    (``shard_map``)."""
    pred = jpacked.make_packed_predictor(**case["kwargs"], coo=True)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n_dev]), ("graph",))
    loss = jes.make_edgeshard_coo_loss(pred, mesh, axis="graph")
    args = jes.shard_packed_coo_batch(case["batch"], mesh, axis="graph")
    tree = jax.tree_util.tree_map(jnp.asarray, case["tree"])
    return jax.jit(lambda p: loss(p, *args)), tree


def _jax_sharded(case, n_dev=2):
    """Its loss and gradients."""
    loss, tree = _jax_sharded_loss(case, n_dev)
    value, grads = jax.jit(jax.value_and_grad(loss))(tree)
    return float(value), jax.tree_util.tree_map(np.asarray, grads)


def _jax_sharded_by_hand(case, n_dev=2):
    """The same function as the JAX edgeshard COO loss, written without
    ``shard_map`` (whose gradient of the MPNN encoder JAX refuses on the
    CPU: "Unexpected XLA sharding override"): each device's block of
    ``jes.pad_partition_coo`` through the JAX encoder, the blocks' rows
    summed, each device's pairs scored, the global mean."""
    from gcnbmp_tpu.ops.aggregate import adj_from_coo

    pred = jpacked.make_packed_predictor(**case["kwargs"], coo=True)
    arrays = [np.split(a, n_dev) for a in jes.pad_partition_coo(
        case["batch"], n_dev)]
    elem = jes.elementwise_loss_for(case["loss"])

    def loss(p):
        blocks = [[jnp.asarray(a[d]) for a in arrays] for d in range(n_dev)]
        num_mols = 2 * blocks[0][8].shape[0] * n_dev
        g = 0.0
        for (atom_ids, e_tile, e_type, e_src, e_dst, e_mask, mol_id,
             node_mask, *_) in blocks:
            adj = adj_from_coo(e_tile, e_type, e_src, e_dst, e_mask,
                               num_tiles=atom_ids.shape[0],
                               tile=atom_ids.shape[1])
            g = g + pred.encoder.apply({"params": p["encoder"]}, atom_ids,
                                       adj, mol_id, node_mask, num_mols)[0]
        total = count = 0.0
        for *_, left, right, labels in blocks:
            logits = pred.head.apply({"params": p["head"]}, g[left], g[right])
            per, valid = elem(jnp.reshape(logits, labels.shape), labels)
            total, count = total + jnp.sum(per * valid), count + jnp.sum(valid)
        return total / jnp.maximum(count, 1.0)

    tree = jax.tree_util.tree_map(jnp.asarray, case["tree"])
    value, grads = jax.jit(jax.value_and_grad(loss))(tree)
    return float(value), jax.tree_util.tree_map(np.asarray, grads)


def _compare(got, want, what):
    (gl, gg), (wl, wg) = got, want
    np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL, err_msg=what)
    from gcnbmp_tpu_torch.convert import named_to_tree, flat_npz

    got_flat = flat_npz(named_to_tree({k: torch.as_tensor(v)
                                       for k, v in gg.items()}))
    want_flat = flat_npz(wg)
    assert sorted(got_flat) == sorted(want_flat)
    for k, w in want_flat.items():
        np.testing.assert_allclose(
            got_flat[k], w, rtol=0,
            atol=GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL,
            err_msg=f"{what}: {k}")


def _same_on_every_rank(ranks, name):
    first = ranks[0][name]
    for other in ranks[1:]:
        assert other[name][0] == first[0]
        for k, v in first[1].items():
            np.testing.assert_array_equal(other[name][1][k], v, err_msg=k)


SINGLE = ["coo", "coo-pad", "coo-multihot", "relgcn", "focal", "hinge",
          "dense", "coattn", "coattn-pairlocal", "gwm"]


@pytest.mark.parametrize("name", SINGLE)
def test_edgeshard_loss_matches_jax_single_device(world2, name):
    cases, ranks = world2
    _same_on_every_rank(ranks, name)
    _compare(ranks[0][name], _jax_single(cases[name]), name)


def test_edgeshard_loss_matches_jax_shard_map(world2):
    """The port's sharded loss and gradients against JAX's own
    ``shard_map`` over 2 virtual CPU devices."""
    cases, ranks = world2
    _compare(ranks[0]["coo"], _jax_sharded(cases["coo"]), "coo")


def test_sharded_mpnn_follows_the_jax_sharded_loss(world2):
    """MPNN over 2 devices: Set2Set gives a molecule with no atoms on a
    device a row that is not zero once its biases move (here the
    initial biases are moved off zero), the JAX COO loss sums those rows
    over the devices, and so JAX's sharded loss is not its single-device
    loss (ROADMAP queue 3).  The port follows the sharded one: its loss
    against JAX's ``shard_map`` loss, its gradients against the same
    function written out by hand in JAX (JAX refuses the ``shard_map``
    gradient of its MPNN encoder on the CPU)."""
    cases, ranks = world2
    case = cases["mpnn"]
    _same_on_every_rank(ranks, "mpnn")
    loss, tree = _jax_sharded_loss(case)
    sharded = float(loss(tree))
    single = _jax_single(case)
    assert abs(sharded - single[0]) > 1e-3 * abs(single[0])
    np.testing.assert_allclose(ranks[0]["mpnn"][0], sharded, rtol=LOSS_RTOL)
    by_hand = _jax_sharded_by_hand(case)
    np.testing.assert_allclose(by_hand[0], sharded, rtol=LOSS_RTOL)
    _compare(ranks[0]["mpnn"], by_hand, "mpnn")


def test_edgeshard_loss_at_four_ranks(world4):
    cases, ranks = world4
    _same_on_every_rank(ranks, "coo")
    _compare(ranks[0]["coo"], _jax_single(cases["coo"]), "coo at 4 ranks")


def test_data_and_tensor_parallel_step_matches_single_device(world4):
    """``parallel.dp`` over a 2 x 2 mesh: the message linears split over
    the model axis, the batch over the data axis; loss and every full
    gradient against the port's single-device step."""
    cases, ranks = world4
    case = cases["dp"]
    model = from_jax_params(case["tree"], set_up_predictor(**case["kwargs"]))
    a, j, _, _, m, _, y = (torch.as_tensor(x) for x in case["batch"])
    loss = sigmoid_cross_entropy(model(a, j, a, j, m, m), y)
    loss.backward()
    loss = loss.item()
    for r in ranks:
        got_loss, grads, split = r["dp"]
        assert split == ["encoder.update_0.message.dense",
                         "encoder.update_1.message.dense"]
        np.testing.assert_allclose(got_loss, loss, rtol=LOSS_RTOL)
        for name, p in model.named_parameters():
            w = p.grad.numpy()
            np.testing.assert_allclose(
                grads[name], w, rtol=0,
                atol=GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL,
                err_msg=name)


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_edgeshard_scan_step_matches_steps_and_one_device(world, request):
    """``make_edgeshard_scan_train_step`` over ``stack_sharded_batches``
    equals the same three steps one by one, bit for bit; the replicas'
    parameters after them are the same bits on every rank, at 2 and 4
    ranks; the losses follow the port's single-device steps (1e-5)."""
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor
    from gcnbmp_tpu_torch.train.loop import ChainedAdam, train_step

    cases, ranks = request.getfixturevalue(world)
    for r in ranks:
        (scan_losses, scan_params), (step_losses, step_params) = r["scan"]
        np.testing.assert_array_equal(scan_losses, step_losses)
        for k, v in scan_params.items():
            np.testing.assert_array_equal(step_params[k], v, err_msg=k)
        for k, v in ranks[0]["scan"][0][1].items():
            np.testing.assert_array_equal(scan_params[k], v, err_msg=k)
    case = cases["scan"]
    model = from_jax_params(case["tree"], make_packed_predictor(**MODEL))
    opt = ChainedAdam(list(model.parameters()), lambda count: 1e-2)
    want = [float(train_step(model, opt, [torch.as_tensor(np.asarray(a))
                                          for a in compact_coo_arrays(b)],
                             torch.as_tensor(b.labels)))
            for b in case["batches"]]
    np.testing.assert_allclose(ranks[0]["scan"][0][0], want, rtol=LOSS_RTOL)


def test_host_local_blocks_make_the_global_array(world4):
    """``multihost.global_mesh`` (2 x 2) and ``host_local_to_global``:
    each data rank's block of the batch assembles the whole batch."""
    cases, ranks = world4
    for r in ranks:
        np.testing.assert_array_equal(r["global"], cases["global"]["array"])
