"""Graph-sharded multi-device training over the wire-compact COO layout
(port of gcnbmp_tpu/parallel/edgeshard.py, ``shard_map`` and the XLA
collectives turned into one process per rank and ``torch.distributed``).

The packed layout never splits a molecule across tiles, so splitting the
tile axis over the ranks cuts no edge.  Every array of a batch is padded
and split contiguously on its leading axis (``pad_partition_*``, numpy,
the JAX functions' arrays bit for bit); each rank keeps its block
(``local_wire``) and encodes it in the wire-compact form, with the global
molecule count.  A rank then

1. builds its tiles' adjacency from its edges and runs the encoder on
   them, the same kernels as the single-device step (``models.packed``
   ``encode``): per-molecule rows ``g_local`` (num_mols, D), zero for the
   molecules it does not hold (GGNN, RelGCN, GIN, NFP);
2. completes ``g`` with one sum over the ranks; co-attention's global
   form also gathers the per-atom table; its pair-local form (batches of
   ``data.packing.pack_pair_dataset_coo_pairlocal``) needs neither;
3. scores its own pairs; the loss is the global element-mean, two scalar
   sums (``_global_mean``), pad pairs (label -1) ignored.

Each rank back-propagates its own part of the loss through the
collectives' backward (``parallel.collectives``); the parameter gradients
are then summed over the ranks, and every rank takes the same optimizer
step (``ChainedAdam``, whose clipping sees the global gradient), so the
replicas stay equal.

MPNN: Set2Set gives a molecule without local atoms a nonzero row once
its biases move, and the COO loss sums those rows over the ranks, as the
JAX loss does (it masks only GWM): the sharded MPNN loss follows the JAX
package's sharded loss, not its single-device one (ROADMAP queue 3).

Departure: the JAX dense loss (``make_edgeshard_loss``, over host-built
dense tiles) has no dense host batch here; as on the single-device
``packed`` path, it rides the compact-COO shards (``make_edgeshard_loss``
is ``make_edgeshard_coo_loss``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from gcnbmp_tpu_torch.data.packing import (
    PackedCOOBatch,
    check_side_index_injective,
    molecule_slot_table,
)
from gcnbmp_tpu_torch.data.wire import compact_coo_arrays
from gcnbmp_tpu_torch.models.packed import decode_compact_wire, pair_logits
from gcnbmp_tpu_torch.ops.slotgather import gather_slot_table
from gcnbmp_tpu_torch.parallel.collectives import (
    all_gather_tensor,
    all_gather_tiled,
    all_reduce_sum,
    all_reduce_sum_list,
)
from gcnbmp_tpu_torch.train.loop import (
    focal_elements,
    hinge_elements,
    sigmoid_ce_elements,
)

GWM_SUPERS_INDEX = 6  # position of the replicated supers array (pad_partition_gwm)
# partition tuple lengths: COO, GWM (supers added), co-attention (slots added)
_COO, _GWM, _COATTN = 11, 12, 15


def elementwise_loss_for(name: str, **kwargs):
    """Map a TrainConfig.loss name to its elementwise form (:44-52)."""
    if name in ("sigmoid_ce", "sigmoid_cross_entropy"):
        return sigmoid_ce_elements
    if name == "focal":
        return focal_elements(**kwargs)
    if name == "hinge":
        return hinge_elements
    raise ValueError(f"unknown loss {name!r}")


def _axis(mesh, axis: str):
    """(process group, size, this rank's index) of ``axis``."""
    return (mesh.get_group(axis), mesh[axis].size(),
            mesh.get_local_rank(axis))


class _GlobalValue(torch.autograd.Function):
    """``value`` forward (the same on every rank), the gradient passed
    to ``part`` (this rank's share of it) backward."""

    @staticmethod
    def forward(ctx, part, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _global_mean(per, valid, group):
    """The global element-mean over every rank's elements (:55-60): its
    value is sum / max(count, 1) over all ranks, the same bits on each;
    its gradient is this rank's own part, sum_local / max(count, 1),
    which the collectives' backward and the gradient sum complete."""
    local = (per * valid).sum()
    totals = torch.stack([local.detach(), valid.sum().detach()])
    torch.distributed.all_reduce(totals, group=group)
    count = torch.clamp(totals[1], min=1.0)
    return _GlobalValue.apply(local / count, totals[0] / count)


def global_mean_loss(mesh, axis: str = "graph",
                     elementwise_loss=sigmoid_ce_elements) -> Callable:
    """``loss(logits, labels)``: the global element-mean of
    ``elementwise_loss`` over every rank's pairs (labels < 0 ignored;
    multi-hot labels reduce element-wise)."""
    group = mesh.get_group(axis)

    def loss(logits, labels):
        return _global_mean(*elementwise_loss(
            logits.reshape(labels.shape), labels), group)

    return loss


def _decoded(wire, num_mols):
    nodes, e_packed, n_edges = wire[:3]
    return decode_compact_wire(nodes, e_packed, n_edges, num_mols)


def _coo_logits(predictor):
    """This rank's logits over its wire (nodes, e_packed, n_edges, left,
    right): the local rows completed by one sum (:144-191)."""

    def logits(wire, group, n_dev):
        left, right = wire[3], wire[4]
        num_mols = 2 * left.shape[0] * n_dev
        atom_ids, mol_id, node_mask, *edges = _decoded(wire, num_mols)
        g = all_reduce_sum(predictor.encoder.encode(
            atom_ids, edges, mol_id, node_mask, num_mols), group)
        return pair_logits(predictor.head, g, left, right)

    return logits


def _side_rows(index, mask, num_mols: int):
    """``ops.slotgather.side_mol_row`` over the rows with real atoms: a
    row without any (a pad pair, which the partition points at molecule
    0) goes to the sentinel, so it cannot take a real row's molecule."""
    index = torch.where(mask.sum(dim=1) > 0, index.long(),
                        torch.full_like(index.long(), num_mols))
    rows = torch.full((num_mols + 1,), -1, dtype=torch.int64,
                      device=index.device)
    rows = rows.index_copy(0, index, torch.arange(
        index.shape[0], dtype=torch.int64, device=index.device))
    rows[num_mols] = -1
    return rows


def _coattn_logits(predictor, pair_local: bool):
    """This rank's co-attention logits over its wire (nodes, e_packed,
    n_edges, left, right, left_slots, right_slots, left_mask, right_mask)
    (:194-319).  Global form: the per-atom table is completed by one
    all-gather (contiguous tile split, so rank order is the global flat
    layout the slot tables index) and ``g`` by one sum.  Pair-local: both
    molecules of every pair are this rank's and the slot tables index its
    own tiles: no collective."""

    def logits(wire, group, n_dev):
        left, right, lslots, rslots, lmask, rmask = wire[3:]
        num_mols = 2 * left.shape[0] * n_dev
        atom_ids, mol_id, node_mask, *edges = _decoded(wire, num_mols)
        g, h = predictor.encoder.encode(atom_ids, edges, mol_id, node_mask,
                                        num_mols, return_atoms=True)
        flat, ids = h.reshape(-1, h.shape[-1]), mol_id.reshape(-1)
        if not pair_local:
            g = all_reduce_sum(g, group)
            flat = all_gather_tiled(flat, group)
            ids = all_gather_tensor(ids, group)
        atoms1 = gather_slot_table(flat, lslots, lmask, ids,
                                   _side_rows(left, lmask, num_mols))
        atoms2 = gather_slot_table(flat, rslots, rmask, ids,
                                   _side_rows(right, rmask, num_mols))
        g1, g2 = predictor.coattention(atoms1, g[left.long()], atoms2,
                                       g[right.long()], lmask, rmask)
        return predictor.head(g1, g2)

    return logits


def _gwm_logits(predictor):
    """This rank's GWM logits over its wire (nodes, e_packed, n_edges,
    supers, left, right) (:322-385).  The supernode exchange is
    molecule-local, so a rank computes its own molecules exactly and the
    others wrongly (no local atoms); owner masking (:356-363) zeroes the
    rows of molecules with no local atom before the sum, so each row
    comes from its one owner.  The supernode table rides whole."""

    def logits(wire, group, n_dev):
        supers, left, right = wire[3], wire[4], wire[5]
        num_mols = supers.shape[0]
        atom_ids, mol_id, node_mask, *edges = _decoded(wire, num_mols)
        out = predictor.encoder.encode(atom_ids, edges, mol_id, node_mask,
                                       num_mols, supers)
        owner = out.new_zeros(num_mols + 1).index_add_(
            0, mol_id.reshape(-1).long(),
            node_mask.reshape(-1).to(out.dtype))[:num_mols] > 0
        g = all_reduce_sum(out * owner[:, None].to(out.dtype), group)
        return pair_logits(predictor.head, g, left, right)

    return logits


def edgeshard_forward(predictor, mesh, axis: str = "graph",
                      pair_local: bool = False) -> Callable:
    """``forward(*wire) -> logits`` of this rank's pairs, for the form of
    ``predictor`` (a predictor of ``models.packed.make_packed_predictor``):
    co-attention (pair-local or global), GWM (owner-masked) or the COO
    form.  Its gradient is this rank's part of the global one."""
    group, n_dev, _ = _axis(mesh, axis)
    if hasattr(predictor, "coattention"):
        fn = _coattn_logits(predictor, pair_local)
    elif hasattr(predictor, "supernode_fn"):
        fn = _gwm_logits(predictor)
    else:
        fn = _coo_logits(predictor)
    return lambda *wire: fn(wire, group, n_dev)


def _loss(logits_fn, mesh, axis, elementwise_loss):
    group, n_dev, _ = _axis(mesh, axis)
    loss = global_mean_loss(mesh, axis, elementwise_loss)

    def loss_fn(*args):
        *wire, labels = args
        return loss(logits_fn(wire, group, n_dev), labels)

    return loss_fn


def make_edgeshard_coo_loss(predictor, mesh, axis: str = "graph",
                            elementwise_loss=sigmoid_ce_elements) -> Callable:
    """``loss_fn(nodes, e_packed, n_edges, left, right, labels)`` over this
    rank's wire (``local_wire`` of ``pad_partition_coo``): the global mean
    loss of the compact-COO ``predictor``."""
    return _loss(_coo_logits(predictor), mesh, axis, elementwise_loss)


# the JAX dense loss rides the compact-COO shards here (module docstring)
make_edgeshard_loss = make_edgeshard_coo_loss


def make_edgeshard_coattn_loss(predictor, mesh, axis: str = "graph",
                               elementwise_loss=sigmoid_ce_elements,
                               pair_local: bool = False) -> Callable:
    """``loss_fn(nodes, e_packed, n_edges, left, right, left_slots,
    right_slots, left_mask, right_mask, labels)``: the global mean loss of
    the co-attention ``predictor`` over the wire of
    ``pad_partition_coattn``, or with ``pair_local`` of
    ``pad_partition_coattn_pairlocal``."""
    return _loss(_coattn_logits(predictor, pair_local), mesh, axis,
                 elementwise_loss)


def make_edgeshard_gwm_loss(predictor, mesh, axis: str = "graph",
                            elementwise_loss=sigmoid_ce_elements) -> Callable:
    """``loss_fn(nodes, e_packed, n_edges, supers, left, right, labels)``:
    the global mean loss of the GWM ``predictor`` over the wire of
    ``pad_partition_gwm``."""
    return _loss(_gwm_logits(predictor), mesh, axis, elementwise_loss)


class SummedGradients:
    """``optimizer`` (a ``train.loop.ChainedAdam``) stepping on the
    parameter gradients summed over ``axis`` of ``mesh`` (:643-657): a
    missing gradient counts as zero, so every rank sums the same buffer,
    in one collective, and the optimizer's clip sees the global gradient.
    It stands in for the optimizer in ``train.loop.train_step``."""

    def __init__(self, optimizer, mesh, axis: str = "graph"):
        self.optimizer = optimizer
        self.params = optimizer.params
        self.group = mesh.get_group(axis)

    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        self.optimizer.step(all_reduce_sum_list(grads, self.group))


def make_edgeshard_train_step_from_loss(loss_fn: Callable, optimizer, mesh,
                                        axis: str = "graph") -> Callable:
    """One train step for any ``make_edgeshard_*_loss`` (:643-657):
    ``step(*wire, labels) -> loss`` backpropagates this rank's part and
    takes ``optimizer``'s step on the gradients summed over ``axis``
    (``SummedGradients``).  Returns the global loss, detached."""
    summed = SummedGradients(optimizer, mesh, axis)

    def step(*args):
        for p in summed.params:
            p.grad = None
        loss = loss_fn(*args)
        loss.backward()
        summed.step()
        return loss.detach()

    return step


def make_edgeshard_scan_train_step(loss_fn: Callable, optimizer, mesh,
                                   axis: str = "graph") -> Callable:
    """S edgeshard steps over a chunk (:660-688): ``scan(stacked_args,
    stacked_labels) -> losses (S,)``, each stacked array with its leading
    (S,) axis (``stack_sharded_batches``).  The steps run one after
    another, as the single-device scan mode does."""
    step = make_edgeshard_train_step_from_loss(loss_fn, optimizer, mesh, axis)

    def scan(stacked_args, stacked_labels):
        return torch.stack([step(*(a[i] for a in stacked_args),
                                 stacked_labels[i])
                            for i in range(stacked_labels.shape[0])])

    return scan


def make_edgeshard_coo_train_step(predictor, optimizer, mesh,
                                  axis: str = "graph") -> Callable:
    """The COO loss's train step (:388-403)."""
    return make_edgeshard_train_step_from_loss(
        make_edgeshard_coo_loss(predictor, mesh, axis), optimizer, mesh, axis)


# the JAX dense step (:123-141) rides the compact-COO shards here
make_edgeshard_train_step = make_edgeshard_coo_train_step


# ---------------------------------------------------------------------------
# host partitioners (numpy; the JAX functions' arrays bit for bit)


def pad_partition_coo(coo, n_dev: int,
                      edge_capacity_per_shard: Optional[int] = None):
    """Pad and partition a PackedCOOBatch for the COO loss (:406-481).

    Tiles are padded to a multiple of ``n_dev`` and split contiguously;
    each edge goes to the rank owning its tile, its tile index made local;
    the per-shard edge lists are padded to one capacity (the largest
    shard's, 128-aligned, unless ``edge_capacity_per_shard`` pins it, as
    the trainer does to keep every step's shapes).  Pairs are padded with
    label -1 and split contiguously.  Returns the 11 arrays (atom_ids,
    e_tile, e_type, e_src, e_dst, e_mask, mol_id, node_mask, left, right,
    labels), each rank's block contiguous on the leading axis."""
    p = coo.num_tiles
    pad_tiles = (-p) % n_dev
    tiles_per = (p + pad_tiles) // n_dev
    b = len(coo.left_index)
    pad_pairs = (-b) % n_dev

    def pad0(x, k):
        return np.pad(x, [(0, k)] + [(0, 0)] * (x.ndim - 1)) if k else x

    atom_ids = pad0(coo.atom_ids, pad_tiles)
    mol_id = np.pad(
        coo.mol_id, [(0, pad_tiles), (0, 0)], constant_values=coo.num_mols,
    ) if pad_tiles else coo.mol_id
    node_mask = pad0(coo.node_mask, pad_tiles)

    real = coo.e_mask > 0
    owner = coo.e_tile // tiles_per
    shard_edges = []
    for d in range(n_dev):
        sel = real & (owner == d)
        shard_edges.append((coo.e_tile[sel] - d * tiles_per, coo.e_type[sel],
                            coo.e_src[sel], coo.e_dst[sel]))
    cap = max(len(e[0]) for e in shard_edges)
    cap = ((cap + 127) // 128) * 128
    if edge_capacity_per_shard is not None:
        if edge_capacity_per_shard < cap:
            raise ValueError(f"edge_capacity_per_shard="
                             f"{edge_capacity_per_shard} < required {cap}")
        cap = edge_capacity_per_shard

    def padded_stack(i, dtype):
        out = np.zeros((n_dev, cap), dtype)
        for d, e in enumerate(shard_edges):
            out[d, : len(e[i])] = e[i]
        return out.reshape(n_dev * cap)

    e_tile = padded_stack(0, np.int32)
    e_type = padded_stack(1, np.int32)
    e_src = padded_stack(2, np.int32)
    e_dst = padded_stack(3, np.int32)
    e_mask = np.zeros((n_dev, cap), np.float32)
    for d, e in enumerate(shard_edges):
        e_mask[d, : len(e[0])] = 1.0
    e_mask = e_mask.reshape(n_dev * cap)

    left = np.concatenate([coo.left_index, np.zeros(pad_pairs, np.int32)])
    right = np.concatenate([coo.right_index, np.zeros(pad_pairs, np.int32)])
    labels = np.asarray(coo.labels, np.float32)
    if pad_pairs:
        fill = -np.ones((pad_pairs,) + labels.shape[1:], np.float32)
        labels = np.concatenate([labels, fill])
    return (atom_ids, e_tile, e_type, e_src, e_dst, e_mask,
            mol_id, node_mask, left, right, labels)


def pad_partition_coattn(coo, n_dev: int, n_max: int,
                         edge_capacity_per_shard: Optional[int] = None):
    """``pad_partition_coo`` plus the per-pair atom slot tables of the
    co-attention loss's global form (:493-526): the slots index the
    global padded flat (P_padded * T) layout, which the loss's all-gather
    rebuilds.  Returns 15 arrays (the slot tables and masks before the
    labels)."""
    (atom_ids, e_tile, e_type, e_src, e_dst, e_mask,
     mol_id, node_mask, left, right, labels) = pad_partition_coo(
        coo, n_dev, edge_capacity_per_shard)
    slots, mask = molecule_slot_table(mol_id, coo.num_mols, n_max)
    left_slots = slots[left].astype(np.int32)
    right_slots = slots[right].astype(np.int32)
    left_mask = mask[left].astype(np.float32)
    right_mask = mask[right].astype(np.float32)
    pad_pairs = len(left) - len(coo.left_index)
    if pad_pairs:
        # pad pairs point at molecule 0; their atom masks are zeroed
        left_mask[-pad_pairs:] = 0.0
        right_mask[-pad_pairs:] = 0.0
    check_side_index_injective(left, left_mask)
    check_side_index_injective(right, right_mask)
    return (atom_ids, e_tile, e_type, e_src, e_dst, e_mask, mol_id, node_mask,
            left, right, left_slots, right_slots, left_mask, right_mask,
            labels)


def pad_partition_coattn_pairlocal(coo, meta, n_max: int):
    """The 15 arrays of the pair-local co-attention loss (:539-595) for a
    batch of ``pack_pair_dataset_coo_pairlocal`` and its ``meta``: tiles,
    pairs and edges are already part-major with equal counts, so nothing
    is padded; the edge tile indices and the pair slot tables are made
    local to the part's own tiles.  Raises if a pair's atoms lie outside
    its part."""
    n, p_per = meta.n_parts, meta.tiles_per_part
    t = coo.atom_ids.shape[1]
    if coo.num_tiles != n * p_per or len(coo.left_index) != \
            n * meta.pairs_per_part:
        raise ValueError(f"batch of {coo.num_tiles} tiles and "
                         f"{len(coo.left_index)} pairs does not match {meta}")

    e_cap = meta.edge_capacity_per_part
    seg = (np.arange(n * e_cap) // e_cap).astype(np.int32)
    e_tile = np.where(coo.e_mask > 0, coo.e_tile - seg * p_per, 0
                      ).astype(np.int32)

    slots, mask = molecule_slot_table(coo.mol_id, coo.num_mols, n_max)
    left_slots = slots[coo.left_index].astype(np.int32)
    right_slots = slots[coo.right_index].astype(np.int32)
    left_mask = mask[coo.left_index].astype(np.float32)
    right_mask = mask[coo.right_index].astype(np.float32)
    pair_dev = (np.arange(len(coo.left_index))
                // meta.pairs_per_part).astype(np.int32)
    base = (pair_dev * p_per * t)[:, None]
    for sl, msk, side in ((left_slots, left_mask, "left"),
                          (right_slots, right_mask, "right")):
        real = msk > 0
        lo = np.broadcast_to(base, sl.shape)[real]
        if not ((sl[real] >= lo) & (sl[real] < lo + p_per * t)).all():
            raise ValueError(
                f"pair-local invariant violated: a {side} molecule's "
                "atoms lie outside its pair's device tile range")
    left_slots = np.where(left_mask > 0, left_slots - base, 0
                          ).astype(np.int32)
    right_slots = np.where(right_mask > 0, right_slots - base, 0
                           ).astype(np.int32)
    check_side_index_injective(coo.left_index, left_mask)
    check_side_index_injective(coo.right_index, right_mask)
    return (coo.atom_ids, e_tile, coo.e_type, coo.e_src, coo.e_dst,
            coo.e_mask, coo.mol_id, coo.node_mask, coo.left_index,
            coo.right_index, left_slots, right_slots, left_mask, right_mask,
            np.asarray(coo.labels, np.float32))


def pad_partition_gwm(coo, n_dev: int,
                      edge_capacity_per_shard: Optional[int] = None):
    """``pad_partition_coo`` plus the supernode table (set by
    ``data.packing.attach_supers_coo``), whole on every rank, at
    ``GWM_SUPERS_INDEX`` (:607-623).  Returns 12 arrays."""
    if coo.supers is None:
        raise ValueError("COO batch has no supernode features; build it "
                         "with attach_supers_coo")
    (atom_ids, e_tile, e_type, e_src, e_dst, e_mask,
     mol_id, node_mask, left, right, labels) = pad_partition_coo(
        coo, n_dev, edge_capacity_per_shard)
    return (atom_ids, e_tile, e_type, e_src, e_dst, e_mask, coo.supers,
            mol_id, node_mask, left, right, labels)


def pad_packed_global(packed, n_dev: int):
    """Pad a dense packed batch (``atom_ids``, ``adj``, ``mol_id``,
    ``node_mask``, ``left_index``, ``right_index``, ``labels``,
    ``num_mols``) for an ``n_dev``-way tile and pair split (:713-742):
    tiles and pairs to a multiple of ``n_dev``, pad pairs with label -1.
    Returns the 7 arrays in the JAX dense step's order.  The port builds
    no dense batch of its own; this pads one built elsewhere."""
    p = packed.num_tiles
    pad_tiles = (-p) % n_dev
    b = len(packed.left_index)
    pad_pairs = (-b) % n_dev

    def pad0(x, k):
        return np.pad(x, [(0, k)] + [(0, 0)] * (x.ndim - 1)) if k else x

    atom_ids = pad0(packed.atom_ids, pad_tiles)
    adj = pad0(packed.adj, pad_tiles)
    mol_id = np.pad(
        packed.mol_id, [(0, pad_tiles), (0, 0)],
        constant_values=packed.num_mols,
    ) if pad_tiles else packed.mol_id
    node_mask = pad0(packed.node_mask, pad_tiles)
    left = np.concatenate([packed.left_index, np.zeros(pad_pairs, np.int32)])
    right = np.concatenate([packed.right_index,
                            np.zeros(pad_pairs, np.int32)])
    labels = np.concatenate([np.asarray(packed.labels, np.float32),
                             -np.ones(pad_pairs, np.float32)])
    return atom_ids, adj, mol_id, node_mask, left, right, labels


# ---------------------------------------------------------------------------
# a rank's block of a partition, as its wire


@dataclasses.dataclass
class RankBatch:
    """This rank's wire arrays and labels of one global batch, and the
    global batch's directed edge count (what ``edges_per_s`` counts)."""

    wire: Tuple[np.ndarray, ...]
    labels: np.ndarray
    num_edges: int


def local_wire(arrays: Sequence[np.ndarray], rank: int,
               n_dev: int) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
    """Rank ``rank``'s block of a partition tuple (``pad_partition_coo``,
    ``_gwm``, ``_coattn`` or ``_coattn_pairlocal``; told apart by length),
    encoded as its loss's wire: (wire arrays, labels).  The slots of
    padding (``node_mask`` 0) carry the global molecule count as their id,
    so that the wire's decoded mask is the partition's."""
    gwm = len(arrays) == _GWM
    if len(arrays) not in (_COO, _GWM, _COATTN):
        raise ValueError(f"not a partition tuple: {len(arrays)} arrays")
    block = [a if gwm and i == GWM_SUPERS_INDEX
             else np.split(np.asarray(a), n_dev)[rank]
             for i, a in enumerate(arrays)]
    supers = block.pop(GWM_SUPERS_INDEX) if gwm else None
    (atom_ids, e_tile, e_type, e_src, e_dst, e_mask, mol_id, node_mask,
     left, right) = block[:10]
    labels = block[-1]
    num_mols = (supers.shape[0] if gwm else 2 * len(left) * n_dev)
    batch = PackedCOOBatch(
        atom_ids=atom_ids,
        mol_id=np.where(node_mask > 0, mol_id, num_mols).astype(np.int32),
        node_mask=node_mask, e_tile=e_tile, e_type=e_type, e_src=e_src,
        e_dst=e_dst, e_mask=e_mask, num_mols=num_mols, left_index=left,
        right_index=right, labels=labels)
    nodes, e_packed, n_edges, left, right = compact_coo_arrays(batch)
    if gwm:
        return (nodes, e_packed, n_edges, supers, left, right), labels
    return (nodes, e_packed, n_edges, left, right, *block[10:-1]), labels


def _place(wire, labels, device):
    return tuple(torch.as_tensor(np.asarray(a)).to(device)
                 for a in (*wire, labels))


def shard_packed_coo_batch(coo, mesh, axis: str = "graph",
                           edge_capacity_per_shard: Optional[int] = None,
                           device="cuda"):
    """``pad_partition_coo``, then this rank's wire and labels on
    ``device`` (:484-490): the COO loss's arguments."""
    group, n_dev, rank = _axis(mesh, axis)
    return _place(*local_wire(pad_partition_coo(
        coo, n_dev, edge_capacity_per_shard), rank, n_dev), device)


def shard_packed_coattn_batch(coo, mesh, axis: str = "graph",
                              n_max: int = 48,
                              edge_capacity_per_shard: Optional[int] = None,
                              device="cuda"):
    """``pad_partition_coattn``, then this rank's wire and labels."""
    group, n_dev, rank = _axis(mesh, axis)
    return _place(*local_wire(pad_partition_coattn(
        coo, n_dev, n_max, edge_capacity_per_shard), rank, n_dev), device)


def shard_packed_coattn_batch_pairlocal(coo, meta, mesh, axis: str = "graph",
                                        n_max: int = 48, device="cuda"):
    """``pad_partition_coattn_pairlocal``, then this rank's wire and
    labels."""
    group, n_dev, rank = _axis(mesh, axis)
    return _place(*local_wire(pad_partition_coattn_pairlocal(
        coo, meta, n_max), rank, n_dev), device)


def shard_packed_gwm_batch(coo, mesh, axis: str = "graph",
                           edge_capacity_per_shard: Optional[int] = None,
                           device="cuda"):
    """``pad_partition_gwm``, then this rank's wire (the whole supernode
    table) and labels."""
    group, n_dev, rank = _axis(mesh, axis)
    return _place(*local_wire(pad_partition_gwm(
        coo, n_dev, edge_capacity_per_shard), rank, n_dev), device)


def stack_sharded_batches(argses, mesh, axis: str = "graph"):
    """Stack S partition tuples into the (stacked wire, stacked labels)
    of this rank that ``make_edgeshard_scan_train_step`` takes
    (:691-710), each numpy array with its leading (S,) axis."""
    group, n_dev, rank = _axis(mesh, axis)
    locals_ = [local_wire(a, rank, n_dev) for a in argses]
    stacked = tuple(np.stack([w[i] for w, _ in locals_])
                    for i in range(len(locals_[0][0])))
    return stacked, np.stack([lab for _, lab in locals_])
