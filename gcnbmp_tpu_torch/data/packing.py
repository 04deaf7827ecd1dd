"""Packed supergraph batching in COO form (the port's copy of the COO
parts of gcnbmp_tpu/data/packing.py).

Many small molecules are bin-packed (first-fit decreasing) into fixed
tiles of TILE=128 atoms.  A batch is

    atom_ids  (P, 128)  int32   atoms of all packed molecules
    mol_id    (P, 128)  int32   molecule index per slot (pads -> num_mols)
    node_mask (P, 128)  f32
    e_tile, e_type, e_src, e_dst, e_mask (E_cap,)  the edges, padded

Molecules never split across tiles and mol_id ascends within each tile.
The dense adjacency is built on the device from the edges
(``ops.aggregate.adj_from_coo_flat``), also for the ``packed`` compute
path.  A batch for GWM carries the per-molecule supernode table
``supers`` (num_mols, F) in packed-mol-id order (``attach_supers_coo``).
``pack_pair_dataset_coo_pairlocal`` packs the multi-device co-attention
path's batches: each pair's two molecules in one rank's tiles.  The dense
host-side batches of the JAX module are not ported: every layout builds
its adjacency on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from gcnbmp_tpu_torch.chem.featurize import NUM_EDGE_TYPES, MolGraph

TILE = 128


def _first_fit_pack(sizes: Sequence[int], tile: int) -> List[List[int]]:
    """First-fit-decreasing bin packing; returns list of molecule-index
    lists per tile."""
    # stable sort so the order is well-defined under ties — the native
    # C++ packer (native/pack.cpp) replicates exactly this ordering
    order = np.argsort(np.asarray(sizes), kind="stable")[::-1]
    bins: List[List[int]] = []
    space: List[int] = []
    for idx in order:
        s = sizes[idx]
        if s > tile:
            raise ValueError(f"molecule with {s} atoms exceeds tile size {tile}")
        placed = False
        for b in range(len(bins)):
            if space[b] >= s:
                bins[b].append(int(idx))
                space[b] -= s
                placed = True
                break
        if not placed:
            bins.append([int(idx)])
            space.append(tile - s)
    return bins


def estimate_tiles(sizes: Sequence[int], tile: int = TILE, slack: float = 1.1) -> int:
    """Upper-bound tile count for fixed shapes across shuffled batches."""
    total = int(np.sum(sizes))
    return int(np.ceil(slack * total / tile)) + 1


def max_atoms_lane_rounded(datasets, round_to: int = 8) -> int:
    """The largest molecule across ``datasets`` (graphs1+graphs2),
    rounded up to a multiple of ``round_to``: the dense-Set2Set atom-table
    width."""
    m = 0
    for ds in datasets:
        if len(ds) == 0:
            continue
        m = max(m, max(g.num_atoms for g in ds.graphs1))
        m = max(m, max(g.num_atoms for g in ds.graphs2))
    return ((max(m, 1) + round_to - 1) // round_to) * round_to


def estimate_coo_capacities(datasets, batch_size: int, tile: int = TILE):
    """Static (num_tiles, edge_capacity) bounds covering every
    ``batch_size``-pair batch drawn from any of ``datasets`` — shuffled
    train batches and sequential eval batches alike.

    The tile bound runs the real first-fit-decreasing packer on the
    worst-case batch (the largest ``2*batch_size`` molecules) rather
    than an occupancy estimate: bin-packing fragmentation makes the
    occupancy bound unsound (e.g. uniform 43-atom molecules pack 2 per
    128-slot tile, 33% waste).  Both bounds are still taken, +1 margin.

    When a dataset has fewer pairs than ``batch_size``, eval tail
    batches repeat the smallest pair (iter_coo_eval_batches) — the fill
    copies are added to the worst-case batch here so the bounds cover
    them too."""
    num_tiles = 0
    edge_capacity = 0
    for ds in datasets:
        n = len(ds)
        if n == 0:
            continue
        k = min(batch_size, n)
        fill = batch_size - k
        sizes = sorted(
            [g.num_atoms for g in ds.graphs1]
            + [g.num_atoms for g in ds.graphs2],
            reverse=True,
        )
        worst = list(sizes[: 2 * k])
        per_pair = sorted(
            (ds.graphs1[i].num_edges + ds.graphs2[i].num_edges
             for i in range(n)),
            reverse=True,
        )
        cap = int(sum(per_pair[:k]))
        if fill > 0:
            i = smallest_pair_index(ds)
            worst += [ds.graphs1[i].num_atoms,
                      ds.graphs2[i].num_atoms] * fill
            cap += fill * (ds.graphs1[i].num_edges + ds.graphs2[i].num_edges)
        ffd_tiles = len(_first_fit_pack(worst, tile))
        occ_tiles = estimate_tiles(worst, tile, slack=1.0)
        num_tiles = max(num_tiles, max(ffd_tiles, occ_tiles) + 1)
        edge_capacity = max(edge_capacity, ((cap + 127) // 128) * 128 + 128)
    return num_tiles, edge_capacity


def smallest_pair_index(ds) -> int:
    """Index of the pair with the fewest atoms (ties: fewest edges) — the
    safe tail-batch fill row.  Filling with pair 0 can overflow the
    static capacity bounds when pair 0 happens to be large; filling with
    the smallest pair never can."""
    return int(min(
        range(len(ds)),
        key=lambda i: (
            ds.graphs1[i].num_atoms + ds.graphs2[i].num_atoms,
            ds.graphs1[i].num_edges + ds.graphs2[i].num_edges,
        ),
    ))


def _supers_problems(supers, num_mols: int) -> List[str]:
    if supers is None:
        return []
    if supers.ndim != 2 or supers.shape[0] != num_mols:
        return [f"supers shape {supers.shape}, not ({num_mols}, F)"]
    if not np.isfinite(supers).all():
        return ["supers not finite"]
    return []


@dataclass
class PackedCOOBatch:
    """Packed tiles with the adjacency in COO form.

    Edge arrays are padded to a fixed capacity (``e_mask`` = 1 for real
    edges) so shapes stay fixed across shuffled batches.
    """

    atom_ids: np.ndarray   # (P, TILE) int32
    mol_id: np.ndarray     # (P, TILE) int32; padding slots = num_mols
    node_mask: np.ndarray  # (P, TILE) float32
    e_tile: np.ndarray     # (E_cap,) int32
    e_type: np.ndarray     # (E_cap,) int32
    e_src: np.ndarray      # (E_cap,) int32  (tile-local row, offset applied)
    e_dst: np.ndarray      # (E_cap,) int32
    e_mask: np.ndarray     # (E_cap,) float32
    num_mols: int
    left_index: np.ndarray   # (B,) int32
    right_index: np.ndarray  # (B,) int32
    labels: np.ndarray       # (B,) or (B, C) float32
    # per-molecule feature vectors in packed-mol-id order (num_mols, F);
    # set by attach_supers_coo for supernode encoders (PackedGGNN_GWM)
    supers: Optional[np.ndarray] = None

    @property
    def num_tiles(self) -> int:
        return int(self.atom_ids.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.e_mask.sum())

    @property
    def occupancy(self) -> float:
        return float(self.node_mask.mean())

    def validate(self) -> "PackedCOOBatch":
        """Bounds and consistency check of the COO wire format (the
        trainer's ``debug_checks``; gcnbmp_tpu/data/packing.py:320-354,
        the same checks and error text).  The device's COO scatter takes
        out-of-range indices on trust; this turns a corrupted batch or a
        packer fault into an error on the host, before any launch."""
        p = self.num_tiles
        real = self.e_mask > 0
        problems = []
        for name, arr, hi in (
            ("e_tile", self.e_tile, p), ("e_type", self.e_type,
                                         NUM_EDGE_TYPES),
            ("e_src", self.e_src, TILE), ("e_dst", self.e_dst, TILE),
        ):
            bad = (arr[real] < 0) | (arr[real] >= hi)
            if bad.any():
                problems.append(f"{name}: {int(bad.sum())} edges out of "
                                f"[0, {hi})")
        if not np.isin(self.e_mask, (0.0, 1.0)).all():
            problems.append("e_mask not 0/1")
        if ((self.mol_id >= self.num_mols) != (self.node_mask == 0)).any():
            problems.append("node_mask inconsistent with mol_id padding")
        idx = np.concatenate([self.left_index, self.right_index])
        if ((idx < 0) | (idx >= self.num_mols)).any():
            problems.append("left/right_index out of range")
        if not problems:
            # real edges must land on real (unpadded) node slots, which
            # is checkable only once the indices are in bounds
            src_ok = self.node_mask[self.e_tile[real], self.e_src[real]] > 0
            dst_ok = self.node_mask[self.e_tile[real], self.e_dst[real]] > 0
            if not (src_ok.all() and dst_ok.all()):
                problems.append("edges touch padded node slots")
        problems += _supers_problems(self.supers, self.num_mols)
        if problems:
            raise ValueError("invalid PackedCOOBatch: " + "; ".join(problems))
        return self


def molecule_slot_table(mol_id: np.ndarray, num_mols: int,
                        n_max: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each molecule's flat slot indices into the packed layout
    (gcnbmp_tpu/data/packing.py:465-489): ``slots (num_mols, n_max)
    int32`` index the flattened (P*T,) node axis (pad entries point at
    slot 0) and ``mask (num_mols, n_max) float32`` marks the real ones.
    The co-attention predictor gathers each pair's atom tables with them."""
    flat = mol_id.reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=num_mols + 1)[:num_mols]
    if counts.size and counts.max(initial=0) > n_max:
        raise ValueError(f"molecule with {counts.max()} atoms > n_max={n_max}")
    total = int(counts.sum())
    starts = np.zeros(num_mols + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rows = np.repeat(np.arange(num_mols), counts)
    cols = np.arange(total) - np.repeat(starts[:-1], counts)
    slots = np.zeros((num_mols, n_max), np.int32)
    mask = np.zeros((num_mols, n_max), np.float32)
    slots[rows, cols] = order[:total].astype(np.int32)
    mask[rows, cols] = 1.0
    return slots, mask


def check_side_index_injective(index: np.ndarray, mask: np.ndarray) -> None:
    """Raise when a co-attention side index repeats a molecule over rows
    that have real atoms (:492-505): ``ops.slotgather.side_mol_row``
    would drop one row's gradient."""
    real = np.asarray(mask).reshape(mask.shape[0], -1).any(axis=1)
    ids = np.asarray(index)[real]
    if ids.size != np.unique(ids).size:
        raise ValueError(
            "co-attention side index repeats a molecule id across rows "
            "with real atoms; slotgather.side_mol_row requires injectivity"
        )


def _pad_coo(e_tile, e_type, e_src, e_dst, edge_capacity: Optional[int]):
    n = len(e_tile)
    cap = n if edge_capacity is None else edge_capacity
    if cap < n:
        raise ValueError(f"edge_capacity={cap} < actual edges {n}")
    out = []
    for a in (e_tile, e_type, e_src, e_dst):
        pad = np.zeros(cap, np.int32)
        pad[:n] = a
        out.append(pad)
    mask = np.zeros(cap, np.float32)
    mask[:n] = 1.0
    return (*out, mask)


def pack_pair_dataset_coo(
    ds,
    indices: Sequence[int],
    tile: int = TILE,
    num_tiles: Optional[int] = None,
    edge_capacity: Optional[int] = None,
) -> PackedCOOBatch:
    """Python COO packer (spec for native/pack.cpp; identical output)."""
    graphs: List[MolGraph] = []
    labels = []
    for i in indices:
        graphs.append(ds.graphs1[i])
        graphs.append(ds.graphs2[i])
        labels.append(np.atleast_1d(ds.labels[i]).astype(np.float32))
    labels = np.stack(labels)
    if labels.shape[-1] == 1:
        labels = labels[:, 0]
    n_mols = len(graphs)
    sizes = [g.num_atoms for g in graphs]
    bins = _first_fit_pack(sizes, tile)
    p = len(bins)
    if num_tiles is not None:
        if num_tiles < p:
            raise ValueError(f"num_tiles={num_tiles} < required {p}")
        p = num_tiles
    atom_ids = np.zeros((p, tile), np.int32)
    mol_id = np.full((p, tile), n_mols, np.int32)
    node_mask = np.zeros((p, tile), np.float32)
    placements: List[Tuple[int, int, int]] = []
    for b, members in enumerate(bins):
        off = 0
        for idx in sorted(members):
            placements.append((idx, b, off))
            off += sizes[idx]
    placements.sort(key=lambda t: (t[1], t[2]))
    remap = np.empty(n_mols, np.int32)
    et_l, es_l, ed_l, tl_l = [], [], [], []
    for new_id, (orig_idx, b, off) in enumerate(placements):
        remap[orig_idx] = new_id
        g = graphs[orig_idx]
        k = g.num_atoms
        atom_ids[b, off : off + k] = g.atom_ids
        mol_id[b, off : off + k] = new_id
        node_mask[b, off : off + k] = 1.0
        et_l.append(g.edge_type.astype(np.int32))
        es_l.append((g.edge_src + off).astype(np.int32))
        ed_l.append((g.edge_dst + off).astype(np.int32))
        tl_l.append(np.full(g.edge_type.shape[0], b, np.int32))
    e_tile, e_type, e_src, e_dst, e_mask = _pad_coo(
        np.concatenate(tl_l), np.concatenate(et_l),
        np.concatenate(es_l), np.concatenate(ed_l), edge_capacity,
    )
    return PackedCOOBatch(
        atom_ids=atom_ids, mol_id=mol_id, node_mask=node_mask,
        e_tile=e_tile, e_type=e_type, e_src=e_src, e_dst=e_dst, e_mask=e_mask,
        num_mols=n_mols,
        left_index=remap[0::2].astype(np.int32),
        right_index=remap[1::2].astype(np.int32),
        labels=np.asarray(labels, np.float32),
    )


def attach_supers_coo(batch, ds, indices: Sequence[int], supernode_fn):
    """Set ``batch.supers`` (num_mols, F) from each pair's two SMILES
    through the batch's pair -> molecule maps, so any packer's batch
    takes it (the native one knows nothing of supernodes).  Molecules no
    pair names keep the zero row.  Returns ``batch``."""
    n = len(indices)
    left = np.stack([supernode_fn(ds.graphs1[i].smiles) for i in indices])
    right = np.stack([supernode_fn(ds.graphs2[i].smiles) for i in indices])
    supers = np.zeros((batch.num_mols, left.shape[1]), np.float32)
    supers[batch.left_index[:n]] = left
    supers[batch.right_index[:n]] = right
    batch.supers = supers
    return batch


@dataclass
class PairLocalMeta:
    """Static geometry of a pair-local packed batch (uniform across
    batches, so every step sees the same shapes)."""

    n_parts: int
    tiles_per_part: int
    pairs_per_part: int
    edge_capacity_per_part: int


def assign_pairs_balanced(costs: Sequence[int],
                          n_parts: int) -> List[List[int]]:
    """LPT-greedy assignment of pair positions to ``n_parts`` buckets
    (gcnbmp_tpu/data/packing.py:522-539): equal pair counts (up to the
    padding of the last) and near-equal total cost, deterministic given
    the input order; each bucket keeps its pairs in input order."""
    cap = -(-len(costs) // n_parts)
    order = np.argsort(np.asarray(costs), kind="stable")[::-1]
    buckets: List[List[int]] = [[] for _ in range(n_parts)]
    load = np.zeros(n_parts, np.int64)
    for pos in order:
        open_b = [b for b in range(n_parts) if len(buckets[b]) < cap]
        b = min(open_b, key=lambda i: (load[i], i))
        buckets[b].append(int(pos))
        load[b] += costs[pos]
    for b in buckets:
        b.sort()
    return buckets


def pack_pair_dataset_coo_pairlocal(
    ds,
    indices: Sequence[int],
    n_parts: int,
    tile: int = TILE,
    tiles_per_part: Optional[int] = None,
    edge_capacity_per_part: Optional[int] = None,
    pack_fn=None,
) -> Tuple[PackedCOOBatch, PairLocalMeta]:
    """Pack pairs so that both molecules of every pair land in one part of
    the contiguous tile split of ``parallel.edgeshard``
    (gcnbmp_tpu/data/packing.py:542-660, the same arrays bit for bit).

    The pairs are LPT-partitioned into ``n_parts`` buckets balanced by
    edge count; each bucket is packed into its own group of
    ``tiles_per_part`` tiles and ``edge_capacity_per_part`` edges; the
    merged batch is part-major, and stays a valid single-device batch.
    A bucket short of ``pairs_per_part`` pairs gets padding pairs with
    distinct phantom molecule ids (no atoms, label -1), so that
    ``num_mols == 2 * pairs_per_part * n_parts`` follows from the shapes
    and each side index stays injective (``ops.slotgather.side_mol_row``).

    ``pack_fn(idx, num_tiles, edge_capacity) -> PackedCOOBatch`` packs one
    bucket (default: the Python packer; the trainer passes the native
    one).  Returns (merged batch, PairLocalMeta)."""
    indices = list(indices)
    if len(indices) < n_parts:
        raise ValueError(
            f"pair-local packing needs at least one pair per part "
            f"({len(indices)} pairs < {n_parts} parts); lower the "
            "device count or raise the batch size")
    if pack_fn is None:
        def pack_fn(idx, num_tiles, edge_capacity):
            return pack_pair_dataset_coo(ds, idx, tile=tile,
                                         num_tiles=num_tiles,
                                         edge_capacity=edge_capacity)

    costs = [ds.graphs1[i].num_edges + ds.graphs2[i].num_edges
             for i in indices]
    buckets = assign_pairs_balanced(costs, n_parts)
    parts = [pack_fn([indices[j] for j in b], tiles_per_part,
                     edge_capacity_per_part) for b in buckets]

    p_max = tiles_per_part or max(pt.num_tiles for pt in parts)
    e_max = edge_capacity_per_part or max(pt.e_tile.shape[0] for pt in parts)
    b_max = -(-len(indices) // n_parts)
    num_mols_g = 2 * b_max * n_parts
    label_tail = parts[0].labels.shape[1:]

    atom_ids, mol_id, node_mask = [], [], []
    e_tile, e_type, e_src, e_dst, e_mask = [], [], [], [], []
    left, right, labels = [], [], []
    for d, pt in enumerate(parts):
        pad_t = p_max - pt.num_tiles
        if pad_t < 0:
            raise ValueError(f"tiles_per_part={p_max} < bucket need "
                             f"{pt.num_tiles}")
        aid = np.pad(pt.atom_ids, [(0, pad_t), (0, 0)])
        nm = np.pad(pt.node_mask, [(0, pad_t), (0, 0)])
        mid = np.pad(pt.mol_id, [(0, pad_t), (0, 0)],
                     constant_values=pt.num_mols)
        off = d * 2 * b_max
        mid = np.where(nm > 0, mid + off, num_mols_g).astype(np.int32)
        atom_ids.append(aid)
        node_mask.append(nm)
        mol_id.append(mid)

        pad_e = e_max - pt.e_tile.shape[0]
        if pad_e < 0:
            raise ValueError(f"edge_capacity_per_part={e_max} < bucket "
                             f"need {pt.e_tile.shape[0]}")
        em = np.pad(pt.e_mask, (0, pad_e))
        et_g = np.where(em > 0, np.pad(pt.e_tile, (0, pad_e)) + d * p_max, 0)
        e_tile.append(et_g.astype(np.int32))
        e_type.append(np.pad(pt.e_type, (0, pad_e)))
        e_src.append(np.pad(pt.e_src, (0, pad_e)))
        e_dst.append(np.pad(pt.e_dst, (0, pad_e)))
        e_mask.append(em)

        pad_b = b_max - len(pt.left_index)
        l_g = pt.left_index + off
        r_g = pt.right_index + off
        lab = np.asarray(pt.labels, np.float32)
        if pad_b:
            ph = off + pt.num_mols + 2 * np.arange(pad_b, dtype=np.int32)
            l_g = np.concatenate([l_g, ph])
            r_g = np.concatenate([r_g, ph + 1])
            lab = np.concatenate(
                [lab, -np.ones((pad_b,) + label_tail, np.float32)])
        left.append(l_g.astype(np.int32))
        right.append(r_g.astype(np.int32))
        labels.append(lab)

    merged = PackedCOOBatch(
        atom_ids=np.concatenate(atom_ids),
        mol_id=np.concatenate(mol_id),
        node_mask=np.concatenate(node_mask),
        e_tile=np.concatenate(e_tile),
        e_type=np.concatenate(e_type),
        e_src=np.concatenate(e_src),
        e_dst=np.concatenate(e_dst),
        e_mask=np.concatenate(e_mask),
        num_mols=num_mols_g,
        left_index=np.concatenate(left),
        right_index=np.concatenate(right),
        labels=np.concatenate(labels),
    )
    meta = PairLocalMeta(n_parts=n_parts, tiles_per_part=p_max,
                         pairs_per_part=b_max, edge_capacity_per_part=e_max)
    return merged, meta
