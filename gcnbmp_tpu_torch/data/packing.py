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
(``ops.aggregate.adj_from_coo_flat``).  The dense host-side batches,
supernode features and pair-local packing of the JAX module belong to
layouts and encoders the port has not taken yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from gcnbmp_tpu_torch.chem.featurize import MolGraph

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

    @property
    def num_tiles(self) -> int:
        return int(self.atom_ids.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.e_mask.sum())

    @property
    def occupancy(self) -> float:
        return float(self.node_mask.mean())


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
