"""The wire-compact COO batch encoding and fixed-shape eval batches.

Ports host numpy code that lives inside jax modules of the JAX package
(and so cannot be imported without jax):

- ``compact_coo_arrays``        <- gcnbmp_tpu/models/packed.py:1055-1088
- ``compact_coattn_arrays``     <- gcnbmp_tpu/models/packed.py:1036-1052
- ``compact_gwm_arrays``        <- gcnbmp_tpu/models/packed.py:1091-1099
- ``iter_coo_eval_batches``     <- gcnbmp_tpu/train/loop.py:577-616
- ``packed_coo_batch_iterator`` <- gcnbmp_tpu/train/loop.py:437-519
- ``_window_parallel``          <- gcnbmp_tpu/train/loop.py:413-434
- ``scan_chunk_iterator``       <- gcnbmp_tpu/train/loop.py:393-410

The bit layout must stay identical to the JAX package's, so one batch
feeds both packages: edges pack as ``tile | type | src | dst`` with src
and dst in ``log2(T)``-bit lanes (T=128 -> 7 bits; ``4*P*T^2`` must fit
in int31, i.e. P < 2^15 tiles).  ``models.packed.decode_compact_wire``
is the device-side inverse.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

from gcnbmp_tpu_torch.data import native_pack
from gcnbmp_tpu_torch.data.packing import (
    PackedCOOBatch,
    attach_supers_coo,
    check_side_index_injective,
    molecule_slot_table,
    pack_pair_dataset_coo,
    pack_pair_dataset_coo_pairlocal,
    smallest_pair_index,
)


def compact_coo_arrays(batch: PackedCOOBatch) -> Tuple:
    """Encode a PackedCOOBatch into the wire-compact form:

        nodes (2, P, T) int32, e_packed (E,) int32, n_edges () int32,
        left_index (B,), right_index (B,)
    """
    t = batch.atom_ids.shape[1]
    sbits = int(t - 1).bit_length()
    nodes = np.stack([batch.atom_ids, batch.mol_id])
    # the wire masks edges by position (arange < n_edges), so real edges
    # must form a prefix; stably compact any gaps first (a no-op for the
    # standard packers)
    real = batch.e_mask > 0
    n_real = int(real.sum())
    e_tile, e_type, e_src, e_dst = (
        batch.e_tile, batch.e_type, batch.e_src, batch.e_dst)
    if not real[:n_real].all():
        order = np.argsort(~real, kind="stable")
        e_tile, e_type, e_src, e_dst = (
            e_tile[order], e_type[order], e_src[order], e_dst[order])
    e_packed = (
        ((e_tile << 2 | e_type) << (2 * sbits))
        | (e_src << sbits)
        | e_dst
    ).astype(np.int32)
    n_edges = np.int32(n_real)
    return nodes, e_packed, n_edges, batch.left_index, batch.right_index


def compact_coattn_arrays(batch: PackedCOOBatch, n_max: int) -> Tuple:
    """``compact_coo_arrays`` plus each pair side's atom slot table and
    mask (B, n_max), the co-attention predictor's wire: nine arrays, all
    4-byte (int32, the masks f32)."""
    base = compact_coo_arrays(batch)
    slots, mask = molecule_slot_table(batch.mol_id, batch.num_mols, n_max)
    lmask = mask[batch.left_index]
    rmask = mask[batch.right_index]
    check_side_index_injective(batch.left_index, lmask)
    check_side_index_injective(batch.right_index, rmask)
    return base + (slots[batch.left_index], slots[batch.right_index],
                   lmask, rmask)


def compact_gwm_arrays(batch: PackedCOOBatch) -> Tuple:
    """``compact_coo_arrays`` with the supernode table (num_mols, F) f32
    before left_index, right_index: the GWM predictor's wire."""
    nodes, e_packed, n_edges, left, right = compact_coo_arrays(batch)
    if batch.supers is None:
        raise ValueError("COO batch has no supernode features; build it "
                         "with attach_supers_coo")
    return nodes, e_packed, n_edges, batch.supers, left, right


def _pair_cache(ds):
    """The native packer's per-dataset cache, or None when the native
    packer does not load (the Python packer is used then)."""
    if not native_pack.native_pack_available():
        return None
    cache = getattr(ds, "_native_pack_cache", None)
    if cache is None:
        cache = native_pack.PairDatasetCache(ds)
        ds._native_pack_cache = cache
    return cache


def _window_parallel(items, build, workers: int):
    """Yield build(item) in order with a ``workers``-deep lookahead on a
    thread pool (the native packer releases the GIL, so packing overlaps
    the device step)."""
    with ThreadPoolExecutor(max_workers=workers) as ex:
        pending = deque()
        for item in items:
            pending.append(ex.submit(build, item))
            if len(pending) > workers:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def packed_coo_batch_iterator(ds, batch_size: int, num_tiles: int,
                              edge_capacity: int, rng: np.random.Generator,
                              supernode_fn=None, pack_workers: int = 4,
                              pack_cache: Optional[List[PackedCOOBatch]] = None,
                              pairlocal_parts: Optional[int] = None
                              ) -> Iterator[PackedCOOBatch]:
    """Shuffled training batches with fixed tile and edge capacities; the
    tail batch is dropped.  The order comes from ``rng`` (the trainer's
    generator), packing runs ``pack_workers`` batches ahead, with the
    native packer when it loads.  ``pack_cache``: a caller-owned list;
    empty, it collects this epoch's batches; filled, its batches are
    yielded in a fresh random order without packing (``reuse_packs``), the
    supernode tables they hold with them.  ``supernode_fn`` attaches the
    per-molecule supernode table (GWM, ``attach_supers_coo``) to each
    batch after packing.  ``pairlocal_parts``: pack each batch with
    ``pack_pair_dataset_coo_pairlocal`` into that many parts of
    ``num_tiles`` tiles and ``edge_capacity`` edges each (the
    multi-device co-attention path).  A supernode table is refused
    there: the pair-local batch holds padding pairs and reorders the
    pairs by part, so ``attach_supers_coo``'s map from the dataset's
    pairs to the batch's molecules does not hold (ROADMAP queue 3; the
    JAX trainer never combines the two either, loop.py:507)."""
    if pairlocal_parts and supernode_fn is not None:
        raise ValueError("pair-local packing with a supernode table: the "
                         "pair-local batch reorders and pads the pairs, "
                         "which attach_supers_coo cannot follow")
    if pack_cache:
        for i in rng.permutation(len(pack_cache)):
            yield pack_cache[i]
        return
    cache = _pair_cache(ds)
    order = np.arange(len(ds))
    rng.shuffle(order)

    def build(start):
        idx = order[start:start + batch_size].tolist()
        if pairlocal_parts:
            return pack_pair_dataset_coo_pairlocal(
                ds, idx, pairlocal_parts, tiles_per_part=num_tiles,
                edge_capacity_per_part=edge_capacity,
                pack_fn=lambda i2, nt, ec: _pack(ds, cache, i2, nt, ec))[0]
        return _pack(ds, cache, idx, num_tiles, edge_capacity, supernode_fn)

    starts = range(0, len(ds) - batch_size + 1, batch_size)
    produced = (_window_parallel(starts, build, pack_workers)
                if pack_workers > 1 else (build(s) for s in starts))
    for b in produced:
        if pack_cache is not None:
            pack_cache.append(b)
        yield b


def _pack(ds, cache, idx, num_tiles: int, edge_capacity: int,
          supernode_fn=None) -> PackedCOOBatch:
    """The COO batch of pairs ``idx``: the native packer when ``cache``
    is given, else the Python one; then the supernode table."""
    if cache is not None:
        batch = native_pack.pack_pairs_native(
            cache, idx, num_tiles=num_tiles, edge_capacity=edge_capacity)
    else:
        batch = pack_pair_dataset_coo(ds, idx, num_tiles=num_tiles,
                                      edge_capacity=edge_capacity)
    if supernode_fn is not None:
        batch = attach_supers_coo(batch, ds, idx, supernode_fn)
    return batch


def scan_chunk_iterator(batches, scan_steps: int, args_fn):
    """Group a COO batch iterator into stacks of ``scan_steps`` batches:
    yields (stacked wire arrays, stacked labels, edge count), each array
    with a leading (S,) axis, ready for one scan-mode call.  The tail
    chunk is dropped; like the per-epoch tail batch, its pairs return
    next epoch under the reshuffle."""
    chunk = []
    for b in batches:
        chunk.append(b)
        if len(chunk) == scan_steps:
            argses = [args_fn(c) for c in chunk]
            stacked = tuple(
                np.stack([a[i] for a in argses])
                for i in range(len(argses[0]))
            )
            labels = np.stack([c.labels for c in chunk])
            edges = int(sum(c.num_edges for c in chunk))
            yield stacked, labels, edges
            chunk = []


def iter_coo_eval_batches(
    ds, batch_size: int, num_tiles: int, edge_capacity: int,
    supernode_fn=None,
) -> Iterator[Tuple[PackedCOOBatch, int]]:
    """Sequential fixed-shape COO batches over a whole dataset: yields
    (PackedCOOBatch, valid_count).  Tail batches are filled with the
    dataset's smallest pair so the capacities from
    ``estimate_coo_capacities`` hold for every batch; callers drop rows
    past ``valid_count``.  Uses the native C++ packer when it loads;
    ``supernode_fn`` attaches the supernode table (GWM)."""
    cache = _pair_cache(ds)
    fill = smallest_pair_index(ds)
    n = len(ds)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        valid = len(idx)
        idx = idx + [fill] * (batch_size - valid)
        yield _pack(ds, cache, idx, num_tiles, edge_capacity,
                    supernode_fn), valid
