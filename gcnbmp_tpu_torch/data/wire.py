"""The wire-compact COO batch encoding and fixed-shape eval batches.

Ports two pieces of host numpy code that live inside jax modules of the
JAX package (and so cannot be imported without jax):

- ``compact_coo_arrays``    <- gcnbmp_tpu/models/packed.py:1055-1088
- ``iter_coo_eval_batches`` <- gcnbmp_tpu/train/loop.py:577-614

The bit layout must stay identical to the JAX package's, so one batch
feeds both packages: edges pack as ``tile | type | src | dst`` with src
and dst in ``log2(T)``-bit lanes (T=128 -> 7 bits; ``4*P*T^2`` must fit
in int31, i.e. P < 2^15 tiles).  ``models.packed.decode_compact_wire``
is the device-side inverse.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from gcnbmp_tpu.data import native_pack
from gcnbmp_tpu.data.packing import (
    PackedCOOBatch,
    pack_pair_dataset_coo,
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


def iter_coo_eval_batches(
    ds, batch_size: int, num_tiles: int, edge_capacity: int
) -> Iterator[Tuple[PackedCOOBatch, int]]:
    """Sequential fixed-shape COO batches over a whole dataset: yields
    (PackedCOOBatch, valid_count).  Tail batches are filled with the
    dataset's smallest pair so the capacities from
    ``estimate_coo_capacities`` hold for every batch; callers drop rows
    past ``valid_count``.  Uses the native C++ packer when it loads."""
    cache = None
    if native_pack.native_pack_available():
        cache = getattr(ds, "_native_pack_cache", None)
        if cache is None:
            cache = native_pack.PairDatasetCache(ds)
            ds._native_pack_cache = cache
    fill = smallest_pair_index(ds)
    n = len(ds)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        valid = len(idx)
        idx = idx + [fill] * (batch_size - valid)
        if cache is not None:
            batch = native_pack.pack_pairs_native(
                cache, idx, num_tiles=num_tiles, edge_capacity=edge_capacity
            )
        else:
            batch = pack_pair_dataset_coo(
                ds, idx, num_tiles=num_tiles, edge_capacity=edge_capacity
            )
        yield batch, valid
