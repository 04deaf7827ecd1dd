"""ctypes bindings for the native packed-batch builder (native/pack.cpp).

The port's copy of the COO half of gcnbmp_tpu/data/native_pack.py: the
Python packer in ``data.packing`` is the executable spec, the native
library gives byte-identical batches about 100x faster.
``gcnbmp_tpu_torch.native_lib`` builds it at first use.

Usage:
    cache = PairDatasetCache(ds)               # once per dataset
    batch = pack_pairs_native(cache, idx, ...) # per training batch
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from gcnbmp_tpu_torch import native_lib
from gcnbmp_tpu_torch.data.packing import TILE, PackedCOOBatch, _pad_coo

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


def _configure(lib: ctypes.CDLL) -> None:
    lib.pack_pairs.restype = ctypes.c_void_p
    lib.pack_pairs.argtypes = [
        _I32P, ctypes.c_int32,          # indices, n_pairs
        _I32P, _I64P, _I32P,            # sizes, atom_offsets, atom_ids_flat
        _I64P, _I32P, _I32P, _I32P,     # edge_offsets, e_type, e_src, e_dst
        ctypes.c_int32, ctypes.c_int32,  # tile, num_tiles
        ctypes.c_int32, ctypes.c_int32,  # want_dense, n_threads
    ]
    for name in ("error", "tiles", "n_edges"):
        fn = getattr(lib, f"pack_out_{name}")
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_void_p]
    for name in ("atom_ids", "mol_id", "e_tile", "e_type", "e_src", "e_dst",
                 "left_index", "right_index"):
        fn = getattr(lib, f"pack_out_{name}")
        fn.restype = _I32P
        fn.argtypes = [ctypes.c_void_p]
    lib.pack_out_node_mask.restype = _F32P
    lib.pack_out_node_mask.argtypes = [ctypes.c_void_p]
    lib.pack_free.restype = None
    lib.pack_free.argtypes = [ctypes.c_void_p]


def load_library(build: bool = True) -> Optional[ctypes.CDLL]:
    return native_lib.load("pack", _configure, build=build)


def native_pack_available() -> bool:
    return load_library() is not None


class PairDatasetCache:
    """Flattened per-dataset arrays the native packer gathers from.

    Cache molecule ``2*r`` is the left molecule of dataset row r, ``2*r+1``
    the right one (matching pack_pair_dataset_coo's interleaving).
    """

    def __init__(self, ds):
        mols = []
        for i in range(len(ds)):
            mols.append(ds.graphs1[i])
            mols.append(ds.graphs2[i])
        self.sizes = np.asarray([m.num_atoms for m in mols], np.int32)
        self.atom_offsets = np.zeros(len(mols) + 1, np.int64)
        np.cumsum(self.sizes, out=self.atom_offsets[1:])
        self.atom_ids_flat = (
            np.concatenate([m.atom_ids for m in mols]).astype(np.int32)
            if mols else np.zeros(0, np.int32)
        )
        edge_counts = np.asarray([m.num_edges for m in mols], np.int64)
        self.edge_offsets = np.zeros(len(mols) + 1, np.int64)
        np.cumsum(edge_counts, out=self.edge_offsets[1:])
        cat = lambda arrs: (
            np.concatenate(arrs).astype(np.int32) if arrs else np.zeros(0, np.int32)
        )
        self.e_type_flat = cat([m.edge_type for m in mols])
        self.e_src_flat = cat([m.edge_src for m in mols])
        self.e_dst_flat = cat([m.edge_dst for m in mols])
        self.labels = np.stack([
            np.atleast_1d(np.asarray(l, np.float32)) for l in ds.labels
        ]) if len(ds) else np.zeros((0, 1), np.float32)

    def batch_labels(self, indices: Sequence[int]) -> np.ndarray:
        labels = self.labels[np.asarray(indices, np.int64)]
        if labels.shape[-1] == 1:
            labels = labels[:, 0]
        return labels


def pack_pairs_native(
    cache: PairDatasetCache,
    indices: Sequence[int],
    tile: int = TILE,
    num_tiles: Optional[int] = None,
    edge_capacity: Optional[int] = None,
    n_threads: int = 0,
) -> PackedCOOBatch:
    """Native twin of pack_pair_dataset_coo; byte-identical output."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native pack library unavailable (no C++ "
                           "compiler, or native/pack.cpp failed to build)")
    idx = np.ascontiguousarray(indices, np.int32)
    p = lambda a, t: a.ctypes.data_as(t)
    h = lib.pack_pairs(
        p(idx, _I32P), len(idx),
        p(cache.sizes, _I32P), p(cache.atom_offsets, _I64P),
        p(cache.atom_ids_flat, _I32P), p(cache.edge_offsets, _I64P),
        p(cache.e_type_flat, _I32P), p(cache.e_src_flat, _I32P),
        p(cache.e_dst_flat, _I32P),
        tile, 0 if num_tiles is None else num_tiles, 0, n_threads,
    )
    try:
        err = lib.pack_out_error(h)
        if err == 1:
            raise ValueError(f"molecule exceeds tile size {tile}")
        if err == 2:
            raise ValueError(f"num_tiles={num_tiles} too small for batch")
        tiles = lib.pack_out_tiles(h)
        n_edges = lib.pack_out_n_edges(h)
        n_pairs = len(idx)

        def arr(name, shape, dtype=np.int32):
            ptr = getattr(lib, f"pack_out_{name}")(h)
            out = np.empty(shape, dtype)
            ctypes.memmove(out.ctypes.data, ptr, out.nbytes)
            return out

        shape_e = (max(n_edges, 1),)
        e_tile, e_type, e_src, e_dst, e_mask = _pad_coo(
            arr("e_tile", shape_e)[:n_edges], arr("e_type", shape_e)[:n_edges],
            arr("e_src", shape_e)[:n_edges], arr("e_dst", shape_e)[:n_edges],
            edge_capacity,
        )
        return PackedCOOBatch(
            atom_ids=arr("atom_ids", (tiles, tile)),
            mol_id=arr("mol_id", (tiles, tile)),
            node_mask=arr("node_mask", (tiles, tile), np.float32),
            e_tile=e_tile, e_type=e_type, e_src=e_src, e_dst=e_dst,
            e_mask=e_mask, num_mols=2 * n_pairs,
            left_index=arr("left_index", (n_pairs,)),
            right_index=arr("right_index", (n_pairs,)),
            labels=cache.batch_labels(indices),
        )
    finally:
        lib.pack_free(h)
