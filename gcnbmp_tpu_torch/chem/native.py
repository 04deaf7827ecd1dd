"""ctypes bindings to the native C++ SMILES parser/featurizer.

The port's copy of gcnbmp_tpu/chem/native.py: ``native/smiles.cpp``
implements the same chemistry as ``chem/smiles.py`` with multi-threaded
batch parsing.  ``gcnbmp_tpu_torch.native_lib`` builds it at first use;
without a C++ compiler the parser falls back to the pure-Python one.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

from gcnbmp_tpu_torch import native_lib
from gcnbmp_tpu_torch.chem.featurize import MolGraph


def _configure(lib: ctypes.CDLL) -> None:
    lib.smiles_parse_batch.restype = ctypes.c_void_p
    lib.smiles_parse_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32,
    ]
    for name in ("mol_ok", "atom_offsets", "bond_offsets", "atomic_nums",
                 "aromatic", "charges", "total_h", "degrees",
                 "bond_a1", "bond_a2", "bond_order"):
        fn = getattr(lib, f"smiles_batch_{name}")
        fn.restype = ctypes.POINTER(ctypes.c_int32)
        fn.argtypes = [ctypes.c_void_p]
    for name in ("n_atoms", "n_bonds"):
        fn = getattr(lib, f"smiles_batch_{name}")
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_void_p]
    lib.smiles_batch_free.restype = None
    lib.smiles_batch_free.argtypes = [ctypes.c_void_p]


def load_library(build: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    return native_lib.load("smiles", _configure, build=build)


def native_available() -> bool:
    return load_library() is not None


def parse_smiles_batch_native(
    smiles_list: List[str], n_threads: int = 0
) -> List[Optional[MolGraph]]:
    """Parse many SMILES with the native library; returns MolGraphs in
    GGNN 'atomic_number' featurization (None per failed row).

    Raises RuntimeError if the native library is unavailable.
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native SMILES library unavailable (no C++ "
                           "compiler, or native/smiles.cpp failed to build)")
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    encoded = [s.encode() for s in smiles_list]
    buf = b"".join(encoded)
    offsets = np.zeros(len(encoded) + 1, np.int32)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    h = lib.smiles_parse_batch(
        buf, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(encoded), n_threads,
    )
    try:
        n = len(encoded)
        n_atoms = lib.smiles_batch_n_atoms(h)
        n_bonds = lib.smiles_batch_n_bonds(h)

        def arr(name, size):
            if size == 0:
                # an empty std::vector's data() is NULL; as_array on a
                # NULL pointer raises — e.g. a batch of bond-free ions
                # ([Na+]) or all-unparseable rows
                return np.zeros((0,), np.int32)
            ptr = getattr(lib, f"smiles_batch_{name}")(h)
            return np.ctypeslib.as_array(ptr, shape=(size,)).copy()

        ok = arr("mol_ok", n)
        atom_off = arr("atom_offsets", n + 1)
        bond_off = arr("bond_offsets", n + 1)
        nums = arr("atomic_nums", n_atoms)
        b1 = arr("bond_a1", n_bonds)
        b2 = arr("bond_a2", n_bonds)
        border = arr("bond_order", n_bonds)
        out: List[Optional[MolGraph]] = []
        for k in range(n):
            if not ok[k]:
                out.append(None)
                continue
            a0, a1_ = atom_off[k], atom_off[k + 1]
            e0, e1_ = bond_off[k], bond_off[k + 1]
            src = np.empty(2 * (e1_ - e0), np.int32)
            dst = np.empty(2 * (e1_ - e0), np.int32)
            typ = np.empty(2 * (e1_ - e0), np.int32)
            src[0::2], dst[0::2], typ[0::2] = b1[e0:e1_], b2[e0:e1_], border[e0:e1_]
            src[1::2], dst[1::2], typ[1::2] = b2[e0:e1_], b1[e0:e1_], border[e0:e1_]
            out.append(MolGraph(
                atom_ids=nums[a0:a1_].astype(np.int32),
                edge_src=src, edge_dst=dst, edge_type=typ,
                smiles=smiles_list[k],
            ))
        return out
    finally:
        lib.smiles_batch_free(h)
