"""SMILES -> numeric graph features for the GGNN/MPNN encoders.

The port's copy of the parts of gcnbmp_tpu/chem/featurize.py that its
parsing path runs: ``MolGraph`` and ``GGNNFeaturizer`` (atom-ID array +
4-channel one-hot bond-type adjacency, the default ``atomic_number`` mode
of chainer_chemistry's GGNNPreprocessor, and the ``wl`` vocabulary mode).
The dense-feature featurizers (DrugFP, Weave) and the ``add_hs`` /
``kekulize`` options, which need ``chem/transforms.py``, feed encoders the
port has not taken yet and stay in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from gcnbmp_tpu_torch.chem.mol import Mol

NUM_EDGE_TYPES = 4


class FeaturizeError(ValueError):
    pass


@dataclass
class MolGraph:
    """Ragged featurized molecule.

    ``atom_ids``: int32[N] (or -1s when dense features are used);
    ``atom_feats``: optional float32[N, F];
    ``edge_src``/``edge_dst``/``edge_type``: int32[E*2] directed edges
    (both directions materialized — the adjacency is symmetric);
    """

    atom_ids: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_type: np.ndarray
    atom_feats: Optional[np.ndarray] = None
    pair_feats: Optional[np.ndarray] = None  # (N, N, F) Weave pair features
    smiles: str = ""

    @property
    def num_atoms(self) -> int:
        return int(self.atom_ids.shape[0])

    @property
    def num_edges(self) -> int:
        """Directed edge count (2x bond count)."""
        return int(self.edge_src.shape[0])

    def dense_adj(self, out_size: Optional[int] = None) -> np.ndarray:
        """(4, N, N) one-hot bond-type adjacency, float32.

        Matches chainer_chemistry's construct_discrete_edge_matrix: both
        directions set to 1, channel = bond type, zero diagonal.
        """
        n = self.num_atoms if out_size is None else out_size
        adj = np.zeros((NUM_EDGE_TYPES, n, n), dtype=np.float32)
        adj[self.edge_type, self.edge_src, self.edge_dst] = 1.0
        return adj


def _edges_from_mol(mol: Mol) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    e = mol.num_bonds
    src = np.empty(2 * e, dtype=np.int32)
    dst = np.empty(2 * e, dtype=np.int32)
    typ = np.empty(2 * e, dtype=np.int32)
    for i, b in enumerate(mol.bonds):
        src[2 * i], dst[2 * i], typ[2 * i] = b.a1, b.a2, int(b.order)
        src[2 * i + 1], dst[2 * i + 1], typ[2 * i + 1] = b.a2, b.a1, int(b.order)
    return src, dst, typ


@dataclass
class GGNNFeaturizer:
    """Featurizer for the GGNN/RelGCN/GIN/MPNN encoder family.

    Args:
        mode: 'atomic_number' -> atom IDs are atomic numbers (canonical);
            'wl' -> WL r-radius subgraph IDs from a growing vocabulary.
        radius: WL radius ('wl' mode); radius=0 => (symbol, aromatic) IDs.
        max_atoms: molecules with more atoms raise FeaturizeError
            (mirrors type_check_num_atoms); negative = unlimited.
        out_size: pad atom/adj arrays to this size per molecule
            (negative = no per-molecule padding; the batcher pads).
    """

    mode: str = "atomic_number"
    radius: int = 0
    max_atoms: int = -1
    out_size: int = -1
    # WL vocabularies, built on the fly like the reference's defaultdicts.
    atom_vocab: Dict = field(default_factory=dict)
    fp_vocab: Dict = field(default_factory=dict)
    edge_vocab: Dict = field(default_factory=dict)

    def _vocab_id(self, vocab: Dict, key) -> int:
        if key not in vocab:
            vocab[key] = len(vocab)
        return vocab[key]

    def _wl_ids(self, mol: Mol) -> np.ndarray:
        atoms = []
        for a in mol.atoms:
            key = (a.symbol, "aromatic") if a.aromatic else a.symbol
            atoms.append(self._vocab_id(self.atom_vocab, key))
        if mol.num_atoms == 1 or self.radius == 0:
            fps = [self._vocab_id(self.fp_vocab, a) for a in atoms]
            return np.asarray(fps, dtype=np.int32)
        # r-radius WL refinement over (node id, sorted neighbor (id, edge))
        nodes = atoms
        edge_ids = {bi: self._vocab_id(self.edge_vocab, ("bond", int(b.order)))
                    for bi, b in enumerate(mol.bonds)}
        for _ in range(self.radius):
            fps = []
            for i in range(mol.num_atoms):
                neighbors = tuple(
                    sorted((nodes[j], edge_ids[bi]) for j, bi in mol.neighbors(i))
                )
                fps.append(self._vocab_id(self.fp_vocab, (nodes[i], neighbors)))
            new_edge_ids = {}
            for bi, b in enumerate(mol.bonds):
                both = tuple(sorted((fps[b.a1], fps[b.a2])))
                new_edge_ids[bi] = self._vocab_id(self.edge_vocab, (both, edge_ids[bi]))
            nodes, edge_ids = fps, new_edge_ids
        return np.asarray(nodes, dtype=np.int32)

    def __call__(self, mol: Mol) -> MolGraph:
        n = mol.num_atoms
        if 0 <= self.max_atoms < n:
            raise FeaturizeError(
                f"molecule has {n} atoms > max_atoms={self.max_atoms}"
            )
        if self.mode == "atomic_number":
            ids = np.asarray([a.atomic_num for a in mol.atoms], dtype=np.int32)
        elif self.mode == "wl":
            ids = self._wl_ids(mol)
        else:
            raise ValueError(f"unknown mode {self.mode!r}")
        src, dst, typ = _edges_from_mol(mol)
        if self.out_size >= 0:
            if self.out_size < n:
                raise FeaturizeError(
                    f"out_size={self.out_size} < num_atoms={n}"
                )
            ids = np.pad(ids, (0, self.out_size - n))
        return MolGraph(
            atom_ids=ids, edge_src=src, edge_dst=dst, edge_type=typ,
            smiles=mol.smiles,
        )
