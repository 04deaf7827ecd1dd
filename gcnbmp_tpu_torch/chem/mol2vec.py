"""Gensim-free mol2vec featurization (the port's copy of
gcnbmp_tpu/chem/mol2vec.py, unchanged but for its imports: the same
sentences and bit-identical vectors).

Reference: my_utils/parsers.py Mol2VecParserForPair:247-453 joins
precomputed smiles->vector tables that were produced offline by the
mol2vec pipeline (Jaeger et al. 2018): per-atom Morgan substructure
identifiers at radii 0..r form a "sentence", a word2vec model maps each
identifier to a vector, and the molecule vector is the sum of its word
vectors (unseen identifiers fall back to an UNSEEN vector).

This module reimplements the featurization half without gensim:

- ``morgan_sentence(mol, radius)``: deterministic per-atom substructure
  identifiers via iterative neighborhood hashing (Morgan/ECFP-style;
  our own invariants, since RDKit's private hash is not part of the
  behavioral contract — what matters downstream is a stable
  substructure-id vocabulary).
- ``identifier_table_from_corpus(mols, dim)``: identifier -> vector
  table playing the trained word2vec model's role; vectors are
  deterministic hash-seeded Gaussians, so the same identifier maps to
  the same vector across runs and processes without any training
  artifact.  A table trained elsewhere (any {id: vec} mapping) drops in.
- ``Mol2VecFeaturizer``: mol -> summed sentence vector.
- ``mol2vec_table``: smiles list -> {smiles: vector}, the shape
  train/fixed.py's pair_embeddings consumes.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from gcnbmp_tpu_torch.chem.mol import Mol

UNSEEN = "UNSEEN"


def _stable_hash(key: str) -> int:
    """Deterministic 63-bit hash (Python's ``hash`` is salted per process)."""
    return int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8).digest(),
                          "big") >> 1


def morgan_sentence(mol: Mol, radius: int = 1) -> List[int]:
    """Per-atom Morgan identifiers at radii 0..radius, interleaved per atom
    (atom0_r0, atom0_r1, ..., atom1_r0, ...) — the mol2vec
    ``mol2alt_sentence`` ordering."""
    n = mol.num_atoms
    # radius-0 invariant: the ECFP-style atom descriptor tuple
    ids = [
        _stable_hash(
            f"{a.atomic_num}|{mol.degree(i)}|{a.charge}|{a.total_h}|{int(a.aromatic)}"
        )
        for i, a in enumerate(mol.atoms)
    ]
    per_radius = [ids]
    for _ in range(radius):
        nxt = []
        for i in range(n):
            env = sorted(
                (int(mol.bonds[bi].order), per_radius[-1][j])
                for j, bi in mol.neighbors(i)
            )
            nxt.append(_stable_hash(f"{per_radius[-1][i]}|{env}"))
        per_radius.append(nxt)
    sentence: List[int] = []
    for i in range(n):
        for r in range(radius + 1):
            sentence.append(per_radius[r][i])
    return sentence


def _hash_vector(identifier, dim: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng((_stable_hash(f"{seed}|{identifier}")) % (2**63))
    return rng.standard_normal(dim).astype(np.float32) / np.sqrt(dim)


def identifier_table_from_corpus(
    mols: Iterable[Mol], dim: int = 100, radius: int = 1, seed: int = 2018,
    min_count: int = 1,
) -> Dict[int, np.ndarray]:
    """Build the identifier->vector table from a molecule corpus: the role
    of the trained gensim model, with deterministic hash-seeded vectors.
    Identifiers seen fewer than ``min_count`` times are dropped (word2vec
    min_count semantics); lookups of dropped/unknown identifiers use the
    UNSEEN vector."""
    counts: Dict[int, int] = {}
    for m in mols:
        for w in morgan_sentence(m, radius):
            counts[w] = counts.get(w, 0) + 1
    table: Dict = {
        w: _hash_vector(w, dim, seed)
        for w, c in counts.items() if c >= min_count
    }
    table[UNSEEN] = _hash_vector(UNSEEN, dim, seed)
    return table


@dataclass
class Mol2VecFeaturizer:
    """mol -> sum of identifier vectors over its Morgan sentence
    (reference pipeline semantics; my_utils/parsers.py:247-453 consumes
    exactly such summed vectors from its smiles2vec pickle)."""

    table: Dict = field(default_factory=dict)
    radius: int = 1
    dim: Optional[int] = None  # inferred from the table when None

    # BEHAVIOR CHANGE (round 3): externally supplied tables lacking the
    # UNSEEN key now get the same deterministic hash-seeded UNSEEN
    # vector as identifier_table_from_corpus builds — previously unseen
    # identifiers fell back to zeros.  Features computed from such
    # tables therefore differ from pre-round-3 outputs wherever a
    # molecule contains identifiers missing from the table; recompute
    # any cached features rather than mixing the two vintages.

    def __post_init__(self):
        if self.dim is None:
            if not self.table:
                raise ValueError("empty table and no dim given")
            self.dim = len(next(iter(self.table.values())))
        # copy: never mutate the caller's dict, and use the same
        # deterministic hash-seeded UNSEEN fallback as
        # identifier_table_from_corpus so unseen-identifier features do
        # not depend on the construction path
        self.table = dict(self.table)
        if UNSEEN not in self.table:
            self.table[UNSEEN] = _hash_vector(UNSEEN, self.dim, 2018)

    def __call__(self, mol: Mol) -> np.ndarray:
        unseen = self.table[UNSEEN]
        vec = np.zeros(self.dim, np.float32)
        for w in morgan_sentence(mol, self.radius):
            vec += self.table.get(w, unseen)
        return vec


def mol2vec_table(
    smiles_list: Sequence[str], dim: int = 100, radius: int = 1,
    seed: int = 2018, table: Optional[Dict] = None,
) -> Dict[str, np.ndarray]:
    """smiles -> mol2vec vector for a drug list: the smiles2vec artifact
    the reference loads (my_utils/parsers.py:283-287), computed here
    instead of unpickled.  Unparseable SMILES are skipped (parser
    fail-count semantics)."""
    from gcnbmp_tpu_torch.chem.smiles import mol_from_smiles

    mols: Dict[str, Mol] = {}
    for s in smiles_list:
        try:
            m = mol_from_smiles(s)
        except Exception:
            m = None
        if m is not None:
            mols[s] = m
    if table is None:
        table = identifier_table_from_corpus(
            mols.values(), dim=dim, radius=radius, seed=seed
        )
    f = Mol2VecFeaturizer(table=table, radius=radius)
    return {s: f(m) for s, m in mols.items()}
