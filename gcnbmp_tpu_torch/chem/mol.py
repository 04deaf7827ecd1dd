"""Minimal molecular data model (the port's copy of gcnbmp_tpu/chem/mol.py,
unchanged but for its imports).

The reference pipeline leans on RDKit ``Mol`` objects only for a handful of
per-atom/per-bond queries (reference: my_utils/preprocessors/
ggnn_preprocessor.py:81-108, my_utils/preprocessors/drugfp_preprocessor.py:
30-50): atomic number, aromaticity, degree, total H count, implicit
valence, and bond type in {single, double, triple, aromatic}.  This module
provides exactly that surface, backend-free.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Symbol -> atomic number, all 118 elements.
PERIODIC_TABLE: Dict[str, int] = {
    s: i + 1
    for i, s in enumerate(
        [
            "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
            "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
            "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
            "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
            "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
            "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
            "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
            "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
            "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
            "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
            "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds",
            "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
        ]
    )
}

ATOMIC_SYMBOLS: Dict[int, str] = {v: k for k, v in PERIODIC_TABLE.items()}

# Default valences used for implicit-hydrogen completion (OpenSMILES
# "normal valence" table).  Multiple entries = the smallest valence that
# fits the explicit bond-order sum is used.
DEFAULT_VALENCES: Dict[str, Tuple[int, ...]] = {
    "B": (3,),
    "C": (4,),
    "N": (3, 5),
    "O": (2,),
    "P": (3, 5),
    "S": (2, 4, 6),
    "F": (1,),
    "Cl": (1, 3, 5, 7),
    "Br": (1, 3, 5, 7),
    "I": (1, 3, 5, 7),
}


class BondOrder(enum.IntEnum):
    """Bond types, numbered to match the reference's 4 edge-type channels

    (reference: chainer_chemistry construct_discrete_edge_matrix as used by
    my_utils/preprocessors/ggnn_preprocessor.py:69-79 — channel order
    single, double, triple, aromatic)."""

    SINGLE = 0
    DOUBLE = 1
    TRIPLE = 2
    AROMATIC = 3

    @property
    def order_value(self) -> float:
        return {0: 1.0, 1: 2.0, 2: 3.0, 3: 1.5}[int(self)]


@dataclass
class Atom:
    symbol: str
    atomic_num: int
    aromatic: bool = False
    charge: int = 0
    isotope: int = 0
    explicit_h: Optional[int] = None  # set for bracket atoms only
    # Filled in by Mol.finalize():
    implicit_h: int = 0
    idx: int = -1

    @property
    def total_h(self) -> int:
        if self.explicit_h is not None:
            return self.explicit_h
        return self.implicit_h


@dataclass
class Bond:
    a1: int
    a2: int
    order: BondOrder

    def other(self, idx: int) -> int:
        return self.a2 if idx == self.a1 else self.a1


@dataclass
class Mol:
    """A parsed molecule: atoms + bonds + adjacency helpers."""

    atoms: List[Atom] = field(default_factory=list)
    bonds: List[Bond] = field(default_factory=list)
    smiles: str = ""
    _neighbors: Optional[List[List[Tuple[int, int]]]] = None  # (atom, bond idx)

    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    @property
    def num_bonds(self) -> int:
        return len(self.bonds)

    def neighbors(self, idx: int) -> List[Tuple[int, int]]:
        """Neighbor list [(other_atom_idx, bond_idx), ...]."""
        if self._neighbors is None:
            nb: List[List[Tuple[int, int]]] = [[] for _ in self.atoms]
            for bi, b in enumerate(self.bonds):
                nb[b.a1].append((b.a2, bi))
                nb[b.a2].append((b.a1, bi))
            self._neighbors = nb
        return self._neighbors[idx]

    def degree(self, idx: int) -> int:
        """Heavy-atom degree (number of explicit bonds)."""
        return len(self.neighbors(idx))

    def bond_order_sum(self, idx: int) -> float:
        return sum(self.bonds[bi].order.order_value for _, bi in self.neighbors(idx))

    def explicit_valence(self, idx: int) -> int:
        """Ceil of the bond-order sum (aromatic bonds count 1.5)."""
        return int(math.ceil(self.bond_order_sum(idx) - 1e-9))

    def implicit_valence(self, idx: int) -> int:
        """Number of implicit+explicit hydrogens (mirrors RDKit's
        GetImplicitValence for organic-subset atoms as consumed by the
        DrugFP featurizer, reference my_utils/preprocessors/
        drugfp_preprocessor.py:30-40)."""
        return self.atoms[idx].total_h

    def finalize(self) -> "Mol":
        """Compute implicit hydrogens; called once after parsing."""
        self._neighbors = None
        for i, atom in enumerate(self.atoms):
            atom.idx = i
            if atom.explicit_h is not None:
                atom.implicit_h = atom.explicit_h
                continue
            valences = DEFAULT_VALENCES.get(atom.symbol)
            if valences is None or atom.charge != 0:
                # Unknown element or charged organic-subset atom written
                # without brackets cannot occur in valid SMILES; bracket
                # atoms without explicit H get zero implicit H (OpenSMILES).
                atom.implicit_h = 0
                continue
            ev = self.explicit_valence(i)
            for v in valences:
                if ev <= v:
                    atom.implicit_h = v - ev
                    break
            else:
                atom.implicit_h = 0
        return self

    def ring_info(self) -> List[List[int]]:
        """Small rings: DFS cycle basis augmented with pairwise XOR
        combinations (recovers the small rings of fused systems that the
        raw basis can miss — e.g. the second 6-ring of naphthalene when
        the DFS tree yields {6-ring, 10-rim}).  Not a full SSSR, but
        sound for aromaticity perception of drug-like molecules; the
        native C++ parser (native/smiles.cpp) mirrors this algorithm
        exactly."""
        n = self.num_atoms
        seen = [False] * n
        parent = [-1] * n
        parent_bond = [-1] * n
        depth = [0] * n
        cycles_bonds: List[frozenset] = []  # each cycle as a bond-id set
        used_bonds = set()
        for root in range(n):
            if seen[root]:
                continue
            stack = [(root, -1, -1)]
            order = []
            while stack:
                v, p, pb = stack.pop()
                if seen[v]:
                    continue
                seen[v] = True
                parent[v] = p
                parent_bond[v] = pb
                depth[v] = depth[p] + 1 if p >= 0 else 0
                order.append(v)
                for w, bi in self.neighbors(v):
                    if not seen[w]:
                        stack.append((w, v, bi))
            # collect back-edges within this component
            for v in order:
                for w, bi in self.neighbors(v):
                    if bi == parent_bond[v] or bi == parent_bond[w]:
                        continue
                    if bi in used_bonds:
                        continue
                    if depth[w] >= depth[v]:
                        continue  # count each back-edge once (from deeper end)
                    used_bonds.add(bi)
                    # walk v up to w, collecting tree bonds
                    bonds = [bi]
                    u = v
                    while u != w and parent[u] >= 0:
                        bonds.append(parent_bond[u])
                        u = parent[u]
                    if u == w:
                        cycles_bonds.append(frozenset(bonds))
        # XOR closure over pairs: recover small fused rings
        known = set(cycles_bonds)
        current = list(cycles_bonds)
        for _ in range(4):
            new = []
            for i in range(len(current)):
                for j in range(i + 1, len(current)):
                    x = current[i] ^ current[j]
                    if not x or len(x) > 7 or x in known:
                        continue
                    if self._bond_set_cycle(x) is not None:
                        known.add(x)
                        new.append(x)
            if not new:
                break
            current = current + new
        rings = []
        for bset in current:
            cyc = self._bond_set_cycle(bset)
            if cyc is not None:
                rings.append(cyc)
        return rings

    def _bond_set_cycle(self, bond_ids) -> Optional[List[int]]:
        """If the bond set forms exactly one simple cycle, return its
        vertices in walk order; else None."""
        deg: Dict[int, List[Tuple[int, int]]] = {}
        for bi in bond_ids:
            b = self.bonds[bi]
            deg.setdefault(b.a1, []).append((b.a2, bi))
            deg.setdefault(b.a2, []).append((b.a1, bi))
        if any(len(v) != 2 for v in deg.values()):
            return None
        if len(deg) != len(bond_ids):
            return None
        start = min(deg)
        cyc = [start]
        prev_bi = -1
        u = start
        for _ in range(len(bond_ids)):
            nxt = [(w, bi) for w, bi in deg[u] if bi != prev_bi]
            if not nxt:
                return None
            w, bi = nxt[0]
            prev_bi = bi
            if w == start:
                return cyc if len(cyc) == len(bond_ids) else None
            cyc.append(w)
            u = w
        return None
