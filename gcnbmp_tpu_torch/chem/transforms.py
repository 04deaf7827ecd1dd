"""Molecule transforms: explicit hydrogens and kekulization (the port's
copy of gcnbmp_tpu/chem/transforms.py, unchanged but for its imports).

The reference's MolPreprocessor exposes ``add_Hs`` and ``kekulize``
options delegated to RDKit (preprocessors.py:12-23, my_utils
preprocessors).  Dependency-free equivalents over the built-in Mol:

- ``add_explicit_hydrogens``: materialize implicit H as atoms + single
  bonds (RDKit AddHs).
- ``kekulize``: replace aromatic bonds by alternating single/double via
  perfect matching over the atoms that must carry a double bond
  (aromatic C and pyridine-type N need exactly one; pyrrole-type
  N/O/S lone-pair donors need none).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

from gcnbmp_tpu_torch.chem.mol import Atom, Bond, BondOrder, Mol


def add_explicit_hydrogens(mol: Mol) -> Mol:
    """Return a new Mol with implicit hydrogens as explicit atoms."""
    out = copy.deepcopy(mol)
    out._neighbors = None
    n = out.num_atoms
    for i in range(n):
        a = out.atoms[i]
        for _ in range(a.total_h):
            h_idx = len(out.atoms)
            out.atoms.append(
                Atom(symbol="H", atomic_num=1, explicit_h=0, implicit_h=0)
            )
            out.bonds.append(Bond(i, h_idx, BondOrder.SINGLE))
        a.explicit_h = 0
        a.implicit_h = 0
    out._neighbors = None
    return out.finalize()


def _needs_double(mol: Mol, idx: int) -> bool:
    """Does this aromatic atom require one in-ring double bond when
    kekulized?  Lone-pair donors (pyrrole N-H, furan O, thiophene S,
    charged C-) contribute 2 pi electrons and take no double bond."""
    a = mol.atoms[idx]
    # exocyclic double bond already satisfies the valence (rare in
    # perceived-aromatic rings, but keep the check)
    for w, bi in mol.neighbors(idx):
        if (mol.bonds[bi].order in (BondOrder.DOUBLE, BondOrder.TRIPLE)
                and not mol.atoms[w].aromatic):
            return False
    if a.symbol in ("O", "S", "Se"):
        return False
    if a.symbol == "C" and a.charge < 0:
        return False
    if a.symbol in ("N", "P"):
        # pyrrole-type N (three sigma connections incl. H) donates its
        # lone pair; pyridine-type N (two connections, no H) needs a double
        sigma = len(mol.neighbors(idx)) + a.total_h
        return sigma <= 2
    return True


def kekulize(mol: Mol) -> Optional[Mol]:
    """Return a kekulized copy (no AROMATIC bond orders), or None if no
    valid assignment exists."""
    out = copy.deepcopy(mol)
    out._neighbors = None
    arom_bonds = [bi for bi, b in enumerate(out.bonds)
                  if b.order == BondOrder.AROMATIC]
    if not arom_bonds:
        return out
    needs: Dict[int, bool] = {}
    arom_atoms = set()
    for bi in arom_bonds:
        arom_atoms.add(out.bonds[bi].a1)
        arom_atoms.add(out.bonds[bi].a2)
    for i in arom_atoms:
        needs[i] = _needs_double(out, i)
    # adjacency restricted to aromatic bonds
    nb: Dict[int, List[int]] = {i: [] for i in arom_atoms}
    for bi in arom_bonds:
        nb[out.bonds[bi].a1].append(bi)
        nb[out.bonds[bi].a2].append(bi)

    assign: Dict[int, int] = {}  # bond -> 0 single, 1 double
    satisfied: Dict[int, bool] = {i: not needs[i] for i in arom_atoms}

    order = sorted(arom_bonds, key=lambda bi: -max(
        int(needs[out.bonds[bi].a1]), int(needs[out.bonds[bi].a2])
    ))

    def ok_to_double(bi):
        b = out.bonds[bi]
        return needs[b.a1] and needs[b.a2] and not satisfied[b.a1] and not satisfied[b.a2]

    def feasible(i):
        """atom i can still be satisfied by some unassigned bond."""
        if satisfied[i]:
            return True
        return any(bj not in assign for bj in nb[i])

    def solve(k: int) -> bool:
        if k == len(order):
            return all(satisfied[i] for i in arom_atoms)
        bi = order[k]
        b = out.bonds[bi]
        # try double first where it helps
        if ok_to_double(bi):
            assign[bi] = 1
            satisfied[b.a1] = satisfied[b.a2] = True
            if solve(k + 1):
                return True
            del assign[bi]
            satisfied[b.a1] = not needs[b.a1]
            satisfied[b.a2] = (not needs[b.a2]) or any(
                assign.get(bj) == 1 for bj in nb[b.a2]
            )
            satisfied[b.a1] = (not needs[b.a1]) or any(
                assign.get(bj) == 1 for bj in nb[b.a1]
            )
        assign[bi] = 0
        if feasible(b.a1) and feasible(b.a2) and solve(k + 1):
            return True
        del assign[bi]
        return False

    if not solve(0):
        return None
    for bi, val in assign.items():
        out.bonds[bi].order = BondOrder.DOUBLE if val else BondOrder.SINGLE
    for i in arom_atoms:
        out.atoms[i].aromatic = False
    out._neighbors = None
    return out.finalize()
