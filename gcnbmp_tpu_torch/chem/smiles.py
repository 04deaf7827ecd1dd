"""Dependency-free SMILES parser (OpenSMILES subset); the port's copy of
gcnbmp_tpu/chem/smiles.py, unchanged but for its imports.

Replaces RDKit's ``Chem.MolFromSmiles`` for the featurization pipeline
(reference: parsers.py:219-235 calls MolFromSmiles per CSV row).  Supported:
organic subset + bracket atoms (isotope, chirality [discarded], hcount,
charge, atom class), all bond symbols (stereo ``/``/``\\`` treated as
single), branches, ring closures incl. ``%nn``, dots (multi-fragment).

Aromaticity: lowercase atoms/(``:``) bonds are taken as aromatic directly;
additionally a Hückel-style perception pass upgrades kekulized rings
(size 5-7, conjugated, 4n+2 pi electrons) so that kekulized and aromatic
spellings of the same molecule featurize identically — mirroring RDKit's
sanitization behavior that the reference relies on for its bond-type
adjacency channels.

If RDKit is importable, ``mol_from_smiles`` uses it instead (behavioral
superset); the pure parser is the fallback and the spec for the native C++
fast path in ``native/``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from gcnbmp_tpu_torch.chem.mol import (
    Atom,
    Bond,
    BondOrder,
    Mol,
    PERIODIC_TABLE,
)

try:  # pragma: no cover - exercised only where rdkit is installed
    from rdkit import Chem as _rdkit_chem  # type: ignore

    HAVE_RDKIT = True
except Exception:  # pragma: no cover
    _rdkit_chem = None
    HAVE_RDKIT = False


class SmilesError(ValueError):
    pass


_ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
_AROMATIC_SUBSET = {"b", "c", "n", "o", "p", "s"}
_BOND_SYMBOLS = {
    "-": BondOrder.SINGLE,
    "=": BondOrder.DOUBLE,
    "#": BondOrder.TRIPLE,
    ":": BondOrder.AROMATIC,
    "/": BondOrder.SINGLE,
    "\\": BondOrder.SINGLE,
}
# Elements that can participate in an aromatic ring for perception.
_AROMATIC_CAPABLE = {"C", "N", "O", "S", "P", "B", "Se", "As", "Si", "Te"}


def _parse_bracket_atom(s: str, pos: int) -> Tuple[Atom, int]:
    """Parse ``[...]`` starting at ``s[pos] == '['``; returns (atom, next_pos)."""
    end = s.find("]", pos)
    if end < 0:
        raise SmilesError(f"unclosed bracket atom at {pos} in {s!r}")
    body = s[pos + 1 : end]
    i = 0
    isotope = 0
    while i < len(body) and body[i].isdigit():
        isotope = isotope * 10 + int(body[i])
        i += 1
    if i >= len(body):
        raise SmilesError(f"bracket atom missing symbol: {body!r}")
    # element symbol: wildcard, two-letter, or one-letter (possibly aromatic lowercase)
    aromatic = False
    if body[i] == "*":
        symbol, atomic_num = "*", 0
        i += 1
    else:
        two = body[i : i + 2]
        if two[:1].isupper() and len(two) == 2 and two[1].islower() and two in PERIODIC_TABLE:
            symbol = two
            i += 2
        elif body[i : i + 2] in ("se", "as", "te", "si"):
            symbol = body[i : i + 2].capitalize()
            aromatic = True
            i += 2
        elif body[i].isupper():
            symbol = body[i]
            i += 1
        elif body[i].islower():
            symbol = body[i].upper()
            aromatic = True
            i += 1
        else:
            raise SmilesError(f"bad bracket atom symbol in {body!r}")
        if symbol not in PERIODIC_TABLE:
            raise SmilesError(f"unknown element {symbol!r} in {body!r}")
        atomic_num = PERIODIC_TABLE[symbol]
    # chirality (discarded)
    while i < len(body) and body[i] == "@":
        i += 1
        if body[i : i + 2] in ("TH", "AL", "SP", "TB", "OH"):
            i += 2
            while i < len(body) and body[i].isdigit():
                i += 1
    # hydrogen count
    hcount = 0
    if i < len(body) and body[i] == "H":
        i += 1
        hcount = 1
        if i < len(body) and body[i].isdigit():
            hcount = 0
            while i < len(body) and body[i].isdigit():
                hcount = hcount * 10 + int(body[i])
                i += 1
    # charge
    charge = 0
    if i < len(body) and body[i] in "+-":
        sign = 1 if body[i] == "+" else -1
        i += 1
        if i < len(body) and body[i].isdigit():
            mag = 0
            while i < len(body) and body[i].isdigit():
                mag = mag * 10 + int(body[i])
                i += 1
            charge = sign * mag
        else:
            mag = 1
            while i < len(body) and body[i] == body[i - 1]:
                mag += 1
                i += 1
            charge = sign * mag
    # atom class (discarded)
    if i < len(body) and body[i] == ":":
        i += 1
        while i < len(body) and body[i].isdigit():
            i += 1
    if i != len(body):
        raise SmilesError(f"trailing junk {body[i:]!r} in bracket atom {body!r}")
    atom = Atom(
        symbol=symbol,
        atomic_num=atomic_num,
        aromatic=aromatic,
        charge=charge,
        isotope=isotope,
        explicit_h=hcount,
    )
    return atom, end + 1


def _parse_smiles_graph(s: str) -> Mol:
    mol = Mol(smiles=s)
    prev: Optional[int] = None
    stack: List[Optional[int]] = []
    pending_bond: Optional[BondOrder] = None
    # ring number -> (atom_idx, bond symbol or None)
    rings: Dict[int, Tuple[int, Optional[BondOrder]]] = {}

    def add_atom(atom: Atom) -> None:
        nonlocal prev, pending_bond
        idx = len(mol.atoms)
        mol.atoms.append(atom)
        if prev is not None:
            order = pending_bond
            if order is None:
                if mol.atoms[prev].aromatic and atom.aromatic:
                    order = BondOrder.AROMATIC
                else:
                    order = BondOrder.SINGLE
            mol.bonds.append(Bond(prev, idx, order))
        prev = idx
        pending_bond = None

    def close_ring(num: int) -> None:
        nonlocal pending_bond
        if prev is None:
            raise SmilesError(f"ring closure {num} before any atom in {s!r}")
        if num in rings:
            other, obond = rings.pop(num)
            order = pending_bond if pending_bond is not None else obond
            if order is None:
                if mol.atoms[other].aromatic and mol.atoms[prev].aromatic:
                    order = BondOrder.AROMATIC
                else:
                    order = BondOrder.SINGLE
            if other == prev:
                raise SmilesError(f"self ring closure {num} in {s!r}")
            mol.bonds.append(Bond(other, prev, order))
        else:
            rings[num] = (prev, pending_bond)
        pending_bond = None

    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c == "[":
            atom, i = _parse_bracket_atom(s, i)
            add_atom(atom)
        elif c in "(":
            stack.append(prev)
            i += 1
        elif c == ")":
            if not stack:
                raise SmilesError(f"unbalanced ')' in {s!r}")
            prev = stack.pop()
            i += 1
        elif c == ".":
            prev = None
            pending_bond = None
            i += 1
        elif c in _BOND_SYMBOLS:
            pending_bond = _BOND_SYMBOLS[c]
            i += 1
        elif c == "%":
            if i + 2 < n and s[i + 1] == "(":
                j = s.find(")", i)
                if j < 0:
                    raise SmilesError(f"unterminated '%(' ring closure in {s!r}")
                close_ring(int(s[i + 2 : j]))
                i = j + 1
            else:
                close_ring(int(s[i + 1 : i + 3]))
                i += 3
        elif c.isdigit():
            close_ring(int(c))
            i += 1
        elif c.isupper():
            two = s[i : i + 2]
            if two in ("Cl", "Br"):
                symbol = two
                i += 2
            elif c in _ORGANIC_SUBSET:
                symbol = c
                i += 1
            else:
                raise SmilesError(f"unexpected atom {c!r} outside brackets in {s!r}")
            add_atom(Atom(symbol=symbol, atomic_num=PERIODIC_TABLE[symbol], aromatic=False))
        elif c in _AROMATIC_SUBSET:
            symbol = c.upper()
            add_atom(Atom(symbol=symbol, atomic_num=PERIODIC_TABLE[symbol], aromatic=True))
            i += 1
        elif c == "*":
            add_atom(Atom(symbol="*", atomic_num=0, aromatic=False))
            i += 1
        elif c in " \t":
            break  # SMILES may carry a trailing title; stop at whitespace
        else:
            raise SmilesError(f"unexpected character {c!r} at {i} in {s!r}")
    if rings:
        raise SmilesError(f"unclosed ring bond(s) {sorted(rings)} in {s!r}")
    if stack:
        raise SmilesError(f"unbalanced '(' in {s!r}")
    if not mol.atoms:
        raise SmilesError(f"empty SMILES {s!r}")
    return mol


def _perceive_aromaticity(mol: Mol) -> None:
    """Upgrade kekulized conjugated rings to aromatic (Hückel 4n+2).

    Handles the common drug-like cases (benzene/pyridine/pyrrole/furan/
    thiophene/imidazole spelling with explicit double bonds) so that both
    spellings produce identical edge-type channels.  Fused systems are
    handled ring-by-ring, iterated to a fixed point so that e.g. the middle
    ring of anthracene written kekulized still perceives.
    """
    changed = True
    guard = 0
    while changed and guard < 8:
        guard += 1
        changed = False
        for ring in mol.ring_info():
            if not 5 <= len(ring) <= 7:
                continue
            ring_set = set(ring)
            ring_bonds = []
            ok = True
            for a in ring:
                for w, bi in mol.neighbors(a):
                    if w in ring_set and bi not in ring_bonds:
                        b = mol.bonds[bi]
                        if {b.a1, b.a2} <= ring_set:
                            ring_bonds.append(bi)
            # ring must be a simple cycle
            if len(ring_bonds) != len(ring):
                continue
            if all(mol.bonds[bi].order == BondOrder.AROMATIC for bi in ring_bonds):
                # already aromatic bonds (':'-spelled input or a prior
                # pass): ensure the ATOMS carry the flag too before
                # skipping the pi count
                for a in ring:
                    mol.atoms[a].aromatic = True
                continue
            pi = 0
            for a in ring:
                atom = mol.atoms[a]
                if atom.symbol not in _AROMATIC_CAPABLE:
                    ok = False
                    break
                has_ring_double = any(
                    mol.bonds[bi].order == BondOrder.DOUBLE and mol.bonds[bi].other(a) in ring_set
                    for _, bi in mol.neighbors(a)
                    if {mol.bonds[bi].a1, mol.bonds[bi].a2} <= ring_set | {a}
                )
                has_ring_arom = any(
                    mol.bonds[bi].order == BondOrder.AROMATIC
                    for w, bi in mol.neighbors(a)
                    if w in ring_set
                )
                has_exo_double = any(
                    mol.bonds[bi].order in (BondOrder.DOUBLE, BondOrder.TRIPLE)
                    for w, bi in mol.neighbors(a)
                    if w not in ring_set
                )
                if mol.bonds and any(
                    mol.bonds[bi].order == BondOrder.TRIPLE
                    for w, bi in mol.neighbors(a)
                    if w in ring_set
                ):
                    ok = False
                    break
                if has_ring_double or has_ring_arom:
                    pi += 1
                elif has_exo_double:
                    # exocyclic C=O etc: sp2 but contributes 0 pi electrons
                    pi += 0
                elif atom.symbol in ("N", "O", "S", "P", "Se") or (
                    atom.symbol == "C" and atom.charge < 0
                ):
                    pi += 2  # lone pair donor (pyrrole-type)
                else:
                    ok = False  # sp3 center breaks conjugation
                    break
            if not ok or pi % 4 != 2:
                continue
            for a in ring:
                if mol.atoms[a].explicit_h is None and mol.atoms[a].symbol == "N":
                    # pyrrole-type N written 'N1C=CC=C1' needs its H kept:
                    # record current implicit H before bond orders change.
                    mol.finalize()
                    mol.atoms[a].explicit_h = mol.atoms[a].implicit_h
                mol.atoms[a].aromatic = True
            for bi in ring_bonds:
                if mol.bonds[bi].order != BondOrder.AROMATIC:
                    mol.bonds[bi].order = BondOrder.AROMATIC
                    changed = True
            mol._neighbors = None


def _mol_from_rdkit(smiles: str) -> Optional[Mol]:  # pragma: no cover
    rd = _rdkit_chem.MolFromSmiles(smiles)
    if rd is None:
        return None
    mol = Mol(smiles=smiles)
    for a in rd.GetAtoms():
        mol.atoms.append(
            Atom(
                symbol=a.GetSymbol(),
                atomic_num=a.GetAtomicNum(),
                aromatic=a.GetIsAromatic(),
                charge=a.GetFormalCharge(),
                isotope=a.GetIsotope(),
                explicit_h=a.GetTotalNumHs(),
            )
        )
    order_map = {
        _rdkit_chem.BondType.SINGLE: BondOrder.SINGLE,
        _rdkit_chem.BondType.DOUBLE: BondOrder.DOUBLE,
        _rdkit_chem.BondType.TRIPLE: BondOrder.TRIPLE,
        _rdkit_chem.BondType.AROMATIC: BondOrder.AROMATIC,
    }
    for b in rd.GetBonds():
        mol.bonds.append(
            Bond(
                b.GetBeginAtomIdx(),
                b.GetEndAtomIdx(),
                order_map.get(b.GetBondType(), BondOrder.SINGLE),
            )
        )
    return mol.finalize()


def mol_from_smiles(smiles: str, strict: bool = False,
                    backend: str = "auto") -> Optional[Mol]:
    """Parse SMILES -> Mol.  Returns None on failure unless ``strict``.

    Mirrors the reference's use of MolFromSmiles returning None for
    unparseable rows, which the CSV parser skips with a fail count
    (reference: parsers.py:222-262).

    ``backend``: "auto" (RDKit sanitization when installed — the
    reference's exact chemistry, ggnn_preprocessor.py:10-11 — else the
    built-in parser), "rdkit" (require RDKit), or "own" (force the
    built-in parser + Hückel perception even when RDKit is present —
    used by the cross-check test tests/test_rdkit_crosscheck.py).
    """
    if backend not in ("auto", "rdkit", "own"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "rdkit" and not HAVE_RDKIT:
        raise ImportError("backend='rdkit' requested but rdkit is not installed")
    if HAVE_RDKIT and backend in ("auto", "rdkit"):  # pragma: no cover
        mol = _mol_from_rdkit(smiles)
        if mol is None and strict:
            raise SmilesError(f"rdkit failed to parse {smiles!r}")
        return mol
    try:
        mol = _parse_smiles_graph(smiles)
        _perceive_aromaticity(mol)
        return mol.finalize()
    except SmilesError:
        if strict:
            raise
        return None
    except (ValueError, IndexError) as e:
        if strict:
            raise SmilesError(str(e))
        return None
