"""Dataset generation & splitting tools (port of gcnbmp_tpu/data/splits.py,
all of it, over the port's own ``chem.smiles``; numpy and pandas only).

Re-implements the reference's offline dataset tooling (data_generator.py
967 LoC + utils.py): pair/label generation from the drug-drug matrix's
upper triangle, drug-based random and scaffold splits, interaction-based
stratified splits, the isc scale series, symmetric-pair dedup, and the
KAIST-style multi-label splitter.  CSV schema matches the reference
(utils.py:142): cid_1, cid_2, drugbank_id_1, drugbank_id_2, smiles_1,
smiles_2, label.

GLOBAL_SEED = 2018 (reference setting.py:13).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import pandas as pd

from gcnbmp_tpu_torch.chem.smiles import mol_from_smiles

GLOBAL_SEED = 2018


# ---------------------------------------------------------------------------
# pair generation
# ---------------------------------------------------------------------------

def generate_pairs_from_matrix(
    matrix: pd.DataFrame, drug_ids: Sequence
) -> Tuple[np.ndarray, np.ndarray]:
    """Upper-triangle (i < j) pairs + 0/1 labels from an N x N DDI matrix
    (reference: Splitter.__generate_data_and_labels,
    data_generator.py:178-198)."""
    n = len(drug_ids)
    mat = matrix.to_numpy() if isinstance(matrix, pd.DataFrame) else np.asarray(matrix)
    assert mat.shape[-1] >= n
    pairs, labels = [], []
    for i in range(n):
        for j in range(i + 1, n):
            pairs.append((drug_ids[i], drug_ids[j]))
            labels.append(int(mat[i, j] > 0))
    return np.asarray(pairs, dtype=object), np.asarray(labels, np.int64)


def dedupe_symmetric(pairs: Sequence[Tuple]) -> List[int]:
    """Indices of the first occurrence of each unordered pair
    (reference: SymmetricPair, data_generator.py:616)."""
    seen = set()
    keep = []
    for i, (a, b) in enumerate(pairs):
        key = (a, b) if str(a) <= str(b) else (b, a)
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return keep


# ---------------------------------------------------------------------------
# scaffolds (Bemis-Murcko, dependency-free)
# ---------------------------------------------------------------------------

def murcko_scaffold_key(smiles: str) -> str:
    """Deterministic scaffold identifier: iteratively strip terminal
    atoms, then hash a WL-refined graph invariant of what remains.
    Groups molecules by ring-system+linker skeleton the way the
    reference's RDKit scaffold splitter does (data_generator.py:331)."""
    mol = mol_from_smiles(smiles)
    if mol is None:
        return ""
    alive = [True] * mol.num_atoms
    deg = [len(mol.neighbors(i)) for i in range(mol.num_atoms)]
    changed = True
    while changed:
        changed = False
        for i in range(mol.num_atoms):
            if alive[i] and deg[i] <= 1:
                alive[i] = False
                changed = True
                for j, _ in mol.neighbors(i):
                    if alive[j]:
                        deg[j] -= 1
    atoms = [i for i in range(mol.num_atoms) if alive[i]]
    if not atoms:
        return ""  # acyclic molecule: empty scaffold
    # WL refinement over the scaffold subgraph
    label = {i: f"{mol.atoms[i].symbol}{int(mol.atoms[i].aromatic)}" for i in atoms}
    for _ in range(3):
        new = {}
        for i in atoms:
            nb = sorted(
                f"{label[j]}:{int(mol.bonds[bi].order)}"
                for j, bi in mol.neighbors(i)
                if alive[j]
            )
            new[i] = hashlib.md5((label[i] + "|" + ",".join(nb)).encode()).hexdigest()[:8]
        label = new
    return hashlib.md5(",".join(sorted(label.values())).encode()).hexdigest()


# ---------------------------------------------------------------------------
# drug-based splits
# ---------------------------------------------------------------------------

def _assign_pairs_by_drug(
    pairs: np.ndarray,
    labels: np.ndarray,
    train_set: set,
    valid_set: set,
    test_set: set,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """The reference's assignment rule (data_generator.py:283-300):
    train = both drugs in train; valid/test = one train drug + one
    valid/test drug; all other combinations are dropped."""
    out = {k: ([], []) for k in ("train", "valid", "test")}
    for (a, b), y in zip(pairs, labels):
        if a in train_set and b in train_set:
            key = "train"
        elif (a in train_set and b in valid_set) or (a in valid_set and b in train_set):
            key = "valid"
        elif (a in train_set and b in test_set) or (a in test_set and b in train_set):
            key = "test"
        else:
            continue
        out[key][0].append((a, b))
        out[key][1].append(y)
    return {
        k: (np.asarray(p, dtype=object), np.asarray(l, np.int64))
        for k, (p, l) in out.items()
    }


def random_split_by_drug(
    pairs: np.ndarray, labels: np.ndarray, drug_ids: Sequence,
    frac_train: float = 0.8, frac_valid: float = 0.1, frac_test: float = 0.1,
    seed: int = GLOBAL_SEED,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """(reference: random_split_based_drug, data_generator.py:239-330)."""
    rng = np.random.default_rng(seed)
    ids = np.asarray(drug_ids, dtype=object)
    perm = rng.permutation(len(ids))
    n_train = int(frac_train * len(ids))
    n_valid = int(frac_valid * len(ids))
    train = set(ids[perm[:n_train]])
    valid = set(ids[perm[n_train:n_train + n_valid]])
    test = set(ids[perm[n_train + n_valid:]])
    return _assign_pairs_by_drug(pairs, labels, train, valid, test)


def scaffold_split_by_drug(
    pairs: np.ndarray, labels: np.ndarray, drug_ids: Sequence,
    smiles_by_id: Dict, frac_train: float = 0.8, frac_valid: float = 0.1,
    frac_test: float = 0.1,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Scaffold-grouped drug split: whole scaffold groups go to one fold,
    largest groups first into train (reference:
    scaffold_split_based_drug, data_generator.py:331-433).

    ``frac_test`` is implicit (test = drugs fitting neither the train
    nor the valid quota) and only validated against the other two
    fractions; because whole scaffold groups are indivisible, realized
    fold sizes can deviate from the requested fractions."""
    if abs(frac_train + frac_valid + frac_test - 1.0) > 1e-6:
        raise ValueError(
            f"fractions must sum to 1, got "
            f"{frac_train}+{frac_valid}+{frac_test}"
        )
    groups: Dict[str, List] = {}
    for d in drug_ids:
        key = murcko_scaffold_key(str(smiles_by_id[d]))
        groups.setdefault(key, []).append(d)
    ordered = sorted(groups.values(), key=len, reverse=True)
    n = len(drug_ids)
    n_train, n_valid = int(frac_train * n), int(frac_valid * n)
    train, valid, test = set(), set(), set()
    for grp in ordered:
        if len(train) + len(grp) <= n_train:
            train.update(grp)
        elif len(valid) + len(grp) <= n_valid:
            valid.update(grp)
        else:
            test.update(grp)
    return _assign_pairs_by_drug(pairs, labels, train, valid, test)


# ---------------------------------------------------------------------------
# interaction-based splits
# ---------------------------------------------------------------------------

def stratified_interaction_split(
    pairs: np.ndarray, labels: np.ndarray,
    frac_train: float = 0.8, frac_valid: float = 0.1, frac_test: float = 0.1,
    seed: int = GLOBAL_SEED,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Label-stratified random split over interactions
    (reference: random_split_based_interaction, data_generator.py:434-547;
    gives the 118158/14769/14769 statistics of RECORD.txt:56-60 on the
    full 546-drug matrix)."""
    rng = np.random.default_rng(seed)
    idx_by_label: Dict[int, np.ndarray] = {}
    for y in np.unique(labels):
        idx = np.flatnonzero(labels == y)
        rng.shuffle(idx)
        idx_by_label[int(y)] = idx
    out = {k: [] for k in ("train", "valid", "test")}
    for y, idx in idx_by_label.items():
        n = len(idx)
        n_train, n_valid = int(frac_train * n), int(frac_valid * n)
        out["train"].append(idx[:n_train])
        out["valid"].append(idx[n_train:n_train + n_valid])
        out["test"].append(idx[n_train + n_valid:])
    result = {}
    for k, chunks in out.items():
        idx = np.concatenate(chunks)
        rng.shuffle(idx)
        result[k] = (pairs[idx], labels[idx])
    return result


def interaction_scale_series(
    pairs: np.ndarray, labels: np.ndarray,
    sizes: Sequence[int] = (10000, 20000, 30000, 35000, 40000, 50000, 60000, 70000),
    seed: int = GLOBAL_SEED,
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Balanced (50/50) training subsets of increasing size — the
    isc10000..isc70000 series (reference:
    random_split_based_interaction_different_scales,
    data_generator.py:548-615)."""
    rng = np.random.default_rng(seed)
    pos = np.flatnonzero(labels == 1)
    neg = np.flatnonzero(labels == 0)
    rng.shuffle(pos)
    rng.shuffle(neg)
    out = {}
    for size in sizes:
        k = size // 2
        if k > min(len(pos), len(neg)):
            continue
        idx = np.concatenate([pos[:k], neg[:k]])
        rng.shuffle(idx)
        out[size] = (pairs[idx], labels[idx])
    return out


# ---------------------------------------------------------------------------
# multi-label (KAIST x86) split
# ---------------------------------------------------------------------------

def kaist_multilabel_split(
    df: pd.DataFrame,
    label_col: str = "label",
    frac_train: float = 0.8,
    frac_valid: float = 0.1,
    seed: int = GLOBAL_SEED,
    delimiter: str = "||",
) -> Dict[str, pd.DataFrame]:
    """Split a multi-label pair table, deduping symmetric pairs and
    stratifying by each row's first label (reference: KaistSplitter,
    data_generator.py:637-837)."""
    keep = dedupe_symmetric(
        list(zip(df["drugbank_id_1"], df["drugbank_id_2"]))
        if "drugbank_id_1" in df.columns
        else list(zip(df["smiles_1"], df["smiles_2"]))
    )
    df = df.iloc[keep].reset_index(drop=True)
    first_label = df[label_col].astype(str).str.split(
        delimiter.replace("|", r"\|"), regex=True
    ).str[0]
    rng = np.random.default_rng(seed)
    train_idx, valid_idx, test_idx = [], [], []
    for _, idx in first_label.groupby(first_label).groups.items():
        idx = np.asarray(list(idx))
        rng.shuffle(idx)
        n = len(idx)
        n_train, n_valid = int(frac_train * n), int(frac_valid * n)
        train_idx.extend(idx[:n_train])
        valid_idx.extend(idx[n_train:n_train + n_valid])
        test_idx.extend(idx[n_train + n_valid:])
    return {
        "train": df.iloc[sorted(train_idx)].reset_index(drop=True),
        "valid": df.iloc[sorted(valid_idx)].reset_index(drop=True),
        "test": df.iloc[sorted(test_idx)].reset_index(drop=True),
    }


# ---------------------------------------------------------------------------
# CSV output
# ---------------------------------------------------------------------------

def write_pair_csv(
    path: str,
    pairs: np.ndarray,
    labels: np.ndarray,
    drug_info: pd.DataFrame,
    id_col: str = "cid",
) -> pd.DataFrame:
    """Write the reference pair-CSV schema (utils.py:142, __write_to_disk
    data_generator.py:206-237)."""
    to_dbid = dict(zip(drug_info[id_col], drug_info.get("drugbank_id", drug_info[id_col])))
    to_smiles = dict(zip(drug_info[id_col], drug_info["smiles"]))
    rows = []
    for (a, b), y in zip(pairs, labels):
        rows.append({
            "cid_1": a, "cid_2": b,
            "drugbank_id_1": to_dbid[a], "drugbank_id_2": to_dbid[b],
            "smiles_1": to_smiles[a], "smiles_2": to_smiles[b],
            "label": int(y),
        })
    df = pd.DataFrame(rows)
    if path:
        df.to_csv(path, index=False)
    return df


def export_known_ddis_edgelist(
    matrix_df: pd.DataFrame, path: str
) -> List[Tuple[str, str]]:
    """Write the known-DDI upper triangle of a drug-drug matrix as an
    edgelist file, one ``cid_i cid_j`` line per interaction (reference:
    generate_known_ddis, data_generator.py:838-870).  Returns the pairs."""
    df = matrix_df
    if "Unnamed: 0" in df.columns:
        df = df.drop(columns=["Unnamed: 0"])
    mat = df.to_numpy().astype(np.int32)
    cids = [str(c) for c in df.columns]
    n = mat.shape[0]
    assert mat.shape == (n, len(cids)), (mat.shape, len(cids))
    pairs = [
        (cids[i], cids[j])
        for i in range(n)
        for j in range(i + 1, len(cids))
        if mat[i, j] == 1
    ]
    if path:
        with open(path, "w") as w:
            for a, b in pairs:
                w.write(f"{a} {b}\n")
    return pairs


def split_statistics(labels: np.ndarray) -> Dict[str, float]:
    """pos/neg counts + ratio (reference stat(), data_generator.py:200)."""
    pos = int(np.sum(labels == 1))
    neg = int(np.sum(labels == 0))
    return {"total": len(labels), "pos": pos, "neg": neg,
            "ratio": pos / max(neg, 1)}


def validate_drug_list(drug_df: pd.DataFrame, smiles_col: str = "smiles") -> List[int]:
    """Indices of unparseable SMILES (reference: data_validator.py:19-29
    asserts all parse; here the bad rows are returned for the caller)."""
    bad = []
    for i, smi in enumerate(drug_df[smiles_col]):
        if mol_from_smiles(str(smi)) is None:
            bad.append(i)
    return bad


def index_id_maps(drug_df: pd.DataFrame, id_col: str = "drugbank_id"):
    """index <-> drug-id lookup dicts (reference utils.py index2id:34)."""
    ids = list(drug_df[id_col])
    return dict(enumerate(ids)), {d: i for i, d in enumerate(ids)}
