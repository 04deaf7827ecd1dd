"""Classical-ML baselines over pair features (port of
gcnbmp_tpu/eval/baselines.py:17-76).

Reference: machine_learning_methods.py:26-146 — SVM / RandomForest /
LogisticRegression on concatenated per-drug feature vectors (ecfp4 /
mol2vec / SSP / learned GNN embeddings), reporting AUROC / AUPRC / F1.
Host code only: scikit-learn is imported inside ``_make_model``, as in
the JAX module, so the package imports without it (the machine with the
card has none, and this module does not run there).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from gcnbmp_tpu_torch.train.metrics import binary_metrics


def _make_model(name: str, seed: int = 0):
    from sklearn.ensemble import RandomForestClassifier
    from sklearn.linear_model import LogisticRegression
    from sklearn.svm import SVC

    if name == "svm":
        return SVC(probability=True, random_state=seed)
    if name == "rf":
        return RandomForestClassifier(n_estimators=200, random_state=seed)
    if name in ("lr", "logistic"):
        return LogisticRegression(max_iter=1000, random_state=seed)
    raise ValueError(f"unknown baseline model {name!r}")


def pair_features(e1: np.ndarray, e2: np.ndarray, mode: str = "concat") -> np.ndarray:
    if mode == "concat":
        return np.concatenate([e1, e2], axis=1)
    if mode == "sum-prod":
        return np.concatenate([e1 + e2, e1 * e2], axis=1)
    raise ValueError(f"unknown pair feature mode {mode!r}")


def run_baseline(
    model_name: str,
    train_e1: np.ndarray, train_e2: np.ndarray, train_y: np.ndarray,
    test_e1: np.ndarray, test_e2: np.ndarray, test_y: np.ndarray,
    feature_mode: str = "concat",
    seed: int = 0,
) -> Dict[str, float]:
    """Fit one classical model on pair features; return test metrics."""
    model = _make_model(model_name, seed)
    x_train = pair_features(train_e1, train_e2, feature_mode)
    x_test = pair_features(test_e1, test_e2, feature_mode)
    model.fit(x_train, np.ravel(train_y).astype(int))
    probs = model.predict_proba(x_test)[:, 1]
    # binary_metrics expects logits; invert sigmoid on clipped probs
    p = np.clip(probs, 1e-7, 1 - 1e-7)
    logits = np.log(p / (1 - p))
    return binary_metrics(logits, np.ravel(test_y))


def ecfp_features(smiles_list, n_bits: int = 2048, radius: int = 2) -> np.ndarray:
    """Morgan/ECFP-style hashed circular fingerprints using the built-in
    WL featurizer (dependency-free stand-in for RDKit ecfp4)."""
    from gcnbmp_tpu_torch.chem import GGNNFeaturizer, mol_from_smiles

    out = np.zeros((len(smiles_list), n_bits), np.float32)
    # one shared featurizer -> one consistent WL vocabulary for the set;
    # each molecule sets the bits of its atoms' substructure ids at every
    # radius 0..radius
    feats = [GGNNFeaturizer(mode="wl", radius=r) for r in range(radius + 1)]
    for i, smi in enumerate(smiles_list):
        mol = mol_from_smiles(smi)
        if mol is None:
            continue
        for r, f in enumerate(feats):
            g = f(mol)
            for fp_id in set(g.atom_ids.tolist()):
                out[i, hash((r, fp_id)) % n_bits] = 1.0
    return out
