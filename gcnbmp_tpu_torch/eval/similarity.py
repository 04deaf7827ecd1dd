"""Drug-drug similarity matrices over learned embeddings (the port's copy
of gcnbmp_tpu/eval/similarity.py, numpy and pandas only).

Reference: similarity.py:24-141 — continuous Jaccard (generalized to
real vectors via min/max sums), extended Jaccard (dot / (|a|^2 + |b|^2 -
dot)), and cosine, computed pairwise over the drug embedding list into an
N x N CSV.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import pandas as pd


def continuous_jaccard_matrix(emb: np.ndarray) -> np.ndarray:
    """J[i,j] = sum(min(a,b)) / sum(max(a,b)) (real-valued Jaccard)."""
    n = emb.shape[0]
    out = np.zeros((n, n), np.float64)
    for i in range(n):
        mins = np.minimum(emb[i][None, :], emb)  # (N, D)
        maxs = np.maximum(emb[i][None, :], emb)
        denom = maxs.sum(axis=1)
        denom[denom == 0] = 1.0
        out[i] = mins.sum(axis=1) / denom
    return out


def extended_jaccard_matrix(emb: np.ndarray) -> np.ndarray:
    """T[i,j] = a.b / (|a|^2 + |b|^2 - a.b) (Tanimoto for real vectors)."""
    dots = emb @ emb.T
    sq = np.sum(emb * emb, axis=1)
    denom = sq[:, None] + sq[None, :] - dots
    denom[denom == 0] = 1.0
    return dots / denom


def cosine_similarity_matrix(emb: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    unit = emb / norms
    return unit @ unit.T


def similarity_csv(
    emb: np.ndarray,
    ids: Sequence,
    method: str = "cosine",
    out_path: Optional[str] = None,
) -> pd.DataFrame:
    fn = {
        "jaccard": continuous_jaccard_matrix,
        "extended-jaccard": extended_jaccard_matrix,
        "cosine": cosine_similarity_matrix,
    }[method]
    mat = fn(np.asarray(emb, np.float64))
    df = pd.DataFrame(mat, index=list(ids), columns=list(ids))
    if out_path:
        df.to_csv(out_path)
    return df
