"""Embedding-similarity vs. known-DDI correlation analysis (the port's
copy of the numeric part of gcnbmp_tpu/eval/analysis.py).

Reference: result_analysis.py:27-349 — for each drug pair, compare the
similarity of their learned embeddings with the number of interactions
they share in the known DDI matrix; report the Pearson correlation.  The
JAX module's scatter plot (``correlation_plot``) needs matplotlib and is
not ported: the evaluate CLI writes ``correlation.json`` only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gcnbmp_tpu_torch.eval.similarity import cosine_similarity_matrix


def shared_interaction_counts(ddi_matrix: np.ndarray) -> np.ndarray:
    """C[i,j] = number of partners both i and j interact with."""
    m = (np.asarray(ddi_matrix) > 0).astype(np.float64)
    return m @ m.T


def embedding_ddi_correlation(
    embeddings: np.ndarray,
    ddi_matrix: np.ndarray,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Pearson correlation between pairwise embedding cosine similarity
    and shared-interaction count, over the upper triangle (i < j), as the
    evaluate CLI asks for it.

    Returns (correlation, sim_values, count_values).
    """
    sims = cosine_similarity_matrix(np.asarray(embeddings, np.float64))
    counts = shared_interaction_counts(ddi_matrix)
    iu = np.triu_indices(sims.shape[0], k=1)
    s, c = sims[iu], counts[iu]
    if s.std() == 0 or c.std() == 0:
        return float("nan"), s, c
    corr = float(np.corrcoef(s, c)[0, 1])
    return corr, s, c
