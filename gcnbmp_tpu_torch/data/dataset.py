"""Pair datasets (the port's copy of ``PairDataset`` from
gcnbmp_tpu/data/dataset.py).

The padded batching of that module (``PaddedPairBatch``, ``make_batch``,
``batch_iterator``) feeds the padded layout, which the port has not taken
yet (ROADMAP queue 1, item 7); the packed batches are built from these
datasets by ``data.packing`` and ``data.native_pack``.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Iterable, List, Tuple

import numpy as np

from gcnbmp_tpu_torch.chem.featurize import MolGraph


@dataclass
class PairDataset:
    """In-memory dataset of (mol graph, mol graph, label) triples.

    Mirrors the 5-tuple NumpyTupleDataset of the reference
    (parsers.py:319) plus SMILES bookkeeping.
    """

    graphs1: List[MolGraph] = field(default_factory=list)
    graphs2: List[MolGraph] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)
    smiles_pairs: List[Tuple[str, str]] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i):
        return self.graphs1[i], self.graphs2[i], self.labels[i]

    def append(self, g1: MolGraph, g2: MolGraph, label) -> None:
        self.graphs1.append(g1)
        self.graphs2.append(g2)
        self.labels.append(np.asarray(label))
        self.smiles_pairs.append((g1.smiles, g2.smiles))

    def subset(self, indices: Iterable[int]) -> "PairDataset":
        idx = list(indices)
        return PairDataset(
            graphs1=[self.graphs1[i] for i in idx],
            graphs2=[self.graphs2[i] for i in idx],
            labels=[self.labels[i] for i in idx],
            smiles_pairs=[self.smiles_pairs[i] for i in idx],
        )

    def augment_swap(self) -> "PairDataset":
        """Double the dataset with (mol2, mol1) copies

        (reference: train_ddi_modify_eval2.py:317-326)."""
        return PairDataset(
            graphs1=self.graphs1 + self.graphs2,
            graphs2=self.graphs2 + self.graphs1,
            labels=self.labels + self.labels,
            smiles_pairs=self.smiles_pairs + [(b, a) for a, b in self.smiles_pairs],
        )

    def rebalance(
        self, rng: np.random.Generator, ratio: float = 1.0
    ) -> "PairDataset":
        """Subsample to a pos:neg ratio (default 1:1 = the reference's
        balance option, train_ddi_modify_eval2.py:525-551; other ratios
        cover utils.py split_dataset_imbalance)."""
        labels = np.asarray([float(np.ravel(l)[0]) for l in self.labels])
        pos = np.flatnonzero(labels > 0.5)
        neg = np.flatnonzero(labels <= 0.5)
        k_pos = min(len(pos), int(len(neg) * ratio))
        k_neg = min(len(neg), int(np.ceil(k_pos / ratio)))
        keep = np.concatenate(
            [rng.choice(pos, k_pos, replace=False),
             rng.choice(neg, k_neg, replace=False)]
        )
        rng.shuffle(keep)
        return self.subset(keep.tolist())

    def max_atoms(self) -> int:
        m = 0
        for g in self.graphs1:
            m = max(m, g.num_atoms)
        for g in self.graphs2:
            m = max(m, g.num_atoms)
        return m

    def label_array(self) -> np.ndarray:
        return np.stack([np.atleast_1d(l) for l in self.labels])

    def save(self, path: str) -> None:
        """Pickle cache (reference: data_pipeline.py:20-100)."""
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> "PairDataset":
        with open(path, "rb") as f:
            obj = pickle.load(f)
        if not isinstance(obj, PairDataset):
            raise TypeError(f"{path} does not contain a PairDataset")
        return obj
