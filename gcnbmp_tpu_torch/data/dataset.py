"""Pair datasets and the padded batch (the port's copy of
gcnbmp_tpu/data/dataset.py:27-290).

- ``PairDataset``: the in-memory (graph, graph, label) triples;
- ``DEFAULT_BUCKETS``, ``bucket_size``: the ladder of padded atom counts;
- ``PaddedPairBatch``, ``pad_graphs``, ``make_batch``, ``batch_iterator``
  and ``padded_args`` (a batch on the device; ``padded_arrays`` its host
  side, which the trainer's prefetcher stages from pinned memory):
  the padded layout's batches, (B, N) atom ids, (B, 4, N, N) adjacencies
  and (B, N) masks per side, and (B, N, F) dense atom features when the
  graphs carry them (``chem.WeaveFeaturizer``, ``chem.DrugFPFeaturizer``).
  A short batch is filled to ``fill_batch_to`` rows with one-atom graphs
  of atom id 0 and label -1, which the loss and the evaluators ignore; a
  GWM batch carries each side's supernode rows (``supernode_fn`` of each
  SMILES, a zero row for a graph without one).

The packed batches are built from these datasets by ``data.packing`` and
``data.native_pack``.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from gcnbmp_tpu_torch.chem.featurize import NUM_EDGE_TYPES, MolGraph

# Bucket ladder for per-batch padded atom counts.  Drug molecules are
# under ~100 atoms; the top bucket handles outliers.
DEFAULT_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 160, 256)


def bucket_size(n: int) -> int:
    """The smallest bucket holding ``n`` atoms; past the ladder, ``n``
    rounded up to a multiple of 128."""
    for b in DEFAULT_BUCKETS:
        if n <= b:
            return b
    return int(np.ceil(n / 128) * 128)


@dataclass
class PaddedPairBatch:
    """One padded minibatch of molecule pairs (numpy arrays).

    Shapes: atoms (B, N) int32 (pad id 0), adj (B, 4, N, N) float32, mask
    (B, N) float32, labels (B,) or (B, C); ``num_edges``, the directed
    edges of both molecules from the graphs' metadata (summing the dense
    adjacency costs tens of ms at B=2048); ``atom_feats1``/``atom_feats2``
    (B, N, F) float32 the dense per-atom features of a dense featurizer
    (``WeaveFeaturizer``, ``DrugFPFeaturizer``), None for atom ids;
    ``super1``/``super2`` (B, F_s) are GWM's supernode features."""

    atoms1: np.ndarray
    adj1: np.ndarray
    mask1: np.ndarray
    atoms2: np.ndarray
    adj2: np.ndarray
    mask2: np.ndarray
    labels: np.ndarray
    num_edges: int
    atom_feats1: Optional[np.ndarray] = None
    atom_feats2: Optional[np.ndarray] = None
    super1: Optional[np.ndarray] = None
    super2: Optional[np.ndarray] = None

    @property
    def batch_size(self) -> int:
        return int(self.atoms1.shape[0])


def padded_arrays(batch: PaddedPairBatch,
                  uses_supernodes: bool = False) -> List[np.ndarray]:
    """The host arrays of ``padded_args``, in its order: atoms1, adj1,
    atoms2, adj2, mask1, mask2, then super1 and super2 for a GWM
    predictor, then the labels as f32."""
    names = ["atoms1", "adj1", "atoms2", "adj2", "mask1", "mask2"]
    if uses_supernodes:
        names += ["super1", "super2"]
    return ([np.asarray(getattr(batch, n)) for n in names]
            + [np.asarray(batch.labels, np.float32)])


def padded_tensors(tensors: Sequence, uses_supernodes: bool = False):
    """``padded_arrays`` on the device, as ``padded_args`` returns them."""
    args, labels = list(tensors[:6]), tensors[-1]
    kwargs = ({"super1": tensors[6], "super2": tensors[7]}
              if uses_supernodes else {})
    return args, kwargs, labels


def padded_args(batch: PaddedPairBatch, device,
                uses_supernodes: bool = False):
    """A padded batch on ``device``: the predictor's positional arguments
    (atoms1, adj1, atoms2, adj2, mask1, mask2), the supernode kwargs of a
    GWM predictor, and the labels, one copy each."""
    import torch  # the host layer imports no torch otherwise

    return padded_tensors([torch.as_tensor(a).to(device) for a in
                           padded_arrays(batch, uses_supernodes)],
                          uses_supernodes)


def pad_graphs(graphs: Sequence[MolGraph], n: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                          Optional[np.ndarray]]:
    """Pad ragged graphs to (B, n) atoms, (B, 4, n, n) adjacency, (B, n)
    mask and, when the first graph has dense atom features, (B, n, F)
    features (else None)."""
    b = len(graphs)
    atoms = np.zeros((b, n), dtype=np.int32)
    adj = np.zeros((b, NUM_EDGE_TYPES, n, n), dtype=np.float32)
    mask = np.zeros((b, n), dtype=np.float32)
    feats = None
    if graphs and graphs[0].atom_feats is not None:
        f = graphs[0].atom_feats.shape[-1]
        feats = np.zeros((b, n, f), dtype=np.float32)
    for i, g in enumerate(graphs):
        k = g.num_atoms
        if k > n:
            raise ValueError(f"graph with {k} atoms does not fit pad size {n}")
        atoms[i, :k] = g.atom_ids
        adj[i, g.edge_type, g.edge_src, g.edge_dst] = 1.0
        mask[i, :k] = 1.0
        if feats is not None:
            feats[i, :k] = g.atom_feats
    return atoms, adj, mask, feats


# what a dataset pickle may name: this package's and numpy's classes and
# functions (numpy's array reconstructors), and plain builtin types
_PICKLE_PACKAGES = ("gcnbmp_tpu_torch", "numpy")
_PICKLE_BUILTINS = frozenset({
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset",
    "int", "list", "object", "range", "set", "slice", "str", "tuple"})


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _PICKLE_PACKAGES or (
                module == "builtins" and name in _PICKLE_BUILTINS):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"{module}.{name} is not a class of gcnbmp_tpu_torch, numpy or "
            "builtins")


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
        """Unpickle a dataset ``save`` wrote.  Only classes of this
        package, numpy's and plain builtin types are taken: a pickle that
        names any other (the JAX package's ``PairDataset`` among them,
        which would import that package) raises ``pickle.UnpicklingError``
        before anything is imported."""
        with open(path, "rb") as f:
            obj = _PortUnpickler(f).load()
        if not isinstance(obj, PairDataset):
            raise TypeError(f"{path} does not contain a PairDataset")
        return obj


def make_batch(
    ds: PairDataset,
    indices: Sequence[int],
    pad_to: Optional[int] = None,
    fill_batch_to: Optional[int] = None,
    supernode_fn=None,
) -> PaddedPairBatch:
    """One padded batch of the pairs ``indices``, ``pad_to`` atoms wide
    (default: the bucket of its largest molecule).  ``fill_batch_to``
    fills a short batch with one-atom graphs of atom id 0 and label -1;
    ``supernode_fn`` (SMILES -> features) fills ``super1``/``super2``,
    with a zero row for a graph without SMILES (the fill rows)."""
    g1 = [ds.graphs1[i] for i in indices]
    g2 = [ds.graphs2[i] for i in indices]
    label_rows = [np.atleast_1d(ds.labels[i]).astype(np.float32)
                  for i in indices]
    if fill_batch_to is not None and len(indices) < fill_batch_to:
        n_fill = fill_batch_to - len(indices)
        empty = MolGraph(
            atom_ids=np.zeros((1,), dtype=np.int32),
            edge_src=np.zeros((0,), dtype=np.int32),
            edge_dst=np.zeros((0,), dtype=np.int32),
            edge_type=np.zeros((0,), dtype=np.int32),
        )
        g1 = g1 + [empty] * n_fill
        g2 = g2 + [empty] * n_fill
        label_rows = label_rows + [np.full_like(label_rows[0], -1.0)] * n_fill
    n = pad_to
    if n is None:
        raw = max(max(g.num_atoms for g in g1), max(g.num_atoms for g in g2))
        n = bucket_size(raw)
    a1, adj1, m1, f1 = pad_graphs(g1, n)
    a2, adj2, m2, f2 = pad_graphs(g2, n)
    labels = np.stack(label_rows)
    if labels.shape[-1] == 1:
        labels = labels[:, 0]
    s1 = s2 = None
    if supernode_fn is not None:
        def snode(graphs):
            rows = [np.asarray(supernode_fn(g.smiles), np.float32)
                    if g.smiles else None for g in graphs]
            dim = next(len(r) for r in rows if r is not None)
            return np.stack([r if r is not None
                             else np.zeros((dim,), np.float32) for r in rows])

        s1, s2 = snode(g1), snode(g2)
    return PaddedPairBatch(
        atoms1=a1, adj1=adj1, mask1=m1,
        atoms2=a2, adj2=adj2, mask2=m2,
        labels=labels, atom_feats1=f1, atom_feats2=f2, super1=s1, super2=s2,
        num_edges=int(sum(g.num_edges for g in g1)
                      + sum(g.num_edges for g in g2)),
    )


def batch_iterator(
    ds: PairDataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    rng: Optional[np.random.Generator] = None,
    pad_to: Optional[int] = None,
    drop_remainder: bool = False,
    supernode_fn=None,
) -> Iterator[PaddedPairBatch]:
    """One pass of padded batches over ``ds``, in order or shuffled by
    ``rng``.  The last short batch is filled to ``batch_size`` with
    ignore-label rows, or skipped (``drop_remainder``)."""
    order = np.arange(len(ds))
    if shuffle:
        (rng or np.random.default_rng(0)).shuffle(order)
    for start in range(0, len(ds), batch_size):
        idx = order[start:start + batch_size]
        if len(idx) < batch_size and drop_remainder:
            continue
        yield make_batch(ds, idx.tolist(), pad_to=pad_to,
                         fill_batch_to=batch_size, supernode_fn=supernode_fn)
