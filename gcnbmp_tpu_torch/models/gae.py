"""Graph auto-encoder baseline over the DDI graph itself (port of
gcnbmp_tpu/models/gae.py:27-249).

Two graph convolutions (hidden 32 -> embedding 16, relu then linear) over
the symmetric-normalized adjacency with self-loops, an inner-product
decoder (one relation) or a per-relation diagonal decoder
(``relation_diag``, the multi-relational variant), weighted
cross-entropy with ``pos_weight``, and masked-edge train/val/test
evaluation.  The DDI graph is small (546 drugs), so the adjacency is a
dense (N, N) matrix and everything is dense products, on ``device``.
Parameter names follow the flax tree (``encoder/gc1``, ``encoder/gc2``,
``relation_diag``), so ``convert.from_jax_params`` loads a JAX tree.

``train_gae`` draws its initial weights with numpy from the JAX module's
initializers (glorot-uniform kernels, ones for ``relation_diag``), or
takes a given tree (``params``); dropout draws from a ``torch.Generator``
seeded with ``seed``, so at a nonzero rate it differs from the JAX run
bit for bit (at rate 0 it trains step for step alike).  The edge metrics
are scikit-learn's ROC-AUC and average precision, computed in numpy
(``train.metrics``): the machine with the card has no scikit-learn.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from gcnbmp_tpu_torch.convert import from_jax_params, to_jax_params
from gcnbmp_tpu_torch.models.layers import dropout
from gcnbmp_tpu_torch.train.loop import ChainedAdam, sigmoid_ce_elements
from gcnbmp_tpu_torch.train.metrics import average_precision, roc_auc


def normalize_adj(adj: np.ndarray) -> np.ndarray:
    """D^-1/2 (A + I) D^-1/2 (reference preprocess_graph,
    train_gcn_cos.py:108-115)."""
    a = np.asarray(adj, np.float32)
    a = a + np.eye(a.shape[0], dtype=np.float32)
    d = a.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    return (a * d_inv_sqrt[:, None]) * d_inv_sqrt[None, :]


class GCNEncoder(nn.Module):
    """dropout -> relu(A gc1(x)) -> dropout -> A gc2(x); ``gc1``/``gc2``
    are bias-free linears (in_dim -> hidden1 -> hidden2)."""

    def __init__(self, in_dim: int, hidden1: int = 32, hidden2: int = 16,
                 dropout: float = 0.1, device=None):
        super().__init__()
        self.dropout = dropout
        self.gc1 = nn.Linear(in_dim, hidden1, bias=False, device=device)
        self.gc2 = nn.Linear(hidden1, hidden2, bias=False, device=device)

    def forward(self, x, adj_norm, deterministic: bool = True,
                generator=None):
        x = dropout(x, self.dropout, deterministic, generator)
        x = torch.relu(adj_norm @ self.gc1(x))
        x = dropout(x, self.dropout, deterministic, generator)
        return adj_norm @ self.gc2(x)


class GAE(nn.Module):
    """Encoder + inner-product decoder: ``forward(x, adj_norm,
    deterministic=True, generator=None)`` -> (reconstruction logits, z);
    with ``n_relations`` > 1 the logits are (R, N, N), z diag(r_R) z^T
    per relation."""

    def __init__(self, in_dim: int, hidden1: int = 32, hidden2: int = 16,
                 dropout: float = 0.1, n_relations: int = 1, device=None):
        super().__init__()
        self.encoder = GCNEncoder(in_dim, hidden1, hidden2, dropout,
                                  device=device)
        self.n_relations = n_relations
        if n_relations > 1:
            self.relation_diag = nn.Parameter(
                torch.ones(n_relations, hidden2, device=device))

    def forward(self, x, adj_norm, deterministic: bool = True,
                generator=None):
        z = self.encoder(x, adj_norm, deterministic, generator)
        if self.n_relations == 1:
            logits = z @ z.T
        else:
            logits = torch.einsum("ic,rc,jc->rij", z, self.relation_diag, z)
        return logits, z


def init_gae_params(model: GAE, seed: int) -> dict:
    """The flax-layout tree of ``model`` drawn from the JAX module's
    initializers with numpy: glorot-uniform ``gc1``/``gc2`` kernels, ones
    for ``relation_diag``."""
    rng = np.random.default_rng(seed)
    enc = {}
    for name in ("gc1", "gc2"):
        fan_out, fan_in = getattr(model.encoder, name).weight.shape
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        enc[name] = {"kernel": rng.uniform(-limit, limit, (fan_in, fan_out))
                     .astype(np.float32)}
    tree = {"encoder": enc}
    if model.n_relations > 1:
        tree["relation_diag"] = np.ones(tuple(model.relation_diag.shape),
                                        np.float32)
    return tree


def mask_test_edges(
    adj: np.ndarray, val_frac: float = 0.05, test_frac: float = 0.10,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Hold out edges + sample equal negatives (reference mask_test_edges,
    train_gcn_cos.py:137).  Returns train adjacency and edge lists."""
    rng = np.random.default_rng(seed)
    n = adj.shape[0]
    iu = np.triu_indices(n, k=1)
    pos = np.stack([iu[0][adj[iu] > 0], iu[1][adj[iu] > 0]], axis=1)
    perm = rng.permutation(len(pos))
    n_val = int(len(pos) * val_frac)
    n_test = int(len(pos) * test_frac)
    val_pos = pos[perm[:n_val]]
    test_pos = pos[perm[n_val:n_val + n_test]]
    train_pos = pos[perm[n_val + n_test:]]
    # negatives: absent edges
    neg_needed = n_val + n_test
    negs = []
    seen = set(map(tuple, pos))
    while len(negs) < neg_needed:
        i, j = rng.integers(0, n, 2)
        if i == j:
            continue
        a, b = (i, j) if i < j else (j, i)
        if (a, b) in seen:
            continue
        seen.add((a, b))
        negs.append((a, b))
    negs = np.asarray(negs)
    adj_train = np.zeros_like(adj)
    adj_train[train_pos[:, 0], train_pos[:, 1]] = 1
    adj_train[train_pos[:, 1], train_pos[:, 0]] = 1
    return {
        "adj_train": adj_train,
        "train_pos": train_pos,
        "val_pos": val_pos, "val_neg": negs[:n_val],
        "test_pos": test_pos, "test_neg": negs[n_val:],
    }


def parse_edge_csv(filepath, id2ind: Optional[Dict] = None):
    """Read a pair CSV into (pos_edges, neg_edges) index arrays
    (reference parse_ddi_dataset, train_gcn_cos_multi.py:125-134: rows
    with label==1 are positive edges, label==0 negatives; cid columns
    are mapped through the drug-index map when given)."""
    import pandas as pd

    df = pd.read_csv(filepath)
    cols = ("cid_1", "cid_2") if "cid_1" in df.columns else (
        "drugbank_id_1", "drugbank_id_2")

    def to_ind(rows):
        if id2ind is not None:
            return np.asarray(
                [(id2ind[a], id2ind[b]) for a, b in rows], np.int32
            ).reshape(-1, 2)
        return np.asarray(list(rows), np.int32).reshape(-1, 2)

    pos = df[df["label"] == 1]
    neg = df[df["label"] == 0]
    return (to_ind(zip(pos[cols[0]], pos[cols[1]])),
            to_ind(zip(neg[cols[0]], neg[cols[1]])))


def mask_test_edges_from_splits(
    n: int,
    train_pos: np.ndarray,
    val_pos: np.ndarray, val_neg: np.ndarray,
    test_pos: np.ndarray, test_neg: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Externally-provided split variant of mask_test_edges (reference
    mask_test_edges with train/valid/test_filepath set,
    train_gcn_cos_multi.py:136-175): the train adjacency is rebuilt from
    the given positive train edges and val/test pos+neg lists are used
    as-is."""
    adj_train = np.zeros((n, n), np.float32)
    tp = np.asarray(train_pos, np.int64).reshape(-1, 2)
    adj_train[tp[:, 0], tp[:, 1]] = 1
    adj_train[tp[:, 1], tp[:, 0]] = 1
    return {
        "adj_train": adj_train,
        "train_pos": tp,
        "val_pos": np.asarray(val_pos).reshape(-1, 2),
        "val_neg": np.asarray(val_neg).reshape(-1, 2),
        "test_pos": np.asarray(test_pos).reshape(-1, 2),
        "test_neg": np.asarray(test_neg).reshape(-1, 2),
    }


def train_gae(
    adj: np.ndarray,
    features: Optional[np.ndarray] = None,
    hidden1: int = 32,
    hidden2: int = 16,
    dropout: float = 0.1,
    learning_rate: float = 0.01,
    epochs: int = 200,
    seed: int = 0,
    val_frac: float = 0.05,
    test_frac: float = 0.10,
    splits: Optional[Dict[str, np.ndarray]] = None,
    device="cuda",
    params: Optional[dict] = None,
) -> Dict:
    """Full GAE training run on ``device``; returns the embeddings, the
    trained flax-layout ``params``, ``final_loss`` and the val/test edge
    ROC-AUC and AP (reference main loop, train_gcn_cos.py:430-600;
    default hyperparameters :50-54).  ``splits`` (from
    ``mask_test_edges_from_splits``) overrides the random holdout;
    ``params`` starts from that tree instead of the seeded draw."""
    device = torch.device(device)
    n = adj.shape[0]
    masked = (splits if splits is not None
              else mask_test_edges(np.asarray(adj), val_frac, test_frac, seed))
    adj_train = masked["adj_train"]
    adj_norm = torch.as_tensor(normalize_adj(adj_train), device=device)
    x_np = (features if features is not None
            else np.eye(n, dtype=np.float32))
    x = torch.as_tensor(np.asarray(x_np, np.float32), device=device)
    # reconstruct edges + self-loops (adj_label, reference :472)
    target = torch.as_tensor(
        np.asarray(adj_train + np.eye(n, dtype=np.float32), np.float32),
        device=device)
    e = float(adj_train.sum())
    pos_weight = float(n * n - e) / max(e, 1.0)
    norm = n * n / float(2 * max((n * n - e), 1.0))

    model = GAE(x.shape[1], hidden1, hidden2, dropout, device=device)
    from_jax_params(params if params is not None
                    else init_gae_params(model, seed), model)
    model.to(device)
    opt = ChainedAdam(list(model.parameters()), lambda count: learning_rate)
    generator = torch.Generator(device=device).manual_seed(seed)
    w = target * pos_weight + (1.0 - target)

    loss = None
    for _ in range(epochs):
        logits, _ = model(x, adj_norm, deterministic=False,
                          generator=generator)
        ce, _ = sigmoid_ce_elements(logits, target)
        loss = norm * torch.mean(ce * w)
        model.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    with torch.no_grad():
        _, z = model(x, adj_norm, deterministic=True)
    z = z.cpu().numpy()

    def edge_metrics(pos, neg):
        scores = np.concatenate([
            np.sum(z[pos[:, 0]] * z[pos[:, 1]], axis=1),
            np.sum(z[neg[:, 0]] * z[neg[:, 1]], axis=1),
        ])
        y = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
        probs = 1 / (1 + np.exp(-scores))
        return {"roc_auc": roc_auc(y, probs),
                "ap": average_precision(y, probs)}

    return {
        "embeddings": z,
        "params": to_jax_params(model),
        "final_loss": float(loss.detach()),
        "val": edge_metrics(masked["val_pos"], masked["val_neg"]),
        "test": edge_metrics(masked["test_pos"], masked["test_neg"]),
    }
