"""Training over fixed precomputed drug embeddings (port of
gcnbmp_tpu/train/fixed.py:30-224).

The reference's mol2vec / molecular-autoencoder / SSP baselines train
only the scoring head over frozen per-drug feature vectors.  Here: load
an id -> vector table, join it onto a pair CSV, and fit a
``FixedEmbeddingPredictor`` head, on ``device`` (the vectors and labels
go to the device once; each batch is an index into them).

The run directory keeps the JAX package's layout and its marker
(``config.json`` with ``method: "fixed"``), with ``params.npz``, the
flax-layout tree (``convert.save_params_npz``), in place of
``params.msgpack``: flax serialization needs flax to read, as the JAX
package's orbax checkpoints need orbax (``train/checkpoints.py``).  A
directory holding only a ``params.msgpack`` is refused, naming the file.

The JAX function draws the head's initial weights with ``jax.random``;
this one draws them from the flax initializers' distributions with numpy
(``convert.init_module_params``), or takes a given tree (``params``), so
a JAX run's initial tree trains here step for step alike.  The batches
follow the same order: one ``np.random.default_rng(seed)`` permutation
per epoch, the tail dropped, ``batch_size`` clamped to the pair count.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gcnbmp_tpu_torch.convert import (
    from_jax_params, init_module_params, load_params_npz, save_params_npz,
    to_jax_params)
from gcnbmp_tpu_torch.models.heads import make_head
from gcnbmp_tpu_torch.models.predictor import FixedEmbeddingPredictor
from gcnbmp_tpu_torch.train.loop import ChainedAdam, sigmoid_cross_entropy
from gcnbmp_tpu_torch.train.metrics import binary_metrics


def load_embedding_table(path: str, id_col: str = "cid",
                         vec_col: str = "entity") -> Dict[str, np.ndarray]:
    """Load id -> vector from a pickle dict or a CSV with a
    space-separated vector column (the drug_list_with_representation.csv
    format written by the evaluate CLI's exports)."""
    import pandas as pd

    if path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as f:
            table = pickle.load(f)
        return {str(k): np.asarray(v, np.float32) for k, v in table.items()}
    df = pd.read_csv(path)
    return {
        str(k): np.fromstring(str(v), sep=" ", dtype=np.float32)
        for k, v in zip(_column(df, id_col), _column(df, vec_col))
    }


def _column(df, col):
    """The values of ``col`` as ``DataFrame.iterrows`` yields them: each
    row of ``df.values``, the frame's common dtype (a frame of int and
    float columns gives floats), so ids read as the JAX loop reads them."""
    return df.values[:, df.columns.get_loc(col)]


def pair_embeddings(
    pair_csv: str, table: Dict[str, np.ndarray],
    id_cols: Sequence[str] = ("drugbank_id_1", "drugbank_id_2"),
    label_col: str = "label",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(e1, e2, labels) of the CSV's rows whose two ids are both in
    ``table``, in file order."""
    import pandas as pd

    df = pd.read_csv(pair_csv)
    e1, e2, y = [], [], []
    for a, b, lab in zip(_column(df, id_cols[0]), _column(df, id_cols[1]),
                         _column(df, label_col)):
        a, b = str(a), str(b)
        if a in table and b in table:
            e1.append(table[a])
            e2.append(table[b])
            y.append(float(lab))
    return np.stack(e1), np.stack(e2), np.asarray(y, np.float32)


def build_fixed_predictor(sim_method: str, class_num: int,
                          net_hidden_dims: Tuple[int, ...], emb_dim: int,
                          device=None) -> FixedEmbeddingPredictor:
    """The head the JAX ``_build_fixed_predictor`` builds over
    ``emb_dim``-wide vectors (every head but ``cosine`` takes
    ``net_hidden_dims``)."""
    return FixedEmbeddingPredictor(
        make_head(sim_method, emb_dim, class_num, tuple(net_hidden_dims),
                  device=device))


def train_fixed_embedding_head(
    e1: np.ndarray, e2: np.ndarray, labels: np.ndarray,
    val: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    sim_method: str = "hole",
    class_num: int = 1,
    net_hidden_dims: Tuple[int, ...] = (32, 16),
    learning_rate: float = 1e-3,
    epochs: int = 100,
    batch_size: int = 128,
    seed: int = 2018,
    device="cuda",
    params: Optional[dict] = None,
) -> Dict:
    """Fit a scoring head over frozen embeddings with Adam (optax's
    defaults, constant rate).  Returns ``params`` (the flax-layout tree),
    ``predictor`` (the trained module), ``losses`` (the last batch's loss
    of each epoch), ``train_metrics`` and, with ``val``, ``val_metrics``.
    ``params`` starts from that tree instead of the seeded draw."""
    device = torch.device(device)
    predictor = build_fixed_predictor(sim_method, class_num, net_hidden_dims,
                                      e1.shape[1], device=device)
    if params is None:
        params = init_module_params(predictor, seed)
    from_jax_params(params, predictor)
    predictor.to(device)
    opt = ChainedAdam(list(predictor.parameters()),
                      lambda count: learning_rate)
    t1, t2, ty = (torch.as_tensor(np.asarray(x, np.float32), device=device)
                  for x in (e1, e2, labels))

    np_rng = np.random.default_rng(seed)
    n = len(labels)
    # a dataset smaller than batch_size would otherwise train no step
    batch_size = min(batch_size, n)
    losses = []
    for _ in range(epochs):
        order = torch.as_tensor(np_rng.permutation(n), device=device)
        loss = None
        for start in range(0, n - batch_size + 1, batch_size):
            idx = order[start:start + batch_size]
            y = ty[idx]
            loss = sigmoid_cross_entropy(
                predictor(t1[idx], t2[idx]).reshape(y.shape), y)
            predictor.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        losses.append(float(loss.detach()))

    out = {"params": to_jax_params(predictor), "predictor": predictor,
           "losses": losses}
    with torch.no_grad():
        logits = predictor(t1, t2).cpu().numpy()
        out["train_metrics"] = binary_metrics(logits, labels)
        if val is not None:
            v1, v2, vy = val
            vlogits = predictor(
                torch.as_tensor(v1, device=device),
                torch.as_tensor(v2, device=device)).cpu().numpy()
            out["val_metrics"] = binary_metrics(vlogits, vy)
    return out


def save_fixed_run(out_dir: str, result: Dict, *, sim_method: str,
                   class_num: int, net_hidden_dims: Tuple[int, ...],
                   table: Dict[str, np.ndarray]) -> None:
    """Write a self-contained fixed-embedding run directory:
    ``config.json`` (method="fixed" and the head's config, the marker the
    predict CLI routes on), ``params.npz`` (the flax-layout tree),
    ``embeddings.npz`` (ids and vectors, so scoring needs no external
    artifact) and ``metrics.json``."""
    os.makedirs(out_dir, exist_ok=True)
    ids = sorted(table)
    vecs = np.stack([table[i] for i in ids]).astype(np.float32)
    cfg = {
        "method": "fixed",
        "sim_method": sim_method,
        "class_num": int(class_num),
        "net_hidden_dims": list(net_hidden_dims),
        "emb_dim": int(vecs.shape[1]),
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    save_params_npz(os.path.join(out_dir, "params.npz"), result["params"])
    np.savez(os.path.join(out_dir, "embeddings.npz"),
             ids=np.asarray(ids), vecs=vecs)
    metrics = {k: result[k] for k in ("train_metrics", "val_metrics", "losses")
               if k in result}
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=1, default=float)


def is_fixed_run(run_dir: str) -> bool:
    """True when ``run_dir`` is a fixed-embedding run (config.json with
    method == "fixed"), the predict CLI's routing check."""
    path = os.path.join(run_dir, "config.json")
    try:
        with open(path) as f:
            return json.load(f).get("method") == "fixed"
    except (OSError, ValueError):
        return False


def load_fixed_run(run_dir: str, device="cuda"):
    """(predictor on ``device`` with the run's weights, the flax-layout
    params tree, the id -> vector table) of a ``save_fixed_run``
    directory."""
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    path = os.path.join(run_dir, "params.npz")
    if not os.path.exists(path):
        msgpack = os.path.join(run_dir, "params.msgpack")
        if os.path.exists(msgpack):
            raise ValueError(
                f"{msgpack}: a JAX run's flax serialization, which needs "
                "flax to read; the port reads params.npz (the flax-layout "
                "tree, convert.save_params_npz)")
        raise FileNotFoundError(f"no params.npz in fixed run {run_dir!r}")
    predictor = build_fixed_predictor(
        cfg["sim_method"], cfg["class_num"], tuple(cfg["net_hidden_dims"]),
        cfg["emb_dim"])
    params = load_params_npz(path)
    from_jax_params(params, predictor)
    data = np.load(os.path.join(run_dir, "embeddings.npz"), allow_pickle=False)
    table = {str(i): v for i, v in zip(data["ids"], data["vecs"])}
    return predictor.to(torch.device(device)), params, table


def score_fixed_pairs(run_dir: str, id1, id2, batch_size: int = 4096,
                      device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Score id pairs with a fixed-embedding run.

    Returns ``(probs, present)``: sigmoid probabilities for rows whose
    BOTH ids are in the run's embedding table (shape (n_present,) or
    (n_present, class_num)), and the boolean presence mask over the
    input rows."""
    predictor, _, table = load_fixed_run(run_dir, device)
    id1 = [str(x) for x in id1]
    id2 = [str(x) for x in id2]
    present = np.array([a in table and b in table for a, b in zip(id1, id2)])
    if not present.any():
        return np.zeros((0,), np.float32), present
    e1 = np.stack([table[a] for a, ok in zip(id1, present) if ok])
    e2 = np.stack([table[b] for b, ok in zip(id2, present) if ok])
    chunks = []
    with torch.no_grad():
        for s in range(0, len(e1), batch_size):
            a = torch.as_tensor(e1[s:s + batch_size], device=device)
            b = torch.as_tensor(e2[s:s + batch_size], device=device)
            chunks.append(predictor(a, b).cpu().numpy())
    logits = np.concatenate(chunks)
    if logits.ndim > 1 and logits.shape[-1] == 1:
        logits = logits[:, 0]
    return 1.0 / (1.0 + np.exp(-logits)), present
