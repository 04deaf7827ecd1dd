"""Evaluation metrics: accuracy / ROC-AUC / PRC-AUC / F1 / precision /
recall, in numpy only (port of gcnbmp_tpu/train/metrics.py).

The JAX package calls scikit-learn; the machine with the card has none,
so the metrics are computed here the way scikit-learn computes them:

- ROC-AUC: the trapezoid over the ROC curve with one point per distinct
  score (ties share a point), collinear points dropped, (0, 0) prepended
  (``roc_auc_score`` / ``roc_curve(drop_intermediate=True)``).
- PRC-AUC: ``auc(recall, precision)`` over ``precision_recall_curve``:
  one point per distinct score, reversed, ending at (recall 0,
  precision 1); precision is 0 where nothing is predicted positive.
- F1, precision, recall of the thresholded probabilities, 0 where the
  denominator is 0 (``zero_division=0``).

Multi-label metrics average per class column, skipping columns with a
single class for the two AUCs, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _clf_curve(y: np.ndarray, score: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(fps, tps) at each distinct score, in descending score order."""
    order = np.argsort(score, kind="stable")[::-1]
    score, y = score[order], y[order].astype(np.float64)
    idx = np.r_[np.nonzero(np.diff(score))[0], y.size - 1]
    tps = np.cumsum(y)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps


def roc_auc(y: np.ndarray, score: np.ndarray) -> float:
    fps, tps = _clf_curve(y, score)
    if fps.size > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps = fps[keep], tps[keep]
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return float(np.trapezoid(tpr, fpr))


def prc_auc(y: np.ndarray, score: np.ndarray) -> float:
    fps, tps = _clf_curve(y, score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = tps / tps[-1]
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    # recall decreases along the curve: the area is the negated trapezoid
    return float(-np.trapezoid(precision, recall))


def _prf(y: np.ndarray, pred: np.ndarray) -> Tuple[float, float, float]:
    tp = float(np.sum((pred == 1) & (y == 1)))
    n_pred = float(np.sum(pred == 1))
    n_true = float(np.sum(y == 1))
    precision = tp / n_pred if n_pred else 0.0
    recall = tp / n_true if n_true else 0.0
    f1 = 2.0 * tp / (n_true + n_pred) if n_true + n_pred else 0.0
    return precision, recall, f1


def binary_metrics(logits: np.ndarray, labels: np.ndarray,
                   threshold: float = 0.5) -> Dict[str, float]:
    """Metrics for binary DDI (labels in {0,1}, logits pre-sigmoid)."""
    logits = np.ravel(np.asarray(logits, dtype=np.float64))
    labels = np.ravel(np.asarray(labels)).astype(np.int64)
    probs = _sigmoid(logits)
    preds = (probs >= threshold).astype(np.int64)
    out: Dict[str, float] = {
        "accuracy": float((preds == labels).mean()) if labels.size else float("nan"),
    }
    if labels.size and 0 < labels.sum() < labels.size:
        out["roc_auc"] = roc_auc(labels, probs)
        out["prc_auc"] = prc_auc(labels, probs)
    else:
        out["roc_auc"] = float("nan")
        out["prc_auc"] = float("nan")
    out["precision"], out["recall"], out["f1"] = _prf(labels, preds)
    return {k: out[k] for k in ("accuracy", "roc_auc", "prc_auc", "f1",
                                "precision", "recall")}


def multilabel_metrics(logits: np.ndarray, labels: np.ndarray,
                       threshold: float = 0.5,
                       class_names=None) -> Dict[str, float]:
    """Per-class-mean metrics for multi-hot labels (B, C); with
    ``class_names`` also a ``"per_class"`` breakdown."""
    logits = np.asarray(logits, dtype=np.float64)
    labels = np.asarray(labels).astype(np.int64)
    probs = _sigmoid(logits)
    preds = (probs >= threshold).astype(np.int64)
    rocs, prcs, f1s, accs, precs, recs = [], [], [], [], [], []
    per_class: Dict[str, Dict[str, float]] = {}
    for c in range(labels.shape[1]):
        y = labels[:, c]
        accs.append(float((preds[:, c] == y).mean()))
        precision, recall, f1 = _prf(y, preds[:, c])
        f1s.append(f1)
        precs.append(precision)
        recs.append(recall)
        roc = prc = float("nan")
        if 0 < y.sum() < y.size:
            roc = roc_auc(y, probs[:, c])
            prc = prc_auc(y, probs[:, c])
            rocs.append(roc)
            prcs.append(prc)
        if class_names is not None:
            per_class[str(class_names[c])] = {
                "roc_auc": roc, "prc_auc": prc, "f1": f1,
                "support": int(y.sum()),
            }
    mean = lambda v: float(np.mean(v)) if v else float("nan")
    out: Dict[str, float] = {
        "accuracy": mean(accs), "roc_auc": mean(rocs), "prc_auc": mean(prcs),
        "f1": mean(f1s), "precision": mean(precs), "recall": mean(recs),
    }
    if class_names is not None:
        out["per_class"] = per_class
    return out


def compute_metrics(logits: np.ndarray, labels: np.ndarray,
                    class_num: int = 1, class_names=None) -> Dict[str, float]:
    if class_num > 1:
        return multilabel_metrics(logits, labels, class_names=class_names)
    return binary_metrics(logits, labels)
