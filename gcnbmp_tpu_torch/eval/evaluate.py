"""Packed pair evaluation, the serving path
(port of ``PackedPairEvaluator``, gcnbmp_tpu/eval/evaluate.py:110-197).

Runs the wire-compact predictor over a whole ``PairDataset`` in
fixed-shape batches and collects logits, labels, the pair's two molecule
embeddings (after co-attention, for a co-attention model) and
``train.metrics.compute_metrics`` of the logits.  A co-attention model's
batches carry each pair side's atom slot table (``compact_coattn_arrays``)
``n_max`` wide: the caller's width, or as the JAX evaluator takes it, the
dataset's largest molecule rounded up to 8 (:156-162); the predictor's
``wire_encoder`` makes that choice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from gcnbmp_tpu_torch.data import estimate_coo_capacities
from gcnbmp_tpu_torch.data.wire import iter_coo_eval_batches
from gcnbmp_tpu_torch.train.metrics import compute_metrics


@dataclass
class EvalResult:
    logits: np.ndarray
    labels: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    metrics: Dict[str, float]


class PackedPairEvaluator:
    """Serve ``predictor`` (a ``PackedPairPredictorCOOCompact`` of any
    ported encoder or a ``PackedCoattnPairPredictor``, taken as it is
    given) over a dataset on ``device``.  ``n_max``: the co-attention
    atom table width, default the dataset's."""

    def __init__(self, predictor, batch_size: int = 512, class_num: int = 1,
                 device="cuda", n_max: Optional[int] = None):
        self.device = torch.device(device)
        self.predictor = predictor.to(self.device).eval()
        self.batch_size = batch_size
        self.class_num = class_num
        self.n_max = n_max

    @torch.no_grad()
    def evaluate(self, ds) -> EvalResult:
        args_fn = self.predictor.wire_encoder([ds], self.n_max)
        bs = min(self.batch_size, len(ds))
        num_tiles, edge_capacity = estimate_coo_capacities([ds], bs)
        logits_all, labels_all, e1_all, e2_all = [], [], [], []
        for batch, valid in iter_coo_eval_batches(ds, bs, num_tiles,
                                                  edge_capacity):
            args = [torch.as_tensor(np.asarray(a)).to(self.device)
                    for a in args_fn(batch)]
            logits, g1, g2 = self.predictor(*args, return_g=True)
            labels = np.asarray(batch.labels)
            logits = logits.cpu().numpy().reshape(
                labels.shape if self.class_num == 1
                else (labels.shape[0], -1))
            labels = labels[:valid]
            # drop ignore-labelled rows (label < 0), as the JAX evaluator does
            keep = ((labels >= 0).all(axis=-1) if labels.ndim > 1
                    else labels >= 0)
            logits_all.append(logits[:valid][keep])
            labels_all.append(labels[keep])
            e1_all.append(g1.cpu().numpy()[:valid][keep])
            e2_all.append(g2.cpu().numpy()[:valid][keep])
        logits = np.concatenate(logits_all)
        labels = np.concatenate(labels_all)
        return EvalResult(
            logits=logits, labels=labels,
            e1=np.concatenate(e1_all), e2=np.concatenate(e2_all),
            metrics=compute_metrics(logits, labels, self.class_num),
        )
