"""Pair evaluation, the serving path (port of gcnbmp_tpu/eval/evaluate.py:
``PairEvaluator`` :34-107, ``PackedPairEvaluator`` :110-197,
``_packed_eval_eligible`` :200-210, ``export_representations`` and
``evaluate_dataset`` :222-293).

Each evaluator runs a predictor over a whole ``PairDataset`` in
fixed-shape batches and collects logits, labels, the pair's two molecule
embeddings (after co-attention, for a co-attention model) and
``train.metrics.compute_metrics`` of the logits, dropping fill rows:

- ``PairEvaluator``: the padded predictor (``PairPredictor``,
  ``GWMPairPredictor``) over ``data.dataset`` batches, ``pad_to`` atoms
  wide (default: the bucket of the dataset's largest molecule), a GWM
  model's batches with the supernode rows of its ``supernode_fn``;
- ``PackedPairEvaluator``: the wire-compact predictor.  A co-attention
  model's batches carry each pair side's atom slot table
  (``compact_coattn_arrays``) ``n_max`` wide: the caller's width, or as
  the JAX evaluator takes it, the dataset's largest molecule rounded up
  to 8 (:156-162); the predictor's ``wire_encoder`` makes that choice.

The JAX package scores a run on the packed layout when
``_packed_eval_eligible`` holds (a run trained on a packed layout with a
configuration those layouts take, no supernodes), and on the padded one
otherwise: padded runs and every GWM run.  ``train.checkpoints.
served_predictor`` builds the predictor of that layout, and
``evaluate_dataset`` and ``make_evaluator`` take the evaluator of the
predictor's layout.  ``evaluate_dataset`` writes ``eval_result.json``
and, given the source CSV, the embedding exports of the JAX package:
``<test>_e.csv``, ``<test>_e_y.csv`` and
``drug_list_with_representation.csv``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import pandas as pd
import torch

from gcnbmp_tpu_torch.data import estimate_coo_capacities
from gcnbmp_tpu_torch.data.wire import iter_coo_eval_batches
from gcnbmp_tpu_torch.train.metrics import compute_metrics

# the pair CSV's id columns; the drug list is written when both exist
ID_COLS = ("drugbank_id_1", "drugbank_id_2")


@dataclass
class EvalResult:
    logits: np.ndarray
    labels: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    metrics: Dict[str, float]


class PairEvaluator:
    """Serve the padded ``predictor`` over a dataset on ``device`` at
    ``pad_to`` atoms per molecule (default: the bucket of each dataset's
    largest molecule), its batches filled to ``batch_size`` with
    ignore-label rows, which are dropped.  A GWM predictor's batches carry
    the supernode rows of ``supernode_fn``, by default the predictor's.
    ``class_names`` and ``with_metrics`` as for ``PackedPairEvaluator``."""

    def __init__(self, predictor, batch_size: int = 32,
                 pad_to: Optional[int] = None, class_num: int = 1,
                 supernode_fn=None, class_names=None, device="cuda",
                 with_metrics: bool = True):
        self.device = torch.device(device)
        self.predictor = predictor.to(self.device).eval()
        self.batch_size = batch_size
        self.pad_to = pad_to
        self.class_num = class_num
        self.supernode_fn = supernode_fn or getattr(predictor,
                                                    "supernode_fn", None)
        self.class_names = class_names
        self.with_metrics = with_metrics

    @torch.no_grad()
    def evaluate(self, ds) -> EvalResult:
        from gcnbmp_tpu_torch.data.dataset import (
            batch_iterator, bucket_size, padded_args)

        pad_to = self.pad_to or bucket_size(ds.max_atoms())
        logits_all, labels_all, e1_all, e2_all = [], [], [], []
        for batch in batch_iterator(ds, self.batch_size, shuffle=False,
                                    pad_to=pad_to,
                                    supernode_fn=self.supernode_fn):
            args, kwargs, _ = padded_args(batch, self.device,
                                          self.supernode_fn is not None)
            logits, aux = self.predictor(*args, deterministic=True,
                                         return_aux=True, **kwargs)
            labels = np.asarray(batch.labels)
            logits = logits.cpu().numpy().reshape(
                labels.shape if self.class_num == 1
                else (labels.shape[0], -1))
            valid = ((labels >= 0).all(axis=-1) if labels.ndim > 1
                     else labels >= 0)
            logits_all.append(logits[valid])
            labels_all.append(labels[valid])
            e1_all.append(aux["g1"].cpu().numpy()[valid])
            e2_all.append(aux["g2"].cpu().numpy()[valid])
        return _result(logits_all, labels_all, e1_all, e2_all,
                       self.class_num, self.class_names, self.with_metrics)


def _result(logits_all, labels_all, e1_all, e2_all, class_num, class_names,
            with_metrics) -> EvalResult:
    logits = np.concatenate(logits_all)
    labels = np.concatenate(labels_all)
    return EvalResult(
        logits=logits, labels=labels,
        e1=np.concatenate(e1_all), e2=np.concatenate(e2_all),
        metrics=(compute_metrics(logits, labels, class_num,
                                 class_names=class_names)
                 if with_metrics else {}),
    )


class PackedPairEvaluator:
    """Serve ``predictor`` (a ``PackedPairPredictorCOOCompact`` of any
    ported encoder, a ``PackedCoattnPairPredictor`` or a
    ``PackedGWMPairPredictorCOOCompact``, taken as it is given) over a
    dataset on ``device``.  ``n_max``: the co-attention
    atom table width, default the dataset's.  ``class_names`` (a
    multi-label run's classes) add ``per_class`` to the metrics;
    ``with_metrics=False`` computes none (serving, whose labels are
    placeholders: a multi-label run's would not have its classes'
    shape)."""

    def __init__(self, predictor, batch_size: int = 512, class_num: int = 1,
                 device="cuda", n_max: Optional[int] = None,
                 class_names=None, with_metrics: bool = True):
        self.device = torch.device(device)
        self.predictor = predictor.to(self.device).eval()
        self.batch_size = batch_size
        self.class_num = class_num
        self.n_max = n_max
        self.class_names = class_names
        self.with_metrics = with_metrics

    @torch.no_grad()
    def evaluate(self, ds) -> EvalResult:
        args_fn = self.predictor.wire_encoder([ds], self.n_max)
        bs = min(self.batch_size, len(ds))
        num_tiles, edge_capacity = estimate_coo_capacities([ds], bs)
        logits_all, labels_all, e1_all, e2_all = [], [], [], []
        supernode_fn = getattr(self.predictor, "supernode_fn", None)
        for batch, valid in iter_coo_eval_batches(ds, bs, num_tiles,
                                                  edge_capacity,
                                                  supernode_fn):
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
        return _result(logits_all, labels_all, e1_all, e2_all,
                       self.class_num, self.class_names, self.with_metrics)


def _packed_eval_eligible(train_cfg, supernode_fn=None) -> bool:
    """Whether the JAX package scores the run of ``train_cfg`` (a config
    dict or ``TrainConfig``) on the packed layout (:200-210): a run
    trained on ``packed``, ``coo`` or ``fused`` whose configuration
    ``packed_config_problems`` (co-attention allowed) takes, and no
    supernodes (a GWM run, whose CLIs pass its ``supernode_fn``)."""
    from gcnbmp_tpu_torch.train.loop import packed_config_problems

    if train_cfg is None or supernode_fn is not None:
        return False
    get = (train_cfg.get if isinstance(train_cfg, dict)
           else lambda k, d=None: getattr(train_cfg, k, d))
    if get("method", "ggnn") == "ggnn-gwm":
        return False
    if get("compute_path", "padded") not in ("packed", "coo", "fused"):
        return False
    return not packed_config_problems(train_cfg, allow_attn=True)


def is_padded(predictor) -> bool:
    """Whether ``predictor`` is one of the padded layout's."""
    from gcnbmp_tpu_torch.models.gwm import GWMPairPredictor
    from gcnbmp_tpu_torch.models.predictor import PairPredictor

    return isinstance(predictor, (PairPredictor, GWMPairPredictor))


def make_evaluator(predictor, **kwargs):
    """``PairEvaluator`` for a padded predictor, else
    ``PackedPairEvaluator``, with ``kwargs`` (``batch_size``,
    ``class_num``, ``device``, ``class_names``, ``with_metrics``)."""
    cls = PairEvaluator if is_padded(predictor) else PackedPairEvaluator
    return cls(predictor, **kwargs)


def _float_list_to_str(v: np.ndarray) -> str:
    return " ".join(f"{x:.6g}" for x in np.ravel(v))


def export_representations(
    source_csv: str,
    out_dir: str,
    result: EvalResult,
    is_successful: Optional[np.ndarray] = None,
) -> None:
    """Write <test>_e.csv, <test>_e_y.csv, drug_list_with_representation.csv
    (the JAX package's :222-260): each pair's two embeddings as
    space-joined ``%.6g`` floats in columns ``e1``/``e2`` before the last
    column, ``y`` the probabilities, and each id's embedding when both
    ``ID_COLS`` exist.  Refuses when the evaluated rows do not line up
    with the CSV's parseable ones."""
    os.makedirs(out_dir, exist_ok=True)
    df = pd.read_csv(source_csv)
    if is_successful is not None:
        df = df[np.asarray(is_successful)].reset_index(drop=True)
    if len(result.e1) != len(df):
        # evaluators drop ignore-labelled (label < 0 / NaN) rows, which
        # the is_successful mask cannot see
        raise ValueError(
            f"export alignment mismatch: {len(result.e1)} evaluated rows "
            f"vs {len(df)} parseable CSV rows (does the CSV contain "
            "negative/NaN labels?)"
        )
    base = os.path.splitext(os.path.basename(source_csv))[0]
    e1 = [_float_list_to_str(x) for x in result.e1]
    e2 = [_float_list_to_str(x) for x in result.e2]
    out = df.copy()
    out.insert(len(out.columns) - 1, "e1", e1)
    out.insert(len(out.columns) - 1, "e2", e2)
    out.to_csv(os.path.join(out_dir, f"{base}_e.csv"), index=False)
    out_y = out.copy()
    probs = 1.0 / (1.0 + np.exp(-result.logits))
    out_y["y"] = list(np.ravel(probs) if probs.ndim == 1 else probs.tolist())
    out_y.to_csv(os.path.join(out_dir, f"{base}_e_y.csv"), index=False)
    if all(c in df.columns for c in ID_COLS):
        mapping = dict(zip(df[ID_COLS[0]], e1))
        mapping.update(dict(zip(df[ID_COLS[1]], e2)))
        pd.DataFrame(
            {"cid": list(mapping.keys()), "entity": list(mapping.values())}
        ).to_csv(
            os.path.join(out_dir, "drug_list_with_representation.csv"),
            index=False,
        )


def evaluate_dataset(
    predictor, ds, out_dir: Optional[str] = None,
    source_csv: Optional[str] = None, batch_size: int = 32,
    class_num: int = 1, is_successful: Optional[np.ndarray] = None,
    class_names=None, device="cuda", train_cfg=None,
) -> EvalResult:
    """One call: evaluate ``predictor`` over ``ds`` on ``device``, write
    ``eval_result.json`` (the metrics, under the JAX package's keys)
    into ``out_dir`` and, given ``source_csv``, the exports
    (``export_representations``).  The JAX function (:263-293) takes a
    flax predictor, its params and the run's config, and takes the packed
    evaluator where ``_packed_eval_eligible`` holds, else the padded one.
    The port's predictor holds its weights in one layout: given
    ``train_cfg``, one in the other layout is refused; the evaluator is
    that of the predictor's layout (``served_predictor`` builds the
    right one for a run).  A co-attention model's atom table is the
    dataset's width, as the JAX evaluator takes it."""
    if train_cfg is not None and is_padded(predictor) == \
            _packed_eval_eligible(train_cfg):
        want = "packed" if _packed_eval_eligible(train_cfg) else "padded"
        raise ValueError(f"the JAX package scores this run on the {want} "
                         "layout; build its predictor with "
                         "train.checkpoints.served_predictor")
    result = make_evaluator(
        predictor, batch_size=batch_size, class_num=class_num,
        device=device, class_names=class_names,
    ).evaluate(ds)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "eval_result.json"), "w") as f:
            json.dump(result.metrics, f, indent=2)
        if source_csv:
            export_representations(
                source_csv, out_dir, result, is_successful=is_successful
            )
    return result
