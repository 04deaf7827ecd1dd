#!/usr/bin/env python
"""Score drug-pair CSVs with the port's pair predictors.

Port of the JAX package's predict CLI (gcnbmp_tpu/cli/predict.py:74-136):
reads a pair CSV (label column optional), writes it back with a ``prob``
column (``prob_class{c}`` for multi-label models).  The run is served
in the layout the JAX CLI serves it on (:99-115): a run trained on a
packed layout (``coo``, ``fused``, ``packed``) whose configuration those
layouts take goes through the packed compact-COO predictor (every packed
encoder with any head, and any of them but GWM with any co-attention
variant; MPNN with the JAX evaluator's Set2Set table width
of 64 atoms, and a wider molecule turns its batch NaN; co-attention with
the input's largest molecule rounded up to 8, which ``lt``'s weights
must match); a padded run and every GWM run go through the padded
``PairEvaluator`` (GWM with the supernode features of each SMILES), at
the bucket of the input's largest molecule.

    python -m gcnbmp_tpu_torch.cli.predict --input pairs.csv \\
        --run results/run1 --checkpoint best --out preds.csv
    python -m gcnbmp_tpu_torch.cli.predict --input pairs.csv \\
        --config run/config.json --params params.npz --out preds.csv

Give a trained run (``--run``, with ``--checkpoint``, default ``best``:
``train.checkpoints.load_run``) or a config and params pair, not both.
``--config`` is a JAX run's ``config.json``; only its model fields are
read, and on ``--device cuda`` a width the card's kernels are not built
for is refused before any pair is parsed.  ``--params`` is a flat
``.npz`` of the flax param tree (``convert.save_params_npz``).

A ``--run`` that is a fixed-embedding run (``config.json`` with
``method: "fixed"``, written by the train CLI's ``--fixed-embeddings``)
is scored from its own embedding table, with no SMILES parsed
(gcnbmp_tpu/cli/predict.py:41-76): the id columns are ``--smiles-cols``
with ``smiles`` read as ``drugbank_id``, rows with an id missing from
the table are dropped, and a multi-class run gets ``prob_class{c}``
columns.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

# the packed layout's config reader, importable from this CLI as before
from gcnbmp_tpu_torch.models.packed import model_kwargs_from_config  # noqa: F401


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True, help="pair CSV to score")
    p.add_argument("--run", default=None, help="training output dir")
    p.add_argument("--checkpoint", default="best",
                   help="checkpoint name under --run (best/final/"
                        "snapshot_epoch_N)")
    p.add_argument("--config", default=None, help="run config.json")
    p.add_argument("--params", default=None, help="flax-layout params .npz")
    p.add_argument("--out", default=None, help="output CSV (default stdout)")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--smiles-cols", default="smiles_1,smiles_2",
                   help="the two SMILES column names")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain versions, for tests)")
    args = p.parse_args(argv)
    pair_given = args.config is not None or args.params is not None
    if (args.run is not None) == pair_given or (
            pair_given and None in (args.config, args.params)):
        p.error("give either --run (with --checkpoint) or both --config "
                "and --params")
    logging.basicConfig(level=logging.INFO)

    import numpy as np
    import pandas as pd
    import torch

    from gcnbmp_tpu_torch.train.fixed import is_fixed_run

    if args.run is not None and is_fixed_run(args.run):
        return _predict_fixed(args)

    from gcnbmp_tpu_torch.data import CSVPairParser
    from gcnbmp_tpu_torch.convert import load_params_npz
    from gcnbmp_tpu_torch.eval.evaluate import make_evaluator
    from gcnbmp_tpu_torch.train.checkpoints import load_run, served_predictor
    from gcnbmp_tpu_torch.train.loop import kernel_problems

    config_path = (os.path.join(args.run, "config.json") if args.run
                   else args.config)
    with open(config_path) as f:
        config = json.load(f)
    problems = kernel_problems(config, args.device)
    if problems:
        raise ValueError("configuration outside what the card's kernels "
                         "serve: " + "; ".join(problems))
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available")
    if args.run:
        _, predictor = load_run(args.run, args.checkpoint, device)
    else:
        predictor = served_predictor(config, load_params_npz(args.params))

    df = pd.read_csv(args.input).copy()
    # every row gets a valid label so the evaluator keeps all of them
    # aligned with the output frame
    df["label"] = 0
    res = CSVPairParser(smiles_cols=tuple(args.smiles_cols.split(","))).parse(df)
    logging.info("scoring %d pairs (%d unparseable)",
                 len(res.dataset), res.fail_count)
    # no metrics over the placeholder labels: the JAX CLI computes them
    # and so cannot serve a multi-label run (its labels lack the classes'
    # axis)
    result = make_evaluator(
        predictor, batch_size=args.batch_size,
        class_num=int(config.get("class_num", 1)), device=device,
        with_metrics=False,
    ).evaluate(res.dataset)
    probs = 1.0 / (1.0 + np.exp(-result.logits))

    out = df[np.asarray(res.is_successful)].reset_index(drop=True).copy()
    if probs.ndim == 1 or probs.shape[-1] == 1:
        out["prob"] = np.ravel(probs)
    else:
        for c in range(probs.shape[1]):
            out[f"prob_class{c}"] = probs[:, c]
    _write(out, args.out)
    return 0


def _write(out, path) -> None:
    if path:
        out.to_csv(path, index=False)
        logging.info("wrote %s", path)
    else:
        out.to_csv(sys.stdout, index=False)


def _predict_fixed(args) -> int:
    """Score a fixed-embedding run's pairs straight from its table."""
    import pandas as pd
    import torch

    from gcnbmp_tpu_torch.train.fixed import score_fixed_pairs

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available")
    df = pd.read_csv(args.input)
    id_cols = [c.replace("smiles", "drugbank_id")
               for c in args.smiles_cols.split(",")]
    for c in id_cols:
        if c not in df.columns:
            raise SystemExit(
                f"fixed-embedding run needs id column {c!r} in --input")
    probs, present = score_fixed_pairs(
        args.run, df[id_cols[0]], df[id_cols[1]], batch_size=args.batch_size,
        device=device)
    logging.info("scoring %d pairs (%d ids missing from table)",
                 int(present.sum()), int((~present).sum()))
    out = df[present].reset_index(drop=True).copy()
    if probs.ndim == 1:
        out["prob"] = probs
    else:
        for c in range(probs.shape[1]):
            out[f"prob_class{c}"] = probs[:, c]
    _write(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
