#!/usr/bin/env python
"""Score drug-pair CSVs with the port's packed pair predictor.

Port of the JAX package's predict CLI (gcnbmp_tpu/cli/predict.py:74-136)
for the packed GGNN + HolE and MPNN + HolE families (``method`` of the
config; MPNN serves with the JAX evaluator's Set2Set table width of 64
atoms, and a wider molecule turns its batch NaN): reads a pair CSV
(label column optional), writes it back with a ``prob`` column
(``prob_class{c}`` for multi-label models).

    python -m gcnbmp_tpu_torch.cli.predict --input pairs.csv \\
        --config run/config.json --params params.npz --out preds.csv

``--config`` is a JAX run's ``config.json``; only its model fields are
read, and on ``--device cuda`` a width the card's kernels are not built
for is refused before any pair is parsed.  ``--params`` is a flat
``.npz`` of the flax param tree (``convert.save_params_npz``).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from gcnbmp_tpu_torch.models.packed import model_kwargs_from_config


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True, help="pair CSV to score")
    p.add_argument("--config", required=True, help="run config.json")
    p.add_argument("--params", required=True, help="flax-layout params .npz")
    p.add_argument("--out", default=None, help="output CSV (default stdout)")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--smiles-cols", default="smiles_1,smiles_2",
                   help="the two SMILES column names")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain versions, for tests)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import numpy as np
    import pandas as pd
    import torch

    from gcnbmp_tpu_torch.data import CSVPairParser
    from gcnbmp_tpu_torch.convert import from_jax_params, load_params_npz
    from gcnbmp_tpu_torch.eval.evaluate import PackedPairEvaluator
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor
    from gcnbmp_tpu_torch.train.loop import kernel_problems

    with open(args.config) as f:
        config = json.load(f)
    kwargs = model_kwargs_from_config(config)
    problems = kernel_problems(config, args.device)
    if problems:
        raise ValueError("configuration outside what the card's kernels "
                         "serve: " + "; ".join(problems))
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available")
    predictor = from_jax_params(load_params_npz(args.params),
                                make_packed_predictor(**kwargs))

    df = pd.read_csv(args.input).copy()
    # every row gets a valid label so the evaluator keeps all of them
    # aligned with the output frame
    df["label"] = 0
    res = CSVPairParser(smiles_cols=tuple(args.smiles_cols.split(","))).parse(df)
    logging.info("scoring %d pairs (%d unparseable)",
                 len(res.dataset), res.fail_count)
    result = PackedPairEvaluator(
        predictor, batch_size=args.batch_size,
        class_num=kwargs["class_num"], device=device,
    ).evaluate(res.dataset)
    probs = 1.0 / (1.0 + np.exp(-result.logits))

    out = df[np.asarray(res.is_successful)].reset_index(drop=True).copy()
    if probs.ndim == 1 or probs.shape[-1] == 1:
        out["prob"] = np.ravel(probs)
    else:
        for c in range(probs.shape[1]):
            out[f"prob_class{c}"] = probs[:, c]
    if args.out:
        out.to_csv(args.out, index=False)
        logging.info("wrote %s", args.out)
    else:
        out.to_csv(sys.stdout, index=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
