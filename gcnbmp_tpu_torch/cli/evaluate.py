#!/usr/bin/env python
"""Evaluate a trained run of the port on a test pair CSV.

Port of the JAX package's evaluate CLI (gcnbmp_tpu/cli/evaluate.py):
loads ``<run>/config.json`` and ``<run>/<checkpoint>/params.npz``
(``train.checkpoints.load_run``) into the predictor of the layout the
JAX CLI scores the run on (gcnbmp_tpu/cli/evaluate.py:114-124): the
packed compact-COO predictor for a run trained on a packed layout with
a configuration those layouts take, else the padded one (``PairEvaluator``
over ``PairPredictor``, or ``GWMPairPredictor`` with its supernode
features for every GWM run), runs it over the test CSV and writes,
under ``--out`` (default ``<run>/eval``),
``eval_result.json`` (the metrics), ``<test>_e.csv``, ``<test>_e_y.csv``
and ``drug_list_with_representation.csv``; on request
``similarity_<method>.csv`` and ``correlation.json``, and with
``--saliency gradient|integrated|bayes`` the atom saliency SVGs
``saliency/pair{i}_{side}.svg`` of the first ``--saliency-count`` pairs
(``eval.saliency``, through the padded predictor of the run's config
and weights, whatever layout scored the metrics, as the JAX CLI takes
its trainer's padded predictor; a GWM run is refused there as the JAX
CLI refuses it, ``GWMPairPredictor`` having no supernode features).
Prints the metrics without ``per_class`` as one JSON line.

    python -m gcnbmp_tpu_torch.cli.evaluate --test test.csv \\
        --run results/run1 --checkpoint best --device cuda

The same flags and defaults as the JAX CLI, plus ``--device`` (``cuda``,
the default, runs the CUDA kernels; ``cpu`` runs their plain versions).
``--platform`` (a JAX platform) is refused.  The correlation's scatter
plot needs matplotlib and is skipped.  On
``--device cuda`` a width the card's kernels are not built for is
refused before any pair is parsed.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--test", required=True, help="test pair CSV")
    p.add_argument("--run", required=True,
                   help="training output dir (config.json + checkpoints)")
    p.add_argument("--checkpoint", default="best",
                   help="checkpoint name under the run dir "
                        "(best/final/snapshot_epoch_N)")
    p.add_argument("--out", default=None, help="output dir (default <run>/eval)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--similarity", default=None,
                   choices=["cosine", "jaccard", "extended-jaccard"],
                   help="also write a drug-drug similarity matrix CSV")
    p.add_argument("--saliency", default=None,
                   choices=["gradient", "integrated", "bayes"],
                   help="also render saliency SVGs for the first pairs")
    p.add_argument("--saliency-count", type=int, default=4)
    p.add_argument("--correlation-matrix", default=None,
                   help="known-DDI drug-drug matrix CSV (columns = cids); "
                        "also compute embedding-similarity vs shared-DDI "
                        "correlation into correlation.json")
    p.add_argument("--smiles-cols", default="smiles_1,smiles_2",
                   help="the two SMILES column names (match the train CLI)")
    p.add_argument("--label-cols", default="label",
                   help="label column name(s) (match the train CLI)")
    p.add_argument("--labels-csv", dest="labels_csv", default=None,
                   help="class-list CSV for multi-label runs (the file "
                        "given to the train CLI; enables ||-label parsing)")
    p.add_argument("--platform", default=None,
                   help="JAX platform override; the port takes --device")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain versions, for tests)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.platform:
        raise ValueError("--platform selects a JAX platform; the port runs "
                         "on --device cuda|cpu")
    logging.basicConfig(level=logging.INFO)

    import numpy as np
    import torch

    from gcnbmp_tpu_torch.data import CSVPairParser, get_class_labels
    from gcnbmp_tpu_torch.eval.evaluate import evaluate_dataset
    from gcnbmp_tpu_torch.train.checkpoints import load_run
    from gcnbmp_tpu_torch.train.loop import kernel_problems

    with open(os.path.join(args.run, "config.json")) as f:
        config = json.load(f)
    class_num = int(config.get("class_num", 1))
    classes = None
    if args.labels_csv:
        classes = get_class_labels(args.labels_csv)
        if class_num > 1 and len(classes) != class_num:
            raise SystemExit(
                f"--labels-csv has {len(classes)} classes but the run was "
                f"trained with class_num={class_num}")
    elif class_num > 1:
        raise SystemExit(
            "this run is multi-label (class_num>1); pass the same "
            "--labels-csv used for training so test labels binarize "
            "identically")
    problems = kernel_problems(config, args.device, serving=True)
    if problems:
        raise ValueError("configuration outside what the card's kernels "
                         "serve: " + "; ".join(problems))
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available")
    _, predictor = load_run(args.run, args.checkpoint, device)

    parser = CSVPairParser(
        multi_label_classes=classes,
        smiles_cols=tuple(args.smiles_cols.split(",")),
        labels=tuple(args.label_cols.split(",")),
    )
    res = parser.parse(args.test)
    ds = res.dataset
    logging.info("test: %d pairs (%d failed)", len(ds), res.fail_count)
    out_dir = args.out or os.path.join(args.run, "eval")
    result = evaluate_dataset(
        predictor, ds, out_dir=out_dir, source_csv=args.test,
        batch_size=args.batch_size, class_num=class_num,
        is_successful=res.is_successful, class_names=classes, device=device,
        train_cfg=config,
    )
    print(json.dumps(
        {k: v for k, v in result.metrics.items() if k != "per_class"}))

    if args.similarity:
        from gcnbmp_tpu_torch.eval.similarity import similarity_csv

        # e1 holds all left embeddings, then e2 all right: the ids go in
        # the same order
        ids = ([p[0] for p in ds.smiles_pairs]
               + [p[1] for p in ds.smiles_pairs])
        emb = np.concatenate([result.e1, result.e2])
        uniq = {}
        for i, s in enumerate(ids):
            uniq.setdefault(s, emb[i])
        similarity_csv(
            np.stack(list(uniq.values())), list(uniq.keys()),
            method=args.similarity,
            out_path=os.path.join(out_dir, f"similarity_{args.similarity}.csv"),
        )
        logging.info("similarity matrix written")

    if args.correlation_matrix:
        import pandas as pd

        from gcnbmp_tpu_torch.eval.analysis import embedding_ddi_correlation

        mat_df = pd.read_csv(args.correlation_matrix)
        if "Unnamed: 0" in mat_df.columns:  # pandas index column
            mat_df = mat_df.drop(columns=["Unnamed: 0"])
        cids = [str(c) for c in mat_df.columns]
        mat = mat_df.to_numpy()
        # per-drug embedding from the pair exports (cid columns when
        # present, else drugbank ids)
        test_df = pd.read_csv(args.test)
        test_df = test_df[np.asarray(res.is_successful)].reset_index(drop=True)
        emb = {}
        for col, e in (("1", result.e1), ("2", result.e2)):
            idcol = (f"cid_{col}" if f"cid_{col}" in test_df.columns
                     else f"drugbank_id_{col}")
            for i, d in enumerate(test_df[idcol].astype(str)):
                emb.setdefault(d, e[i])
        keep = [i for i, d in enumerate(cids) if d in emb]
        if len(keep) < 3:
            raise SystemExit(
                "--correlation-matrix: fewer than 3 matrix drugs appear "
                "in the test CSV ids")
        E = np.stack([emb[cids[i]] for i in keep])
        sub = mat[np.ix_(keep, keep)]
        corr, _, _ = embedding_ddi_correlation(E, sub)
        with open(os.path.join(out_dir, "correlation.json"), "w") as f:
            json.dump({"pearson_correlation": corr, "n_drugs": len(keep)}, f,
                      indent=2)
        logging.info("correlation %.4f over %d drugs; the scatter plot is "
                     "skipped: the port has no matplotlib", corr, len(keep))

    if args.saliency:
        write_saliency(args, config, ds, out_dir, device)
    return 0


def write_saliency(args, config, ds, out_dir, device) -> None:
    """The saliency SVGs of the first ``--saliency-count`` pairs of ``ds``
    (gcnbmp_tpu/cli/evaluate.py:184-210)."""
    from gcnbmp_tpu_torch.chem import mol_from_smiles
    from gcnbmp_tpu_torch.convert import load_params_npz
    from gcnbmp_tpu_torch.data.dataset import make_batch
    from gcnbmp_tpu_torch.eval.saliency import (
        atom_saliency, render_molecule_svg)
    from gcnbmp_tpu_torch.train.checkpoints import padded_predictor

    k = min(args.saliency_count, len(ds))
    batch = make_batch(ds, list(range(k)))
    tree = load_params_npz(os.path.join(args.run, args.checkpoint,
                                        "params.npz"))
    predictor = padded_predictor(config, tree).to(device)
    try:
        sal = atom_saliency(
            predictor, batch.atoms1, batch.adj1, batch.atoms2, batch.adj2,
            batch.mask1, batch.mask2, method=args.saliency)
    except NotImplementedError as e:
        logging.warning("saliency skipped: %s", e)
        return
    os.makedirs(os.path.join(out_dir, "saliency"), exist_ok=True)
    for i in range(k):
        for side, key in (("mol1", 0), ("mol2", 1)):
            mol = mol_from_smiles(ds.smiles_pairs[i][key])
            svg = render_molecule_svg(mol, sal[side][i])
            with open(os.path.join(out_dir, "saliency",
                                   f"pair{i}_{side}.svg"), "w") as f:
                f.write(svg)
    logging.info("saliency SVGs written")


if __name__ == "__main__":
    sys.exit(main())
