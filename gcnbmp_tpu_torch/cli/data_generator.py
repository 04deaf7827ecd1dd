#!/usr/bin/env python
"""Dataset generation CLI: the port's copy of gcnbmp_tpu/cli/data_generator.py
(the reference data_generator.py re-expressed over
``gcnbmp_tpu_torch.data.splits``), with the same flags and outputs.

Reads a drug list CSV (cid, drugbank_id, smiles) and a drug-drug matrix
CSV, writes train/valid/test pair CSVs under --out.

Examples:
    python -m gcnbmp_tpu_torch.cli.data_generator --drug-list drug_list.csv \
        --matrix drug_drug_matrix.csv --split inter --out dataset/inter
    python -m gcnbmp_tpu_torch.cli.data_generator ... --split drug
    python -m gcnbmp_tpu_torch.cli.data_generator ... --split scaffold
    python -m gcnbmp_tpu_torch.cli.data_generator ... --split isc \
        --sizes 10000,35000
    python -m gcnbmp_tpu_torch.cli.data_generator --split kaist \
        --kaist-csv pairs_multilabel.csv --out dataset/kaist
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import pandas as pd


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--drug-list")
    p.add_argument("--matrix")
    p.add_argument("--split", default="inter",
                   choices=["inter", "drug", "scaffold", "isc", "kaist"])
    p.add_argument("--kaist-csv",
                   help="multi-label pair CSV to split (for --split kaist; "
                        "reference KaistSplitter, data_generator.py:637-837)")
    p.add_argument("--edgelist",
                   help="also write the known-DDI matrix upper triangle as "
                        "an edgelist file at this path (reference "
                        "generate_known_ddis, data_generator.py:838-870)")
    p.add_argument("--out", required=True)
    p.add_argument("--frac-train", type=float, default=0.8)
    p.add_argument("--frac-valid", type=float, default=0.1)
    p.add_argument("--sizes", default="10000,20000,30000,35000,40000,50000,60000,70000")
    p.add_argument("--seed", type=int, default=2018)
    p.add_argument("--validate", action="store_true",
                   help="check all drug SMILES parse before splitting")
    args = p.parse_args(argv)

    from gcnbmp_tpu_torch.data import splits as S

    os.makedirs(args.out, exist_ok=True)
    if args.split == "kaist":
        if not args.kaist_csv:
            p.error("--split kaist requires --kaist-csv")
        parts = S.kaist_multilabel_split(
            pd.read_csv(args.kaist_csv),
            frac_train=args.frac_train, frac_valid=args.frac_valid,
            seed=args.seed,
        )
        stats = {}
        for key, part in parts.items():
            part.to_csv(os.path.join(args.out, f"ddi_{key}_multi.csv"),
                        index=False)
            stats[key] = {"total": len(part)}
        print(json.dumps(stats, indent=2))
        return 0

    if not args.drug_list or not args.matrix:
        p.error("--drug-list and --matrix are required (except --split kaist)")
    drug_df = pd.read_csv(args.drug_list)
    matrix_df = pd.read_csv(args.matrix)
    if args.edgelist:
        S.export_known_ddis_edgelist(matrix_df, args.edgelist)
    if "Unnamed: 0" in matrix_df.columns:
        # pandas index column is numeric — select_dtypes would keep it
        # and silently shift every pair label one column
        matrix_df = matrix_df.drop(columns=["Unnamed: 0"])
    mat = matrix_df.select_dtypes(include=[np.number]).to_numpy()
    ids = list(drug_df["cid"])
    if args.validate:
        bad = S.validate_drug_list(drug_df)
        if bad:
            print(f"ERROR: unparseable SMILES at rows {bad}", file=sys.stderr)
            return 1
    pairs, labels = S.generate_pairs_from_matrix(mat, ids)
    frac_test = 1.0 - args.frac_train - args.frac_valid

    stats = {}
    if args.split == "isc":
        sizes = tuple(int(x) for x in args.sizes.split(","))
        series = S.interaction_scale_series(pairs, labels, sizes, seed=args.seed)
        for size, (p_, l_) in series.items():
            path = os.path.join(args.out, f"isc{size}.csv")
            S.write_pair_csv(path, p_, l_, drug_df)
            stats[f"isc{size}"] = S.split_statistics(l_)
    else:
        if args.split == "inter":
            result = S.stratified_interaction_split(
                pairs, labels, args.frac_train, args.frac_valid, frac_test,
                seed=args.seed,
            )
        elif args.split == "drug":
            result = S.random_split_by_drug(
                pairs, labels, ids, args.frac_train, args.frac_valid, frac_test,
                seed=args.seed,
            )
        else:  # scaffold
            smiles_by_id = dict(zip(drug_df["cid"], drug_df["smiles"]))
            result = S.scaffold_split_by_drug(
                pairs, labels, ids, smiles_by_id,
                args.frac_train, args.frac_valid, frac_test,
            )
        for key, (p_, l_) in result.items():
            path = os.path.join(args.out, f"ddi_{args.split}_{key}.csv")
            S.write_pair_csv(path, p_, l_, drug_df)
            stats[key] = S.split_statistics(l_)
    print(json.dumps(stats, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
