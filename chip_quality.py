#!/usr/bin/env python3
"""Train and score quality rows with the PyTorch/CUDA port on one NVIDIA
GPU, building the splits that are not committed first.

    python3 chip_quality.py [--rows drug,scaffold,isc,...] [--seeds 0]
                            [--summary-dir results/quality_summary]

Each row runs the port's train CLI, then its evaluate CLI on the row's
test split with ``--checkpoint best``, as two processes.  Every row keeps
batch 2048, Adam lr 2e-3 with the x0.5-per-10-epochs schedule, early
stopping on val loss with patience 10, ``--no-eval-train`` and
``--compute-path coo`` but ``isc_padded`` and ``fused64``
(examples/ref_scale_battery.sh:29-38, scripts/quality_battery_r3.sh:13-30);
the GGNN rows the flagship model (8 untied layers, H = D = 32, HolE, swap
augmentation, up to 80 epochs), ``fused64`` at H = D = 64.
The JAX package's test AUROC / AUPRC (docs/QUALITY.md) beside each:

- ``drug``: dataset/synth546/drug (``ref_scale_drugsplit``; 0.9621 /
  0.9420 after 80 epochs);
- ``scaffold``: dataset/synth546/scaffold (``ref_scale_scafsplit``;
  0.7586 / 0.5121);
- ``isc``: the flagship on isc35000, validated and tested on the
  stratified ``inter`` split (``ref_scale``; 0.9641 / 0.9483, four seeds
  0.9622 +- 0.0012);
- ``isc_padded``: the same flagship on the padded layout
  (``--compute-path padded``, the train CLI's default; scored by the
  evaluate CLI through the padded ``PairEvaluator``; JAX 0.9641 as
  ``isc``);
- ``relgcn``, ``gin``: ``--method relgcn`` / ``gin`` on isc35000
  (0.9600 / 0.9417 and 0.8390 / 0.7289);
- ``nfp``: ``--method nfp --conv-layers 4 --epochs 40`` (0.7923 /
  0.6581);
- ``jkgru_multi``: GGNN with ``--layer-aggregator gru`` on the 5-type
  multi-label ``kaist`` split with ``--labels-csv``, no augmentation
  (``ref_scale_jkgru_multi_full``; per-class mean AUROC 0.9915);
- ``para``: co-attention ``--attn para --sim-method ntn`` on isc35000
  (``ref_scale_para``; 0.9640);
- ``mpnn``: ``--method mpnn --conv-layers 4 --weight-tying true
  --compute-dtype bfloat16`` on isc35000 through K5/K4
  (``ref_scale_mpnn_fusedkernel_r5``; 0.9644);
- ``production``: ``--preset ggnn_hole_production`` (bf16 computed in
  f32, scan 10, reused packs) on isc35000 (0.9645);
- ``gwm``: GGNN-GWM, ``--method ggnn-gwm --conv-layers 4 --compute-path
  coo --scan-steps 10 --epochs 30`` on isc35000 (``ref_scale_gwm_cooscan``,
  scripts/quality_battery_r3.sh:48-50; 0.9641 / 0.9494);
- ``gwm_packed``: the same with ``--compute-path packed`` and no scan
  mode (``ref_scale_gwm_full``, 0.9635 / 0.9489; the JAX run shipped the
  dense adjacency from the host and validated on ``inter_valid_4k.csv``,
  examples/ref_scale_battery.sh:63-80; the port trains ``packed`` on the
  wire-compact COO predictor and validates on the full valid split, as
  ``gwm`` does);
- ``fused64``: the ``ref_scale_fused64`` row, H = D = 64 on
  ``--compute-path fused --scan-steps 10`` (scripts/quality_battery_r3.sh:
  33-44; 0.9596 / 0.9393, docs/QUALITY.md:77), through the H=64 bodies
  of K2/K2b.

The ``inter``, ``kaist`` and isc35000 splits are gitignored: when one is
missing, ``build_synth546`` makes the whole synth546 tree with the port's
generator (``gcnbmp_tpu_torch.data.synth``, ``cli.data_generator``) and
the pandas subsample of scripts/regen_data.sh:7-17 in a temporary
directory, and copies the missing files into dataset/synth546.  Runs go
under ``results/quality/`` (each run's directory is emptied first); each
row's ``config.json``, ``log.json`` and ``eval_result.json``, the exact
commands and the wall times go to ``<--summary-dir>/<row>_seed<k>/`` and
one JSON line per run is printed, then the card's name and power limit.
Exits non-zero when CUDA is unavailable, the port's package is not beside
this script, or a command fails.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SYNTH = os.path.join("dataset", "synth546")
LABELS = os.path.join(SYNTH, "labels.csv")
_INTER = os.path.join(SYNTH, "inter")
_KAIST = os.path.join(SYNTH, "kaist")
ISC = (os.path.join(_INTER, "isc35000_train.csv"),
       os.path.join(_INTER, "ddi_inter_valid.csv"),
       os.path.join(_INTER, "ddi_inter_test.csv"))
# row -> (train, val, test) CSVs
SPLITS = {
    "drug": tuple(os.path.join(SYNTH, "drug", f"ddi_drug_{p}.csv")
                  for p in ("train", "valid", "test")),
    "scaffold": tuple(os.path.join(SYNTH, "scaffold", f"ddi_scaffold_{p}.csv")
                      for p in ("train", "valid", "test")),
    "kaist": tuple(os.path.join(_KAIST, f"ddi_{p}_multi.csv")
                   for p in ("train", "valid", "test")),
    "isc": ISC,
}
COMMON = ["--compute-path", "coo", "--batch-size", "2048", "--lr", "2e-3",
          "--patience", "10", "--no-eval-train"]
GGNN = ["--method", "ggnn", "--conv-layers", "8", "--fp-hidden-dim", "32",
        "--fp-out-dim", "32", "--weight-tying", "false"]
FLAGS = GGNN + COMMON + ["--epochs", "80", "--augment"]


def with_layout(flags, layout):
    """A copy of ``flags`` whose ``--compute-path`` is ``layout``."""
    i = flags.index("--compute-path")
    return flags[:i + 1] + [layout] + flags[i + 2:]


WIDTHS = ["--fp-hidden-dim", "32", "--fp-out-dim", "32"]
GWM = ["--method", "ggnn-gwm", "--sim-method", "hole", "--conv-layers", "4",
       *WIDTHS, "--batch-size", "2048", "--lr", "2e-3", "--epochs", "30",
       "--patience", "10", "--augment", "--no-eval-train"]
# ref_scale_fused64 (scripts/quality_battery_r3.sh:33-44): H = D = 64 on the
# fused path in scan mode, through the H=64 kernel bodies
FUSED64 = ["--method", "ggnn", "--conv-layers", "8", "--fp-hidden-dim", "64",
           "--fp-out-dim", "64", "--weight-tying", "false", "--compute-path",
           "fused", "--scan-steps", "10", "--batch-size", "2048", "--lr", "2e-3",
           "--epochs", "80", "--patience", "10", "--augment", "--no-eval-train"]
# row -> (split, train CLI flags, evaluate CLI flags)
ROWS = {
    "drug": ("drug", FLAGS, []),
    "scaffold": ("scaffold", FLAGS, []),
    "isc": ("isc", FLAGS, []),
    "isc_padded": ("isc", with_layout(FLAGS, "padded"), []),
    "relgcn": ("isc", FLAGS + ["--method", "relgcn"], []),
    "gin": ("isc", FLAGS + ["--method", "gin"], []),
    "nfp": ("isc", ["--method", "nfp", "--conv-layers", "4", *WIDTHS,
                    *COMMON, "--epochs", "40", "--augment"], []),
    "jkgru_multi": ("kaist", GGNN + COMMON + [
        "--epochs", "80", "--layer-aggregator", "gru", "--labels-csv",
        LABELS], ["--labels-csv", LABELS]),
    "para": ("isc", FLAGS + ["--sim-method", "ntn", "--attn", "para"], []),
    "mpnn": ("isc", ["--method", "mpnn", "--conv-layers", "4",
                     "--weight-tying", "true", *WIDTHS, *COMMON,
                     "--compute-dtype", "bfloat16", "--epochs", "80",
                     "--augment"], []),
    "production": ("isc", ["--preset", "ggnn_hole_production", *FLAGS], []),
    "gwm": ("isc", GWM + ["--compute-path", "coo", "--scan-steps", "10"], []),
    "gwm_packed": ("isc", GWM + ["--compute-path", "packed"], []),
    "fused64": ("isc", FUSED64, []),
}
# the files build_synth546 makes beside the committed drug_list.csv and
# rule_stats.json (and the drug and scaffold splits, which it can remake)
GENERATED = ["drug_drug_matrix.csv", "pairs_multilabel.csv",
             *(os.path.join("inter", f"ddi_inter_{p}.csv")
               for p in ("train", "valid", "test")),
             os.path.join("inter", "isc35000_train.csv"),
             os.path.join("inter", "inter_valid_4k.csv"),
             os.path.join("inter", "inter_test_4k.csv"),
             *(os.path.join("kaist", f"ddi_{p}_multi.csv")
               for p in ("train", "valid", "test"))]


# sha256 (first 16 hex digits) of files the JAX generator writes from
# this tree (drug list, matrix and splits as scripts/regen_data.sh makes
# them); build_synth546 must give the same bytes
SHA256 = {
    "drug_drug_matrix.csv": "25c0cb2836c3237d",
    "pairs_multilabel.csv": "911c8a051ad1e7c7",
    "inter/ddi_inter_train.csv": "03b0184d22fbaddd",
    "inter/ddi_inter_valid.csv": "34978432842f38ac",
    "inter/ddi_inter_test.csv": "072ad8703a2d5007",
    "inter/isc35000_train.csv": "5a9fa29813fe672b",
    "kaist/ddi_train_multi.csv": "4f2fefc90164605e",
    "kaist/ddi_valid_multi.csv": "b88f32dc2c405b0f",
    "kaist/ddi_test_multi.csv": "1ccb59bcbc04b222",
}


def isc35000_subsample(inter_dir: str) -> None:
    """The balanced isc35000 training subset and the 4k valid and test
    subsets, the pandas steps of scripts/regen_data.sh:7-17: 17,500
    positives and 17,500 negatives of ``ddi_inter_train.csv`` each drawn
    with random_state=1, shuffled with random_state=2; 4,000 rows of each
    of ``ddi_inter_{valid,test}.csv`` with random_state=3."""
    import pandas as pd

    df = pd.read_csv(os.path.join(inter_dir, "ddi_inter_train.csv"))
    pos, neg = df[df.label == 1], df[df.label == 0]
    sub = pd.concat([pos.sample(17500, random_state=1),
                     neg.sample(17500, random_state=1)])
    sub.sample(frac=1.0, random_state=2).to_csv(
        os.path.join(inter_dir, "isc35000_train.csv"), index=False)
    for split in ("valid", "test"):
        d = pd.read_csv(os.path.join(inter_dir, f"ddi_inter_{split}.csv"))
        d.sample(4000, random_state=3).to_csv(
            os.path.join(inter_dir, f"inter_{split}_4k.csv"), index=False)


def build_synth546(out: str) -> None:
    """The synth546 tree under ``out`` with the port's generator, as
    scripts/regen_data.sh:4-21 builds it: the drug list, the matrix and
    the multi-label pairs, the ``inter`` split with the isc35000
    subsample, and the ``kaist`` split.  The generators' printed
    statistics are swallowed."""
    from gcnbmp_tpu_torch.cli import data_generator
    from gcnbmp_tpu_torch.data import synth

    splits = (["--drug-list", os.path.join(out, "drug_list.csv"),
               "--matrix", os.path.join(out, "drug_drug_matrix.csv"),
               "--split", "inter", "--out", os.path.join(out, "inter"),
               "--validate"],
              ["--split", "kaist", "--kaist-csv",
               os.path.join(out, "pairs_multilabel.csv"), "--out",
               os.path.join(out, "kaist")])
    with contextlib.redirect_stdout(io.StringIO()):
        synth.main(["--out", out, "--multi-label"])
        for argv in splits:
            if data_generator.main(argv) != 0:
                raise RuntimeError(f"data_generator {' '.join(argv)} failed")
    isc35000_subsample(os.path.join(out, "inter"))


def ensure_splits() -> float:
    """Build the gitignored synth546 files into dataset/synth546 when any
    is missing; returns the seconds it took (0 when none was)."""
    missing = [f for f in GENERATED
               if not os.path.exists(os.path.join(ROOT, SYNTH, f))]
    if not missing:
        return 0.0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        build_synth546(tmp)
        for name in ("drug_list.csv", "rule_stats.json"):
            with open(os.path.join(tmp, name), "rb") as a, \
                    open(os.path.join(ROOT, SYNTH, name), "rb") as b:
                if a.read() != b.read():
                    raise RuntimeError(f"the generator's {name} differs from "
                                       "the committed one")
        for f in missing:
            os.makedirs(os.path.dirname(os.path.join(ROOT, SYNTH, f)),
                        exist_ok=True)
            shutil.copy(os.path.join(tmp, f), os.path.join(ROOT, SYNTH, f))
    return time.perf_counter() - t0


def run(cmd, log_path):
    """Run ``cmd`` from the repo root with its output into ``log_path``;
    returns its wall seconds, raising on a non-zero exit."""
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        rc = subprocess.call(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-3000:]
        raise RuntimeError(f"{' '.join(cmd)} exited {rc}:\n{tail}")
    return wall


def quality_row(row, seed, summary_dir):
    split, flags, eval_flags = ROWS[row]
    train_csv, val_csv, test_csv = SPLITS[split]
    out = os.path.join("results", "quality", f"{row}_seed{seed}")
    keep = os.path.join(ROOT, summary_dir, f"{row}_seed{seed}")
    shutil.rmtree(os.path.join(ROOT, out), ignore_errors=True)
    os.makedirs(keep, exist_ok=True)
    train = [sys.executable, "-m", "gcnbmp_tpu_torch.cli.train",
             "--train", train_csv, "--val", val_csv, *flags,
             "--seed", str(seed), "--device", "cuda", "--out", out]
    train_s = run(train, os.path.join(keep, "train.log"))
    with open(os.path.join(ROOT, out, "log.json")) as f:
        log = json.load(f)
    evaluate = [sys.executable, "-m", "gcnbmp_tpu_torch.cli.evaluate",
                "--test", test_csv, "--run", out, "--checkpoint", "best",
                *eval_flags, "--device", "cuda"]
    eval_s = run(evaluate, os.path.join(keep, "evaluate.log"))
    with open(os.path.join(ROOT, out, "eval", "eval_result.json")) as f:
        metrics = json.load(f)
    shutil.copy(os.path.join(ROOT, out, "config.json"), keep)
    shutil.copy(os.path.join(ROOT, out, "eval", "eval_result.json"), keep)
    shutil.copy(os.path.join(ROOT, out, "log.json"), keep)
    # best is written at each epoch whose val loss improves on the best
    best = min(log, key=lambda e: e["val/loss"])["epoch"]
    result = {
        "row": row, "seed": seed, "test": metrics, "epochs": log[-1]["epoch"],
        "best_epoch": best, "train_s": train_s, "evaluate_s": eval_s,
        "val_roc_auc": [round(e["val/roc_auc"], 5) for e in log],
        "commands": ["python " + " ".join(c[1:]) for c in (train, evaluate)],
    }
    with open(os.path.join(keep, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rows", default="drug,scaffold",
                   help=f"comma-separated, of {', '.join(ROWS)}")
    p.add_argument("--seeds", default="0")
    p.add_argument("--summary-dir", default=os.path.join("results",
                                                         "quality_summary"))
    args = p.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "gcnbmp_tpu_torch")):
        print("chip_quality.py: the gcnbmp_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    rows = args.rows.split(",")
    unknown = [r for r in rows if r not in ROWS]
    if unknown:
        p.error(f"unknown rows {unknown}; rows: {', '.join(ROWS)}")
    import torch

    if not torch.cuda.is_available():
        print("chip_quality.py: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}",
          flush=True)
    print(json.dumps({"splits_built_s": ensure_splits()}), flush=True)
    for row in rows:
        for seed in args.seeds.split(","):
            quality_row(row, int(seed), args.summary_dir)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
