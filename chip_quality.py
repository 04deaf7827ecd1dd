#!/usr/bin/env python3
"""Train and score the quality rows whose splits are committed, with the
PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_quality.py [--rows drug,scaffold] [--seeds 0]
                            [--summary-dir results/quality_summary]

Each row runs the port's train CLI, then its evaluate CLI on the row's
test split with ``--checkpoint best``, as two processes, with the
flagship flags of docs/QUALITY.md (GGNN, 8 untied layers, H = D = 32,
HolE, batch 2048, Adam lr 2e-3 with the x0.5-per-10-epochs schedule,
swap augmentation, early stopping on val loss with patience 10):

- ``drug``: dataset/synth546/drug (``ref_scale_drugsplit``; the JAX
  package's test AUROC 0.9621, AUPRC 0.9420 after 80 epochs);
- ``scaffold``: dataset/synth546/scaffold (``ref_scale_scafsplit``;
  0.7586 and 0.5121, early stop after 11 epochs).

The default GGNN form on ``--compute-path coo`` trains through K2/K2b and
evaluates through K2.  A row takes about two minutes of training on an
H100, so each run trains from epoch 1 in one process.  Runs go under
``results/quality/`` (each run's directory is emptied first); each row's ``config.json``, ``log.json`` and
``eval_result.json``, the exact commands and the wall times go to
``<--summary-dir>/<row>_seed<k>/`` (default ``results/quality_summary``)
and one JSON line per run is printed, then the card's name and power
limit.  Exits non-zero when
CUDA is unavailable, the port's package is not beside this script, or a
command fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SPLITS = {
    "drug": ("dataset/synth546/drug", "ddi_drug"),
    "scaffold": ("dataset/synth546/scaffold", "ddi_scaffold"),
}
FLAGS = ["--method", "ggnn", "--conv-layers", "8", "--fp-hidden-dim", "32",
         "--fp-out-dim", "32", "--weight-tying", "false", "--compute-path",
         "coo", "--batch-size", "2048", "--lr", "2e-3", "--epochs", "80",
         "--patience", "10", "--augment", "--no-eval-train"]


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
    folder, stem = SPLITS[row]
    data = lambda part: os.path.join(folder, f"{stem}_{part}.csv")
    out = os.path.join("results", "quality", f"{row}_seed{seed}")
    keep = os.path.join(ROOT, summary_dir, f"{row}_seed{seed}")
    shutil.rmtree(os.path.join(ROOT, out), ignore_errors=True)
    os.makedirs(keep, exist_ok=True)
    train = [sys.executable, "-m", "gcnbmp_tpu_torch.cli.train",
             "--train", data("train"), "--val", data("valid"), *FLAGS,
             "--seed", str(seed), "--device", "cuda", "--out", out]
    train_s = run(train, os.path.join(keep, "train.log"))
    with open(os.path.join(ROOT, out, "log.json")) as f:
        log = json.load(f)
    evaluate = [sys.executable, "-m", "gcnbmp_tpu_torch.cli.evaluate",
                "--test", data("test"), "--run", out, "--checkpoint", "best",
                "--device", "cuda"]
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
    p.add_argument("--rows", default="drug,scaffold")
    p.add_argument("--seeds", default="0")
    p.add_argument("--summary-dir", default=os.path.join("results",
                                                         "quality_summary"))
    args = p.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "gcnbmp_tpu_torch")):
        print("chip_quality.py: the gcnbmp_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_quality.py: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}",
          flush=True)
    for row in args.rows.split(","):
        for seed in args.seeds.split(","):
            quality_row(row, int(seed), args.summary_dir)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
