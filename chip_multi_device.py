"""Graph-sharded training over every card of one machine, through the
train CLI as a user runs it (one rank per visible card, NCCL), against
the single-device run of the same flags.

    python3 chip_multi_device.py        # needs two or more cards

For the flagship (K2/K2b), co-attention packed pair-local (K1/K1b) and
the MPNN row (K5/K5b, K4/K4b), at batch 2048 on synth546 drug's first
10,240 train pairs (10 steps per epoch with augmentation), 2 epochs:
the train CLI on card 0 alone, then with ``--multi-device`` (the CLI
starts one process per card).  Each epoch's mean step loss and val loss
must agree within 1e-5, except MPNN's, whose sharded loss sums the
Set2Set rows of molecules a card does not hold, as the JAX package's
does (ROADMAP queue 3): its gap is printed.  Prints each run's epoch
training throughput (``edges_per_s`` of log.json: packing, partition and
steps, on rank 0's clock) and ends with ``entry.dryrun_multichip`` over
every card.  The last line is a JSON object with ``ok`` and the device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DRUG = os.path.join(ROOT, "dataset", "synth546", "drug")
N_TRAIN, N_VAL, BATCH, SEED = 10240, 512, 2048, 2018
RUNS = [
    ("flagship", ["--preset", "ggnn_hole_binary", "--compute-path", "coo"]),
    ("co-attention (para, ntn, pair-local)",
     ["--method", "ggnn", "--conv-layers", "8", "--fp-hidden-dim", "32",
      "--fp-out-dim", "32", "--weight-tying", "false", "--compute-path",
      "coo", "--lr", "2e-3", "--augment", "--sim-method", "ntn", "--attn",
      "para"]),
    ("mpnn", ["--method", "mpnn", "--sim-method", "hole", "--conv-layers",
              "4", "--weight-tying", "true", "--fp-hidden-dim", "32",
              "--fp-out-dim", "32", "--lr", "2e-3", "--compute-path", "coo",
              "--augment"]),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_multi_device.py: needs two or more CUDA devices",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import pandas as pd

    from gcnbmp_tpu_torch import entry
    from gcnbmp_tpu_torch.cli import train as train_cli
    from gcnbmp_tpu_torch.ops import build

    n = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{n} devices: {torch.cuda.get_device_name(0)}; nvidia-smi:\n{smi}"
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    failed = []
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        train = os.path.join(tmp, "train.csv")
        val = os.path.join(tmp, "val.csv")
        pd.read_csv(os.path.join(DRUG, "ddi_drug_train.csv")).head(
            N_TRAIN).to_csv(train, index=False)
        pd.read_csv(os.path.join(DRUG, "ddi_drug_valid.csv")).head(
            N_VAL).to_csv(val, index=False)
        for tag, flags in RUNS:
            logs = {}
            for mode, extra in (("single", []), ("multi", ["--multi-device"])):
                out = os.path.join(tmp, f"{tag}-{mode}")
                t0 = time.perf_counter()
                rc = train_cli.main([
                    "--train", train, "--val", val, *flags, "--batch-size",
                    str(BATCH), "--epochs", "2", "--seed", str(SEED),
                    "--no-eval-train", "--out", out, *extra])
                wall = time.perf_counter() - t0
                if rc != 0:
                    raise AssertionError(f"{tag} {mode}: train.main {rc}")
                with open(os.path.join(out, "log.json")) as f:
                    logs[mode] = json.load(f)
                print(f"{tag} {mode}: {wall:.1f} s of train.main; epochs' "
                      "edges/s " + ", ".join(
                          f"{e['edges_per_s']:.0f}" for e in logs[mode])
                      + "; mean step loss " + ", ".join(
                          f"{e['main/loss']:.7f}" for e in logs[mode])
                      + "; val loss " + ", ".join(
                          f"{e['val/loss']:.7f}" for e in logs[mode]))
            gap = max(abs(a[k] - b[k]) for a, b in zip(*logs.values())
                      for k in ("main/loss", "val/loss"))
            speed = logs["multi"][-1]["edges_per_s"] / \
                logs["single"][-1]["edges_per_s"]
            print(f"{tag}: {n} cards vs one: epoch losses max |diff| "
                  f"{gap:.3e}; epoch 2 throughput x{speed:.3f}")
            if tag != "mpnn" and gap > 1e-5:
                failed.append(f"{tag}: epoch losses differ by {gap}")
        t0 = time.perf_counter()
        entry.dryrun_multichip(n)
        print(f"dryrun_multichip({n}): {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError("; ".join(failed))
    print(smi.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": n}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
