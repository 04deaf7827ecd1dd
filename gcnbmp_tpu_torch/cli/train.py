#!/usr/bin/env python
"""Train a packed pair predictor with the port: GGNN + HolE on the fused
path, or MPNN (EdgeNet + Set2Set) + HolE on the coo path.

Port of the JAX package's train CLI (gcnbmp_tpu/cli/train.py:23-211):
the same flags and override logic, plus ``--device`` (``cuda``, the
default, runs the CUDA kernels; ``cpu`` runs their plain versions).

    python -m gcnbmp_tpu_torch.cli.train --train train.csv --val val.csv \\
        --preset ggnn_hole_binary --compute-path fused --device cuda
    python -m gcnbmp_tpu_torch.cli.train --train train.csv --val val.csv \\
        --method mpnn --sim-method hole --conv-layers 4 --weight-tying true \\
        --fp-hidden-dim 32 --fp-out-dim 32 --batch-size 2048 --lr 2e-3 \\
        --compute-path coo --compute-dtype bfloat16 --augment --device cuda

The second line is the MPNN quality row's recipe; its kernels compute in
f32 whatever ``--compute-dtype`` says.  Writes ``config.json`` (the JAX
run's format), ``log.json`` and the ``snapshot_epoch_*``, ``best`` and
``final`` checkpoints under ``--out``; ``final/params.npz`` serves
through ``gcnbmp_tpu_torch.cli.predict``.  Prints the last log entry as
JSON.  Options the port does not train yet, and on ``--device cuda``
widths the card's kernels are not built for, raise before any work,
naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train", required=True, help="training pair CSV")
    p.add_argument("--val", default=None, help="validation pair CSV")
    p.add_argument("--preset", default=None, help="named preset config")
    p.add_argument("--method", default=None)
    p.add_argument("--sim-method", dest="sim_method", default=None)
    p.add_argument("--attn", default=None)
    p.add_argument("--conv-layers", dest="conv_layers", type=int, default=None)
    p.add_argument("--fp-hidden-dim", dest="fp_hidden_dim", type=int, default=None)
    p.add_argument("--fp-out-dim", dest="fp_out_dim", type=int, default=None)
    p.add_argument("--net-hidden-dims", dest="net_hidden_dims", default=None,
                   help="comma-separated, e.g. 32,16")
    p.add_argument("--weight-tying", dest="weight_tying", default=None,
                   choices=["true", "false"])
    p.add_argument("--augment", action="store_true", default=None)
    p.add_argument("--balance", action="store_true", default=None)
    p.add_argument("--symmetric", default=None, choices=["or", "and"])
    p.add_argument("--batch-size", dest="batch_size", type=int, default=None)
    p.add_argument("--lr", dest="learning_rate", type=float, default=None)
    p.add_argument("--exp-shift-strategy", dest="lr_shift_strategy",
                   type=int, default=None, choices=[1, 2, 3],
                   help="manual LR-decay epoch schedule")
    p.add_argument("--exp-shift-rate", dest="lr_decay_rate", type=float,
                   default=None, help="LR multiplier at each shift epoch")
    p.add_argument("--clr", default=None,
                   choices=["triangular", "triangular2", "exp_range"],
                   help="cyclical LR instead of exponential shifts")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--patience", dest="early_stop_patience", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--compute-path", dest="compute_path", default=None,
                   choices=["padded", "packed", "coo", "fused"])
    p.add_argument("--compute-dtype", dest="compute_dtype", default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--scan-steps", dest="scan_steps", type=int, default=None)
    p.add_argument("--loss", default=None, choices=["sigmoid_ce", "hinge", "focal"])
    p.add_argument("--focal-gamma", dest="focal_gamma", type=float, default=None)
    p.add_argument("--focal-alpha", dest="focal_alpha", type=float, default=None)
    p.add_argument("--reuse-packs", dest="reuse_packs", action="store_true",
                   default=None,
                   help="reuse epoch-1 packed batches with batch-level "
                        "reshuffle (removes per-epoch host pack cost)")
    p.add_argument("--pack-workers", dest="pack_workers", type=int, default=None)
    p.add_argument("--no-eval-train", dest="eval_train", action="store_false",
                   default=None)
    p.add_argument("--concat-hidden", dest="concat_hidden", action="store_true",
                   default=None)
    p.add_argument("--layer-aggregator", dest="layer_aggregator", default=None)
    p.add_argument("--dropout", dest="fp_dropout_rate", type=float, default=None)
    p.add_argument("--out", dest="out_dir", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--labels-csv", dest="labels_csv", default=None,
                   help="class list CSV -> multi-label training")
    p.add_argument("--label-cols", dest="label_cols", default="label")
    p.add_argument("--smiles-cols", dest="smiles_cols", default="smiles_1,smiles_2")
    p.add_argument("--platform", default=None,
                   help="JAX platform override; the port takes --device")
    p.add_argument("--multi-device", dest="multi_device", action="store_true",
                   default=None)
    p.add_argument("--debug-checks", dest="debug_checks", action="store_true",
                   default=None)
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly detection: fail at the op whose "
                        "backward produced a NaN (debug only, slow)")
    p.add_argument("--fixed-embeddings", dest="fixed_embeddings", default=None,
                   help="head-only training over frozen per-drug vectors")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain versions, for tests)")
    return p.parse_args(argv)


def build_config(args):
    """The run's ``TrainConfig``: the preset (or defaults) with every flag
    that was given laid over it."""
    from gcnbmp_tpu_torch.train.config import PRESETS, TrainConfig

    cfg = PRESETS[args.preset] if args.preset else TrainConfig()
    overrides = {}
    for f in dataclasses.fields(TrainConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            overrides[f.name] = v
    if args.weight_tying is not None:
        overrides["weight_tying"] = args.weight_tying == "true"
    if args.net_hidden_dims is not None:
        overrides["net_hidden_dims"] = tuple(
            int(x) for x in args.net_hidden_dims.split(",") if x)
    return dataclasses.replace(cfg, **overrides)


def main(argv=None):
    args = parse_args(argv)
    if args.fixed_embeddings:
        raise ValueError("--fixed-embeddings (head-only training over frozen "
                         "embeddings) is not ported yet: ROADMAP queue 1, "
                         "item 10")
    if args.platform:
        raise ValueError("--platform selects a JAX platform; the port runs "
                         "on --device cuda|cpu (ROADMAP queue 1, item 6)")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    import torch

    from gcnbmp_tpu_torch.data import CSVPairParser, get_class_labels
    from gcnbmp_tpu_torch.train.loop import (
        Trainer, config_problems, kernel_problems)

    classes = get_class_labels(args.labels_csv) if args.labels_csv else None
    cfg = build_config(args)
    if classes is not None:
        cfg = dataclasses.replace(cfg, class_num=len(classes))
    problems = config_problems(cfg) + kernel_problems(cfg, args.device)
    if problems:
        raise ValueError("configuration outside the ported training path: "
                         + "; ".join(problems))
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available")
    torch.autograd.set_detect_anomaly(args.debug_nans)

    parser = CSVPairParser(
        labels=tuple(args.label_cols.split(",")),
        smiles_cols=tuple(args.smiles_cols.split(",")),
        multi_label_classes=classes)
    train_res = parser.parse(args.train)
    logging.info("train: %d pairs (%d rows failed)",
                 len(train_res.dataset), train_res.fail_count)
    val_ds = None
    if args.val:
        val_res = parser.parse(args.val)
        logging.info("val: %d pairs (%d rows failed)",
                     len(val_res.dataset), val_res.fail_count)
        val_ds = val_res.dataset

    trainer = Trainer(cfg, train_res.dataset, val_ds, device=device)
    os.makedirs(cfg.out_dir, exist_ok=True)
    with open(os.path.join(cfg.out_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    result = trainer.fit()
    final = result["log"][-1] if result["log"] else {}
    print(json.dumps(final))
    return 0


if __name__ == "__main__":
    sys.exit(main())
