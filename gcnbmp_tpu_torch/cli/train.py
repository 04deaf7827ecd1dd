#!/usr/bin/env python
"""Train a pair predictor with the port: on the padded layout (the
default ``--compute-path padded``) every encoder (GGNN with or without a
layer aggregator, RelGCN, GIN, NFP, MPNN, the four GGNN-dev methods,
GGNN-GWM) with co-attention and the options only that layout has
(``--symmetric``, ``--dropout``, ``--concat-hidden``); GGNN on the fused,
coo or packed path, GGNN with a layer aggregator, MPNN (EdgeNet +
Set2Set), RelGCN, GIN, NFP and GGNN-GWM on coo or packed, and on coo
co-attention over any of them but GWM, each with any of the six heads.

Port of the JAX package's train CLI (gcnbmp_tpu/cli/train.py:23-211):
the same flags and override logic, plus ``--device`` (``cuda``, the
default, runs the CUDA kernels; ``cpu`` runs their plain versions).

    python -m gcnbmp_tpu_torch.cli.train --train train.csv --val val.csv \\
        --preset ggnn_hole_binary --device cuda
    python -m gcnbmp_tpu_torch.cli.train --train train.csv --val val.csv \\
        --preset ggnn_hole_binary --compute-path fused --device cuda
    python -m gcnbmp_tpu_torch.cli.train --train train.csv --val val.csv \\
        --method mpnn --sim-method hole --conv-layers 4 --weight-tying true \\
        --fp-hidden-dim 32 --fp-out-dim 32 --batch-size 2048 --lr 2e-3 \\
        --compute-path coo --compute-dtype bfloat16 --augment --device cuda
    python -m gcnbmp_tpu_torch.cli.train --train train.csv --val val.csv \\
        --preset ggnn_coattention --compute-path coo --device cuda
    python -m gcnbmp_tpu_torch.cli.train --train train.csv --val val.csv \\
        --method mpnn --conv-layers 4 --fp-hidden-dim 32 --fp-out-dim 32 \\
        --attn para --sim-method ntn --compute-path coo --device cuda
    python -m gcnbmp_tpu_torch.cli.train --train train.csv --val val.csv \\
        --method relgcn --conv-layers 8 --compute-path coo --device cuda
    python -m gcnbmp_tpu_torch.cli.train --train train_multi.csv \\
        --val val_multi.csv --labels-csv labels.csv --conv-layers 8 \\
        --weight-tying false --layer-aggregator gru --compute-path coo
    python -m gcnbmp_tpu_torch.cli.train --train train.csv --val val.csv \\
        --method ggnn-gwm --conv-layers 4 --fp-hidden-dim 32 \\
        --fp-out-dim 32 --batch-size 2048 --lr 2e-3 --augment \\
        --compute-path coo --scan-steps 10 --device cuda
    python -m gcnbmp_tpu_torch.cli.train --train train.csv --val val.csv \\
        --method ggnn --conv-layers 8 --weight-tying false \\
        --fp-hidden-dim 128 --fp-out-dim 128 --compute-path fused \\
        --scan-steps 10 --batch-size 2048 --lr 2e-3 --augment --device cuda

The first line trains the flagship on the padded layout, as the JAX
CLI does without ``--compute-path``: ``PairPredictor`` over padded
batches, PyTorch ops and no kernel, as the JAX padded path runs XLA ops
and no Pallas kernel; the second on the GGNN kernels.  The third line is
the MPNN quality row's recipe; its kernels compute in
f32 whatever ``--compute-dtype`` says.  The fourth trains the paper's
co-attention model (NTN head, parallel co-attention), the fifth MPNN
with it (K5 and K4, K5b and K4b in the backward, K5's per-atom states
read by both the Set2Set readout and the co-attention); co-attention is
refused on ``--compute-path fused``, as in the JAX package, and so are
the fused path for any method but GGNN and a layer aggregator on it.  The
sixth line trains RelGCN and the seventh GGNN with the JKNet ``gru``
aggregator on multi-label data; they, GIN and NFP run plain PyTorch ops
(no kernel computes them, in either package).  The eighth trains
GGNN-GWM, the supernode table on the wire, in scan mode (plain PyTorch
ops too); GWM scan mode needs ``coo``, as in the JAX package.  The ninth
trains bench.py's h=128 model (H = D = 128, 8 untied layers) on the GGNN
kernels at that width, K2 and K2b (``GCNBMP_FUSED_READOUT=0``: K1 and
K1b; with ``GCNBMP_FUSED_TWOPASS=1`` too: K1m and K3).
``--compute-path packed`` trains the same compact-COO predictor as
``coo`` for every method above (co-attention refused, as in the JAX
package, whose ``packed`` path ships dense batches).  Writes
``config.json`` (the JAX run's format), ``log.json`` and the
``snapshot_epoch_*``, ``best`` and ``final`` checkpoints under
``--out``; ``final/params.npz`` serves
through ``gcnbmp_tpu_torch.cli.predict``, and ``--run <out>`` serves and
evaluates (``gcnbmp_tpu_torch.cli.evaluate``) its ``best`` checkpoint.
``--resume <out>/snapshot_epoch_N`` continues a run from that
checkpoint up to ``--epochs`` (``train.loop.Trainer``).  Prints the last
log entry as JSON.

    python -m gcnbmp_tpu_torch.cli.train --train train.csv --val val.csv \
        --preset ggnn_hole_binary --compute-path coo --multi-device
    torchrun --nproc-per-node 4 -m gcnbmp_tpu_torch.cli.train \
        --train train.csv --val val.csv --preset ggnn_hole_production \
        --multi-device

``--multi-device`` trains graph-sharded over every visible card, one
process per card, which the CLI starts itself, or over torchrun's ranks
(``parallel.edgeshard``; on ``coo`` every option, on ``packed`` binary
sigmoid cross-entropy without scan mode, as in the JAX package); rank 0
writes the run directory and prints.  Every rank still packs the whole
global batch on the host and keeps its share, so on four H100s it trains
no faster than one card (0.35-1.11 times its epoch throughput; ROADMAP
queue 1, item 11).

    python -m gcnbmp_tpu_torch.cli.train --train train.csv --val val.csv \
        --fixed-embeddings drug_list_with_representation.csv \
        --out results/fixed_run --device cuda

``--fixed-embeddings`` (a pickled dict or a ``cid``/``entity`` CSV, the
evaluate CLI's ``drug_list_with_representation.csv``) trains a head
alone over the frozen per-drug vectors instead (``train.fixed``; pairs
join on ``drugbank_id_1/2``), with the JAX CLI's defaults: ``hole``,
``--net-hidden-dims 32,16``, lr 1e-3, 100 epochs, batch 128, seed 2018,
``results/fixed_run``; it writes a fixed run that the predict CLI
scores, and prints the train metrics and ``val/...`` as JSON.  Options the port does not train yet, and on ``--device cuda``
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
                   default=None,
                   help="graph-sharded training over every visible card, "
                        "one process per card (under torchrun, its ranks); "
                        "requires --compute-path coo or packed; every rank "
                        "packs the whole batch, so it is not yet faster "
                        "than one card")
    p.add_argument("--debug-checks", dest="debug_checks", action="store_true",
                   default=None)
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly detection: fail at the op whose "
                        "backward produced a NaN (debug only, slow)")
    p.add_argument("--fixed-embeddings", dest="fixed_embeddings", default=None,
                   help="id->vector table (pkl or CSV): train a scoring "
                        "head over frozen per-drug embeddings instead of a "
                        "graph encoder (pairs join on drugbank_id_1/2)")
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


def _main_fixed(args, device):
    """--fixed-embeddings: head-only training over frozen per-drug vectors
    (the JAX CLI's ``_main_fixed``, gcnbmp_tpu/cli/train.py:100-147),
    writing a run the predict CLI scores (``is_fixed_run``)."""
    from gcnbmp_tpu_torch.train.fixed import (
        load_embedding_table, pair_embeddings, save_fixed_run,
        train_fixed_embedding_head)

    table = load_embedding_table(args.fixed_embeddings)
    e1, e2, y = pair_embeddings(args.train, table)
    logging.info("train: %d joined pairs over %d embeddings", len(y),
                 len(table))
    val = pair_embeddings(args.val, table) if args.val else None
    sim_method = args.sim_method or "hole"
    class_num = 1
    hidden = (tuple(int(x) for x in args.net_hidden_dims.split(",") if x)
              if args.net_hidden_dims else (32, 16))
    result = train_fixed_embedding_head(
        e1, e2, y, val=val, sim_method=sim_method, class_num=class_num,
        net_hidden_dims=hidden,
        learning_rate=(args.learning_rate
                       if args.learning_rate is not None else 1e-3),
        epochs=args.epochs if args.epochs is not None else 100,
        batch_size=args.batch_size if args.batch_size is not None else 128,
        device=device)
    out_dir = args.out_dir or "results/fixed_run"
    save_fixed_run(out_dir, result, sim_method=sim_method,
                   class_num=class_num, net_hidden_dims=hidden, table=table)
    final = dict(result["train_metrics"])
    if "val_metrics" in result:
        final.update({f"val/{k}": v for k, v in result["val_metrics"].items()})
    print(json.dumps(final, default=float))
    return 0


def _rank_main(argv):
    """One rank of a plain ``--multi-device`` run (``parallel.mesh.launch``
    set up its process group)."""
    rc = main(argv)
    if rc:
        raise SystemExit(rc)


def _multi_device_group(argv, device) -> "tuple[bool, bool]":
    """Set up the process group of a ``--multi-device`` run: torchrun's
    ranks when its environment names them, else one rank per visible card
    (on the CPU, one), more than one started as new processes here.
    Returns (this process owns a group it must close, the ranks ran in
    other processes)."""
    import torch
    import torch.distributed as dist

    from gcnbmp_tpu_torch.parallel import mesh

    if dist.is_initialized():
        return False, False
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if "WORLD_SIZE" in os.environ or n == 1:
        mesh.init_distributed(device)
        return True, False
    from gcnbmp_tpu_torch.ops import build

    build.load_library()  # once, before the ranks start
    mesh.launch(_rank_main, n, (argv,), device_type="cuda")
    return False, True


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.platform:
        raise ValueError("--platform selects a JAX platform; the port runs "
                         "on --device cuda|cpu")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    import torch

    if args.fixed_embeddings:
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda requested but CUDA is not "
                               "available")
        return _main_fixed(args, device)

    from gcnbmp_tpu_torch.data import get_class_labels
    from gcnbmp_tpu_torch.train.loop import config_problems, kernel_problems

    classes = get_class_labels(args.labels_csv) if args.labels_csv else None
    cfg = build_config(args)
    if classes is not None:
        cfg = dataclasses.replace(cfg, class_num=len(classes))
    problems = config_problems(cfg) + kernel_problems(cfg, args.device)
    if problems:
        raise ValueError("configuration outside the ported training path: "
                         + "; ".join(problems))
    if cfg.resume and not os.path.exists(
            os.path.join(cfg.resume, "params.npz")):
        raise FileNotFoundError(f"--resume {cfg.resume}: no params.npz "
                                "there to resume from")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available")
    torch.autograd.set_detect_anomaly(args.debug_nans)
    owns_group = False
    if cfg.multi_device:
        import torch.distributed as dist

        from gcnbmp_tpu_torch.parallel.mesh import rank_device

        owns_group, spawned = _multi_device_group(argv, device)
        if spawned:
            return 0
        device = rank_device(device)
        logging.info("multi_device: rank %d of %d on %s", dist.get_rank(),
                     dist.get_world_size(), device)
    try:
        return _train(args, cfg, classes, device)
    finally:
        if owns_group:
            torch.distributed.destroy_process_group()


def _train(args, cfg, classes, device):
    """Parse the CSVs and train; rank 0 writes ``config.json`` and prints
    the last log entry."""
    from gcnbmp_tpu_torch.data import CSVPairParser
    from gcnbmp_tpu_torch.train.loop import Trainer

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
    if trainer.rank == 0:
        os.makedirs(cfg.out_dir, exist_ok=True)
        with open(os.path.join(cfg.out_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
    result = trainer.fit()
    if trainer.rank == 0:
        final = result["log"][-1] if result["log"] else {}
        print(json.dumps(final))
    return 0


if __name__ == "__main__":
    sys.exit(main())
