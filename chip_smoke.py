#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: the card's name and power limit; TF32 off.
2. build: compile the CUDA kernels from ``gcnbmp_tpu_torch/ops/csrc``,
   one nvcc per source, all at once; print ptxas's registers and spills,
   and those of each instance of the forward and backward bodies (K1,
   K1m, K2, the GGNN reverse body, each also at H=64 and H=128, K5, K5b,
   K4, K4b's two kernels); an instance of the GGNN or MPNN bodies or of K4
   that spills fails, and so does a build log without the five H=64 and
   the six H=128 GGNN instances (K1, K1m, K2; the reverse body's three:
   F, the forward over the range storing its activations, without and
   with K2b's readout backward, and R, the reverse of every form).
3. kernels vs plain, at the shapes of real packed batches (the first 2048
   pairs of dataset/synth546's drug test split at batch 256 and 2048);
   errors, median CUDA-event times of kernel and plain version per call
   over runs of back-to-back calls, and the kernel's device time per call
   (torch.profiler, once it has kept every launch of the kernel):
   a. GGNN: K1 (``fused_ggnn``), K1m (``fused_ggnn_mid``, K1 that also
      writes h_mid), K2 (``fused_ggnn_readout``) and the backward kernels
      K1b (``fused_ggnn_bwd``), K3 (``fused_ggnn_half_bwd``, each half of
      the two-pass backward on its own) and K2b
      (``fused_ggnn_readout_bwd``) at the flagship L=8, H=32, D=32, one
      H=16 case, one batch-256 case whose adjacency has rows with more
      than the kernels' 16 neighbour slots, and one L=3 case (the odd
      split); then the same four at H=D=64 (the bodies of
      ``csrc/fused_ggnn64.cuh``, the ``ref_scale_fused64`` model, L=8
      untied; both bodies, the forward K1, K1m, K2 and the reverse K1b,
      K3, K2b, take every dense product on the tensor cores in 3xTF32) at
      batch 256 and 2048 (P=75 and 387), crowded and L=3, and the same
      six kernels at H=D=128 (``csrc/fused_ggnn128_fwd.cuh``, the forward,
      a cluster of two CTAs per tile whose resident clusters
      (``cudaOccupancyMaxActiveClusters``) are printed first, each call a
      launch of the weights' blocked copy and one of the body, and
      ``csrc/fused_ggnn128_bwd.cuh``, the reverse, with dh in global
      memory, two launches in every form: F stores each layer's input and
      its m, r, z and n, R reads them; the h=128 model of bench.py, L=8
      untied) in the same four cases, with the bytes of that stored
      scratch (``acts``) per call at P=387; each forward's
      error is printed with its closest approach to the bound; K1m's
      h must equal K1's bit for bit, K3's two halves summed must equal
      K1b within the gradient bound, and two K2 runs, and two K2b runs, on
      the same inputs must give the same bits;
   b. MPNN: K5 (``fused_mpnn``), K5b (``fused_mpnn_bwd``), K4
      (``fused_set2set``) and K4b (``fused_set2set_bwd``) at the quality
      row's model (L=4 tied, H=32; Set2Set tables 24 and 64 atoms wide),
      the bench model (L=8 untied, H=32), one H=16 case, one crowded,
      asymmetric adjacency and one layer for K5/K5b; two runs each of K5,
      K5b, K4 and K4b on the same inputs must give the same bits, and the
      resident CTAs per SM of K5b's, K4's and K4b's launches (the CUDA
      occupancy query), their warps (K4: its groups of four) and their
      waves over the card's SMs are printed.
4. GGNN serving: ``gcnbmp_tpu_torch.cli.predict.main`` serves those 2048
   pairs at batch 256 (eight requests) with seeded random weights; K2
   must launch once per request, every prob must be finite and in
   [0, 1], and the logits must match the plain layer stack on the card.
5. GGNN training: ``gcnbmp_tpu_torch.cli.train.main`` trains the
   ``ggnn_hole_binary`` preset on the fused path for 2 epochs on the
   first 2048 pairs of the train split (4096 with swap augmentation),
   validating on the first 512 of the valid split; K2b must run once per
   step, the loss must be finite and fall, ``log.json`` must hold the
   val metrics and ``final/params.npz`` must serve through the predict
   CLI.  Then one step's gradients from the kernel path must match
   autograd through the plain layer stack, and the train step is timed
   (host clock) and profiled (torch.profiler) at batch 32 and 2048.
6. MPNN serving: phase 4 for an ``mpnn`` config (the quality row's
   model); K5 and K4 must launch once per request.
7. MPNN training: phase 5 with the quality row's flags (``--method mpnn
   --compute-path coo --compute-dtype bfloat16 --augment``, L=4 tied,
   H=D=32, lr 2e-3) at batch 256: 32 steps, K5b and K4b once per step;
   gradients against the plain layer stack; the step timed and profiled
   at batch 256 and 2048.
8. GGNN production recipe, two-pass: the train CLI with ``--preset
   ggnn_hole_production --compute-path fused`` (L=8 untied, H=32, batch
   2048, bf16 computed in f32, scan mode of 10 steps, reused packs) in
   the JAX package's default fused form (``models.packed.FUSED_READOUT``
   off) with ``ops.fused_ggnn.TWOPASS`` on, on the first 10,240 train
   pairs (20,480 with augmentation: one chunk of 10 steps per epoch) for
   2 epochs: K3 twice per step, K1m at least once, K2 and K2b never;
   falling loss, val metrics, params served, gradients vs the plain
   stack.  Then one epoch of the single-pass default form (K1, K1b), and
   the batch-2048 step timed and profiled in all three forms (K2/K2b,
   K1/K1b, K1m/K3).
9. Co-attention serving: phase 4 for the ``ggnn_coattention`` model
   (GGNN L=8 untied, H=D=32, parallel co-attention, NTN head): K1 once
   per request, K2 never; the logits against the plain layer stack
   (``PackedGGNN.forward``, then the same gather, co-attention and head).
10. Co-attention training: the train CLI with the ``ref_scale_para``
   flags (``--sim-method ntn --attn para --compute-path coo``, batch
   2048, lr 2e-3, augmented) on phase 8's pairs for 2 epochs: K1b once
   per step, K1 at least once, K2, K2b, K1m and K3 never; gradients of
   every parameter (encoder, co-attention, NTN) against the plain stack.
   Then one epoch of ``--attn nie --scan-steps 10`` under TWOPASS: K1m
   once and K3 twice per step, K1b never (the epoch-end evaluations take
   K1: no input of theirs needs a gradient).  Then the batch-2048 step
   timed and profiled for ``para`` and ``nie``.

11. Evaluation and the trainer's modes, on phase 5's run directory (2
   epochs with a val set, so ``best`` exists) and the 2048 test pairs:
   the evaluate CLI at batch 256 on ``best`` (K2 once per batch;
   ``eval_result.json`` with the keys of ``compute_metrics``; AUROC and
   AUPRC within 1e-3 of those of the plain layer stack's logits, the
   logits within atol = rtol = 1e-4; 2048 rows in ``_e.csv`` and
   ``_e_y.csv``; ``--similarity cosine`` symmetric with a unit diagonal
   within 1e-6); ``predict --run`` against ``--config/--params`` (the
   same weights bit for bit, probs within 1e-4: the segment sum's
   ``index_add_`` adds in a varying order on the card); ``snapshot_epoch_2`` restored into a fresh
   ``Trainer`` bit for bit (every parameter and Adam moment), then the
   train CLI with ``--resume`` it and ``--epochs 3`` (K2b once per step,
   finite loss, ``log.json`` only epoch 3); ``profile_epoch=0`` at batch
   256 (a Chrome trace under ``<out>/profile/`` naming K2b's kernel,
   ``fused_ggnn_bwd_kernel<32, true>``); ``debug_checks`` for an epoch,
   and a batch with a corrupted ``e_src`` refused before any launch;
   multi-label: one epoch of ``ggnn_multilabel_x86`` with ``--labels-csv``
   (synth546's 5 classes, a seeded rule) and focal loss at batch 256
   (K2b once per step), then the evaluate CLI with ``--labels-csv``:
   ``per_class`` with 5 finite entries.
12. The packed encoders without a kernel, and the generator: RelGCN (the
   ``relgcn_binary`` preset, L=4, H=32, D=64), GIN (``gin_binary``, 8
   untied layers, H=D=32), NFP (4 layers) and GGNN with the ``gru``
   layer aggregator (``ggnn_multilabel_x37``, 8 untied layers, on phase
   11's seeded 5-class labels), each trained 2 epochs on coo through the
   train CLI at batch 256 on the first 2048 train pairs: no kernel
   launches, the loss finite and falling, val metrics in ``log.json``;
   ``final`` served through the predict CLI (2048 finite probs) and
   ``best`` scored through the evaluate CLI; the card's logits on the
   first 512 test pairs against the same weights on the CPU (atol = rtol
   = 1e-4), the predict CLI's probs too; the train step timed and
   profiled at batch 256 and 2048.  Then the port's generator builds
   synth546's ``inter`` (with the isc35000 subsample) and ``kaist``
   splits in a temporary directory, and their sha256 sums must be the
   recorded ones.
13. GWM and the ``packed`` compute path: the GWM quality row's model
   (``--method ggnn-gwm``, L=4 tied, H=D=32, 8 heads, 244 supernode
   features) served through the predict CLI with seeded weights (no
   kernel may launch; the card's logits and probs on the first 512 test
   pairs against the CPU's, atol = rtol = 1e-4, on the padded
   ``PairEvaluator`` and on the compact-COO ``PackedPairEvaluator``, and
   the two layouts' logits against each other); trained 2 epochs
   through the train CLI at batch 256 on coo in scan mode (chunks of 4)
   and with ``--compute-path packed`` (no kernel; loss finite and
   falling; val metrics), each run served by predict ``--run`` and
   ``--config/--params`` (probs within 1e-4) and scored by the evaluate
   CLI; the GWM step timed and profiled at batch 256 and 2048, with the
   staging of one batch (``stage_chunk``) split into its host gather and
   its copy, and the same bytes copied from pinned memory.  Then GGNN
   (``ggnn_hole_binary``, K2/K2b) and MPNN (the quality row,
   K5/K5b/K4/K4b) trained 2 epochs with ``--compute-path packed``
   through the train CLI as phases 5 and 7 check them (each backward
   kernel once per step, gradients against the plain stack).  The port
   trains ``packed`` on the wire-compact COO predictor, the adjacency
   built on the card; the CLIs score GWM on the padded layout, as the
   JAX CLIs do.
14. The padded layout, the train CLI's default (no kernel in either
   package): ``ggnn_hole_binary`` trained through the train CLI at batch
   256 on the first 2048 train pairs with ``--compute-path padded`` (2
   epochs, falling loss) and with no ``--compute-path`` (1 epoch); the
   padded options ``--symmetric or``, ``--dropout 0.1``,
   ``--concat-hidden``, ``--attn para --sim-method ntn`` and GWM (L=4
   tied) two steps each; no kernel may launch, losses and val metrics
   finite.  The flagship's ``best`` scored by the evaluate and predict
   CLIs on the card and on the CPU, both through ``PairEvaluator`` (no
   ``PackedPairEvaluator`` call): probs and logits within atol = rtol =
   1e-4, AUROC and AUPRC within 1e-3.  The padded step timed (host clock
   over 10 staged steps, then profiled) at batch 256 and 2048 beside the
   K2/K2b step, with one padded batch's host build (``make_batch``) and
   copy timed apart; padded and packed evaluators serving the 2048 test
   pairs (pairs/s, logits within 1e-4 of each other); ``entry.entry()``
   on the card against the CPU within 1e-5.
15. The analysis routes (no kernel in either package), each on the card
   against the CPU: (a) the evaluate CLI with ``--saliency gradient``,
   ``integrated`` and ``bayes`` on the first 64 test pairs, on phase 5's
   flagship run (scored packed, K2 once per batch; saliency through the
   padded predictor) and on a RelGCN run (``relgcn_binary``, one epoch
   through the train CLI): each per-atom map within 1e-5 + 1e-4 |cpu|,
   the SVGs' layouts equal and each atom's colour within one step of
   255, ms per pair; (b) the train CLI's ``--fixed-embeddings`` over
   synth546's mol2vec table (dim 100, radius 1) and over the flagship's
   ``drug_list_with_representation.csv`` (the evaluate CLI's export of
   all 546 drugs) on the drug split's 94,830 train pairs with ``--val``,
   2 epochs, then the predict CLI on each run over the 2048 test pairs:
   losses and probs within 1e-5, val AUROC within 1e-4, steps/s; (c)
   ``train_gae`` on the 546-drug adjacency of the drug split's positive
   train pairs, 200 epochs at dropout 0 (embeddings within 1e-4), then at
   0.1 on the card (val/test AUROC and AP, ms per epoch).  No kernel may
   launch but K2 for the flagship's metrics.
16. GGNN's research options, GGNN-dev, the research predictor, MPNN's
   ``ggnn`` forms and MPNN with co-attention: (a) MPNN + ``para`` + NTN
   (the quality row's L=4 tied, H=D=32) trained 3 epochs through the
   train CLI on coo at batch 2048 (K5b and K4b once per step, K5 and K4
   at least once, no GGNN kernel; falling loss; gradients against the
   plain stack; the step timed and profiled at 256 and 2048), scored by
   the evaluate CLI on the card (K5 and K4 once per batch) and the CPU
   (probs within 1e-4, AUROC and AUPRC within 1e-3), one batch's logits
   and every gradient card against CPU; (b) the four ``ggnn-dev*``
   methods (L=8 untied, H=D=32, HolE, padded) trained 3 epochs at batch
   2048, served by the predict and evaluate CLIs, their logits card
   against CPU held as a tensor (within 1e-4 of the largest: the ``gate``
   rule's logits reach 6e4), the step timed and profiled at 2048 (the
   first at 256 too); (c) GGNN with each research option, the research
   predictor, MPNN with each ``ggnn`` form and ``para`` over
   ``concat_hidden``, one padded batch of 2048 card against CPU (logits
   within atol = rtol = 1e-4, every gradient as in phase 5).  No kernel
   may launch in (b) and (c).
17. graph-sharded training (``--multi-device``) through the train CLI:
   the flagship (K2/K2b), GGNN + ``para`` + NTN co-attention, pair-local
   (K1/K1b), and the MPNN row (K5/K5b, K4/K4b), one epoch each of the
   first 2048 train pairs (4096 augmented: 16 steps of 256), first
   single-device, then with ``--multi-device`` over NCCL at one rank
   (the one card): step losses within 1e-5 of the single-device run,
   each backward kernel once per step, step times and profiles.  Then
   all three over two gloo ranks on the one card, in one ``launch``:
   both ranks' step losses and final parameters the same bits, each
   rank's kernels once per step, the losses within 1e-5 of one device
   (MPNN's sharded loss sums Set2Set rows of molecules a rank does not
   hold, as the JAX package's does: its gap is printed).
18. the prefetcher (``data.prefetch``; the trainer's default
   ``prefetch=2``, which phases 5, 7, 8, 10, 11, 13, 14, 16 and 17 run
   through the train CLI, so their launch and same-bits checks cover it):
   the flagship on coo (K2/K2b), co-attention ``para`` + NTN (K1/K1b), the
   MPNN row (K5/K5b, K4/K4b) and the padded flagship (no kernel), one
   epoch each of phase 8's pairs at batch 2048 through the ``Trainer``
   with ``prefetch=0`` and ``prefetch=2`` in turns (after a warm-up
   epoch): three runs each as trained, step losses within 1e-4 (the
   segment sums' ``index_add_`` adds in a varying order), then 0, 2, 0
   under ``torch.use_deterministic_algorithms`` (warnings only), where
   the step losses must be the same bits when the two ``prefetch=0``
   runs are, else within twice the larger spread (printed); each kernel
   once per step in every run; each setting's epoch seconds, edges/s and
   device busy share (a profiled run), and the producer's host ms per
   chunk.  Then the race check: ``PrefetchIterator(depth=2, workers=4)``
   stages 80 chunks of batch 256 through the trainer's transfer and a
   pinned ring of 7 slots while K2/K2b steps run on the compute stream;
   every chunk read back after its step equals its host arrays bit for
   bit, and every step's loss that of the same chunk staged on the step's
   thread (1e-5).
19. the ``ref_scale_fused64`` row's model and flags (scripts/
   quality_battery_r3.sh:33-44: ``--method ggnn --conv-layers 8
   --fp-hidden-dim 64 --fp-out-dim 64 --weight-tying false --compute-path
   fused --scan-steps 10 --batch-size 2048 --lr 2e-3 --augment``) through
   the train CLI on phase 8's pairs (one scan chunk of 10 steps per
   epoch, 2 epochs: phase 5's 2048 pairs make 2 steps, fewer than a
   chunk) in each of the three forms: K2/K2b (K2b once per step), K1 and
   the plain readout (K1b once per step), K1m/K3 (K1m once and K3 twice
   per step), each with the others' kernels never launched, a falling
   loss, val metrics, one batch's gradients against the plain layer
   stack and the batch-2048 step timed and profiled; then the K2/K2b
   run's ``final/params.npz`` served through the predict CLI at batch
   256 (K2 once per request, logits against the plain stack).
20. the h=128 fused model (bench.py:65, 137 with
   ``GCNBMP_BENCH_HIDDEN=128``: GGNN, L=8 untied, H=D=128, a HolE head;
   seeded weights) served through the predict CLI at batch 256 on the
   2048 test pairs, K2 once per request, then under
   ``GCNBMP_FUSED_READOUT=0`` K1 and the plain readout, K1 once per
   request, logits against the plain stack on the card (1e-4); then
   scored through the evaluate CLI (K2 once per batch, AUROC and AUPRC
   within 1e-3 of the plain stack's).
21. the h=128 model trained: phase 19's flags at H=D=128 (``--method
   ggnn --conv-layers 8 --fp-hidden-dim 128 --fp-out-dim 128
   --weight-tying false --compute-path fused --scan-steps 10 --batch-size
   2048 --lr 2e-3 --augment``) through the train CLI on phase 8's pairs
   in each of the three forms, as phase 19: K2b once per step, K1b once
   per step, K1m once and K3 twice per step, the others' kernels never
   launched, a falling loss, one batch's gradients against the plain
   layer stack, the batch-2048 step timed and profiled, and the K2/K2b
   run's ``final/params.npz`` served through the predict CLI.
22. the dense packed layout on phase 5's 2048 train pairs (P=356), each
   check fatal: (a) ``pack_pair_dataset_batch`` and the native dense
   packer (``pack_pairs_native(..., want_dense=True)``) byte-identical,
   each one's ms, the adjacency's bytes, the batch's copy to the card
   from pageable and from pinned memory beside the compact wire's
   staging; (b) the flagship ``ggnn_hole_binary`` (L=8 untied, H=D=32,
   HolE), seeded: the dense ``PackedPairPredictor``'s logits (K2 once,
   nothing else) against ``fused_pair_logits``, the compact predictor on
   the same pairs and the plain layer stack (1e-4), a bf16 adjacency's K2
   bits against the f32 one's, then in each form (K2/K2b, K1/K1b, K1m/K3
   by the flags) the kernels of one forward and backward counted, the
   gradients against the plain stack (1e-4 max|want| + 1e-6) and two
   ``train_step``s (finite losses, the form's kernels once per step, K3
   twice), with every kernel wrapper's plain version made to raise; the
   batch-2048 step, dense against compact, timed (median, host clock) on
   staged batches and with each batch's copy from the host, and
   profiled; (c) MPNN (L=4 tied, H=32) dense at batch 256: K5 and K4 once
   per forward, K5b and K4b once per step, gradients against the plain
   stack; (d) GGNN-GWM dense at batch 256: logits against the compact GWM
   predictor's, one step with a finite loss, no kernel; (e) the dense
   edgeshard loss on one NCCL rank within 1e-5 of the single-device loss,
   and its step (K2 and K2b once).

Prints the kernels' JSON line (``launches`` from each kernel's main
path; the H=64 kernels (``*_h64``) from phase 19's runs, the H=128 ones
(``*_h128``) from phase 21's, with phase 20's serving beside them, and
their times and bounds at P=75 (``ms``) and P=387 (``ms_p387``) from phase
3a; ``launches_packed`` from phase 13's packed runs;
``launches_coattention`` from phases 9–10 (GGNN) and 16 (MPNN);
``launches_multi_device`` from phase 17's NCCL runs; ``launches_dense``
from phase 22's dense steps; with each
kernel's bound: the larger of
its bytes over 3.35 TB/s and its f32 operations over 67 TFLOP/s, counted
from this run's inputs, the sparse products by their nonzeros; for the
H=64 and H=128 kernels the bound on the route they take, the larger of
the bytes over 3.35 TB/s and three times their dense operations over the
495 TFLOP/s of dense TF32 plus their sparse ones over 67 TFLOP/s, with
the f32 one as ``bound_f32_ms``), the
nvidia-smi line, and last the device JSON line.  Exits non-zero when
CUDA is unavailable or the port's package is not beside this script.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DRUG = os.path.join(ROOT, "dataset", "synth546", "drug")
DATA = os.path.join(DRUG, "ddi_drug_test.csv")
TRAIN_CSV = os.path.join(DRUG, "ddi_drug_train.csv")
VALID_CSV = os.path.join(DRUG, "ddi_drug_valid.csv")
N_PAIRS = 2048
N_VAL = 512
SERVE_BATCH = 256
TRAIN_EPOCHS = 2
L, H, D = 8, 32, 32
ATOL = RTOL = 1e-4  # f32 sums in another order across 8 layers
# gradients: |got - want| <= GRAD_RTOL * max|want| + GRAD_ATOL per tensor;
# weight gradients are sums over up to 387 x 128 rows, taken in another
# order than the plain version's matmuls
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
SEED = 2018
REPS = 20          # timed runs of the headline cases (batch 256, the
REPS_OTHER = 5     # flagship and quality-row models), and of the others
BACK_TO_BACK = 10
# the MPNN quality row (docs/QUALITY.md:80-84; scripts/tpu_queue_r5e.sh:11-17)
MPNN_CFG = dict(fp_hidden_dim=32, fp_out_dim=32, conv_layers=4,
                weight_tying=True, method="mpnn")
MPNN_BENCH_CFG = dict(MPNN_CFG, conv_layers=8, weight_tying=False)
MPNN_FLAGS = ["--method", "mpnn", "--sim-method", "hole", "--conv-layers", "4",
              "--weight-tying", "true", "--fp-hidden-dim", "32",
              "--fp-out-dim", "32", "--lr", "2e-3", "--compute-path", "coo",
              "--compute-dtype", "bfloat16", "--augment"]
S2S_STEPS = 3
# phase 8: 10,240 train pairs, 20,480 with augmentation, one scan chunk of
# 10 steps of 2048 per epoch
N_PROD_TRAIN = 10240
TILE = 128
# NVIDIA's H100 SXM data sheet: HBM bytes/s, f32 FLOP/s outside the tensor
# cores (every kernel's arithmetic but the H=64 bodies' dense products),
# and the dense TF32 tensor-core FLOP/s, on which the H=64 bodies (K1, K1m,
# K2, K1b, K3, K2b) take each dense product three times (3xTF32)
PEAK_BYTES_S, PEAK_F32_FLOPS, PEAK_TF32_FLOPS = 3.35e12, 67e12, 495e12


def nbytes(*xs) -> int:
    """Bytes of the tensors in ``xs`` (tensors, dicts, tuples, lists)."""
    total = 0
    for x in xs:
        if isinstance(x, dict):
            total += nbytes(*x.values())
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
        elif hasattr(x, "element_size"):
            total += x.numel() * x.element_size()
    return total


def bound(flops, n_bytes):
    """The least time in ms the card could take for a kernel's work (each
    input read once, each output written once; its operations at the f32
    peak), and which of the two terms binds."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ggnn_terms(p, hidden, nnz, lo, hi, readout=False, backward=False):
    """(dense, sparse) f32 operations of GGNN layers [lo, hi) over p tiles.
    Per layer and tile: the message product 8TH^2, the GRU's input
    products 12TH^2 and state products 6TH^2 (none at layer 0, whose state
    is zero), the aggregation 2H per adjacency nonzero; the readout 6TH^2
    (D = H).  A backward rebuilds the forward once (the kernels save only
    inputs) and takes two products for each dense product (input and
    weight gradients) and one for the aggregation (the adjacency gets
    none)."""
    dense = p * TILE * hidden ** 2 * (26 * (hi - lo) - (6 if lo == 0 else 0)
                                     + (6 if readout else 0))
    sparse = 2 * nnz * hidden * (hi - lo)
    return (3 * dense, 2 * sparse) if backward else (dense, sparse)


def bound_tc(dense, sparse, n_bytes):
    """``bound`` for a kernel whose dense products run on the tensor cores
    in 3xTF32 (three TF32 products for each) and whose sparse ones run in
    f32: the larger of the bytes over 3.35 TB/s and 3 dense / 495 TFLOP/s
    + sparse / 67 TFLOP/s."""
    t_ops = 3 * dense / PEAK_TF32_FLOPS + sparse / PEAK_F32_FLOPS
    t_bytes = n_bytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def mpnn_flops(p, hidden, n_layers, carry_state, nnz, mol_pairs,
               backward=False):
    """As ``ggnn_terms``, summed, for EdgeNet layers: per layer and tile the
    edge-type products 8TC^2, the molecule-sum product 2TC^2 and the
    GRU's 12TC^2, plus its state products 6TC^2 where the state is carried
    and not zero; the out and in aggregations 4C per adjacency nonzero,
    the molecule sums 2C per same-molecule atom pair."""
    state_layers = n_layers - 1 if carry_state else 0
    dense = p * TILE * hidden ** 2 * (22 * n_layers + 6 * state_layers)
    sparse = n_layers * hidden * (4 * nnz + 2 * mol_pairs)
    return 3 * dense + 2 * sparse if backward else dense + sparse


def set2set_flops(steps, m, hidden, n_atoms, backward=False):
    """Set2Set: the LSTM's products 24MC^2 per step after the first (whose
    q* and h are zero) and the attention's 4C per real atom per step;
    the backward three times the forward, as above."""
    f = 24 * m * hidden ** 2 * (steps - 1) + 4 * n_atoms * hidden * steps
    return 3 * f if backward else f


# the H=128 reverse body's instances (``csrc/fused_ggnn128_bwd.cuh``, MODE):
# every form launches an F, then R
BWD128_LAUNCHES = ("F: K1b, K3", "F: K2b, with the readout backward", "R: K1b, K3, K2b")
# the bodies whose registers and spills phase 2 reports: the pattern of an
# instance's mangled name, and its name from the match
BODIES = (
    (r"fused_ggnn_kernelILi(\d+)ELb([01])ELb([01])E",
     lambda m: f"fused_ggnn_kernel<{m[1]}> "
               f"({'K2' if m[2] == '1' else 'K1m' if m[3] == '1' else 'K1'})"),
    (r"fused_mpnn_kernelILi(\d+)E", lambda m: f"fused_mpnn_kernel<{m[1]}> (K5)"),
    (r"fused_ggnn_bwd_kernelILi(\d+)ELb([01])E",
     lambda m: f"fused_ggnn_bwd_kernel<{m[1]}, {'true' if m[2] == '1' else 'false'}>"),
    (r"fused_ggnn_kernel64ILb([01])ELb([01])E",
     lambda m: f"fused_ggnn_kernel64 "
               f"({'K2' if m[1] == '1' else 'K1m' if m[2] == '1' else 'K1'})"),
    (r"fused_ggnn_kernel128ILb([01])ELb([01])E",
     lambda m: f"fused_ggnn_kernel128 "
               f"({'K2' if m[1] == '1' else 'K1m' if m[2] == '1' else 'K1'})"),
    (r"fused_ggnn_bwd_kernel64ILb([01])E",
     lambda m: f"fused_ggnn_bwd_kernel64<{'true' if m[1] == '1' else 'false'}>"),
    (r"fused_ggnn_bwd_kernel128ILi([012])E",
     lambda m: f"fused_ggnn_bwd_kernel128<{m[1]}> ({BWD128_LAUNCHES[int(m[1])]})"),
    (r"fused_mpnn_bwd_kernelILi(\d+)E",
     lambda m: f"fused_mpnn_bwd_kernel<{m[1]}>"),
    (r"set2set_fwd_kernelILi(\d+)ELi(\d+)E",
     lambda m: f"set2set_fwd_kernel<{m[1]}, {m[2]}> (K4)"),
    (r"(set2set_(?:bwd|grad)[a-z_]*kernel)ILi(\d+)E",
     lambda m: f"{m[1]}<{m[2]}>"))


def body_registers(log: str):
    """(instance, registers and spills) of each instance of the forward
    and backward bodies (K1, K1m and K2's ``fused_ggnn_kernel``, the GGNN
    reverse body ``fused_ggnn_bwd_kernel<H, READOUT>``, K5's and K5b's
    ``fused_mpnn_kernel<C>`` and ``fused_mpnn_bwd_kernel<C>``, K4's and
    K4b's kernels) in nvcc's ``-Xptxas -v`` report."""
    out, body = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            found = [(re.search(p, m.group(1)), name) for p, name in BODIES]
            body = next((name(b) for b, name in found if b), None)
        elif body and ("spill" in line or "registers" in line):
            out.append((body, line.split(":", 1)[-1].strip()))
    return out


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, torch) -> float:
    """ms per call of ``fn``, from CUDA events around BACK_TO_BACK calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(BACK_TO_BACK):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / BACK_TO_BACK


def compare(name, got, want, torch) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    # the entry that comes closest to its bound, as a fraction of it
    closest = float((err / (ATOL + RTOL * want.abs())).max())
    ok = bool((err <= ATOL + RTOL * want.abs()).all())
    print(f"{name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(atol={ATOL}, rtol={RTOL}; closest to its bound: {closest:.3f} "
          f"of it) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return max_abs


def compare_grads(name, got, want, torch) -> float:
    """Compare named gradient lists tensor by tensor; returns the max abs
    error over all of them."""
    worst_abs, worst = 0.0, ("", 0.0)
    for (tname, g), (_, w) in zip(got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} {tname}: shape {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)} or non-finite values")
        err = float((g - w).abs().max())
        bound = GRAD_RTOL * float(w.abs().max()) + GRAD_ATOL
        if err > bound:
            raise AssertionError(f"{name} {tname}: max_abs_err {err:.3e} > "
                                 f"{bound:.3e}")
        worst_abs = max(worst_abs, err)
        worst = max(worst, (tname, err / bound), key=lambda t: t[1])
    print(f"{name}: {len(got)} tensors ok, max_abs_err={worst_abs:.3e}, "
          f"closest to its bound: {worst[0]} at {worst[1]:.3f} of "
          f"{GRAD_RTOL}*max|want|+{GRAD_ATOL}")
    return worst_abs


def named_grads(result, gru_keys, names):
    """(name, tensor) pairs of a backward result tuple, a GRU dict
    expanded in its key order."""
    out = []
    for name, x in zip(names, result):
        if isinstance(x, dict):
            out += [(f"d{k}", x[k]) for k in gru_keys]
        else:
            out.append((name, x))
    return out


GGNN_GRAD_NAMES = ["dh0", "dmsg_w", "dmsg_b", "gru", "dwi", "dbi", "dwj", "dbj"]
MPNN_GRAD_NAMES = ["dh0", "dwt", "dm0t", "gru"]
S2S_GRAD_NAMES = ["datoms", "dwx", "dwh", "db"]


def time_pair(name, tag, kern, plain, smi, torch, labels=("kernel", "plain"),
              reps=REPS):
    """Median CUDA-event ms per call of kernel and plain version, run in
    turns."""
    kern(), plain()  # warm up
    k_ms, p_ms = [], []
    for _ in range(reps):  # alternate plain and kernel
        p_ms.append(cuda_ms(plain, torch))
        k_ms.append(cuda_ms(kern, torch))
    k_med, p_med = statistics.median(k_ms), statistics.median(p_ms)
    print(f"  time {name} [{tag}]: {labels[0]} {k_med:.4f} ms, {labels[1]} "
          f"{p_med:.4f} ms per call (median of {reps} runs of "
          f"{BACK_TO_BACK} back-to-back calls, CUDA events) on {smi}")
    return k_med, p_med


# the hand-written kernels each wrapper launches, as their names appear in
# the profiler's keys, with their launches per call (K1b, each K3 half and
# K2b at H=128: the reverse body's two launches, F and R,
# ``csrc/fused_ggnn128_bwd.cuh``)
BWD_SUM = {"fused_ggnn_bwd_kernel": 1, "sum_tiles_kernel": 1}
BWD128 = {"fused_ggnn_bwd_kernel": 2, "sum_tiles_kernel": 1}
# the H=128 forward (``csrc/fused_ggnn128_fwd.cuh``): the weights' blocked
# copy, then the body
FWD128 = {"fused_ggnn_kernel128": 1, "block_weights128": 1}
WRAPPER_KERNELS = {
    "fused_ggnn_h128": FWD128,
    "fused_ggnn_mid_h128": FWD128,
    "fused_ggnn_readout_h128": FWD128,
    "fused_ggnn_bwd_h128": BWD128,
    "fused_ggnn_half_bwd_h128": BWD128,
    "fused_ggnn_readout_bwd_h128": BWD128,
    "fused_ggnn": {"fused_ggnn_kernel": 1},
    "fused_ggnn_mid": {"fused_ggnn_kernel": 1},
    "fused_ggnn_readout": {"fused_ggnn_kernel": 1},
    "fused_ggnn_bwd": BWD_SUM,
    "fused_ggnn_half_bwd": BWD_SUM,
    "fused_ggnn_readout_bwd": BWD_SUM,
    "fused_mpnn": {"fused_mpnn_kernel": 1},
    "fused_mpnn_bwd": {"fused_mpnn_bwd_kernel": 1, "sum_tiles_kernel": 1},
    "fused_set2set": {"set2set_fwd_kernel": 1},
    "fused_set2set_bwd": {"set2set_bwd_kernel": 1, "set2set_grad_kernel": 1,
                          "sum_tiles_kernel": 1}}
PROFILE_TRIES = 10


def lost_launches(kernels, name) -> list[str]:
    """What a profiled round of BACK_TO_BACK calls of the wrapper ``name``
    lacks: each of its hand-written kernels must show BACK_TO_BACK times
    its launches per call, and every other kernel (the wrapper's PyTorch
    fills and copies) a whole multiple of BACK_TO_BACK."""
    counts = collections.Counter(e.name for e in kernels)
    lost = []
    for kernel, per_call in WRAPPER_KERNELS[name].items():
        kept = sum(n for k, n in counts.items() if kernel in k)
        if kept != per_call * BACK_TO_BACK:
            lost.append(f"{kernel} {kept} of {per_call * BACK_TO_BACK}")
    for k, n in counts.items():
        if (n % BACK_TO_BACK
                and not any(kernel in k for kernel in WRAPPER_KERNELS[name])):
            lost.append(f"{k[:60]} {n}, not a multiple of {BACK_TO_BACK}")
    return lost


def device_ms(fn, name, torch) -> float:
    """Device ms per call of ``fn``: the durations of the kernels it
    launches, as torch.profiler records them over BACK_TO_BACK calls after
    as many with the tracer warming up.  The profiler loses kernels of a
    run now and then: the sum counts only once the round has kept every
    launch of the wrapper ``name``'s kernels (``lost_launches``), and after
    PROFILE_TRIES rounds that lost some the phase fails.  Beside the
    CUDA-event time, which a call's host work bounds from below when its
    kernels are short."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        # one round with the tracer on and its records dropped, then the
        # round that counts
        counted = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: counted.extend(p.events())
                     ) as prof:
            for _ in range(2):
                for _ in range(BACK_TO_BACK):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kernels = [e for e in counted
                   if getattr(e, "device_type", None) == DeviceType.CUDA]
        lost = lost_launches(kernels, name)
        if not lost:
            return (sum(e.time_range.elapsed_us() for e in kernels) / 1e3
                    / BACK_TO_BACK)
        print(f"  device {name}: the profiler lost launches ({'; '.join(lost)})"
              f"; profiling again")
    raise AssertionError(f"{name}: the profiler lost launches in each of "
                         f"{PROFILE_TRIES} rounds, the last: {'; '.join(lost)}")


def check_pair(name, tag, kern, plain, grad_names, gru_keys, smi, torch,
               reps=REPS, profile_key=None):
    """Hold a kernel against its plain version, then time both; the
    device time counts the kernels of WRAPPER_KERNELS[profile_key or
    name].  Returns (max abs error, kernel ms, plain ms, kernel device ms,
    the kernel's output)."""
    got = kern()
    if grad_names is not None:
        err = compare_grads(f"{name} [{tag}]",
                            named_grads(got, gru_keys, grad_names),
                            named_grads(plain(), gru_keys, grad_names), torch)
    elif isinstance(got, tuple):  # several outputs, each held on its own
        err = max(compare(f"{name} [{tag}] output {i}", g, w, torch)
                  for i, (g, w) in enumerate(zip(got, plain())))
    else:
        err = compare(f"{name} [{tag}]", got, plain(), torch)
    times = time_pair(name, tag, kern, plain, smi, torch, reps=reps)
    dev_ms = device_ms(kern, profile_key or name, torch)
    print(f"  device {name} [{tag}]: {dev_ms:.4f} ms per call (its kernels' "
          f"device time, torch.profiler over {BACK_TO_BACK} calls)")
    return (err, *times, dev_ms, got)


def tensors(x):
    """The tensors of a kernel's result (a tensor, or tuples and dicts of
    them), in order."""
    if isinstance(x, dict):
        return [t for v in x.values() for t in tensors(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors(v)]
    return [x]


def repeat_bits(label, tag, fn, torch):
    """No atomics: two runs of a kernel on the same inputs must give the
    same bits."""
    first, second = tensors(fn()), tensors(fn())
    if len(first) != len(second) or not all(
            torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"two {label} runs differ [{tag}]")
    print(f"{label} twice on the same inputs: equal bits [{tag}]")


def occupancy(label, tag, entry, *args, group_warps=None):
    """Print what ``entry`` (a kernel's exported occupancy query) reports:
    the CTAs an SM holds at the shared memory of the kernel's launch
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the CTAs launched and
    their warps (and groups of ``group_warps`` warps), and the waves over
    the card's SMs."""
    import torch

    out = (ctypes.c_int * 3)()
    err = entry(*args, ctypes.addressof(out))
    if err != 0:
        raise AssertionError(f"{label} occupancy query failed ({err})")
    per_sm, ctas, warps = out
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups = (f" ({warps // group_warps} groups of {group_warps})"
              if group_warps else "")
    print(f"  occupancy {label} [{tag}]: {per_sm} resident CTAs of {warps} "
          f"warps{groups} per SM ({per_sm * warps} warps), {ctas} CTAs on "
          f"{sms} SMs = {ctas / (per_sm * sms):.2f} waves")


def profile_steps(step, n_steps):
    """Device busy share, kernel launches per step and the top kernels by
    device time over n_steps calls of step(i), from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_steps):
            step(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    if not kernels:
        return "the profiler recorded no device kernels", "none"
    total = sum(dev_us(e) for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:5]
    launches = sum(e.count for e in kernels) / n_steps
    busy = (f"device busy {100 * total / wall_us:.1f}% of {wall_us / 1e3 / n_steps:.3f} "
            f"ms wall per step (profiled), {launches:.0f} kernel launches "
            f"per step")
    return busy, "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3 / n_steps:.3f}"
                           for e in top)


def plain_logits(model, args, torch):
    """Logits of the model's plain layer stack (dense adjacency) on a
    wire batch; for a co-attention batch (nine arrays) each side's atom
    table is gathered by plain indexing, then co-attention."""
    from gcnbmp_tpu_torch.models.packed import decode_compact_wire
    from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo

    nodes, e_packed, n_edges, left, right = args[:5]
    num_mols = 2 * left.shape[0]
    atom_ids, mol_id, mask, *edges = decode_compact_wire(
        nodes, e_packed, n_edges, num_mols)
    adj = adj_from_coo(*edges, num_tiles=atom_ids.shape[0],
                       tile=atom_ids.shape[1])
    g, aux = model.encoder(atom_ids, adj, mol_id, mask, num_mols)
    g1, g2 = g[left.long()], g[right.long()]
    if len(args) == 9:
        left_slots, right_slots, left_mask, right_mask = args[5:]
        flat = aux["atoms"].reshape(-1, aux["atoms"].shape[-1])
        atoms1 = flat[left_slots.long()] * left_mask[..., None]
        atoms2 = flat[right_slots.long()] * right_mask[..., None]
        g1, g2 = model.coattention(atoms1, g1, atoms2, g2, left_mask,
                                   right_mask)
    return model.head(g1, g2)


def serve_slice(tag, config, cfg, ds, df, dev, smi, reset_counts, read_counts,
                kernels, absent=(), tree=None):
    """Serve the pairs through predict.main with seeded weights (or the
    parameter tree ``tree``); each of ``kernels`` must launch once per
    request and each of ``absent`` never; the logits must match the plain
    layer stack.  Returns the launch counts."""
    import numpy as np
    import pandas as pd
    import torch

    from gcnbmp_tpu_torch.cli import predict
    from gcnbmp_tpu_torch.convert import (
        from_jax_params, init_params, save_params_npz)
    from gcnbmp_tpu_torch.data import estimate_coo_capacities
    from gcnbmp_tpu_torch.data.wire import iter_coo_eval_batches
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor

    n_batches = -(-N_PAIRS // SERVE_BATCH)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        cfg_path = os.path.join(tmp, "config.json")
        params_path = os.path.join(tmp, "params.npz")
        in_path = os.path.join(tmp, "pairs.csv")
        out_path = os.path.join(tmp, "preds.csv")
        with open(cfg_path, "w") as f:
            json.dump(config, f)
        if tree is None:
            tree = init_params(cfg, SEED)
        save_params_npz(params_path, tree)
        df.to_csv(in_path, index=False)
        argv = ["--input", in_path, "--config", cfg_path,
                "--params", params_path, "--out", out_path,
                "--batch-size", str(SERVE_BATCH), "--device", "cuda"]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = predict.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        if rc != 0:
            raise AssertionError(f"predict.main returned {rc}")
        print(f"{tag} slice: predict.main served {N_PAIRS} pairs in "
              f"{n_batches} requests in {wall:.3f} s = {N_PAIRS / wall:.1f} "
              f"pairs/s (CSV parse + pack + device, first call) on {smi}; "
              f"launches {launches}")
        for name in kernels:
            if launches[name] != n_batches:
                raise AssertionError(f"{name} launched {launches[name]} "
                                     f"times for {n_batches} batches")
        for name in absent:
            if launches[name]:
                raise AssertionError(f"{name} launched {launches[name]} "
                                     f"times on a path that does not run it")
        probs = pd.read_csv(out_path)["prob"].to_numpy()
        if len(probs) != N_PAIRS or not np.all(np.isfinite(probs)) or \
                probs.min() < 0 or probs.max() > 1:
            raise AssertionError("probs not finite in [0, 1] for every pair")

    # the same batches: kernel path vs the plain layer stack on the card
    model = from_jax_params(tree, make_packed_predictor(**cfg)).to(dev).eval()
    tiles, cap = estimate_coo_capacities([ds], SERVE_BATCH)
    args_fn = model.wire_encoder([ds])
    got_l, want_l = [], []
    serve_s = 0.0
    with torch.no_grad():
        for i, (batch, valid) in enumerate(
                iter_coo_eval_batches(ds, SERVE_BATCH, tiles, cap)):
            args = [torch.as_tensor(np.asarray(a)).to(dev)
                    for a in args_fn(batch)]
            if i == 0:  # first-use costs (lazy module loads) stay untimed
                model(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model(*args)
            torch.cuda.synchronize()
            serve_s += time.perf_counter() - t0
            got_l.append(logits[:valid])
            want_l.append(plain_logits(model, args, torch)[:valid])
    got, want = torch.cat(got_l), torch.cat(want_l)
    compare(f"{tag} slice logits (kernel path vs plain layer stack)", got,
            want, torch)
    want_p = torch.sigmoid(want).cpu().numpy().ravel()
    p_err = float(np.abs(probs - want_p).max())
    print(f"{tag} slice probs vs plain: max_abs_err={p_err:.3e}")
    if p_err > ATOL:
        raise AssertionError("served probs disagree with the plain model")
    print(f"{tag} slice device path: {N_PAIRS / serve_s:.1f} pairs/s "
          f"({serve_s * 1e3 / n_batches:.3f} ms per 256-pair request, "
          f"warm, host clock around synchronized forwards) on {smi}")
    return launches


def train_slice(tag, flags, batch_size, train_cfg, model_cfg, per_step,
                fwd_kernels, time_batches, dev, smi, reset_counts,
                read_counts, n_train=N_PAIRS, epochs=TRAIN_EPOCHS, absent=(),
                keep_dir=None):
    """The train CLI on the card with ``flags`` at ``batch_size`` on the
    first ``n_train`` train pairs for ``epochs`` epochs; each kernel of
    ``per_step`` must launch that many times per step, each of
    ``fwd_kernels`` at least once per step and each of ``absent`` never.
    Then one step's gradients vs the plain layer stack, and the step's
    time and profile at each of ``time_batches`` (batch size, steps).
    The CSVs and the run (``train.csv``, ``val.csv``, ``run/``) go into
    ``keep_dir`` when it is given, else into a directory removed after.
    Returns the launch counts and the parsed train pairs."""
    import numpy as np
    import pandas as pd
    import torch

    from gcnbmp_tpu_torch.cli import predict
    from gcnbmp_tpu_torch.cli import train as train_cli
    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.data import CSVPairParser, estimate_coo_capacities
    from gcnbmp_tpu_torch.data.wire import iter_coo_eval_batches
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor
    from gcnbmp_tpu_torch.train import loop as train_loop

    train_df = pd.read_csv(TRAIN_CSV).head(n_train)
    val_df = pd.read_csv(VALID_CSV).head(N_VAL)
    train_ds = CSVPairParser().parse(train_df).dataset
    if len(train_ds) != n_train:
        raise AssertionError(f"parsed {len(train_ds)} of {n_train} pairs")
    steps_per_epoch = 2 * len(train_ds) // batch_size  # swap-augmented
    if train_cfg.scan_steps > 1:  # scan mode drops the tail chunk
        steps_per_epoch -= steps_per_epoch % train_cfg.scan_steps
    with contextlib.ExitStack() as stack:
        tmp = keep_dir or stack.enter_context(
            tempfile.TemporaryDirectory(dir=ROOT))
        train_path = os.path.join(tmp, "train.csv")
        val_path = os.path.join(tmp, "val.csv")
        out_dir = os.path.join(tmp, "run")
        train_df.to_csv(train_path, index=False)
        val_df.to_csv(val_path, index=False)
        argv = ["--train", train_path, "--val", val_path, *flags,
                "--batch-size", str(batch_size),
                "--device", "cuda", "--epochs", str(epochs),
                "--seed", str(SEED), "--out", out_dir]
        # record each step's loss (a device tensor) as the trainer takes it
        step_losses = []
        real_step = train_loop.train_step

        def recording_step(*args, **kwargs):
            loss = real_step(*args, **kwargs)
            step_losses.append(loss)
            return loss

        train_loop.train_step = recording_step
        try:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = train_cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
        finally:
            train_loop.train_step = real_step
        if rc != 0:
            raise AssertionError(f"train.main returned {rc}")
        n_steps = len(step_losses)
        print(f"{tag} train slice: train.main ran {n_steps} steps of batch "
              f"{batch_size} over {epochs} epochs in {wall:.3f} s "
              f"(CSV parse, pack, steps, per-epoch train+val evaluation, "
              f"checkpoints) on {smi}; launches {launches}")
        if n_steps != epochs * steps_per_epoch:
            raise AssertionError(f"{n_steps} steps, expected "
                                 f"{epochs * steps_per_epoch}")
        for name, times in per_step.items():
            if launches[name] != times * n_steps:
                raise AssertionError(f"{name} launched {launches[name]} "
                                     f"times for {n_steps} steps, expected "
                                     f"{times} per step")
        for name in fwd_kernels:
            if launches[name] < n_steps:
                raise AssertionError(f"{name} launched fewer times than steps")
        for name in absent:
            if launches[name]:
                raise AssertionError(f"{name} launched {launches[name]} "
                                     f"times on a path that does not run it")
        losses = torch.stack(step_losses).cpu().numpy()
        k = min(10, n_steps // 3)
        first, last = float(losses[:k].mean()), float(losses[-k:].mean())
        print(f"{tag} train slice: step loss mean first {k} {first:.5f}, "
              f"last {k} {last:.5f}")
        if not np.all(np.isfinite(losses)) or not last < first:
            raise AssertionError("training loss not finite or not falling")
        with open(os.path.join(out_dir, "log.json")) as f:
            log = json.load(f)
        print(f"{tag} train slice: last log entry {json.dumps(log[-1])}")
        if len(log) != epochs or not all(
                np.isfinite(e.get("val/roc_auc", np.nan))
                and np.isfinite(e["val/loss"]) for e in log):
            raise AssertionError("log.json lacks finite val metrics")
        preds_path = os.path.join(tmp, "preds.csv")
        rc = predict.main(["--input", val_path, "--config",
                           os.path.join(out_dir, "config.json"), "--params",
                           os.path.join(out_dir, "final", "params.npz"),
                           "--out", preds_path, "--device", "cuda"])
        probs = pd.read_csv(preds_path)["prob"].to_numpy()
        if rc != 0 or len(probs) != N_VAL or not np.all(np.isfinite(probs)) \
                or probs.min() < 0 or probs.max() > 1:
            raise AssertionError("final/params.npz did not serve")
        print(f"{tag} train slice: final/params.npz served {len(probs)} val "
              f"pairs through predict.main")

    # one step's gradients: kernel path vs autograd through the plain
    # layer stack, batch 256 of the train split
    model = from_jax_params(init_params(model_cfg, SEED),
                            make_packed_predictor(**model_cfg)).to(dev)
    tiles, cap = estimate_coo_capacities([train_ds], SERVE_BATCH)
    batch, _ = next(iter_coo_eval_batches(train_ds, SERVE_BATCH, tiles, cap))
    args = [torch.as_tensor(np.asarray(a)).to(dev)
            for a in model.wire_encoder([train_ds])(batch)]
    labels = torch.as_tensor(batch.labels).to(dev)
    params = list(model.parameters())

    def grads_of(loss):
        # a co-attention variant that reads no g leaves the GGNN readout
        # out of the loss: its gradient is zero, as jax.grad gives it
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for g, p in zip(grads, params)]

    loss_k = train_loop.sigmoid_cross_entropy(model(*args), labels)
    grads_k = grads_of(loss_k)
    loss_p = train_loop.sigmoid_cross_entropy(plain_logits(model, args, torch),
                                              labels)
    grads_p = grads_of(loss_p)
    lk, lp = float(loss_k.detach()), float(loss_p.detach())
    print(f"{tag} train slice: batch {SERVE_BATCH} (P={tiles}) loss kernel "
          f"path {lk:.7f}, plain layer stack {lp:.7f}")
    if abs(lk - lp) > ATOL:
        raise AssertionError("kernel-path loss disagrees with the plain stack")
    names = [n for n, _ in model.named_parameters()]
    compare_grads(f"{tag} train slice gradients (kernel path vs plain layer "
                  f"stack)", list(zip(names, grads_k)),
                  list(zip(names, grads_p)), torch)

    for bs, n_steps in time_batches:
        time_train_step(tag, train_ds, model_cfg, train_cfg, bs, n_steps, dev,
                        smi)
    return launches, train_ds


def time_train_step(tag, train_ds, model_cfg, train_cfg, bs, n_steps, dev,
                    smi):
    """The train step's time (host clock) and profile at batch ``bs``, on
    batches staged on the card beforehand; returns ms per step.  A
    multi-label model (``class_num`` in ``model_cfg``) takes the sigmoid
    cross-entropy over ``train_ds``'s multi-hot labels.  Also times the
    trainer's staging of one batch (``stage_chunk``) and its two parts:
    the host gather into one buffer and the copy from pageable memory;
    and, for comparison, the copy of the same bytes from pinned memory."""
    import numpy as np
    import torch

    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.data import estimate_coo_capacities
    from gcnbmp_tpu_torch.data.wire import packed_coo_batch_iterator
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor
    from gcnbmp_tpu_torch.train import loop as train_loop

    model = from_jax_params(init_params(model_cfg, SEED),
                            make_packed_predictor(**model_cfg)).to(dev)
    tiles, cap = estimate_coo_capacities([train_ds], bs)
    rng = np.random.default_rng(SEED)
    args_fn = model.wire_encoder([train_ds])
    staged, hosts = [], []
    for b in packed_coo_batch_iterator(
            train_ds, bs, tiles, cap, rng,
            supernode_fn=getattr(model, "supernode_fn", None)):
        hosts.append(([np.asarray(a)[None] for a in args_fn(b)],
                      b.labels[None]))
        args, labels = train_loop.stage_chunk(*hosts[-1], dev)
        staged.append(([a[0] for a in args], labels[0]))
        if len(staged) == 8:
            break
    stage_ms = staging_ms(hosts[0], dev, torch)
    del hosts
    opt, _ = train_loop.build_optimizer(train_cfg, 1000,
                                        list(model.parameters()))
    class_num = model_cfg.get("class_num", 1)

    def step(i):
        train_loop.train_step(model, opt, *staged[i % len(staged)],
                              class_num=class_num)

    for i in range(3):  # warm up
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_steps):
        step(i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    busy, top = profile_steps(step, n_steps)
    print(f"{tag} train step: batch={bs} P={tiles}: {step_ms:.3f} ms per "
          f"step, {bs * 1e3 / step_ms:.1f} pairs/s (host clock around "
          f"{n_steps} back-to-back steps on staged batches) on {smi}")
    print(f"  where it goes (torch.profiler over {n_steps} steps): {busy}; "
          f"top kernels, device ms per step: {top}")
    mb = stage_ms.pop("MB")
    print(f"  staging one batch, {mb:.3f} MB, ms (median of 5, host clock "
          "around synchronized calls): " + ", ".join(
              f"{k} {v:.3f}" for k, v in stage_ms.items())
          + f"; pageable copy {mb / stage_ms['pageable copy']:.3f} GB/s, "
          f"pinned copy {mb / stage_ms['pinned copy']:.3f} GB/s")
    return step_ms


def host_ms(fn, torch, reps=5):
    """Median host-clock ms of ``fn()`` between synchronizations, over
    ``reps`` calls after one warm-up call."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def staging_ms(host, dev, torch) -> dict:
    """``stage_chunk`` on one host batch (``host``: the wire arrays and
    labels, each with a leading axis of 1), and its two parts timed
    apart: the gather of every array's bits into one int32 buffer and the
    copy of that buffer from pageable memory; and the copy of the same
    bytes from a pinned buffer, which the trainer does not use."""
    import numpy as np

    from gcnbmp_tpu_torch.train import loop as train_loop

    parts = [np.ascontiguousarray(a) for a in host[0]]
    parts.append(np.ascontiguousarray(host[1], np.float32))

    def gather():
        return np.concatenate([p.view(np.int32).reshape(-1) for p in parts])

    flat = torch.from_numpy(gather())
    pinned = flat.pin_memory()
    calls = {"stage_chunk": lambda: train_loop.stage_chunk(*host, dev),
             "host gather": gather,
             "pageable copy": lambda: flat.to(dev),
             "pinned copy": lambda: pinned.to(dev, non_blocking=True)}
    out = {name: host_ms(fn, torch) for name, fn in calls.items()}
    out["MB"] = flat.numel() * 4 / 1e6
    return out


def multilabel_csv(src, dst, classes):
    """``src``'s pairs with ||-joined labels over ``classes`` by a seeded
    rule: the first class when the pair interacts, each other class with
    probability 1/4."""
    import numpy as np
    import pandas as pd

    df = pd.read_csv(src)
    rng = np.random.default_rng(SEED)
    draws = rng.random((len(df), len(classes))) < 0.25
    draws[:, 0] = df["label"].to_numpy() > 0
    df["label"] = ["||".join(c for c, on in zip(classes, row) if on)
                   for row in draws]
    df.to_csv(dst, index=False)


def score_run(tag, run, test_path, eval_dir, extra, dev, smi, reset_counts,
              read_counts):
    """The evaluate CLI (flags ``extra`` besides) on ``run``'s ``best`` and
    the pairs of ``test_path``, on the card: K2 must launch once per batch,
    eval_result.json must hold the metrics' keys, and its AUROC and AUPRC
    must come within 1e-3 of the plain layer stack's on the same
    parameters.  Returns (the launch counts, the plain stack's logits, the
    CLI's seconds)."""
    import numpy as np
    import torch

    from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli
    from gcnbmp_tpu_torch.data import CSVPairParser, estimate_coo_capacities
    from gcnbmp_tpu_torch.data.wire import iter_coo_eval_batches
    from gcnbmp_tpu_torch.train.checkpoints import load_run
    from gcnbmp_tpu_torch.train.metrics import compute_metrics

    n_batches = -(-N_PAIRS // SERVE_BATCH)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = evaluate_cli.main([
        "--test", test_path, "--run", run, "--checkpoint", "best",
        "--batch-size", str(SERVE_BATCH), *extra, "--out", eval_dir,
        "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    print(f"{tag}: evaluate CLI scored {N_PAIRS} pairs in {n_batches} "
          f"batches of {SERVE_BATCH} in {seconds:.3f} s (CSV parse, "
          f"pack, device, exports{', similarity' if extra else ''}) on {smi}; "
          f"launches {launches}")
    if rc != 0:
        raise AssertionError(f"evaluate.main returned {rc}")
    if launches["fused_ggnn_readout"] != n_batches:
        raise AssertionError(f"K2 launched {launches['fused_ggnn_readout']} "
                             f"times for {n_batches} batches")
    with open(os.path.join(eval_dir, "eval_result.json")) as f:
        metrics = json.load(f)
    keys = sorted(compute_metrics(np.array([0.0, 1.0]), np.array([0, 1])))
    if sorted(metrics) != keys:
        raise AssertionError(f"eval_result.json keys {sorted(metrics)}, "
                             f"expected {keys}")
    # the same params through the plain layer stack on the card
    _, model = load_run(run, "best", dev)
    model.eval()
    ds = CSVPairParser().parse(test_path).dataset
    tiles, cap = estimate_coo_capacities([ds], SERVE_BATCH)
    got_l, want_l, labels = [], [], []
    with torch.no_grad():
        for batch, valid in iter_coo_eval_batches(ds, SERVE_BATCH, tiles, cap):
            args = [torch.as_tensor(np.asarray(a)).to(dev)
                    for a in model.wire_encoder([ds])(batch)]
            got_l.append(model(*args)[:valid])
            want_l.append(plain_logits(model, args, torch)[:valid])
            labels.append(np.asarray(batch.labels)[:valid])
    got, want = torch.cat(got_l).ravel(), torch.cat(want_l).ravel()
    compare(f"{tag}: best's logits (kernel path vs plain layer stack)",
            got, want, torch)
    want_np = want.cpu().numpy()
    plain = compute_metrics(want_np, np.concatenate(labels))
    for key in ("roc_auc", "prc_auc"):
        err = abs(metrics[key] - plain[key])
        print(f"{tag}: evaluate CLI {key} {metrics[key]:.6f}, plain "
              f"stack {plain[key]:.6f}, |diff| {err:.2e}")
        if err > 1e-3:
            raise AssertionError(f"evaluate CLI {key} disagrees with the "
                                 "plain stack's")
    return launches, want_np, seconds


def run_modes(kept, df, dev, smi, reset_counts, read_counts):
    """Phase 11 on phase 5's kept run: the evaluate CLI, predict --run,
    resume, profile_epoch, debug_checks and multi-label, each on the
    card.  Returns the evaluate CLI's launch counts."""
    import numpy as np
    import pandas as pd
    import torch

    from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli
    from gcnbmp_tpu_torch.cli import predict
    from gcnbmp_tpu_torch.cli import train as train_cli
    from gcnbmp_tpu_torch.convert import flat_npz, load_params_npz, named_to_tree
    from gcnbmp_tpu_torch.data import CSVPairParser, get_class_labels
    from gcnbmp_tpu_torch.data import wire
    from gcnbmp_tpu_torch.train import loop as train_loop
    from gcnbmp_tpu_torch.train.checkpoints import (
        load_run, restore_checkpoint, served_predictor)
    from gcnbmp_tpu_torch.train.config import PRESETS, TrainConfig

    run = os.path.join(kept, "run")
    test_path = os.path.join(kept, "test.csv")
    df.to_csv(test_path, index=False)
    n_batches = -(-N_PAIRS // SERVE_BATCH)
    times = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
        return out

    # a. the evaluate CLI on best
    eval_dir = os.path.join(kept, "eval")
    launches, want_np, times["evaluate"] = score_run(
        "run modes", run, test_path, eval_dir, ["--similarity", "cosine"],
        dev, smi, reset_counts, read_counts)
    stem = os.path.join(eval_dir, "test")
    exports = {s: pd.read_csv(f"{stem}{s}.csv") for s in ("_e", "_e_y")}
    if any(len(e) != N_PAIRS for e in exports.values()):
        raise AssertionError(f"exports hold {[len(e) for e in exports.values()]}"
                             f" rows, expected {N_PAIRS}")
    y = exports["_e_y"]["y"].to_numpy()
    p_err = float(np.abs(y - 1.0 / (1.0 + np.exp(-want_np))).max())
    print(f"run modes: _e_y.csv y vs plain probs max_abs_err={p_err:.3e}")
    if p_err > ATOL:
        raise AssertionError("exported probabilities disagree with the "
                             "plain stack")
    sim = pd.read_csv(os.path.join(eval_dir, "similarity_cosine.csv"),
                      index_col=0).to_numpy()
    asym = float(np.abs(sim - sim.T).max())
    diag = float(np.abs(np.diag(sim) - 1.0).max())
    print(f"run modes: similarity_cosine.csv {sim.shape}, asymmetry "
          f"{asym:.2e}, |diag - 1| {diag:.2e}")
    if asym > 1e-6 or diag > 1e-6:
        raise AssertionError("cosine similarity not symmetric with a unit "
                             "diagonal")

    # b. predict --run against --config/--params: the same weights bit
    # for bit, the same probs within the served bound (the segment sum's
    # index_add_ adds in an order that varies from run to run on the card)
    with open(os.path.join(run, "config.json")) as f:
        run_config = json.load(f)
    _, model = load_run(run, "best", dev)
    config_form = served_predictor(
        run_config, load_params_npz(os.path.join(run, "best", "params.npz")))
    for (name, a), b in zip(model.state_dict().items(),
                            config_form.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"--run and --config/--params load "
                                 f"different {name}")
    probs = []
    for i, form in enumerate((["--run", run, "--checkpoint", "best"],
                              ["--config", os.path.join(run, "config.json"),
                               "--params",
                               os.path.join(run, "best", "params.npz")])):
        out = os.path.join(kept, f"preds_{i}.csv")
        if predict.main(["--input", test_path, "--out", out, "--device",
                         "cuda", *form]) != 0:
            raise AssertionError("predict.main failed")
        probs.append(pd.read_csv(out)["prob"].to_numpy())
    p_err = float(np.abs(probs[0] - probs[1]).max())
    print(f"run modes: predict --run and --config/--params load the same "
          f"weights bit for bit; their probs over {len(probs[0])} pairs: "
          f"max_abs_diff={p_err:.3e}, {int((probs[0] == probs[1]).sum())} "
          "equal bit for bit")
    if len(probs[0]) != N_PAIRS or p_err > ATOL:
        raise AssertionError("predict --run and --config/--params differ")

    # c. resume: restore bit for bit, then one epoch through the train CLI
    snapshot = os.path.join(run, f"snapshot_epoch_{TRAIN_EPOCHS}")
    with open(os.path.join(run, "config.json")) as f:
        run_cfg = TrainConfig.from_json(f.read())
    parser = CSVPairParser()
    train_ds = parser.parse(os.path.join(kept, "train.csv")).dataset
    val_ds = parser.parse(os.path.join(kept, "val.csv")).dataset
    trainer = train_loop.Trainer(run_cfg, train_ds, val_ds, device=dev)
    state = restore_checkpoint(snapshot, train_loop.TrainState(
        trainer.model, trainer.optimizer, 0, 0, float("inf"), 0))
    names = [n for n, _ in trainer.model.named_parameters()]
    files = flat_npz(load_params_npz(os.path.join(snapshot, "params.npz")))
    with np.load(os.path.join(snapshot, "opt_state.npz")) as z:
        for prefix, tensors_ in (("", dict(trainer.model.named_parameters())),
                                 ("mu/", dict(zip(names, trainer.optimizer.mu))),
                                 ("nu/", dict(zip(names, trainer.optimizer.nu)))):
            for key, v in flat_npz(named_to_tree(tensors_)).items():
                want_v = files[key] if not prefix else z[prefix + key]
                if not np.array_equal(v, want_v):
                    raise AssertionError(f"restored {prefix}{key} differs "
                                         "from the file")
        if (trainer.optimizer.count, state.step, state.epoch) != (
                int(z["count"]), int(z["step"]), TRAIN_EPOCHS):
            raise AssertionError("restored count, step or epoch differ")
    print(f"run modes: {snapshot.split(os.sep)[-1]} restored bit for bit: "
          f"{len(files)} parameters and their Adam moments, count "
          f"{trainer.optimizer.count}, step {state.step}, epoch {state.epoch}")
    del trainer
    resumed = os.path.join(kept, "resumed")
    step_losses = []
    real_step = train_loop.train_step

    def recording_step(*args, **kwargs):
        loss = real_step(*args, **kwargs)
        step_losses.append(loss)
        return loss

    train_loop.train_step = recording_step
    try:
        reset_counts()
        rc = timed("resume", lambda: train_cli.main([
            "--train", os.path.join(kept, "train.csv"), "--val",
            os.path.join(kept, "val.csv"), "--preset", "ggnn_hole_binary",
            "--compute-path", "fused", "--device", "cuda", "--seed", str(SEED),
            "--epochs", str(TRAIN_EPOCHS + 1), "--resume", snapshot,
            "--out", resumed]))
        launches_resume = read_counts()
    finally:
        train_loop.train_step = real_step
    with open(os.path.join(resumed, "log.json")) as f:
        log = json.load(f)
    n_steps = len(step_losses)
    losses = torch.stack(step_losses).cpu().numpy() if step_losses else []
    print(f"run modes: train CLI --resume trained {n_steps} steps in "
          f"{times['resume']:.3f} s on {smi}; launches {launches_resume}; "
          f"log epochs {[e['epoch'] for e in log]}")
    if rc != 0 or n_steps != 2 * N_PAIRS // PRESETS["ggnn_hole_binary"].batch_size:
        raise AssertionError(f"resume ran {n_steps} steps (rc {rc})")
    if launches_resume["fused_ggnn_readout_bwd"] != n_steps:
        raise AssertionError("K2b did not launch once per resumed step")
    if [e["epoch"] for e in log] != [TRAIN_EPOCHS + 1] or \
            not np.all(np.isfinite(losses)):
        raise AssertionError("resumed log.json or loss wrong")

    # d. profile_epoch=0 and e. debug_checks, one epoch each at batch 256
    base = dataclasses.replace(
        PRESETS["ggnn_hole_binary"], compute_path="fused",
        batch_size=SERVE_BATCH, epochs=1, seed=SEED, plot_reports=False)
    prof_dir = os.path.join(kept, "profiled")
    timed("profile_epoch", lambda: train_loop.Trainer(
        dataclasses.replace(base, profile_epoch=0, out_dir=prof_dir),
        train_ds, val_ds, device=dev).fit())
    traces = os.listdir(os.path.join(prof_dir, "profile"))
    with open(os.path.join(prof_dir, "profile", traces[0])) as f:
        names_ = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    k2b = sorted(n for n in names_ if re.search(
        r"fused_ggnn_bwd_kernel<\d+, true>", n))
    print(f"run modes: profile_epoch=0 wrote {traces} in "
          f"{times['profile_epoch']:.3f} s; K2b's kernel in it: {k2b[:1]}")
    if len(traces) != 1 or not k2b:
        raise AssertionError("the epoch's trace does not name K2b's kernel")
    timed("debug_checks", lambda: train_loop.Trainer(
        dataclasses.replace(base, debug_checks=True,
                            out_dir=os.path.join(kept, "debug")),
        train_ds, val_ds, device=dev).fit())
    real_iter = wire.packed_coo_batch_iterator

    def corrupted(*args, **kwargs):
        for b in real_iter(*args, **kwargs):
            b.e_src[int(np.flatnonzero(b.e_mask > 0)[0])] = TILE + 5
            yield b

    wire.packed_coo_batch_iterator = corrupted
    try:
        trainer = train_loop.Trainer(
            dataclasses.replace(base, debug_checks=True,
                                out_dir=os.path.join(kept, "debug_bad")),
            train_ds, val_ds, device=dev)
        reset_counts()
        try:
            trainer.fit()
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("debug_checks passed a corrupted batch")
        launches_bad = read_counts()
    finally:
        wire.packed_coo_batch_iterator = real_iter
    print(f"run modes: debug_checks epoch passed in "
          f"{times['debug_checks']:.3f} s; a corrupted batch: {refused!r}, "
          f"launches {sum(launches_bad.values())}")
    if "e_src" not in refused or any(launches_bad.values()):
        raise AssertionError("the corrupted batch was not refused before "
                             "any launch")

    # f. multi-label: train one epoch with --labels-csv, then evaluate
    classes_csv = os.path.join(ROOT, "dataset", "synth546", "labels.csv")
    classes = get_class_labels(classes_csv)
    paths = {}
    for name in ("train", "val", "test"):
        paths[name] = os.path.join(kept, f"multi_{name}.csv")
        multilabel_csv(os.path.join(kept, f"{name}.csv"), paths[name], classes)
    multi_run = os.path.join(kept, "multi")
    reset_counts()
    rc = timed("multi-label train", lambda: train_cli.main([
        "--train", paths["train"], "--val", paths["val"], "--labels-csv",
        classes_csv, "--preset", "ggnn_multilabel_x86", "--loss", "focal",
        "--batch-size", str(SERVE_BATCH), "--scan-steps", "4", "--epochs", "1",
        "--device", "cuda", "--seed", str(SEED), "--out", multi_run]))
    launches_multi = read_counts()
    steps = N_PAIRS // SERVE_BATCH
    if rc != 0 or launches_multi["fused_ggnn_readout_bwd"] != steps:
        raise AssertionError(f"multi-label training: rc {rc}, launches "
                             f"{launches_multi}")
    rc = timed("multi-label evaluate", lambda: evaluate_cli.main([
        "--test", paths["test"], "--run", multi_run, "--labels-csv",
        classes_csv, "--batch-size", str(SERVE_BATCH), "--device", "cuda"]))
    with open(os.path.join(multi_run, "eval", "eval_result.json")) as f:
        per_class = json.load(f).get("per_class", {})
    print(f"run modes: multi-label ({len(classes)} classes) trained {steps} "
          f"steps in {times['multi-label train']:.3f} s, launches "
          f"{launches_multi}; evaluated in "
          f"{times['multi-label evaluate']:.3f} s; per_class roc_auc "
          f"{ {c: round(v['roc_auc'], 4) for c, v in per_class.items()} }")
    if rc != 0 or sorted(per_class) != sorted(classes) or not all(
            np.isfinite(v) for c in per_class.values() for v in c.values()):
        raise AssertionError("multi-label per_class lacks finite entries")
    print("run modes: times (s) " + json.dumps(
        {k: round(v, 3) for k, v in times.items()}))
    return launches


# phase 12: the packed encoders that run no kernel, each trained through
# the train CLI on coo: (tag, train CLI flags, make_packed_predictor
# kwargs, multi-label)
ENCODER_ROWS = (
    ("relgcn", ["--preset", "relgcn_binary"],
     dict(method="relgcn", fp_hidden_dim=32, fp_out_dim=64, conv_layers=4),
     False),
    ("gin", ["--preset", "gin_binary", "--weight-tying", "false"],
     dict(method="gin", fp_hidden_dim=32, fp_out_dim=32, conv_layers=8,
          weight_tying=False), False),
    ("nfp", ["--method", "nfp", "--conv-layers", "4", "--fp-hidden-dim", "32",
             "--fp-out-dim", "32"],
     dict(method="nfp", fp_hidden_dim=32, fp_out_dim=32, conv_layers=4),
     False),
    ("ggnn gru aggregator", ["--preset", "ggnn_multilabel_x37",
                             "--weight-tying", "false",
                             "--layer-aggregator", "gru"],
     dict(method="ggnn", fp_hidden_dim=32, fp_out_dim=32, conv_layers=8,
          weight_tying=False, layer_aggregator="gru"), True),
)
N_CPU_CHECK = 512  # test pairs served on the CPU to hold the card's logits


def encoder_slices(df, dev, smi, reset_counts, read_counts):
    """Phase 12: RelGCN, GIN, NFP and GGNN with the gru aggregator
    (multi-label), each trained 2 epochs through the train CLI on coo
    (no kernel may launch), served through the predict CLI and scored
    through the evaluate CLI; the card's logits against the same weights
    on the CPU; each step timed at batch 256 and 2048.  Then the
    generator's files against their sums."""
    import hashlib

    import numpy as np
    import pandas as pd
    import torch

    from chip_quality import SHA256, build_synth546
    from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli
    from gcnbmp_tpu_torch.cli import predict
    from gcnbmp_tpu_torch.cli import train as train_cli
    from gcnbmp_tpu_torch.data import CSVPairParser, get_class_labels
    from gcnbmp_tpu_torch.eval.evaluate import PackedPairEvaluator
    from gcnbmp_tpu_torch.train import loop as train_loop
    from gcnbmp_tpu_torch.train.checkpoints import load_run
    from gcnbmp_tpu_torch.train.config import TrainConfig

    classes_csv = os.path.join(ROOT, "dataset", "synth546", "labels.csv")
    classes = get_class_labels(classes_csv)
    times = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        paths = {}
        for name, frame in (("train", pd.read_csv(TRAIN_CSV).head(N_PAIRS)),
                            ("val", pd.read_csv(VALID_CSV).head(N_VAL)),
                            ("test", df)):
            paths[name] = os.path.join(tmp, f"{name}.csv")
            frame.to_csv(paths[name], index=False)
            paths[f"multi_{name}"] = os.path.join(tmp, f"multi_{name}.csv")
            multilabel_csv(paths[name], paths[f"multi_{name}"], classes)
        for tag, flags, model_cfg, multi in ENCODER_ROWS:
            t0 = time.perf_counter()
            pre = "multi_" if multi else ""
            labels_flags = ["--labels-csv", classes_csv] if multi else []
            class_num = len(classes) if multi else 1
            run = os.path.join(tmp, tag.replace(" ", "_"))
            step_losses = []
            real_step = train_loop.train_step

            def recording_step(*args, **kwargs):
                loss = real_step(*args, **kwargs)
                step_losses.append(loss)
                return loss

            train_loop.train_step = recording_step
            try:
                reset_counts()
                rc = train_cli.main([
                    "--train", paths[pre + "train"], "--val",
                    paths[pre + "val"], *flags, *labels_flags,
                    "--compute-path", "coo", "--batch-size", str(SERVE_BATCH),
                    "--lr", "2e-3", "--epochs", str(TRAIN_EPOCHS), "--seed",
                    str(SEED), "--device", "cuda", "--out", run])
                launches = read_counts()
            finally:
                train_loop.train_step = real_step
            losses = torch.stack(step_losses).cpu().numpy()
            n_steps = len(losses)
            k = min(5, n_steps // 3)
            first, last = float(losses[:k].mean()), float(losses[-k:].mean())
            print(f"{tag} encoder: train.main ran {n_steps} steps of batch "
                  f"{SERVE_BATCH} in {time.perf_counter() - t0:.3f} s on "
                  f"{smi}; step loss mean first {k} {first:.5f}, last {k} "
                  f"{last:.5f}; kernel launches {sum(launches.values())}")
            if rc != 0 or n_steps != TRAIN_EPOCHS * N_PAIRS // SERVE_BATCH:
                raise AssertionError(f"{tag}: train.main rc {rc}, {n_steps} steps")
            if any(launches.values()):
                raise AssertionError(f"{tag}: kernels launched on a path that "
                                     f"runs none: {launches}")
            if not np.all(np.isfinite(losses)) or not last < first:
                raise AssertionError(f"{tag}: training loss not finite or "
                                     "not falling")
            with open(os.path.join(run, "log.json")) as f:
                log = json.load(f)
            if not all(np.isfinite(e["val/loss"]) and
                       np.isfinite(e["val/roc_auc"]) for e in log):
                raise AssertionError(f"{tag}: log.json lacks finite val metrics")
            preds_path = os.path.join(run, "preds.csv")
            rc = predict.main(["--input", paths[pre + "test"], "--run", run,
                               "--checkpoint", "final", "--out", preds_path,
                               "--batch-size", str(SERVE_BATCH), "--device",
                               "cuda"])
            probs = pd.read_csv(preds_path).filter(like="prob").to_numpy()
            if rc != 0 or probs.shape != (N_PAIRS, class_num) \
                    or not np.all(np.isfinite(probs)) or probs.min() < 0 \
                    or probs.max() > 1:
                raise AssertionError(f"{tag}: the predict CLI did not serve")
            rc = evaluate_cli.main(["--test", paths[pre + "test"], "--run",
                                    run, *labels_flags, "--batch-size",
                                    str(SERVE_BATCH), "--device", "cuda"])
            with open(os.path.join(run, "eval", "eval_result.json")) as f:
                result = json.load(f)
            if rc != 0 or not np.isfinite(result["roc_auc"]):
                raise AssertionError(f"{tag}: the evaluate CLI did not score")
            # the card's logits against the same weights on the CPU
            parser = CSVPairParser(multi_label_classes=classes if multi else None)
            check_ds = parser.parse(pd.read_csv(
                paths[pre + "test"]).head(N_CPU_CHECK)).dataset
            logits = {}
            for where in ("cuda", "cpu"):
                _, model = load_run(run, "final", where)
                logits[where] = PackedPairEvaluator(
                    model, batch_size=SERVE_BATCH,
                    class_num=class_num, device=where,
                    with_metrics=False).evaluate(check_ds).logits
            compare(f"{tag} encoder served logits (card vs CPU, same weights)",
                    torch.as_tensor(logits["cuda"]),
                    torch.as_tensor(logits["cpu"]), torch)
            p_err = float(np.abs(probs[:N_CPU_CHECK] - 1.0 / (
                1.0 + np.exp(-logits["cpu"].reshape(N_CPU_CHECK, -1)))).max())
            print(f"{tag} encoder: predict CLI probs vs CPU: max_abs_err="
                  f"{p_err:.3e}; evaluate CLI test roc_auc "
                  f"{result['roc_auc']:.5f}")
            if p_err > ATOL:
                raise AssertionError(f"{tag}: served probs disagree with the CPU")
            train_ds = parser.parse(paths[pre + "train"]).dataset
            with open(os.path.join(run, "config.json")) as f:
                train_cfg = TrainConfig.from_json(f.read())
            for bs in (SERVE_BATCH, N_PAIRS):
                time_train_step(f"{tag} encoder", train_ds,
                                dict(model_cfg, class_num=class_num),
                                train_cfg, bs, 10, dev, smi)
            times[tag] = time.perf_counter() - t0
        # the generator, on the card machine's pandas
        t0 = time.perf_counter()
        out = os.path.join(tmp, "synth546")
        build_synth546(out)
        sums = {name: hashlib.sha256(open(os.path.join(out, name), "rb")
                                     .read()).hexdigest()[:16]
                for name in SHA256}
        times["generator"] = time.perf_counter() - t0
        bad = {k: v for k, v in sums.items() if v != SHA256[k]}
        print(f"generator: {len(sums)} files in {times['generator']:.3f} s, "
              f"sha256 {'all as recorded' if not bad else bad}")
        if bad:
            raise AssertionError(f"generator files differ: {bad}")
    print("encoders: times (s) " + json.dumps(
        {k: round(v, 3) for k, v in times.items()}))


# phase 13: the GWM quality row's model (scripts/quality_battery_r3.sh:48-50)
GWM_CFG = dict(method="ggnn-gwm", fp_hidden_dim=32, fp_out_dim=32,
               conv_layers=4, weight_tying=True)
GWM_FLAGS = ["--method", "ggnn-gwm", "--sim-method", "hole", "--conv-layers",
             "4", "--fp-hidden-dim", "32", "--fp-out-dim", "32", "--lr",
             "2e-3", "--augment"]
GWM_SCAN = 4  # steps per scan chunk on coo: 16 steps of 256 per epoch


def gwm_slice(df, dev, smi, reset_counts, read_counts):
    """Phase 13, GWM: served through the predict CLI with seeded weights
    (no kernel may launch; the padded ``PairEvaluator``, as the JAX CLI
    serves GWM), the card's logits and probs against the CPU's, and the
    compact-COO predictor's logits on the same weights against the CPU's
    and the padded one's (``PackedPairEvaluator``); trained 2 epochs through the train CLI on coo in scan mode and
    with ``--compute-path packed`` (no kernel; loss finite and falling;
    val metrics), each run served by predict ``--run`` and
    ``--config/--params`` and scored by the evaluate CLI; the step timed
    and profiled at batch 256 and 2048."""
    import numpy as np
    import pandas as pd
    import torch

    from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli
    from gcnbmp_tpu_torch.cli import predict
    from gcnbmp_tpu_torch.cli import train as train_cli
    from gcnbmp_tpu_torch.convert import (
        from_jax_params, init_params, save_params_npz)
    from gcnbmp_tpu_torch.data import CSVPairParser
    from gcnbmp_tpu_torch.eval.evaluate import (
        PackedPairEvaluator, PairEvaluator)
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor
    from gcnbmp_tpu_torch.train import loop as train_loop
    from gcnbmp_tpu_torch.train.checkpoints import served_predictor
    from gcnbmp_tpu_torch.train.config import TrainConfig

    config = dict(GWM_CFG, sim_method="hole", net_hidden_dims=[],
                  class_num=1)
    check_ds = CSVPairParser().parse(df.head(N_CPU_CHECK)).dataset
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        paths = {}
        for name, frame in (("train", pd.read_csv(TRAIN_CSV).head(N_PAIRS)),
                            ("val", pd.read_csv(VALID_CSV).head(N_VAL)),
                            ("test", df)):
            paths[name] = os.path.join(tmp, f"{name}.csv")
            frame.to_csv(paths[name], index=False)
        # a. serving with seeded weights
        cfg_path = os.path.join(tmp, "config.json")
        params_path = os.path.join(tmp, "params.npz")
        with open(cfg_path, "w") as f:
            json.dump(config, f)
        tree = init_params(GWM_CFG, SEED)
        save_params_npz(params_path, tree)
        out_path = os.path.join(tmp, "preds.csv")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = predict.main(["--input", paths["test"], "--config", cfg_path,
                           "--params", params_path, "--out", out_path,
                           "--batch-size", str(SERVE_BATCH), "--device",
                           "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        probs = pd.read_csv(out_path)["prob"].to_numpy()
        print(f"gwm slice: predict.main served {len(probs)} pairs in "
              f"{wall:.3f} s = {len(probs) / wall:.1f} pairs/s (CSV parse, "
              f"supernode features, padded batches, device, first call) on "
              f"{smi}; "
              f"kernel launches {sum(launches.values())}")
        if rc != 0 or len(probs) != N_PAIRS or not np.all(np.isfinite(probs)) \
                or probs.min() < 0 or probs.max() > 1:
            raise AssertionError("gwm: the predict CLI did not serve")
        if any(launches.values()):
            raise AssertionError(f"gwm: kernels launched on a path that runs "
                                 f"none: {launches}")
        logits = {}
        for name, where in (("card", dev), ("cpu", "cpu")):
            model = served_predictor(config, tree).to(where)
            logits[name] = PairEvaluator(
                model, batch_size=SERVE_BATCH, device=where,
                with_metrics=False).evaluate(check_ds).logits
        compare("gwm served logits (card vs CPU, same weights)",
                torch.as_tensor(logits["card"]),
                torch.as_tensor(logits["cpu"]), torch)
        # the compact-COO predictor that coo and packed runs train and
        # evaluate each epoch, on the same weights (one flax tree serves
        # both layouts)
        packed_logits = {}
        for name, where in (("card", dev), ("cpu", "cpu")):
            model = from_jax_params(tree, make_packed_predictor(**GWM_CFG))
            packed_logits[name] = PackedPairEvaluator(
                model, batch_size=SERVE_BATCH, device=where,
                with_metrics=False).evaluate(check_ds).logits
        compare("gwm packed COO logits (card vs CPU, same weights)",
                torch.as_tensor(packed_logits["card"]),
                torch.as_tensor(packed_logits["cpu"]), torch)
        compare("gwm packed COO vs padded logits (CPU, same weights)",
                torch.as_tensor(packed_logits["cpu"]),
                torch.as_tensor(logits["cpu"]), torch)
        p_err = float(np.abs(probs[:N_CPU_CHECK] - 1.0 / (
            1.0 + np.exp(-logits["cpu"].ravel()))).max())
        print(f"gwm slice: predict CLI probs vs CPU: max_abs_err={p_err:.3e}")
        if p_err > ATOL:
            raise AssertionError("gwm: served probs disagree with the CPU")

        # b. training on coo in scan mode, and on packed
        train_ds = CSVPairParser().parse(paths["train"]).dataset
        for layout, extra in (("coo", ["--compute-path", "coo",
                                       "--scan-steps", str(GWM_SCAN)]),
                              ("packed", ["--compute-path", "packed"])):
            run = os.path.join(tmp, f"run_{layout}")
            step_losses = []
            real_step = train_loop.train_step

            def recording_step(*args, **kwargs):
                loss = real_step(*args, **kwargs)
                step_losses.append(loss)
                return loss

            train_loop.train_step = recording_step
            try:
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = train_cli.main([
                    "--train", paths["train"], "--val", paths["val"],
                    *GWM_FLAGS, *extra, "--batch-size", str(SERVE_BATCH),
                    "--epochs", str(TRAIN_EPOCHS), "--seed", str(SEED),
                    "--device", "cuda", "--out", run])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = read_counts()
            finally:
                train_loop.train_step = real_step
            losses = torch.stack(step_losses).cpu().numpy()
            n_steps = len(losses)
            k = min(5, n_steps // 3)
            first, last = float(losses[:k].mean()), float(losses[-k:].mean())
            print(f"gwm train slice ({layout}): train.main ran {n_steps} "
                  f"steps of batch {SERVE_BATCH} over {TRAIN_EPOCHS} epochs "
                  f"in {wall:.3f} s on {smi}; step loss mean first {k} "
                  f"{first:.5f}, last {k} {last:.5f}; kernel launches "
                  f"{sum(launches.values())}")
            if rc != 0 or n_steps != TRAIN_EPOCHS * 2 * N_PAIRS // SERVE_BATCH:
                raise AssertionError(f"gwm {layout}: train.main rc {rc}, "
                                     f"{n_steps} steps")
            if any(launches.values()):
                raise AssertionError(f"gwm {layout}: kernels launched on a "
                                     f"path that runs none: {launches}")
            if not np.all(np.isfinite(losses)) or not last < first:
                raise AssertionError(f"gwm {layout}: training loss not "
                                     "finite or not falling")
            with open(os.path.join(run, "log.json")) as f:
                log = json.load(f)
            if len(log) != TRAIN_EPOCHS or not all(
                    np.isfinite(e["val/loss"]) and np.isfinite(e["val/roc_auc"])
                    for e in log):
                raise AssertionError(f"gwm {layout}: log.json lacks finite "
                                     "val metrics")
            served = {}
            for form, args in (
                    ("run", ["--run", run, "--checkpoint", "final"]),
                    ("config", ["--config", os.path.join(run, "config.json"),
                                "--params", os.path.join(run, "final",
                                                         "params.npz")])):
                path = os.path.join(tmp, f"{layout}_{form}.csv")
                rc = predict.main(["--input", paths["test"], *args, "--out",
                                   path, "--batch-size", str(SERVE_BATCH),
                                   "--device", "cuda"])
                served[form] = pd.read_csv(path)["prob"].to_numpy()
                if rc != 0 or not np.all(np.isfinite(served[form])):
                    raise AssertionError(f"gwm {layout}: predict {form} did "
                                         "not serve")
            # the segment sums' index_add_ adds in a varying order on the
            # card: the two serve the same weights within the probs bound
            d = float(np.abs(served["run"] - served["config"]).max())
            rc = evaluate_cli.main(["--test", paths["test"], "--run", run,
                                    "--batch-size", str(SERVE_BATCH),
                                    "--device", "cuda"])
            with open(os.path.join(run, "eval", "eval_result.json")) as f:
                result = json.load(f)
            print(f"gwm train slice ({layout}): predict --run vs "
                  f"--config/--params max_abs_err={d:.3e}; evaluate CLI test "
                  f"roc_auc {result['roc_auc']:.5f}; last log entry "
                  f"{json.dumps(log[-1])}")
            if d > ATOL or rc != 0 or not np.isfinite(result["roc_auc"]):
                raise AssertionError(f"gwm {layout}: served or scored wrong")
        with open(os.path.join(run, "config.json")) as f:
            train_cfg = TrainConfig.from_json(f.read())
        for bs in (SERVE_BATCH, N_PAIRS):
            time_train_step("gwm", train_ds, dict(config), train_cfg, bs, 10,
                            dev, smi)


# phase 14: the padded layout, the train CLI's default
PADDED_OPTIONS = (("symmetric or", ["--symmetric", "or"]),
                  ("dropout 0.1", ["--dropout", "0.1"]),
                  ("concat_hidden", ["--concat-hidden"]),
                  ("co-attention para + ntn", ["--attn", "para",
                                               "--sim-method", "ntn"]))
N_OPTION_PAIRS = 256  # 512 with augmentation: two steps of 256


def time_padded_step(tag, train_ds, kwargs, train_cfg, bs, n_steps, dev,
                     smi):
    """The padded train step's time (host clock over ``n_steps`` steps on
    batches staged on the card beforehand) and profile at batch ``bs``;
    then the host build of one padded batch (``make_batch``) and its copy
    to the card (``padded_args``), timed apart.  Returns ms per step."""
    import numpy as np
    import torch

    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.data.dataset import (
        bucket_size, make_batch, padded_args)
    from gcnbmp_tpu_torch.models.predictor import set_up_predictor
    from gcnbmp_tpu_torch.train import loop as train_loop

    model = from_jax_params(init_params(kwargs, SEED, padded=True),
                            set_up_predictor(**kwargs)).to(dev)
    pad_to = bucket_size(train_ds.max_atoms())
    order = np.random.default_rng(SEED).permutation(len(train_ds))
    batches = [order[i:i + bs].tolist()
               for i in range(0, len(order) - bs + 1, bs)][:8]
    staged = [padded_args(make_batch(train_ds, idx, pad_to), dev)
              for idx in batches]
    opt, _ = train_loop.build_optimizer(train_cfg, 1000,
                                        list(model.parameters()))
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step(i):
        args, kw, labels = staged[i % len(staged)]
        train_loop.train_step(model, opt, args, labels,
                              deterministic=False, generator=gen, **kw)

    for i in range(3):  # warm up
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_steps):
        step(i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    busy, top = profile_steps(step, n_steps)
    host = make_batch(train_ds, batches[0], pad_to)
    mb = sum(np.asarray(getattr(host, n)).nbytes for n in (
        "atoms1", "adj1", "mask1", "atoms2", "adj2", "mask2", "labels")) / 1e6
    parts = {"make_batch": lambda: make_batch(train_ds, batches[0], pad_to),
             "copy": lambda: padded_args(host, dev)}
    split = {}
    for name, fn in parts.items():
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        split[name] = statistics.median(times[1:])
    print(f"{tag} train step: batch={bs} N={pad_to}: {step_ms:.3f} ms per "
          f"step, {bs * 1e3 / step_ms:.1f} pairs/s (host clock around "
          f"{n_steps} back-to-back steps on staged batches) on {smi}")
    print(f"  where it goes (torch.profiler over {n_steps} steps): {busy}; "
          f"top kernels, device ms per step: {top}")
    print(f"  one padded batch, {mb:.3f} MB: make_batch (host) "
          f"{split['make_batch']:.3f} ms, copy to the card (six pageable "
          f"tensors) {split['copy']:.3f} ms = {mb / split['copy']:.3f} GB/s "
          f"(median of 5); {100 * split['make_batch'] / step_ms:.1f}% and "
          f"{100 * split['copy'] / step_ms:.1f}% of the step")
    return step_ms


def padded_slice(df, dev, smi, reset_counts, read_counts, cfg):
    """Phase 14, the padded layout: the flagship trained through the train
    CLI with ``--compute-path padded`` (2 epochs, falling loss) and with
    no ``--compute-path`` (1 epoch), each option and GWM for two steps,
    no kernel launched; the flagship's ``best`` scored by the evaluate and
    predict CLIs on the card and on the CPU, both through
    ``PairEvaluator``; the padded step timed against the K2/K2b one;
    padded and packed serving; the entry twin, card against CPU."""
    import numpy as np
    import pandas as pd
    import torch

    from gcnbmp_tpu_torch import entry
    from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli
    from gcnbmp_tpu_torch.cli import predict
    from gcnbmp_tpu_torch.cli import train as train_cli
    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.data import CSVPairParser
    from gcnbmp_tpu_torch.eval import evaluate as evaluate_module
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor
    from gcnbmp_tpu_torch.models.predictor import (
        padded_kwargs_from_config, set_up_predictor)
    from gcnbmp_tpu_torch.train import loop as train_loop
    from gcnbmp_tpu_torch.train.checkpoints import load_run
    from gcnbmp_tpu_torch.train.config import PRESETS

    preset = PRESETS["ggnn_hole_binary"]
    flagship = ["--preset", "ggnn_hole_binary", "--lr", "2e-3"]
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        paths = {}
        train_df = pd.read_csv(TRAIN_CSV).head(N_PAIRS)
        val_df = pd.read_csv(VALID_CSV).head(N_VAL)
        for name, frame in (("train", train_df), ("val", val_df),
                            ("small", train_df.head(N_OPTION_PAIRS)),
                            ("small_val", val_df.head(N_OPTION_PAIRS)),
                            ("test", df)):
            paths[name] = os.path.join(tmp, f"{name}.csv")
            frame.to_csv(paths[name], index=False)

        def train(tag, flags, train_csv, val_csv, epochs, n_pairs):
            run = os.path.join(tmp, tag.replace(" ", "_").replace("+", ""))
            step_losses = []
            real_step = train_loop.train_step

            def recording_step(*args, **kwargs):
                loss = real_step(*args, **kwargs)
                step_losses.append(loss)
                return loss

            train_loop.train_step = recording_step
            try:
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = train_cli.main([
                    "--train", paths[train_csv], "--val", paths[val_csv],
                    *flags, "--batch-size", str(SERVE_BATCH), "--epochs",
                    str(epochs), "--seed", str(SEED), "--device", "cuda",
                    "--out", run])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = read_counts()
            finally:
                train_loop.train_step = real_step
            losses = torch.stack(step_losses).cpu().numpy()
            want_steps = epochs * (2 * n_pairs // SERVE_BATCH)
            with open(os.path.join(run, "config.json")) as f:
                path = json.load(f)["compute_path"]
            with open(os.path.join(run, "log.json")) as f:
                log = json.load(f)
            print(f"padded train ({tag}): train.main ran {len(losses)} steps "
                  f"of batch {SERVE_BATCH} on compute_path={path!r} in "
                  f"{wall:.3f} s on {smi}; step losses {losses.tolist()[:3]} "
                  f"... {losses.tolist()[-3:]}; kernel launches "
                  f"{sum(launches.values())}")
            if rc != 0 or len(losses) != want_steps or path != "padded":
                raise AssertionError(f"padded {tag}: rc {rc}, {len(losses)} "
                                     f"steps, compute_path {path!r}")
            if any(launches.values()):
                raise AssertionError(f"padded {tag}: kernels launched on a "
                                     f"path that runs none: {launches}")
            if not np.all(np.isfinite(losses)) or not all(
                    np.isfinite(e["val/loss"]) and np.isfinite(e["val/roc_auc"])
                    for e in log):
                raise AssertionError(f"padded {tag}: loss or val metrics not "
                                     "finite")
            return run, losses

        # a. the flagship on padded, explicit and by default
        run, losses = train("flagship", flagship + ["--compute-path",
                                                    "padded"],
                            "train", "val", TRAIN_EPOCHS, N_PAIRS)
        k = min(5, len(losses) // 3)
        if not losses[-k:].mean() < losses[:k].mean():
            raise AssertionError("padded flagship: training loss not falling")
        train("flagship default path", flagship, "train", "val", 1, N_PAIRS)
        # b. the options of the padded layout, and GWM, two steps each
        for tag, flags in PADDED_OPTIONS:
            train(tag, flagship + flags, "small", "small_val", 1,
                  N_OPTION_PAIRS)
        train("gwm", GWM_FLAGS, "small", "small_val", 1, N_OPTION_PAIRS)

        # c. the flagship's best scored on the card and on the CPU, through
        # the evaluate and predict CLIs, both on PairEvaluator
        used = collections.Counter()
        saved = {cls: cls.evaluate for cls in (
            evaluate_module.PairEvaluator, evaluate_module.PackedPairEvaluator)}

        def counting(cls):
            def evaluate(self, ds):
                used[cls.__name__] += 1
                return saved[cls](self, ds)
            return evaluate

        scored, served = {}, {}
        try:
            for cls in saved:
                cls.evaluate = counting(cls)
            for where in ("cuda", "cpu"):
                out = os.path.join(tmp, f"eval_{where}")
                t0 = time.perf_counter()
                rc = evaluate_cli.main(["--test", paths["test"], "--run", run,
                                        "--batch-size", str(SERVE_BATCH),
                                        "--out", out, "--device", where])
                t_eval = time.perf_counter() - t0
                with open(os.path.join(out, "eval_result.json")) as f:
                    scored[where] = json.load(f)
                scored[where]["y"] = pd.read_csv(
                    os.path.join(out, "test_e_y.csv"))["y"].to_numpy()
                pred = os.path.join(tmp, f"pred_{where}.csv")
                t0 = time.perf_counter()
                rc |= predict.main(["--input", paths["test"], "--run", run,
                                    "--out", pred, "--batch-size",
                                    str(SERVE_BATCH), "--device", where])
                t_pred = time.perf_counter() - t0
                served[where] = pd.read_csv(pred)["prob"].to_numpy()
                print(f"padded scoring on {where}: evaluate CLI {t_eval:.3f} "
                      f"s (roc_auc {scored[where]['roc_auc']:.6f}, prc_auc "
                      f"{scored[where]['prc_auc']:.6f}), predict CLI "
                      f"{t_pred:.3f} s, {N_PAIRS} pairs")
                if rc != 0:
                    raise AssertionError(f"padded scoring on {where} failed")
        finally:
            for cls, fn in saved.items():
                cls.evaluate = fn
        if used["PackedPairEvaluator"] or used["PairEvaluator"] != 4:
            raise AssertionError(f"the CLIs scored a padded run with {used}")
        for key in ("roc_auc", "prc_auc"):
            d = abs(scored["cuda"][key] - scored["cpu"][key])
            print(f"padded scoring: {key} card vs CPU |diff|={d:.3e}")
            if d > 1e-3:
                raise AssertionError(f"padded {key} differs card vs CPU")
        for name, a, b in (("evaluate CLI probs", scored["cuda"]["y"],
                            scored["cpu"]["y"]),
                           ("predict CLI probs", served["cuda"],
                            served["cpu"])):
            compare(f"padded {name} (card vs CPU)", torch.as_tensor(a),
                    torch.as_tensor(b), torch)
        check_ds = CSVPairParser().parse(df.head(N_CPU_CHECK)).dataset
        logits = {}
        for where in ("cuda", "cpu"):
            _, model = load_run(run, "best", where)
            logits[where] = evaluate_module.PairEvaluator(
                model, batch_size=SERVE_BATCH, device=where,
                with_metrics=False).evaluate(check_ds).logits
        compare("padded served logits (card vs CPU, same weights)",
                torch.as_tensor(logits["cuda"]),
                torch.as_tensor(logits["cpu"]), torch)

    # d. the step, padded against the K2/K2b step, at 256 and 2048
    train_ds = CSVPairParser().parse(train_df).dataset
    config = dict(cfg, sim_method="hole", net_hidden_dims=[], class_num=1)
    kwargs = padded_kwargs_from_config(config)
    train_cfg = dataclasses.replace(preset, batch_size=SERVE_BATCH)
    for bs in (SERVE_BATCH, N_PAIRS):
        padded_ms = time_padded_step("flagship padded", train_ds, kwargs,
                                     train_cfg, bs, 10, dev, smi)
        k2_ms = time_train_step("flagship K2/K2b", train_ds, cfg, train_cfg,
                                bs, 10, dev, smi)
        print(f"padded vs K2/K2b step at batch {bs}: {padded_ms:.3f} / "
              f"{k2_ms:.3f} ms = {padded_ms / k2_ms:.2f}x")

    # e. serving: padded and packed evaluators on the 2048 test pairs
    tree = init_params(cfg, SEED)
    test_ds = CSVPairParser().parse(df).dataset
    evaluators = {
        "padded": evaluate_module.PairEvaluator(
            from_jax_params(tree, set_up_predictor(**kwargs)),
            batch_size=SERVE_BATCH, device=dev, with_metrics=False),
        "packed": evaluate_module.PackedPairEvaluator(
            from_jax_params(tree, make_packed_predictor(**cfg)),
            batch_size=SERVE_BATCH, device=dev, with_metrics=False)}
    served_logits = {}
    for name, ev in evaluators.items():
        ev.evaluate(test_ds)  # first-use costs stay untimed
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served_logits[name] = ev.evaluate(test_ds).logits
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        print(f"{name} serving: {len(test_ds)} pairs at batch {SERVE_BATCH} "
              f"in {wall:.3f} s = {len(test_ds) / wall:.1f} pairs/s (host "
              f"batching, copy and device, warm) on {smi}; K2 launches "
              f"{launches['fused_ggnn_readout']}, all {sum(launches.values())}")
        if (name == "padded") == bool(sum(launches.values())):
            raise AssertionError(f"{name} serving launched {launches}")
    compare("padded vs packed served logits (same weights)",
            torch.as_tensor(served_logits["padded"]),
            torch.as_tensor(served_logits["packed"]), torch)

    # f. the entry twin, card against CPU
    forward, args = entry.entry("cuda")
    cpu_forward, cpu_args = entry.entry("cpu")
    with torch.no_grad():
        got, want = forward(*args).cpu(), cpu_forward(*cpu_args)
    err = float((got - want).abs().max())
    print(f"entry twin: logits {tuple(got.shape)} card vs CPU max_abs_err="
          f"{err:.3e}")
    if got.shape != (8, 1) or not err <= 1e-5:
        raise AssertionError("entry twin: the card disagrees with the CPU")


# phase 15: the analysis routes, card against CPU: atom saliency through
# the evaluate CLI, fixed-embedding runs through the train and predict
# CLIs, the graph auto-encoder
SALIENCY_COUNT = 64
SALIENCY_METHODS = ("gradient", "integrated", "bayes")
SAL_ATOL, SAL_RTOL = 1e-5, 1e-4
FIXED_EPOCHS = 2
FIXED_TOL, FIXED_AUC_TOL = 1e-5, 1e-4
# card and CPU train step for step alike on a prefix of the train split
# (FIXED_PREFIX_STEPS steps of 128 per epoch); over the whole split the
# head's f32 trajectory forks at rounding level: on the mol2vec table the
# card and the CPU end 2 epochs with losses 8e-3, probs 0.2 and val AUROC
# 2e-3 apart, and so does the card against itself from one kernel element
# moved by 1e-7 of itself (``nudged_spread`` prints it each run; H100
# 80GB HBM3 at 700 W).  The whole split is held to the same model
# quality: val AUROC within 5x that spread
FIXED_PREFIX_STEPS = 100
FIXED_FULL_AUC_TOL = 0.01
GAE_EPOCHS = 200
GAE_TOL = 1e-4
CARD = "cuda"  # the device phase 15 holds against the CPU
DRUG_LIST = os.path.join(ROOT, "dataset", "synth546", "drug_list.csv")


def sync(torch):
    if CARD == "cuda":
        torch.cuda.synchronize()


def svg_fills(svg):
    """An SVG's text with each fill taken out, and the fills as (r, g, b)."""
    fills = re.findall(r'fill="#([0-9a-f]{6})"', svg)
    return (re.sub(r'fill="#[0-9a-f]{6}"', "fill", svg),
            [tuple(int(f[i:i + 2], 16) for i in (0, 2, 4)) for f in fills])


@contextlib.contextmanager
def recorded(module, name, torch, log):
    """Wrap ``module.name`` so that each call appends (seconds, result) to
    ``log``, the device synchronized around it."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        sync(torch)
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        sync(torch)
        log.append((time.perf_counter() - t0, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def no_launches(what, launches, allowed=None):
    """Fail when a kernel launched beyond ``allowed`` (name -> count)."""
    allowed = allowed or {}
    extra = {k: v for k, v in launches.items() if v != allowed.get(k, 0)}
    if extra:
        raise AssertionError(f"{what}: kernel launches {extra}, expected "
                             f"{allowed or 'none'}")


def saliency_runs(tag, run, test_path, out_root, smi, reset_counts,
                  read_counts, k2_batches):
    """The evaluate CLI with each ``--saliency`` method on the card and
    on the CPU: the per-atom maps (recorded from ``atom_saliency``) within
    SAL_ATOL + SAL_RTOL |cpu|, the SVGs with the same layout and each
    atom's colour within one step of 255; no kernel but K2 for the
    metrics (``k2_batches`` per card call).  Returns ms per pair per
    method on the card."""
    import numpy as np
    import torch

    from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli
    from gcnbmp_tpu_torch.convert import load_params_npz
    from gcnbmp_tpu_torch.data import CSVPairParser
    from gcnbmp_tpu_torch.data.dataset import make_batch
    from gcnbmp_tpu_torch.eval import saliency as saliency_module
    from gcnbmp_tpu_torch.train.checkpoints import padded_predictor

    # warm the card up: each method once on the run's padded predictor
    with open(os.path.join(run, "config.json")) as f:
        config = json.load(f)
    model = padded_predictor(config, load_params_npz(
        os.path.join(run, "best", "params.npz"))).to(CARD)
    batch = make_batch(CSVPairParser().parse(test_path).dataset,
                       list(range(SALIENCY_COUNT)))
    for method in SALIENCY_METHODS:
        saliency_module.atom_saliency(
            model, batch.atoms1, batch.adj1, batch.atoms2, batch.adj2,
            batch.mask1, batch.mask2, method=method)
    k2 = ({"fused_ggnn_readout": k2_batches}
          if k2_batches and CARD == "cuda" else {})
    out = {}
    for method in SALIENCY_METHODS:
        maps, secs, dirs = {}, {}, {}
        for device in (CARD, "cpu"):
            log = []
            dirs[device] = os.path.join(out_root, f"{method}_{device}")
            reset_counts()
            with recorded(saliency_module, "atom_saliency", torch, log):
                rc = evaluate_cli.main([
                    "--test", test_path, "--run", run, "--batch-size",
                    str(SERVE_BATCH), "--saliency", method,
                    "--saliency-count", str(SALIENCY_COUNT),
                    "--out", dirs[device], "--device", device])
            if rc != 0 or len(log) != 1:
                raise AssertionError(f"{tag} --saliency {method} on {device}:"
                                     f" rc {rc}, {len(log)} saliency calls")
            no_launches(f"{tag} --saliency {method} on {device}",
                        read_counts(), k2 if device == CARD else {})
            secs[device], maps[device] = log[0]
        err = 0.0
        for side in ("mol1", "mol2"):
            got, want = maps[CARD][side], maps["cpu"][side]
            if got.shape != want.shape or got.shape[0] != SALIENCY_COUNT \
                    or not np.all(np.isfinite(got)) or not np.any(got > 0):
                raise AssertionError(f"{tag} {method} {side}: shape "
                                     f"{got.shape}, finite and non-zero?")
            bad = np.abs(got - want) > SAL_ATOL + SAL_RTOL * np.abs(want)
            if bad.any():
                raise AssertionError(
                    f"{tag} {method} {side}: {int(bad.sum())} atoms off, max "
                    f"abs err {np.abs(got - want).max():.3g}")
            err = max(err, float(np.abs(got - want).max()))
        names = sorted(os.listdir(os.path.join(dirs[CARD], "saliency")))
        if names != sorted(os.listdir(os.path.join(dirs["cpu"], "saliency"))) \
                or len(names) != 2 * SALIENCY_COUNT:
            raise AssertionError(f"{tag} {method}: SVG files differ")
        step = 0
        for name in names:
            texts = []
            for device in (CARD, "cpu"):
                with open(os.path.join(dirs[device], "saliency", name)) as f:
                    texts.append(svg_fills(f.read()))
            (a, fa), (b, fb) = texts
            if a != b or len(fa) != len(fb):
                raise AssertionError(f"{tag} {method} {name}: layouts differ")
            step = max([step] + [abs(x - y) for p, q in zip(fa, fb)
                                 for x, y in zip(p, q)])
        if step > 1:
            raise AssertionError(f"{tag} {method}: an atom's colour moved "
                                 f"{step} steps of 255")
        out[method] = secs[CARD] * 1e3 / SALIENCY_COUNT
        print(f"phase 15 saliency {tag} {method}: {out[method]:.4f} ms per "
              f"pair on the card, {secs['cpu'] * 1e3 / SALIENCY_COUNT:.4f} "
              f"on the CPU ({SALIENCY_COUNT} pairs, padded predictor); maps "
              f"max abs err {err:.3g}; {len(names)} SVGs, colours within "
              f"{step} step; on {smi}")
    return out


def fixed_runs(tag, table, train_path, test_path, tmp, reset_counts,
               read_counts):
    """The train CLI's ``--fixed-embeddings`` over ``table`` on
    ``train_path`` (validating on the drug split's valid pairs), then the
    predict CLI on the run, on the card and on the CPU; no kernel may
    launch.  Returns device -> (the training's result, the test probs,
    steps/s of ``train_fixed_embedding_head``)."""
    import numpy as np
    import pandas as pd
    import torch

    from gcnbmp_tpu_torch.cli import predict
    from gcnbmp_tpu_torch.cli import train as train_cli
    from gcnbmp_tpu_torch.train import fixed as fixed_module

    res = {}
    steps = FIXED_EPOCHS * (len(pd.read_csv(train_path)) // 128)
    for device in (CARD, "cpu"):
        run = os.path.join(tmp, f"fixed_{tag.replace(' ', '_')}_{device}")
        log = []
        reset_counts()
        with recorded(fixed_module, "train_fixed_embedding_head", torch, log):
            rc = train_cli.main([
                "--train", train_path, "--val", VALID_CSV,
                "--fixed-embeddings", table, "--epochs", str(FIXED_EPOCHS),
                "--out", run, "--device", device])
        if rc != 0 or len(log) != 1:
            raise AssertionError(f"fixed {tag} on {device}: rc {rc}")
        secs, result = log[0]
        preds = os.path.join(run, "preds.csv")
        rc = predict.main(["--input", test_path, "--run", run, "--out", preds,
                           "--device", device])
        no_launches(f"fixed {tag} on {device}", read_counts())
        probs = pd.read_csv(preds)["prob"].to_numpy()
        if rc != 0 or len(probs) != N_PAIRS or not np.all(np.isfinite(probs)) \
                or not np.all(np.isfinite(result["losses"])):
            raise AssertionError(f"fixed {tag} on {device}: not finite")
        res[device] = (result, probs, steps / secs)
    return res


def nudged_spread(tag, table, result, probs, test_path, smi):
    """The card against itself: the whole split's fixed head trained again
    from the CLI's initial tree with one kernel element moved by 1e-7 of
    itself; prints how far its losses, test probs and val AUROC end from
    ``result``'s (the f32 trajectory's own spread, which bounds what any
    other device's rounding can be held to)."""
    import numpy as np
    import pandas as pd
    import torch

    from gcnbmp_tpu_torch.convert import flat_npz, init_module_params
    from gcnbmp_tpu_torch.train import fixed as fixed_module

    vectors = fixed_module.load_embedding_table(table)
    e1, e2, y = fixed_module.pair_embeddings(TRAIN_CSV, vectors)
    val = fixed_module.pair_embeddings(VALID_CSV, vectors)
    tree = init_module_params(fixed_module.build_fixed_predictor(
        "hole", 1, (32, 16), e1.shape[1], device="meta"), 2018)
    node, leaf = tree, next(k for k in flat_npz(tree) if
                            k.endswith("kernel")).split("/")
    for key in leaf[:-1]:
        node = node[key]
    node[leaf[-1]][0, 0] *= np.float32(1 + 1e-7)
    nudged = fixed_module.train_fixed_embedding_head(
        e1, e2, y, val=val, epochs=FIXED_EPOCHS, device=CARD, params=tree)
    test = pd.read_csv(test_path)
    p1 = np.stack([vectors[str(d)] for d in test.drugbank_id_1])
    p2 = np.stack([vectors[str(d)] for d in test.drugbank_id_2])
    with torch.no_grad():
        logits = nudged["predictor"](
            torch.as_tensor(p1, device=CARD),
            torch.as_tensor(p2, device=CARD)).cpu().numpy().ravel()
    loss = np.max(np.abs(np.subtract(nudged["losses"], result["losses"])))
    prob = np.max(np.abs(1 / (1 + np.exp(-logits)) - probs))
    auc = abs(nudged["val_metrics"]["roc_auc"]
              - result["val_metrics"]["roc_auc"])
    print(f"phase 15 fixed {tag} full, the card against itself from "
          f"{'/'.join(leaf)}[0, 0] moved by 1e-7 of itself: losses "
          f"{loss:.3g}, probs {prob:.3g}, val AUROC {auc:.3g} apart; on "
          f"{smi}")


def analysis_slice(kept, df, smi, reset_counts, read_counts):
    """Phase 15: (a) the evaluate CLI's ``--saliency`` on phase 5's
    flagship run and on a RelGCN run trained one epoch; (b) the train
    CLI's ``--fixed-embeddings`` over synth546's mol2vec table and over the
    flagship's exported representations on the drug split's 94,830 train
    pairs, then the predict CLI on each run; (c) ``train_gae`` on the
    drug split's positive train pairs.  Each card against the CPU; no
    kernel launched but K2 for the flagship's metrics."""
    import pickle

    import numpy as np
    import pandas as pd
    import torch

    from gcnbmp_tpu_torch.chem import mol2vec_table
    from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli
    from gcnbmp_tpu_torch.cli import train as train_cli
    from gcnbmp_tpu_torch.models.gae import train_gae

    drugs = pd.read_csv(DRUG_LIST)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        # a. saliency: the flagship (a packed run; saliency through the
        # padded predictor), then RelGCN
        t0 = time.perf_counter()
        test_path = os.path.join(tmp, "test.csv")
        df.head(SALIENCY_COUNT).to_csv(test_path, index=False)
        k2_batches = -(-SALIENCY_COUNT // SERVE_BATCH)
        sal = {"flagship": saliency_runs(
            "flagship", os.path.join(kept, "run"), test_path,
            os.path.join(tmp, "sal_flagship"), smi, reset_counts,
            read_counts, k2_batches)}
        train_path = os.path.join(tmp, "train.csv")
        val_path = os.path.join(tmp, "val.csv")
        pd.read_csv(TRAIN_CSV).head(N_PAIRS).to_csv(train_path, index=False)
        pd.read_csv(VALID_CSV).head(N_VAL).to_csv(val_path, index=False)
        relgcn_run = os.path.join(tmp, "relgcn")
        reset_counts()
        rc = train_cli.main(["--train", train_path, "--val", val_path,
                             "--preset", "relgcn_binary", "--compute-path",
                             "coo", "--epochs", "1", "--batch-size",
                             str(SERVE_BATCH), "--seed", str(SEED), "--out",
                             relgcn_run, "--device", CARD])
        if rc != 0:
            raise AssertionError(f"relgcn train.main returned {rc}")
        no_launches("relgcn training", read_counts())
        sal["relgcn"] = saliency_runs(
            "relgcn", relgcn_run, test_path, os.path.join(tmp, "sal_relgcn"),
            smi, reset_counts, read_counts, 0)
        t_sal = time.perf_counter() - t0

        # b. fixed-embedding runs over two tables
        t0 = time.perf_counter()
        smiles_vec = mol2vec_table(list(drugs.smiles), dim=100, radius=1)
        m2v = {db: smiles_vec[s] for db, s in zip(drugs.drugbank_id,
                                                   drugs.smiles)
               if s in smiles_vec}
        m2v_path = os.path.join(tmp, "mol2vec.pkl")
        with open(m2v_path, "wb") as f:
            pickle.dump(m2v, f)
        # every drug once on each side: the flagship's exported
        # representations of all 546 drugs
        n = len(drugs)
        nxt = np.roll(np.arange(n), -1)
        all_pairs = pd.DataFrame({
            "drugbank_id_1": drugs.drugbank_id,
            "drugbank_id_2": drugs.drugbank_id.to_numpy()[nxt],
            "smiles_1": drugs.smiles, "smiles_2": drugs.smiles.to_numpy()[nxt],
            "label": np.arange(n) % 2})
        all_path = os.path.join(tmp, "all_drugs.csv")
        all_pairs.to_csv(all_path, index=False)
        export = os.path.join(tmp, "export")
        reset_counts()
        rc = evaluate_cli.main(["--test", all_path, "--run",
                                os.path.join(kept, "run"), "--batch-size",
                                str(SERVE_BATCH), "--out", export,
                                "--device", CARD])
        no_launches("flagship export", read_counts(),
                    {"fused_ggnn_readout": -(-n // SERVE_BATCH)}
                    if CARD == "cuda" else {})
        flagship_path = os.path.join(export,
                                     "drug_list_with_representation.csv")
        if rc != 0 or len(pd.read_csv(flagship_path)) != n or len(m2v) != n:
            raise AssertionError(f"tables: flagship export rc {rc}, mol2vec "
                                 f"{len(m2v)} of {n} drugs")
        test2048 = os.path.join(tmp, "test2048.csv")
        df.to_csv(test2048, index=False)
        prefix_path = os.path.join(tmp, "train_prefix.csv")
        pd.read_csv(TRAIN_CSV).head(FIXED_PREFIX_STEPS * 128).to_csv(
            prefix_path, index=False)
        fixed = {}
        for tag, table in (("mol2vec", m2v_path), ("flagship", flagship_path)):
            for part, train_path in (("prefix", prefix_path),
                                     ("full", TRAIN_CSV)):
                res = fixed_runs(f"{tag} {part}", table, train_path,
                                 test2048, tmp, reset_counts, read_counts)
                (rc_, pc, sps), (rcpu, pcpu, sps_cpu) = res[CARD], res["cpu"]
                loss_err = float(np.max(np.abs(np.subtract(
                    rc_["losses"], rcpu["losses"]))))
                prob_err = float(np.max(np.abs(pc - pcpu)))
                auc = rc_["val_metrics"]["roc_auc"]
                auc_err = abs(auc - rcpu["val_metrics"]["roc_auc"])
                n_pairs = len(pd.read_csv(train_path))
                steps = FIXED_EPOCHS * (n_pairs // 128)
                print(f"phase 15 fixed {tag} {part}: {steps} steps of 128 "
                      f"over {n_pairs} train pairs, {sps:.1f} steps/s on the "
                      f"card, {sps_cpu:.1f} on the CPU; losses "
                      f"{rc_['losses']}; val AUROC {auc:.6f} AUPRC "
                      f"{rc_['val_metrics']['prc_auc']:.6f}; card vs CPU: "
                      f"losses {loss_err:.3g}, probs {prob_err:.3g} over "
                      f"{N_PAIRS} test pairs, val AUROC {auc_err:.3g}; on "
                      f"{smi}")
                if part == "prefix" and (loss_err > FIXED_TOL
                                         or prob_err > FIXED_TOL
                                         or auc_err > FIXED_AUC_TOL):
                    raise AssertionError(f"fixed {tag} {part}: card and CPU "
                                         "differ")
                if part == "full" and (auc_err > FIXED_FULL_AUC_TOL
                                       or not auc > 0.5):
                    raise AssertionError(f"fixed {tag} {part}: val AUROC "
                                         f"{auc:.6f}, card vs CPU {auc_err:.3g}")
                if part == "full" and tag == "mol2vec":
                    nudged_spread(tag, table, rc_, pc, test2048, smi)
            fixed[tag] = (sps, auc)
        t_fixed = time.perf_counter() - t0

    # c. the GAE on the drug split's positive train pairs
    t0 = time.perf_counter()
    index = {db: i for i, db in enumerate(drugs.drugbank_id)}
    train = pd.read_csv(TRAIN_CSV)
    pos = train[train.label == 1]
    i = pos.drugbank_id_1.map(index).to_numpy()
    j = pos.drugbank_id_2.map(index).to_numpy()
    adj = np.zeros((len(drugs), len(drugs)), np.float32)
    adj[i, j] = adj[j, i] = 1.0
    reset_counts()
    runs = {}
    for device in (CARD, "cpu"):
        runs[device] = train_gae(adj, dropout=0.0, epochs=GAE_EPOCHS,
                                 device=device)
    err = float(np.max(np.abs(runs[CARD]["embeddings"]
                              - runs["cpu"]["embeddings"])))
    timed = {}
    for epochs in (1, GAE_EPOCHS):
        sync(torch)
        t1 = time.perf_counter()
        r = train_gae(adj, dropout=0.1, epochs=epochs, device=CARD)
        sync(torch)
        timed[epochs] = time.perf_counter() - t1
    no_launches("gae", read_counts())
    ms = (timed[GAE_EPOCHS] - timed[1]) * 1e3 / (GAE_EPOCHS - 1)
    print(f"phase 15 gae: {len(drugs)} drugs, {int(adj.sum()) // 2} edges; "
          f"card vs CPU embeddings at dropout 0 max abs err {err:.3g}; "
          f"dropout 0.1 on the card: val AUROC {r['val']['roc_auc']:.6f} AP "
          f"{r['val']['ap']:.6f}, test AUROC {r['test']['roc_auc']:.6f} AP "
          f"{r['test']['ap']:.6f}, {ms:.4f} ms per epoch "
          f"({timed[GAE_EPOCHS]:.3f} s for {GAE_EPOCHS} epochs with set-up, "
          f"{timed[1]:.3f} s for 1); on {smi}")
    if err > GAE_TOL or not np.isfinite(r["final_loss"]):
        raise AssertionError("gae: card and CPU embeddings differ")
    print(f"phase 15 parts: saliency {t_sal:.1f} s, fixed {t_fixed:.1f} s, "
          f"gae {time.perf_counter() - t0:.1f} s")
    return sal, fixed


# phase 16: GGNN's research options, GGNN-dev, the research predictor,
# MPNN's ggnn forms, and MPNN with co-attention on coo
MPNN_COATTN_FLAGS = (MPNN_FLAGS[:2] + ["--sim-method", "ntn"] + MPNN_FLAGS[4:]
                     + ["--attn", "para"])
MPNN_COATTN_CFG = dict(MPNN_CFG, s2s_n_max=24, sim_method="ntn", attn="para")
DEV_METHODS = ("ggnn-dev", "ggnn-dev-fuse", "ggnn-dev-gate",
               "ggnn-dev-self-loop")
DEV_FLAGS = ["--conv-layers", str(L), "--weight-tying", "false",
             "--fp-hidden-dim", str(H), "--fp-out-dim", str(D),
             "--sim-method", "hole", "--lr", "2e-3", "--augment"]
RESEARCH_EPOCHS = 3  # 2048 train pairs, 4096 augmented: 2 steps of 2048
GGNN_KERNELS = ("fused_ggnn", "fused_ggnn_mid", "fused_ggnn_readout",
                "fused_ggnn_bwd", "fused_ggnn_half_bwd",
                "fused_ggnn_readout_bwd")


def card_vs_cpu(tag, build, args, labels, dev, torch):
    """One forward and backward of ``build()`` (a model on the CPU with its
    weights) on the CPU and on ``dev`` on the same inputs: the logits
    within atol = rtol = 1e-4 and every parameter's gradient of the
    sigmoid cross-entropy within GRAD_RTOL * max|want| + GRAD_ATOL."""
    from gcnbmp_tpu_torch.train.loop import sigmoid_cross_entropy

    out = {}
    for where in ("cpu", dev):
        model = build().to(where)
        logits = model(*(a.to(where) for a in args))
        named = list(model.named_parameters())
        grads = torch.autograd.grad(
            sigmoid_cross_entropy(logits, labels.to(where)),
            [p for _, p in named], allow_unused=True)
        out[str(where)] = (logits.detach().cpu(), [
            (n, (torch.zeros_like(p) if g is None else g).cpu())
            for (n, p), g in zip(named, grads)])
    card, cpu = out[str(dev)], out["cpu"]
    compare(f"{tag} logits (card vs CPU)", card[0], cpu[0], torch)
    compare_grads(f"{tag} gradients (card vs CPU)", card[1], cpu[1], torch)


def research_models():
    """Phase 16c's models, each (tag, build): GGNN (flagship widths) with
    each research option, the research predictor, the padded MPNN
    (quality row widths) with each ggnn form, co-attention over
    concat_hidden; ``build()`` gives the model on the CPU with seeded
    weights."""
    from gcnbmp_tpu_torch.convert import from_jax_params, init_module_params
    from gcnbmp_tpu_torch.models.coattention import build_coattention
    from gcnbmp_tpu_torch.models.ggnn import GGNN
    from gcnbmp_tpu_torch.models.ggnn_dev import GGNNDev
    from gcnbmp_tpu_torch.models.heads import MLPHead, make_head
    from gcnbmp_tpu_torch.models.mpnn import MPNN
    from gcnbmp_tpu_torch.models.predictor import (
        PairPredictor, ResearchPairPredictor, set_up_predictor)

    def seeded(make):
        def build():
            model = make()
            return from_jax_params(init_module_params(model, SEED), model)
        return build

    def pair(encoder):
        return PairPredictor(encoder, make_head("hole", encoder.out_width, 1))

    def research():
        enc = GGNNDev(D, H, L, weight_tying=False, sum_pool_readout=False)
        coattn = build_coattention("para", 2 * H, D)
        left, right = ResearchPairPredictor.head_widths(enc, coattn, True,
                                                        True, mlp=True)
        return ResearchPairPredictor(enc, MLPHead(left, 1, (16,),
                                                  right_dim=right), coattn,
                                     use_s_lstm=True, use_i_lstm=True)

    ggnn = dict(out_dim=D, hidden_dim=H, n_layers=L, weight_tying=False)
    mpnn = dict(out_dim=D, hidden_dim=H, n_layers=MPNN_CFG["conv_layers"])
    options = {"use_attention": dict(use_attention=True,
                                     attention_tying=False),
               "edge_network": dict(message_function="edge_network"),
               "set2vec": dict(readout_function="set2vec"),
               "context": dict(context=True)}
    forms = {"ggnn message": dict(message_func="ggnn"),
             "ggnn readout": dict(readout_func="ggnn"),
             "ggnn message and readout": dict(message_func="ggnn",
                                              readout_func="ggnn")}
    models = [(f"GGNN {k}", seeded(lambda kw=kw: pair(GGNN(**ggnn, **kw))))
              for k, kw in options.items()]
    models.append(("research predictor (s and i LSTMs, para, MLP head)",
                   seeded(research)))
    models += [(f"MPNN {k}", seeded(lambda kw=kw: pair(MPNN(**mpnn, **kw))))
               for k, kw in forms.items()]
    models.append(("co-attention para over concat_hidden", seeded(
        lambda: set_up_predictor(
            method="ggnn", fp_hidden_dim=H, fp_out_dim=D, conv_layers=L,
            concat_hidden=True, weight_tying=False, sim_method="ntn",
            attn_model="para"))))
    return models


def research_slice(df, dev, smi, reset_counts, read_counts):
    """Phase 16: (a) MPNN + para + NTN on coo through the train CLI (K5b
    and K4b once per step), then the evaluate CLI on the card and the
    CPU, and one batch's logits and gradients card against CPU; (b) the
    four GGNN-dev methods through the train CLI on the padded layout, the
    predict and evaluate CLIs, the served logits card against CPU, each
    step timed at 2048 (the first method at 256 too); (c) the research
    modules card against CPU at batch 2048.  No kernel may launch in (b)
    and (c).  Returns (a)'s training
    launch counts."""
    import numpy as np
    import pandas as pd
    import torch

    from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli
    from gcnbmp_tpu_torch.cli import predict
    from gcnbmp_tpu_torch.cli import train as train_cli
    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.data import CSVPairParser, estimate_coo_capacities
    from gcnbmp_tpu_torch.data.dataset import (
        bucket_size, make_batch, padded_args)
    from gcnbmp_tpu_torch.data.wire import iter_coo_eval_batches
    from gcnbmp_tpu_torch.eval.evaluate import PairEvaluator
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor
    from gcnbmp_tpu_torch.models.predictor import padded_kwargs_from_config
    from gcnbmp_tpu_torch.train import loop as train_loop
    from gcnbmp_tpu_torch.train.checkpoints import load_run
    from gcnbmp_tpu_torch.train.config import TrainConfig

    times = {}
    n_batches = -(-N_PAIRS // SERVE_BATCH)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        test_path = os.path.join(tmp, "test.csv")
        df.to_csv(test_path, index=False)

        def scored(run, where, kernels=()):
            """The evaluate CLI on ``run``'s best on ``where``: its probs and
            metrics; on the card each of ``kernels`` once per batch and no
            other kernel."""
            out = os.path.join(tmp, f"eval_{os.path.basename(run)}_{where}")
            reset_counts()
            t0 = time.perf_counter()
            rc = evaluate_cli.main(["--test", test_path, "--run", run,
                                    "--batch-size", str(SERVE_BATCH),
                                    "--out", out, "--device", where])
            wall = time.perf_counter() - t0
            launches = read_counts()
            with open(os.path.join(out, "eval_result.json")) as f:
                result = json.load(f)
            probs = pd.read_csv(os.path.join(out, "test_e_y.csv"))["y"]
            print(f"phase 16 evaluate CLI on {where} ({os.path.basename(run)}"
                  f"): {wall:.3f} s, roc_auc {result['roc_auc']:.6f}, "
                  f"prc_auc {result['prc_auc']:.6f}; launches "
                  f"{ {k: v for k, v in launches.items() if v} }")
            if rc != 0 or len(probs) != N_PAIRS or not np.isfinite(
                    result["roc_auc"]):
                raise AssertionError(f"evaluate CLI on {run} ({where})")
            if where == "cuda" and {k: v for k, v in launches.items() if v} \
                    != {k: n_batches for k in kernels}:
                raise AssertionError(f"evaluate CLI launched {launches}, "
                                     f"expected {kernels} once per batch")
            return probs.to_numpy().copy(), result

        def card_and_cpu_scores(tag, run, kernels=()):
            (p_card, r_card), (p_cpu, r_cpu) = (
                scored(run, "cuda", kernels), scored(run, "cpu"))
            compare(f"{tag} evaluate CLI probs (card vs CPU)",
                    torch.as_tensor(p_card), torch.as_tensor(p_cpu), torch)
            for key in ("roc_auc", "prc_auc"):
                if abs(r_card[key] - r_cpu[key]) > 1e-3:
                    raise AssertionError(f"{tag}: {key} card vs CPU")

        # a. MPNN + para + NTN on coo: K5, K5b, K4, K4b per step
        t0 = time.perf_counter()
        coattn_train = TrainConfig(
            method="mpnn", sim_method="ntn", attn="para", conv_layers=4,
            weight_tying=True, fp_hidden_dim=H, fp_out_dim=D,
            learning_rate=2e-3, compute_path="coo",
            compute_dtype="bfloat16", augment=True, batch_size=N_PAIRS)
        kept = os.path.join(tmp, "mpnn_coattn")
        os.makedirs(kept)
        launches, train_ds = train_slice(
            "mpnn co-attention (para, ntn)", MPNN_COATTN_FLAGS, N_PAIRS,
            coattn_train, MPNN_COATTN_CFG,
            {"fused_mpnn_bwd": 1, "fused_set2set_bwd": 1},
            ["fused_mpnn", "fused_set2set"],
            ((SERVE_BATCH, 10), (N_PAIRS, 10)), dev, smi, reset_counts,
            read_counts, epochs=RESEARCH_EPOCHS, absent=GGNN_KERNELS,
            keep_dir=kept)
        card_and_cpu_scores("mpnn co-attention", os.path.join(kept, "run"),
                            ("fused_mpnn", "fused_set2set"))
        tree = init_params(MPNN_COATTN_CFG, SEED)
        cpu_model = from_jax_params(tree, make_packed_predictor(
            **MPNN_COATTN_CFG))
        tiles, cap = estimate_coo_capacities([train_ds], SERVE_BATCH)
        batch, _ = next(iter_coo_eval_batches(train_ds, SERVE_BATCH, tiles,
                                              cap))
        args = [torch.as_tensor(np.asarray(a))
                for a in cpu_model.wire_encoder([train_ds])(batch)]
        card_vs_cpu("mpnn co-attention batch 256 (kernels vs plain twins)",
                    lambda: from_jax_params(tree, make_packed_predictor(
                        **MPNN_COATTN_CFG)), args,
                    torch.as_tensor(batch.labels), dev, torch)
        times["a"] = time.perf_counter() - t0

        # b. the GGNN-dev methods on the padded layout
        t0 = time.perf_counter()
        paths = {}
        for name, frame in (("train", pd.read_csv(TRAIN_CSV).head(N_PAIRS)),
                            ("val", pd.read_csv(VALID_CSV).head(N_VAL))):
            paths[name] = os.path.join(tmp, f"{name}.csv")
            frame.to_csv(paths[name], index=False)
        dev_ds = CSVPairParser().parse(paths["train"]).dataset
        test_ds = CSVPairParser().parse(df).dataset
        for method in DEV_METHODS:
            run = os.path.join(tmp, method)
            step_losses = []
            real_step = train_loop.train_step

            def recording_step(*a, **kw):
                loss = real_step(*a, **kw)
                step_losses.append(loss)
                return loss

            train_loop.train_step = recording_step
            try:
                reset_counts()
                t1 = time.perf_counter()
                rc = train_cli.main([
                    "--train", paths["train"], "--val", paths["val"],
                    "--method", method, *DEV_FLAGS, "--batch-size",
                    str(N_PAIRS), "--epochs", str(RESEARCH_EPOCHS), "--seed",
                    str(SEED), "--device", "cuda", "--out", run])
                wall = time.perf_counter() - t1
                launches_b = read_counts()
            finally:
                train_loop.train_step = real_step
            losses = torch.stack(step_losses).cpu().numpy()
            k = len(losses) // 3
            first, last = float(losses[:k].mean()), float(losses[-k:].mean())
            print(f"{method} train: train.main ran {len(losses)} steps of "
                  f"batch {N_PAIRS} (L={L} untied, H=D={H}, HolE, padded) in "
                  f"{wall:.3f} s on {smi}; step loss mean first {k} "
                  f"{first:.5f}, last {k} {last:.5f}; kernel launches "
                  f"{sum(launches_b.values())}")
            if rc != 0 or len(losses) != RESEARCH_EPOCHS * 2:
                raise AssertionError(f"{method}: rc {rc}, {len(losses)} steps")
            if any(launches_b.values()):
                raise AssertionError(f"{method}: kernels launched on a path "
                                     f"that runs none: {launches_b}")
            if not np.all(np.isfinite(losses)) or not last < first:
                raise AssertionError(f"{method}: training loss not finite or "
                                     "not falling")
            pred = os.path.join(tmp, f"{method}.csv")
            reset_counts()
            rc = predict.main(["--input", test_path, "--run", run, "--out",
                               pred, "--batch-size", str(SERVE_BATCH),
                               "--device", "cuda"])
            probs = pd.read_csv(pred)["prob"].to_numpy()
            if rc != 0 or any(read_counts().values()) or len(probs) != \
                    N_PAIRS or not np.all((probs >= 0) & (probs <= 1)):
                raise AssertionError(f"{method}: the predict CLI did not serve")
            scored(run, "cuda")
            # the served logits, card against CPU: GGNN-dev sums h over the
            # atoms unscaled, so its logits reach 1e3-1e4 (gate), and f32
            # rounding of such sums moves a logit near 0 by more than 1e-4
            # of itself: held as a tensor, to 1e-4 of its largest logit
            logits = {}
            for where in ("cuda", "cpu"):
                _, model = load_run(run, "best", where)
                logits[where] = torch.as_tensor(PairEvaluator(
                    model, batch_size=SERVE_BATCH, device=where,
                    with_metrics=False).evaluate(test_ds).logits)
            print(f"{method} served logits: max |logit| "
                  f"{float(logits['cpu'].abs().max()):.1f}")
            compare_grads(f"{method} served logits (card vs CPU, as a tensor)",
                          [("logits", logits["cuda"])],
                          [("logits", logits["cpu"])], torch)
            with open(os.path.join(run, "config.json")) as f:
                config = json.load(f)
            train_cfg = TrainConfig.from_dict(config)
            # both batches for the first method, batch 2048 for the others
            for bs in (SERVE_BATCH, N_PAIRS)[method != DEV_METHODS[0]:]:
                time_padded_step(method, dev_ds,
                                 padded_kwargs_from_config(config),
                                 train_cfg, bs, 5, dev, smi)
        times["b"] = time.perf_counter() - t0

        # c. the research modules, card against CPU at batch 2048
        t0 = time.perf_counter()
        batch = make_batch(dev_ds, list(range(N_PAIRS)),
                           bucket_size(dev_ds.max_atoms()))
        args, _, labels = padded_args(batch, "cpu")
        reset_counts()
        for tag, build in research_models():
            card_vs_cpu(f"{tag}, padded batch {N_PAIRS}", build, args, labels,
                        dev, torch)
        if any(read_counts().values()):
            raise AssertionError(f"phase 16c launched {read_counts()}")
        times["c"] = time.perf_counter() - t0
    print("phase 16 parts (s): " + json.dumps(
        {k: round(v, 1) for k, v in times.items()}))
    return launches


# phase 17: graph-sharded training (--multi-device) through the train CLI:
# (tag, train CLI flags, kernels once per step, kernels at least once per
# step, kernels that must not launch); batch 256 on phase 5's 2048 train
# pairs (4096 with augmentation: 16 steps), one epoch
MULTI_DEVICE_RUNS = [
    ("flagship", ["--preset", "ggnn_hole_binary", "--compute-path", "coo"],
     ["fused_ggnn_readout_bwd"], ["fused_ggnn_readout"],
     ["fused_ggnn", "fused_ggnn_bwd"]),
    ("co-attention (para, ntn, pair-local)",
     ["--method", "ggnn", "--conv-layers", str(L), "--fp-hidden-dim", str(H),
      "--fp-out-dim", str(D), "--weight-tying", "false", "--compute-path",
      "coo", "--lr", "2e-3", "--augment", "--sim-method", "ntn", "--attn",
      "para"],
     ["fused_ggnn_bwd"], ["fused_ggnn"],
     ["fused_ggnn_readout", "fused_ggnn_readout_bwd"]),
    ("mpnn", MPNN_FLAGS, ["fused_mpnn_bwd", "fused_set2set_bwd"],
     ["fused_mpnn", "fused_set2set"], []),
]


def record_train_cli(argv, reset_counts, read_counts):
    """The train CLI in this process with each step's loss recorded and
    timed (host clock between synchronizations around the step), and
    steps 5-8 profiled: (losses, step ms, launch counts, "device busy
    share, kernel launches per step")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gcnbmp_tpu_torch.cli import train as train_cli
    from gcnbmp_tpu_torch.train import loop as train_loop

    losses, times, prof = [], [], {}
    real_step = train_loop.train_step

    def recording_step(*args, **kwargs):
        if len(losses) == 4:
            prof["p"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            prof["p"].start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = real_step(*args, **kwargs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if len(losses) == 8:
            prof["p"].stop()
            kernels = [e for e in prof["p"].key_averages()
                       if getattr(e, "device_type", None) == DeviceType.CUDA]
            dev_us = sum(getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
                         for e in kernels)
            prof["line"] = (f"device busy {dev_us / 10 / sum(times[4:8]):.1f}%"
                            f", {sum(e.count for e in kernels) / 4:.0f} "
                            "kernel launches per step (profiled, steps 5-8)")
        return loss

    train_loop.train_step = recording_step
    try:
        reset_counts()
        rc = train_cli.main(argv)
        launches = read_counts()
    finally:
        train_loop.train_step = real_step
    if rc != 0:
        raise AssertionError(f"train.main returned {rc}")
    return losses, times, launches, prof.get("line", "not profiled")


def kernel_wrappers():
    """The ten kernel wrappers by name; each counts its launches in
    ``launches``."""
    from gcnbmp_tpu_torch.ops.fused_ggnn import (
        fused_ggnn, fused_ggnn_bwd, fused_ggnn_half_bwd, fused_ggnn_mid,
        fused_ggnn_readout, fused_ggnn_readout_bwd)
    from gcnbmp_tpu_torch.ops.fused_mpnn import fused_mpnn, fused_mpnn_bwd
    from gcnbmp_tpu_torch.ops.set2set_kernel import (
        fused_set2set, fused_set2set_bwd)

    return {"fused_ggnn": fused_ggnn, "fused_ggnn_mid": fused_ggnn_mid,
            "fused_ggnn_readout": fused_ggnn_readout,
            "fused_ggnn_bwd": fused_ggnn_bwd,
            "fused_ggnn_half_bwd": fused_ggnn_half_bwd,
            "fused_ggnn_readout_bwd": fused_ggnn_readout_bwd,
            "fused_mpnn": fused_mpnn, "fused_mpnn_bwd": fused_mpnn_bwd,
            "fused_set2set": fused_set2set,
            "fused_set2set_bwd": fused_set2set_bwd}


def _gloo_rank(runs, out_dir):
    """One rank of phase 17's two gloo ranks on the one card: each
    ``(tag, argv)`` of ``runs`` through the train CLI (the process group
    set up by ``launch``); writes this rank's step losses, kernel
    launches and a digest of its final parameters for each run to
    ``out_dir/rank<r>.json``."""
    import hashlib

    import torch.distributed as dist

    from gcnbmp_tpu_torch.cli import train as train_cli
    from gcnbmp_tpu_torch.train import loop as train_loop

    wrappers = kernel_wrappers()
    real_step, real_fit = train_loop.train_step, train_loop.Trainer.fit
    out = {}
    for tag, argv in runs:
        rec = {"losses": []}

        def recording_step(*args, **kwargs):
            loss = real_step(*args, **kwargs)
            rec["losses"].append(float(loss))
            return loss

        def digest_fit(self, *args, **kwargs):
            result = real_fit(self, *args, **kwargs)
            h = hashlib.sha256()
            for name, v in self.model.state_dict().items():
                h.update(name.encode())
                h.update(v.detach().cpu().numpy().tobytes())
            rec["digest"] = h.hexdigest()
            return result

        for fn in wrappers.values():
            fn.launches = 0
        train_loop.train_step, train_loop.Trainer.fit = (recording_step,
                                                         digest_fit)
        try:
            if train_cli.main(argv) != 0:
                raise AssertionError(f"{tag}: train.main failed")
        finally:
            train_loop.train_step, train_loop.Trainer.fit = real_step, real_fit
        rec["launches"] = {name: fn.launches for name, fn in wrappers.items()}
        out[tag] = rec
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.json"), "w") as f:
        json.dump(out, f)


def check_launches(tag, launches, n, per_step, fwd, absent):
    """Each kernel of ``per_step`` launched once per step of ``n``, each
    of ``fwd`` at least once per step, none of ``absent``."""
    for name in per_step:
        if launches[name] != n:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} "
                                 f"times in {n} steps")
    for name in fwd:
        if launches[name] < n:
            raise AssertionError(f"{tag}: {name} launched fewer times than "
                                 "steps")
    for name in absent:
        if launches[name]:
            raise AssertionError(f"{tag}: {name} launched")


def multi_device_slice(dev, smi, reset_counts, read_counts):
    """Phase 17: each run of ``MULTI_DEVICE_RUNS`` through the train CLI
    on the card single-device, then with ``--multi-device`` (NCCL, one
    rank: the one card); the step losses equal within 1e-5, each kernel's
    launches per step checked, each step's time.  Then every run over two
    ranks on the one card with gloo, whose collectives (all-reduce and
    broadcast, the only ones the COO and pair-local forms use) take CUDA
    tensors: both ranks' step losses and final parameters the same bits,
    each rank's kernels once per step, and the losses within 1e-5 of the
    single-device run's, but MPNN's, whose sharded loss sums the Set2Set
    rows of molecules a rank does not hold (as the JAX package's does):
    its gap is printed.  Returns each kernel's launches in the NCCL
    multi-device runs."""
    import numpy as np
    import pandas as pd

    from gcnbmp_tpu_torch.parallel.mesh import launch

    t_start = time.perf_counter()
    multi_launches = collections.Counter()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        train_path = os.path.join(tmp, "train.csv")
        val_path = os.path.join(tmp, "val.csv")
        pd.read_csv(TRAIN_CSV).head(N_PAIRS).to_csv(train_path, index=False)
        pd.read_csv(VALID_CSV).head(N_VAL).to_csv(val_path, index=False)
        single, gloo_runs = {}, []
        for tag, flags, per_step, fwd, absent in MULTI_DEVICE_RUNS:
            base = ["--train", train_path, "--val", val_path, *flags,
                    "--batch-size", str(SERVE_BATCH), "--epochs", "1",
                    "--seed", str(SEED), "--device", "cuda",
                    "--no-eval-train"]
            runs = {}
            for mode, extra in (("single", []),
                                ("multi", ["--multi-device"])):
                argv = base + ["--out", os.path.join(tmp, f"{tag}-{mode}"),
                               *extra]
                runs[mode] = record_train_cli(argv, reset_counts, read_counts)
            (s_loss, s_ms, s_l, s_prof), (m_loss, m_ms, m_l, m_prof) = (
                runs["single"], runs["multi"])
            n = len(m_loss)
            if n != len(s_loss) or n != 2 * N_PAIRS // SERVE_BATCH:
                raise AssertionError(f"{tag}: {n} multi-device steps, "
                                     f"{len(s_loss)} single-device")
            diff = float(np.max(np.abs(np.subtract(m_loss, s_loss))))
            check_launches(tag, m_l, n, per_step, fwd, absent)
            print(f"phase 17 {tag}: {n} steps of batch {SERVE_BATCH}; step "
                  f"losses multi-device (NCCL, 1 rank) vs single-device max "
                  f"|diff| {diff:.3e}; step ms median (host clock around "
                  f"synchronized steps, steps 3..{n}) single "
                  f"{statistics.median(s_ms[2:]):.3f} ({s_prof}), "
                  f"multi-device {statistics.median(m_ms[2:]):.3f} "
                  f"({m_prof}) on {smi}; kernel wrappers' launches single "
                  f"{ {k: v for k, v in s_l.items() if v} } multi "
                  f"{ {k: v for k, v in m_l.items() if v} }")
            if diff > 1e-5:
                raise AssertionError(f"{tag}: multi-device losses differ by "
                                     f"{diff}")
            multi_launches.update(m_l)
            single[tag] = s_loss
            gloo_runs.append((tag, base + [
                "--out", os.path.join(tmp, f"{tag}-gloo"), "--multi-device"]))
        t0 = time.perf_counter()
        launch(_gloo_rank, 2, (gloo_runs, tmp), device_type="cuda",
               backend="gloo", timeout=300)
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        for tag, _, per_step, fwd, absent in MULTI_DEVICE_RUNS:
            r0, r1 = ranks[0][tag], ranks[1][tag]
            n = len(single[tag])
            if len(r0["losses"]) != n:
                raise AssertionError(f"{tag}: {len(r0['losses'])} steps over "
                                     f"2 gloo ranks, {n} single-device")
            same = r0["losses"] == r1["losses"] and \
                r0["digest"] == r1["digest"]
            for r, rec in enumerate((r0, r1)):
                check_launches(f"{tag}, gloo rank {r}", rec["launches"], n,
                               per_step, fwd, absent)
            diff = float(np.max(np.abs(np.subtract(r0["losses"],
                                                   single[tag]))))
            print(f"phase 17 {tag} over 2 gloo ranks on the one card: {n} "
                  f"steps; step losses vs single-device max |diff| "
                  f"{diff:.3e}"
                  + (" (the sharded MPNN loss, ROADMAP queue 3)"
                     if tag == "mpnn" else "")
                  + f"; ranks' losses and parameters the same bits: {same}; "
                  f"launches rank 0 "
                  f"{ {k: v for k, v in r0['launches'].items() if v} } "
                  f"rank 1 { {k: v for k, v in r1['launches'].items() if v} }")
            if not same:
                raise AssertionError(f"{tag}: the 2 gloo ranks' replicas "
                                     "differ")
            if tag != "mpnn" and diff > 1e-5:
                raise AssertionError(f"{tag}: two gloo ranks disagree with "
                                     f"one device by {diff}")
        print(f"phase 17 gloo runs: {time.perf_counter() - t0:.1f} s with "
              "the ranks' start")
    print(f"phase 17: {time.perf_counter() - t_start:.1f} s")
    return dict(multi_launches)


# phase 18: (tag, TrainConfig fields over the preset's, kernels once per
# step, kernels at least once per step, kernels never)
PREFETCH_PATHS = [
    ("flagship coo", dict(compute_path="coo"), ["fused_ggnn_readout_bwd"],
     ["fused_ggnn_readout"], ["fused_ggnn", "fused_ggnn_bwd"]),
    ("co-attention (para, ntn)", dict(compute_path="coo", attn="para",
                                      sim_method="ntn", learning_rate=2e-3),
     ["fused_ggnn_bwd"], ["fused_ggnn"],
     ["fused_ggnn_readout", "fused_ggnn_readout_bwd"]),
    ("mpnn", dict(method="mpnn", conv_layers=4, weight_tying=True,
                  compute_path="coo", compute_dtype="bfloat16",
                  learning_rate=2e-3),
     ["fused_mpnn_bwd", "fused_set2set_bwd"], ["fused_mpnn", "fused_set2set"],
     ["fused_ggnn_readout", "fused_ggnn_readout_bwd"]),
    ("padded flagship", dict(compute_path="padded"), [], [],
     None),  # None: no kernel at all
]
PREFETCH_RACE_CHUNKS = 64


def prefetch_epoch(base, depth, train_ds, dev, out_dir, reset_counts,
                   read_counts, profiled=False):
    """One epoch of ``base`` (a TrainConfig) with ``prefetch=depth``
    through the Trainer on the card, no evaluation: its step losses, the
    epoch's seconds and edges/s (the trainer's log), the launch counts,
    the prefetcher's log entry and, ``profiled``, the device's kernel and
    copy ms over the epoch (torch.profiler, CUDA activity only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gcnbmp_tpu_torch.train import loop as train_loop

    cfg = dataclasses.replace(base, prefetch=depth, out_dir=out_dir)
    trainer = train_loop.Trainer(cfg, train_ds, None, device=dev)
    losses = []
    real_step = train_loop.train_step

    def recording_step(*args, **kwargs):
        loss = real_step(*args, **kwargs)
        losses.append(loss)
        return loss

    train_loop.train_step = recording_step
    try:
        reset_counts()
        with (profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            trainer.fit()
            torch.cuda.synchronize()
        launches = read_counts()
    finally:
        train_loop.train_step = real_step
    entry = trainer.log[-1]
    out = dict(losses=torch.stack(losses).double().cpu().numpy(),
               epoch_s=entry["elapsed_time"], edges_s=entry["edges_per_s"],
               launches=launches,
               prefetch=trainer.prefetch_log[-1] if depth else None)
    if profiled:
        us = {"kernel": 0.0, "copy": 0.0}
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != DeviceType.CUDA:
                continue
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            us["copy" if e.key.startswith(("Memcpy", "Memset"))
               else "kernel"] += t
        out["kernel_ms"], out["copy_ms"] = us["kernel"] / 1e3, us["copy"] / 1e3
    return out


def prefetch_race(train_ds, dev, smi, reset_counts, read_counts, tmp):
    """The prefetcher at depth 2 with 4 transfer threads stages
    ``PREFETCH_RACE_CHUNKS`` and more chunks (batch 256 of the flagship's
    wire, two shuffled passes) through the trainer's transfer and a
    7-slot pinned ring while K2/K2b train steps (learning rate 0, so every
    step sees the same weights) run on the compute stream; each staged
    chunk is read back after its step and compared with its host arrays
    bit for bit, and each step's loss with the loss of the same chunk
    staged on the step's thread (``stage_chunk``)."""
    import numpy as np
    import torch

    from gcnbmp_tpu_torch.data import estimate_coo_capacities
    from gcnbmp_tpu_torch.data.prefetch import PinnedRing, PrefetchIterator
    from gcnbmp_tpu_torch.data.wire import (
        packed_coo_batch_iterator, scan_chunk_iterator)
    from gcnbmp_tpu_torch.train import loop as train_loop
    from gcnbmp_tpu_torch.train.config import PRESETS

    t0 = time.perf_counter()
    depth, workers = 2, 4
    cfg = dataclasses.replace(
        PRESETS["ggnn_hole_binary"], compute_path="coo",
        batch_size=SERVE_BATCH, learning_rate=0.0, augment=False,
        prefetch=depth, prefetch_workers=workers, seed=SEED,
        out_dir=os.path.join(tmp, "race"))
    trainer = train_loop.Trainer(cfg, train_ds, None, device=dev)
    tiles, cap = estimate_coo_capacities([train_ds], SERVE_BATCH)
    args_fn = trainer.model.wire_encoder()
    rng = np.random.default_rng(SEED)
    host = []
    while len(host) < PREFETCH_RACE_CHUNKS:
        host += list(scan_chunk_iterator(packed_coo_batch_iterator(
            train_ds, SERVE_BATCH, tiles, cap, rng), 1, args_fn))
    ring = PinnedRing(dev, depth + workers + 1)

    def step(args, labels):
        return train_loop.train_step(trainer.model, trainer.optimizer,
                                     [a[0] for a in args], labels[0],
                                     trainer.loss_fn)

    losses, mismatched = [], []
    reset_counts()
    with PrefetchIterator(iter(host), depth=depth,
                          transfer=trainer._transfer(ring), workers=workers,
                          device=dev) as staged_chunks:
        for i, staged in enumerate(staged_chunks):
            args, labels, _ = staged.get()
            losses.append(step(args, labels))
            back = [t.cpu().numpy() for t in (*args, labels)]
            want = train_loop.chunk_parts(*host[i][:2])
            if not all(g.dtype == w.dtype and g.shape == w.shape
                       and np.array_equal(g.view(np.int32), w.view(np.int32))
                       for g, w in zip(back, want)):
                mismatched.append(i)
            del args, labels, staged
    launches = read_counts()
    ref = [step(*train_loop.stage_chunk(stacked, labels, dev))
           for stacked, labels, _ in host]
    diff = float((torch.stack(losses) - torch.stack(ref)).abs().max())
    print(f"phase 18 race check: {len(losses)} chunks of batch {SERVE_BATCH} "
          f"staged at depth {depth} by {workers} transfer threads through "
          f"{depth + workers + 1} pinned slots (grown {ring.grown} times) "
          f"while K2/K2b steps ran; chunks read back unequal to their host "
          f"arrays: {mismatched}; step losses vs the same chunks staged on "
          f"the step's thread max |diff| {diff:.3e}; K2b launches "
          f"{launches['fused_ggnn_readout_bwd']}; "
          f"{time.perf_counter() - t0:.1f} s on {smi}")
    if len(losses) < PREFETCH_RACE_CHUNKS or mismatched:
        raise AssertionError(f"race check: {len(losses)} chunks, unequal "
                             f"read-backs {mismatched}")
    if diff > 1e-5:
        raise AssertionError(f"race check: staged losses differ by {diff}")
    if launches["fused_ggnn_readout_bwd"] != len(losses):
        raise AssertionError("race check: K2b not once per step")


def loss_agreement(tag, mode, runs, tol=None):
    """The step losses of ``runs`` ({depth: [losses per run]}), each run
    against the first ``prefetch=0`` run: with ``tol``, within it; else
    the same bits when the ``prefetch=0`` runs give the same bits, or
    within twice the larger spread of two runs of one depth.  The spreads
    are printed."""
    import numpy as np

    base = runs[0][0]
    spread = {d: max(float(np.abs(r - rs[0]).max()) for r in rs)
              for d, rs in runs.items()}
    cross = max(float(np.abs(r - base).max()) for r in runs[2])
    if tol is not None:
        ok, rule = cross <= tol, f"within {tol:g}"
    elif spread[0] == 0.0:
        ok, rule = cross == 0.0, "the same bits"
    else:
        ok = cross <= 2 * max(spread.values())
        rule = "within twice the larger spread"
    print(f"phase 18 {tag}, {mode}: step losses of {len(runs[2])} "
          f"prefetch=2 run(s) vs prefetch=0 max |diff| {cross:.3e}; spread "
          f"of the {len(runs[0])} prefetch=0 runs {spread[0]:.3e}, of the "
          f"prefetch=2 runs {spread[2]:.3e}; held to {rule}: {ok}")
    if not ok:
        raise AssertionError(f"{tag} ({mode}): prefetch=2 losses off "
                             "prefetch=0's")


def prefetch_slice(train_ds, dev, smi, reset_counts, read_counts):
    """Phase 18: each path of ``PREFETCH_PATHS`` (the preset
    ``ggnn_hole_binary`` but for its fields) one epoch of phase 8's pairs
    (20,480 augmented: 10 steps of 2048) through the Trainer with
    ``prefetch=0`` and ``prefetch=2`` in turns, after a warm-up epoch:
    0, 2, 2, 0 timed, then 2 and 0 profiled (the step losses within 1e-4
    of each other), then 0, 2, 0 under ``torch.use_deterministic_algorithms``
    (warnings only: an operation without a deterministic form runs as it
    is), where the step losses must be the same bits when the two
    ``prefetch=0`` runs are (else within twice the larger spread); each
    kernel once per step in every run; each setting's epoch seconds,
    edges/s and device busy share, and the producer's host ms per chunk;
    then ``prefetch_race``."""
    import warnings

    import torch

    from gcnbmp_tpu_torch.train.config import PRESETS

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        counter = itertools.count()

        def epoch(tag, base, depth, per_step, fwd, absent, profiled=False):
            r = prefetch_epoch(base, depth, train_ds, dev,
                               os.path.join(tmp, f"run{next(counter)}"),
                               reset_counts, read_counts, profiled=profiled)
            n = len(r["losses"])
            if n != 2 * len(train_ds) // N_PAIRS:
                raise AssertionError(f"phase 18 {tag}: {n} steps")
            if absent is None:
                no_launches(f"phase 18 {tag}", r["launches"])
            else:
                check_launches(f"phase 18 {tag}", r["launches"], n, per_step,
                               fwd, absent)
            return r

        for tag, fields, per_step, fwd, absent in PREFETCH_PATHS:
            base = dataclasses.replace(
                PRESETS["ggnn_hole_binary"], batch_size=N_PAIRS, epochs=1,
                eval_train=False, seed=SEED, **fields)
            path = (tag, base, per_step, fwd, absent)
            # a warm-up epoch (first-use costs of the path stay untimed),
            # then the timed runs in turns and the profiled ones
            warm = epoch(*path[:2], 0, *path[2:])
            timed = {0: [], 2: []}
            for d in (0, 2, 2, 0):
                timed[d].append(epoch(*path[:2], d, *path[2:]))
            profiled = {d: epoch(*path[:2], d, *path[2:], profiled=True)
                        for d in (2, 0)}
            loss_agreement(tag, "as trained", {
                d: [r["losses"] for r in timed[d]] + [profiled[d]["losses"]]
                + ([warm["losses"]] if d == 0 else []) for d in (0, 2)},
                tol=ATOL)
            det = {0: [], 2: []}
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    for d in (0, 2, 0):
                        det[d].append(epoch(*path[:2], d,
                                            *path[2:])["losses"])
            finally:
                torch.use_deterministic_algorithms(False)
            loss_agreement(tag, "deterministic algorithms", det)
            nondet = sorted({str(w.message).split("\n")[0][:120]
                             for w in caught
                             if "deterministic" in str(w.message)})
            print(f"phase 18 {tag}: operations without a deterministic form "
                  f"under torch.use_deterministic_algorithms: {nondet}")
            for depth in (0, 2):
                rs, p = timed[depth], profiled[depth]
                pf = ""
                if depth:  # the timed runs' prefetcher, per chunk
                    per = {k: statistics.median(
                        1e3 * r["prefetch"][f"{k}_s"] / r["prefetch"]["items"]
                        for r in rs) for k in ("produce", "transfer", "wait")}
                    pf = (f"; per chunk: producer host {per['produce']:.3f} "
                          f"ms, transfer {per['transfer']:.3f} ms, step "
                          f"thread waiting {per['wait']:.3f} ms")
                walls = " / ".join(f"{r['epoch_s']:.3f}" for r in rs)
                print(f"phase 18 {tag} prefetch={depth}: epoch "
                      f"{statistics.median(r['epoch_s'] for r in rs):.3f} s "
                      f"({walls}), "
                      f"{statistics.median(r['edges_s'] for r in rs):.1f} "
                      f"edges/s (the trainer's log, median of {len(rs)}); "
                      f"profiled run "
                      f"{p['epoch_s']:.3f} s, device busy "
                      f"{100 * p['kernel_ms'] / 1e3 / p['epoch_s']:.1f}% "
                      f"(kernels {p['kernel_ms']:.3f} ms, copies "
                      f"{p['copy_ms']:.3f} ms){pf} on {smi}")
        prefetch_race(train_ds, dev, smi, reset_counts, read_counts, tmp)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")


# phases 19 and 21: the ref_scale_fused64 row's flags
# (scripts/quality_battery_r3.sh:33-44; docs/QUALITY.md:77) at H = D = 64
# and at the h=128 model's H = D = 128, through the train CLI in each
# kernel form: (form, FUSED_READOUT, TWOPASS, kernels per step, forward
# kernels at least once per step, kernels never)
def fused_flags(width):
    return ["--method", "ggnn", "--conv-layers", "8", "--fp-hidden-dim",
            str(width), "--fp-out-dim", str(width), "--weight-tying", "false",
            "--compute-path", "fused", "--scan-steps", "10", "--lr", "2e-3",
            "--augment"]


FUSED64_CFG = dict(fp_hidden_dim=64, fp_out_dim=64, conv_layers=8,
                   weight_tying=False)
_K2 = ["fused_ggnn_readout", "fused_ggnn_readout_bwd"]
FUSED_FORMS = (
    ("K2/K2b", True, False, {"fused_ggnn_readout_bwd": 1},
     ["fused_ggnn_readout"],
     ["fused_ggnn", "fused_ggnn_mid", "fused_ggnn_bwd", "fused_ggnn_half_bwd"]),
    ("K1/K1b", False, False, {"fused_ggnn_bwd": 1}, ["fused_ggnn"],
     _K2 + ["fused_ggnn_mid", "fused_ggnn_half_bwd"]),
    # the epoch-end evaluations take K1 (no input needs a gradient)
    ("K1m/K3", False, True, {"fused_ggnn_mid": 1, "fused_ggnn_half_bwd": 2},
     [], _K2 + ["fused_ggnn_bwd"]))


def fused_train_slice(phase, tag, model_cfg, ds, df, dev, smi, reset_counts,
                      read_counts, set_form):
    """Phases 19 and 21: ``fused_flags`` at ``model_cfg``'s width through
    the train CLI on phase 8's pairs in each form (``set_form(fused_readout,
    twopass)``), then the K2/K2b run's ``final/params.npz`` served through
    the predict CLI.  Returns ({form: launch counts}, the serving launch
    counts)."""
    from gcnbmp_tpu_torch.convert import load_params_npz
    from gcnbmp_tpu_torch.train.config import TrainConfig

    t0 = time.perf_counter()
    train_cfg = TrainConfig(method="ggnn", compute_path="fused", scan_steps=10,
                            batch_size=N_PAIRS, learning_rate=2e-3,
                            augment=True, **model_cfg)
    flags = fused_flags(model_cfg["fp_hidden_dim"])
    runs = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as kept:
        for form, fused_readout, twopass, per_step, fwd, absent in FUSED_FORMS:
            set_form(fused_readout, twopass)
            runs[form], _ = train_slice(
                f"{tag} {form}", flags, N_PAIRS, train_cfg, model_cfg,
                per_step, fwd, ((N_PAIRS, 10),), dev, smi, reset_counts,
                read_counts, n_train=N_PROD_TRAIN, absent=absent,
                keep_dir=kept if form == "K2/K2b" else None)
        set_form(True, False)
        run = os.path.join(kept, "run")
        with open(os.path.join(run, "config.json")) as f:
            config = json.load(f)
        serve = serve_slice(
            f"{tag} final/params.npz", config, model_cfg, ds, df, dev, smi,
            reset_counts, read_counts, ["fused_ggnn_readout"],
            absent=["fused_ggnn", "fused_ggnn_mid"],
            tree=load_params_npz(os.path.join(run, "final", "params.npz")))
    print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    return runs, serve


# phases 20 and 21: the h=128 fused model (bench.py:65, 137:
# GCNBMP_BENCH_HIDDEN=128, GGNN with 8 untied layers, H = D = 128, a HolE
# head), served and scored, then trained
FUSED128_CFG = dict(fp_hidden_dim=128, fp_out_dim=128, conv_layers=8,
                    weight_tying=False)
FUSED128_CONFIG = {"method": "ggnn", "sim_method": "hole", "conv_layers": 8,
                   "fp_hidden_dim": 128, "fp_out_dim": 128,
                   "weight_tying": False, "net_hidden_dims": [],
                   "class_num": 1, "compute_path": "fused"}
_BWD = ["fused_ggnn_bwd", "fused_ggnn_half_bwd", "fused_ggnn_readout_bwd"]


def fused128_slice(ds, df, dev, smi, reset_counts, read_counts, set_form):
    """Phase 20: the h=128 model with seeded weights through the predict
    CLI in the K2 form and in the K1 form (``set_form(fused_readout,
    twopass)``), then through the evaluate CLI.  Returns the launch counts
    of the K2 and K1 serving runs and of the evaluate CLI."""
    from gcnbmp_tpu_torch.convert import init_params, save_params_npz

    t0 = time.perf_counter()
    set_form(True, False)
    serve_k2 = serve_slice(
        "fused128 K2", FUSED128_CONFIG, FUSED128_CFG, ds, df, dev, smi,
        reset_counts, read_counts, ["fused_ggnn_readout"],
        absent=["fused_ggnn", "fused_ggnn_mid", *_BWD])
    set_form(False, False)
    serve_k1 = serve_slice(
        "fused128 K1 + plain readout", FUSED128_CONFIG, FUSED128_CFG, ds, df,
        dev, smi, reset_counts, read_counts, ["fused_ggnn"],
        absent=["fused_ggnn_readout", "fused_ggnn_mid", *_BWD])
    set_form(True, False)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        run = os.path.join(tmp, "run")
        os.makedirs(os.path.join(run, "best"))
        with open(os.path.join(run, "config.json"), "w") as f:
            json.dump(FUSED128_CONFIG, f)
        save_params_npz(os.path.join(run, "best", "params.npz"),
                        init_params(FUSED128_CFG, SEED))
        test_path = os.path.join(tmp, "test.csv")
        df.to_csv(test_path, index=False)
        evaluate, _, _ = score_run("fused128", run, test_path,
                                   os.path.join(tmp, "eval"), [], dev, smi,
                                   reset_counts, read_counts)
    for name in ["fused_ggnn", "fused_ggnn_mid", *_BWD]:
        if evaluate[name]:
            raise AssertionError(f"fused128 evaluate CLI launched {name}")
    print(f"phase 20: {time.perf_counter() - t0:.1f} s")
    return serve_k2, serve_k1, evaluate


def crowd_rows(adj, torch):
    """``adj`` with ~5% of the columns of every other row set to 1: rows
    with more nonzeros than the kernels' NBR_CAP=16 neighbour slots (which
    they rescan densely at every layer), and an asymmetric adjacency."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    extra = torch.as_tensor(rng.random(tuple(adj.shape)) < 0.05).to(adj.device)
    extra[:, 1::2, :] = False
    adj = torch.where(extra, torch.ones_like(adj), adj).contiguous()
    crowded = int(((adj != 0).sum(-1) > 16).sum())
    if crowded == 0:
        raise AssertionError("no adjacency row above 16 nonzeros")
    return adj, crowded


# ---------------------------------------------------------------------------
# phase 22: the dense packed layout (``data.packing.pack_pair_dataset_batch``
# and its native twin, the dense predictors, ``fused_pair_logits``, the dense
# edgeshard step) on phase 5's 2048 train pairs
DENSE_STEPS = 10  # timed steps of each layout
DENSE_SMALL = 256  # the MPNN and GWM parts' batch
# (form, FUSED_READOUT, TWOPASS, launches per forward and backward)
DENSE_FORMS = (
    ("K2/K2b", True, False,
     {"fused_ggnn_readout": 1, "fused_ggnn_readout_bwd": 1}),
    ("K1/K1b", False, False, {"fused_ggnn": 1, "fused_ggnn_bwd": 1}),
    ("K1m/K3", False, True, {"fused_ggnn_mid": 1, "fused_ggnn_half_bwd": 2}))
MPNN_DENSE = {"fused_mpnn": 1, "fused_set2set": 1}
MPNN_DENSE_STEP = {"fused_mpnn": 1, "fused_set2set": 1, "fused_mpnn_bwd": 1,
                   "fused_set2set_bwd": 1}
# the plain versions the kernel wrappers take on CPU tensors: none may run
# on the dense kernel path's calls on the card
PLAIN_VERSIONS = (
    ("gcnbmp_tpu_torch.ops.fused_ggnn", (
        "fused_ggnn_reference", "fused_ggnn_mid_reference",
        "fused_ggnn_readout_reference", "fused_ggnn_bwd_reference",
        "fused_ggnn_half_bwd_reference", "fused_ggnn_readout_bwd_reference")),
    ("gcnbmp_tpu_torch.ops.fused_mpnn", (
        "fused_mpnn_reference", "fused_mpnn_bwd_reference")),
    ("gcnbmp_tpu_torch.ops.set2set_kernel", (
        "fused_set2set_reference", "fused_set2set_bwd_reference")))


@contextlib.contextmanager
def no_plain_versions():
    """The kernel wrappers' plain versions replaced by functions that
    raise, for the length of the block."""
    import importlib

    saved = []

    def refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"{name} ran on the dense kernel path")
        return fn

    for module, names in PLAIN_VERSIONS:
        mod = importlib.import_module(module)
        for name in names:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, refuse(name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def expect_launches(tag, launches, want):
    """Each kernel of ``want`` launched exactly that many times, every
    other kernel never."""
    bad = {k: v for k, v in launches.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{tag}: launches {bad}, expected {want}")


def dense_plain_logits(model, args):
    """The dense predictor's logits through its encoder's plain layer
    stack (``forward`` on the dense adjacency)."""
    atom_ids, adj, mol_id, node_mask, left, right = args
    num_mols = 2 * left.shape[0]
    g, _ = model.encoder(atom_ids, adj, mol_id, node_mask, num_mols)
    return model.head(g[left.long()], g[right.long()])


def loss_and_grads(logits_fn, labels, params):
    """The sigmoid cross-entropy of ``logits_fn()`` and its gradient in
    each of ``params`` (zero for one the loss does not reach)."""
    import torch

    from gcnbmp_tpu_torch.train import loop as train_loop

    loss = train_loop.sigmoid_cross_entropy(logits_fn(), labels)
    out = torch.autograd.grad(loss, params, allow_unused=True)
    return loss, [torch.zeros_like(p) if g is None else g
                  for g, p in zip(out, params)]


def dense_slice(ds, cfg, dev, smi, reset_counts, read_counts, set_form):
    """Phase 22 on ``ds``, phase 5's first 2048 train pairs; returns each
    kernel's launches on the dense path (the two train steps of each
    GGNN form, the MPNN step)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.data.native_pack import (
        PairDatasetCache, pack_pairs_native)
    from gcnbmp_tpu_torch.data.packing import (
        attach_supers_coo, max_atoms_lane_rounded, pack_pair_dataset_batch,
        pack_pair_dataset_coo)
    from gcnbmp_tpu_torch.models.packed import (
        dense_batch_args, fused_pair_logits, make_packed_predictor)
    from gcnbmp_tpu_torch.ops.fused_ggnn import (
        fused_ggnn_readout, params_to_fused)
    from gcnbmp_tpu_torch.parallel.edgeshard import (
        make_edgeshard_loss, make_edgeshard_train_step, shard_packed_batch)
    from gcnbmp_tpu_torch.parallel.mesh import graph_mesh, init_distributed
    from gcnbmp_tpu_torch.train import loop as train_loop
    from gcnbmp_tpu_torch.train.config import PRESETS

    t_start = time.perf_counter()
    idx = list(range(len(ds)))
    preset = PRESETS["ggnn_hole_binary"]
    tree = init_params(cfg, SEED)
    dense_launches = {}

    # a. packing: the Python and the native dense packers, the bytes, and
    # the batch's copy to the card from pageable and from pinned memory
    t0 = time.perf_counter()
    batch = pack_pair_dataset_batch(ds, idx)
    py_ms = (time.perf_counter() - t0) * 1e3
    cache = PairDatasetCache(ds)
    pack_pairs_native(cache, idx, want_dense=True)  # builds the library
    t0 = time.perf_counter()
    native = pack_pairs_native(cache, idx, want_dense=True)
    native_ms = (time.perf_counter() - t0) * 1e3
    for name in ("atom_ids", "adj", "mol_id", "node_mask", "left_index",
                 "right_index", "labels"):
        a, b = getattr(batch, name), getattr(native, name)
        if a.dtype != b.dtype or a.shape != b.shape \
                or a.tobytes() != b.tobytes():
            raise AssertionError(f"phase 22a: the native dense pack's {name} "
                                 "differs from the Python packer's")
    host = [np.ascontiguousarray(a) for a in dense_batch_args(batch)]
    host.append(np.ascontiguousarray(batch.labels, np.float32))
    total_mb = sum(a.nbytes for a in host) / 1e6
    pinned = [torch.from_numpy(a).pin_memory() for a in host]
    pageable_ms = host_ms(lambda: [torch.from_numpy(a).to(dev) for a in host],
                          torch)
    pinned_ms = host_ms(lambda: [t.to(dev, non_blocking=True)
                                 for t in pinned], torch)
    coo = pack_pair_dataset_coo(ds, idx)
    compact = from_jax_params(tree, make_packed_predictor(**cfg)).to(dev)
    wire = [np.asarray(a) for a in compact.wire_encoder([ds])(coo)]
    compact_stage = staging_ms(([a[None] for a in wire], coo.labels[None]),
                               dev, torch)
    print(f"phase 22a pack: {len(idx)} pairs, P={batch.num_tiles}, "
          f"{batch.num_edges} edges, occupancy {batch.occupancy:.4f}; "
          f"pack_pair_dataset_batch {py_ms:.3f} ms, native dense "
          f"{native_ms:.3f} ms (byte-identical); adjacency "
          f"{batch.adj.nbytes} bytes, the batch {total_mb:.3f} MB; H2D "
          f"(median of 5, host clock around synchronized copies) pageable "
          f"{pageable_ms:.3f} ms ({total_mb / pageable_ms:.3f} GB/s), pinned "
          f"{pinned_ms:.3f} ms ({total_mb / pinned_ms:.3f} GB/s); the compact "
          f"wire of the same pairs {compact_stage['MB']:.3f} MB, stage_chunk "
          f"{compact_stage['stage_chunk']:.3f} ms, pinned copy "
          f"{compact_stage['pinned copy']:.3f} ms; on {smi}")
    del pinned

    # b. the flagship ggnn_hole_binary, seeded weights
    args = tuple(torch.as_tensor(a).to(dev) for a in dense_batch_args(batch))
    labels = torch.as_tensor(batch.labels).to(dev)
    wire_dev = [torch.as_tensor(a).to(dev) for a in wire]

    def fresh(**kwargs):
        return from_jax_params(tree, make_packed_predictor(
            **cfg, compact=False, **kwargs)).to(dev)

    model = fresh()
    params = list(model.parameters())
    set_form(True, False)
    with torch.no_grad():
        reset_counts()
        with no_plain_versions():
            logits = model(*args)
        expect_launches("phase 22b dense forward", read_counts(),
                        {"fused_ggnn_readout": 1})
        with no_plain_versions():
            fused = fused_pair_logits(model, *args)
        compare("phase 22b fused_pair_logits vs PackedPairPredictor", fused,
                logits, torch)
        compare("phase 22b PackedPairPredictor vs the compact predictor",
                logits, compact(*wire_dev), torch)
        compare("phase 22b PackedPairPredictor vs the plain layer stack",
                logits, dense_plain_logits(model, args), torch)
        adj16 = args[1].to(torch.bfloat16)
        compare("phase 22b bf16 adjacency vs f32", model(args[0], adj16,
                                                         *args[2:]),
                logits, torch)
        enc = model.encoder
        msg_w, msg_b, gru = params_to_fused(enc)
        h0 = enc.embed(args[0])
        ro = enc.readout_0
        ro_args = (args[3], ro.i.dense.weight.T.contiguous(), ro.i.dense.bias,
                   ro.j.dense.weight.T.contiguous(), ro.j.dense.bias)
        k2 = [fused_ggnn_readout(L, h0, a, msg_w, msg_b, gru, *ro_args)
              for a in (args[1], adj16)]
        if not torch.equal(*k2):
            raise AssertionError("phase 22b: K2 on the bf16 adjacency differs "
                                 "from K2 on the f32 one")
        print("phase 22b: K2's g_nodes from the bf16 dense adjacency equal "
              "those from the f32 one bit for bit")

    names = [n for n, _ in model.named_parameters()]
    loss_p, grads_p = loss_and_grads(
        lambda: dense_plain_logits(model, args), labels, params)
    for form, readout, twopass, step_counts in DENSE_FORMS:
        set_form(readout, twopass)
        reset_counts()
        with no_plain_versions():
            loss_k, grads_k = loss_and_grads(lambda: model(*args), labels,
                                             params)
        expect_launches(f"phase 22b {form} forward and backward",
                        read_counts(), step_counts)
        lk, lp = float(loss_k.detach()), float(loss_p.detach())
        if abs(lk - lp) > ATOL:
            raise AssertionError(f"phase 22b {form}: loss {lk} vs the plain "
                                 f"stack's {lp}")
        compare_grads(f"phase 22b {form} gradients (dense kernel path vs plain "
                      "layer stack)", list(zip(names, grads_k)),
                      list(zip(names, grads_p)), torch)
        step_model = fresh()
        opt, _ = train_loop.build_optimizer(preset, 1000,
                                            list(step_model.parameters()))
        reset_counts()
        with no_plain_versions():
            losses = [float(train_loop.train_step(step_model, opt, args,
                                                  labels))
                      for _ in range(2)]
        counts = read_counts()
        expect_launches(f"phase 22b {form} two train steps", counts,
                        {k: 2 * v for k, v in step_counts.items()})
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"phase 22b {form}: step losses {losses}")
        for k, v in step_counts.items():
            dense_launches[k] = counts[k]
        print(f"phase 22b {form}: two train steps at batch {len(idx)} "
              f"(P={batch.num_tiles}), losses {losses}, launches "
              f"{ {k: counts[k] for k in step_counts} }")

    # the batch-2048 step, dense against compact, K2/K2b, on batches staged
    # on the card beforehand; then the same with each batch's copy from the
    # host (pageable dense arrays; the compact wire through stage_chunk)
    set_form(True, False)
    steps = {"dense": (fresh(), args), "compact": (
        from_jax_params(tree, make_packed_predictor(**cfg)).to(dev),
        wire_dev)}
    step_ms = {}
    for tag, (m, a) in steps.items():
        opt, _ = train_loop.build_optimizer(preset, 1000,
                                            list(m.parameters()))
        step = lambda i, m=m, a=a, opt=opt: train_loop.train_step(m, opt, a,
                                                                  labels)
        step_ms[tag] = host_ms(lambda: step(0), torch, reps=DENSE_STEPS)
        busy, top = profile_steps(step, 5)
        print(f"phase 22b {tag} train step: batch={len(idx)} "
              f"P={batch.num_tiles}: {step_ms[tag]:.3f} ms per step (median "
              f"of {DENSE_STEPS}, host clock around synchronized steps on "
              f"staged batches) on {smi}")
        print(f"  where it goes (torch.profiler over 5 steps): {busy}; top "
              f"kernels, device ms per step: {top}")
    opts = {tag: train_loop.build_optimizer(preset, 1000,
                                            list(m.parameters()))[0]
            for tag, (m, _) in steps.items()}

    def dense_host():
        staged = tuple(torch.from_numpy(x).to(dev) for x in host[:-1])
        train_loop.train_step(steps["dense"][0], opts["dense"], staged,
                              labels)

    def compact_host():
        staged, _ = train_loop.stage_chunk([x[None] for x in wire],
                                           coo.labels[None], dev)
        train_loop.train_step(steps["compact"][0], opts["compact"],
                              [s[0] for s in staged], labels)

    with_copy = {"dense": host_ms(dense_host, torch, reps=DENSE_STEPS),
                 "compact": host_ms(compact_host, torch, reps=DENSE_STEPS)}
    print(f"phase 22b step with the batch's copy from the host: dense "
          f"{with_copy['dense']:.3f} ms, compact {with_copy['compact']:.3f} ms "
          f"(median of {DENSE_STEPS}); staged: dense {step_ms['dense']:.3f} "
          f"ms, compact {step_ms['compact']:.3f} ms; on {smi}")

    # c. MPNN, the quality row's model, at batch 256 dense: K5 and K4 once
    # per forward, K5b and K4b once per step
    small = list(range(DENSE_SMALL))
    sbatch = pack_pair_dataset_batch(ds, small)
    sargs = tuple(torch.as_tensor(a).to(dev) for a in dense_batch_args(sbatch))
    slabels = torch.as_tensor(sbatch.labels).to(dev)
    mcfg = dict(MPNN_CFG, s2s_n_max=max_atoms_lane_rounded([ds]))
    mtree = init_params(mcfg, SEED)
    mpnn = from_jax_params(mtree, make_packed_predictor(
        **mcfg, compact=False)).to(dev)
    mparams = list(mpnn.parameters())
    reset_counts()
    with no_plain_versions():
        with torch.no_grad():
            mpnn(*sargs)
        expect_launches("phase 22c MPNN forward", read_counts(), MPNN_DENSE)
        reset_counts()
        loss_k, grads_k = loss_and_grads(lambda: mpnn(*sargs), slabels,
                                         mparams)
    expect_launches("phase 22c MPNN forward and backward", read_counts(),
                    MPNN_DENSE_STEP)
    loss_p, grads_p = loss_and_grads(lambda: dense_plain_logits(mpnn, sargs),
                                     slabels, mparams)
    mnames = [n for n, _ in mpnn.named_parameters()]
    lk, lp = float(loss_k.detach()), float(loss_p.detach())
    if abs(lk - lp) > ATOL:
        raise AssertionError(f"phase 22c: loss {lk} vs the plain stack's "
                             f"{lp}")
    compare_grads("phase 22c MPNN gradients (dense kernel path vs plain "
                  "stack)", list(zip(mnames, grads_k)),
                  list(zip(mnames, grads_p)), torch)
    opt, _ = train_loop.build_optimizer(preset, 1000, mparams)
    reset_counts()
    with no_plain_versions():
        mloss = float(train_loop.train_step(mpnn, opt, sargs, slabels))
    counts = read_counts()
    expect_launches("phase 22c MPNN train step", counts, MPNN_DENSE_STEP)
    if not np.isfinite(mloss):
        raise AssertionError(f"phase 22c: MPNN step loss {mloss}")
    dense_launches.update({k: counts[k] for k in MPNN_DENSE_STEP})
    print(f"phase 22c MPNN (L=4 tied, H=32) dense at batch {DENSE_SMALL} "
          f"(P={sbatch.num_tiles}): step loss {mloss:.6f}, launches "
          f"{ {k: counts[k] for k in MPNN_DENSE_STEP} }")

    # d. GGNN-GWM dense at batch 256: one step, and the logits of the
    # compact GWM predictor on the same pairs; no kernel
    gcfg = dict(GWM_CFG)
    gtree = init_params(gcfg, SEED)
    gdense = from_jax_params(gtree, make_packed_predictor(
        **gcfg, compact=False)).to(dev)
    gcompact = from_jax_params(gtree, make_packed_predictor(**gcfg)).to(dev)
    gbatch = pack_pair_dataset_batch(ds, small,
                                      supernode_fn=gdense.supernode_fn)
    gargs = (gbatch.atom_ids, gbatch.adj, gbatch.supers, gbatch.mol_id,
             gbatch.node_mask, gbatch.left_index, gbatch.right_index)
    gargs = tuple(torch.as_tensor(a).to(dev) for a in gargs)
    gcoo = attach_supers_coo(pack_pair_dataset_coo(ds, small), ds, small,
                             gcompact.supernode_fn)
    gwire = [torch.as_tensor(np.asarray(a)).to(dev)
             for a in gcompact.wire_encoder([ds])(gcoo)]
    reset_counts()
    with torch.no_grad():
        compare("phase 22d GWM dense vs compact", gdense(*gargs),
                gcompact(*gwire), torch)
    opt, _ = train_loop.build_optimizer(preset, 1000,
                                        list(gdense.parameters()))
    gloss = float(train_loop.train_step(gdense, opt, gargs, slabels))
    expect_launches("phase 22d GWM", read_counts(), {})
    if not np.isfinite(gloss):
        raise AssertionError(f"phase 22d: GWM step loss {gloss}")
    print(f"phase 22d GGNN-GWM dense at batch {DENSE_SMALL}: one step, loss "
          f"{gloss:.6f}")

    # e. the dense edgeshard step on one NCCL rank: its loss against the
    # single-device loss, K2/K2b once
    created = not dist.is_initialized()
    init_distributed("cuda")
    try:
        mesh = graph_mesh("cuda")
        es_model = fresh()
        shards = shard_packed_batch(batch, mesh, device=dev)
        with torch.no_grad():
            single = float(train_loop.sigmoid_cross_entropy(es_model(*args),
                                                            labels))
            sharded = float(make_edgeshard_loss(es_model, mesh)(*shards))
        step = make_edgeshard_train_step(
            es_model, train_loop.ChainedAdam(list(es_model.parameters()),
                                             lambda count: 1e-3), mesh)
        reset_counts()
        with no_plain_versions():
            step_loss = float(step(*shards))
        expect_launches("phase 22e dense edgeshard step", read_counts(),
                        {"fused_ggnn_readout": 1, "fused_ggnn_readout_bwd": 1})
    finally:
        if created:
            dist.destroy_process_group()
    print(f"phase 22e dense edgeshard over one NCCL rank: loss "
          f"{sharded:.8f}, single device {single:.8f}, |diff| "
          f"{abs(sharded - single):.3e}; step loss {step_loss:.8f}")
    if abs(sharded - single) > 1e-5 or abs(step_loss - single) > 1e-5:
        raise AssertionError("phase 22e: the dense edgeshard loss is not "
                             "within 1e-5 of the single-device loss")
    print(f"phase 22: {time.perf_counter() - t_start:.1f} s")
    return dense_launches


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "gcnbmp_tpu_torch")):
        print("chip_smoke.py: the gcnbmp_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    import pandas as pd

    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.data import CSVPairParser, estimate_coo_capacities
    from gcnbmp_tpu_torch.data.wire import (
        compact_coo_arrays, iter_coo_eval_batches)
    from gcnbmp_tpu_torch.models.packed import (
        _device_slot_table, decode_compact_wire, make_packed_predictor)
    from gcnbmp_tpu_torch.ops import build
    from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo_flat
    from gcnbmp_tpu_torch.models import packed as packed_module
    from gcnbmp_tpu_torch.ops import fused_ggnn as fused_ggnn_module
    from gcnbmp_tpu_torch.ops.fused_ggnn import (
        GRU_KEYS, fused_ggnn, fused_ggnn_bwd, fused_ggnn_bwd_reference,
        fused_ggnn_half_bwd, fused_ggnn_half_bwd_reference, fused_ggnn_mid,
        fused_ggnn_mid_reference, fused_ggnn_readout, fused_ggnn_readout_bwd,
        fused_ggnn_readout_bwd_reference, fused_ggnn_readout_reference,
        fused_ggnn_reference, fused_ggnn_twopass_bwd, params_to_fused)
    from gcnbmp_tpu_torch.ops.fused_mpnn import (
        build_molmat, fused_mpnn, fused_mpnn_bwd, fused_mpnn_bwd_reference,
        fused_mpnn_reference, params_to_fused_mpnn)
    from gcnbmp_tpu_torch.ops.set2set_kernel import (
        fused_set2set, fused_set2set_bwd, fused_set2set_bwd_reference,
        fused_set2set_reference)
    from gcnbmp_tpu_torch.ops.slotgather import (
        gather_slot_table, identity_mol_row)
    from gcnbmp_tpu_torch.train.config import PRESETS, TrainConfig

    counters = kernel_wrappers()

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counters.items()}

    t_start = time.perf_counter()
    # 1. device
    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    lib = build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{build.last_build_seconds} s)")
    for line in (build.last_build_log or "").splitlines():
        if line.startswith("== ") or "registers" in line or "spill" in line \
                or "error" in line:
            print(f"  ptxas: {line.strip()}")
    spilling = []
    for body, use in body_registers(build.last_build_log or ""):
        print(f"build: {body}: {use}")
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill", use)]
        if body.startswith(("fused_ggnn", "fused_mpnn", "set2set_fwd")) \
                and any(spills):
            spilling.append(f"{body}: {use}")
    if spilling:
        raise AssertionError("instances that spill registers: " + "; ".join(spilling))
    # the H=64 bodies (K1, K1m, K2; the reverse body with and without the
    # readout) and the H=128 ones (K1, K1m, K2; the reverse body's F without
    # and with the readout, and R) whenever this process built the GGNN
    # sources
    if "fused_ggnn_bwd.cu" in (build.last_build_log or ""):
        for width, n in (("kernel64", 5), ("kernel128", 6)):
            found = {body for body, _ in body_registers(build.last_build_log)
                     if width in body}
            if len(found) != n:
                raise AssertionError(f"{width} GGNN instances in the build "
                                     f"log: {sorted(found)}, expected {n}")
        bwd128 = [body for body, _ in body_registers(build.last_build_log)
                  if "bwd_kernel128" in body]
        missing = [name for name in BWD128_LAUNCHES
                   if not any(name in body for body in bwd128)]
        if missing:
            raise AssertionError(f"H=128 reverse instances missing from the "
                                 f"build log: {missing}")

    # 3. kernels vs plain at real batch shapes
    df = pd.read_csv(DATA).head(N_PAIRS)
    ds = CSVPairParser().parse(df).dataset
    if len(ds) != N_PAIRS:
        raise AssertionError(f"parsed {len(ds)} of {N_PAIRS} pairs")

    def first_batch(bs):
        tiles, cap = estimate_coo_capacities([ds], bs)
        batch, _ = next(iter_coo_eval_batches(ds, bs, tiles, cap))
        return tiles, [torch.as_tensor(np.asarray(a)).to(dev)
                       for a in compact_coo_arrays(batch)]

    def decoded(args):
        nodes, e_packed, n_edges, left, _ = args
        num_mols = 2 * left.shape[0]
        atom_ids, mol_id, mask, *edges = decode_compact_wire(
            nodes, e_packed, n_edges, num_mols)
        p, t = atom_ids.shape
        return (atom_ids, mol_id, mask, num_mols,
                adj_from_coo_flat(*edges, num_tiles=p, tile=t))

    def model_of(c):
        return from_jax_params(init_params(c, SEED),
                               make_packed_predictor(**c)).to(dev)

    results = {name: {} for name in counters}

    def record(name, tag, err, k_med, p_med, dev_ms, got, headline, flops,
               inputs, key=None, suffix="", tc_terms=None):
        """Print the case's bound (from its inputs and the kernel's
        outputs) and, for a kernel on the tensor cores, its ``bound_tc``
        from ``tc_terms`` (dense, sparse); keep the worst error over the
        cases, and the headline case's times and bounds (under ``key``, by
        default the kernel's name, with ``suffix`` after each time's
        name).  A kernel on the tensor cores keeps ``bound_tc`` as its
        bound, the bound of the route it takes, and the f32 one beside it
        as ``bound_f32_ms``."""
        b_ms, b_by = bound(flops, nbytes(inputs, got))
        print(f"  bound {name} [{tag}]: {b_ms:.4f} ms, by {b_by} "
              f"({flops / 1e9:.3f} GFLOP, {nbytes(inputs, got) / 1e6:.1f} MB)")
        r = results.setdefault(key or name, {})
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        if tc_terms is not None:
            tc_ms, tc_by = bound_tc(*tc_terms, nbytes(inputs, got))
            print(f"  bound_tc {name} [{tag}]: {tc_ms:.4f} ms, by {tc_by} "
                  f"(3 x {tc_terms[0] / 1e9:.3f} dense GFLOP in TF32, "
                  f"{tc_terms[1] / 1e9:.3f} sparse GFLOP in f32)")
            if headline:
                r["bound_f32_ms" + suffix] = b_ms
            b_ms, b_by = tc_ms, tc_by
        if headline:
            r["ms" + suffix], r["plain_ms" + suffix] = k_med, p_med
            r["device_ms" + suffix] = dev_ms
            r["bound_ms" + suffix], r["bound_by" + suffix] = b_ms, b_by

    # 3a. GGNN
    cfg = dict(fp_hidden_dim=H, fp_out_dim=D, conv_layers=L,
               weight_tying=False)
    # H=64: the ref_scale_fused64 model (csrc/fused_ggnn64.cuh's bodies)
    cfg64 = dict(cfg, fp_hidden_dim=64, fp_out_dim=64)
    # H=128: the bodies of csrc/fused_ggnn128_fwd.cuh and fused_ggnn128_bwd.cuh
    # (bench.py's h=128 model); the forward's clusters of two CTAs that the
    # card holds at once
    cfg128 = dict(cfg, fp_hidden_dim=128, fp_out_dim=128)
    clusters = ctypes.c_int(-1)
    err = lib.fused_ggnn128_clusters(ctypes.byref(clusters))
    if err != 0 or clusters.value < 1:
        raise AssertionError(f"the H=128 forward's cluster occupancy query: error "
                             f"{err}, {clusters.value} clusters")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"H=128 forward: {clusters.value} resident clusters of two CTAs "
          f"(cudaOccupancyMaxActiveClusters, {sms} SMs; {smi})")
    cases = [(SERVE_BATCH, cfg, False), (N_PAIRS, cfg, False),
             (SERVE_BATCH, dict(cfg, fp_hidden_dim=16, fp_out_dim=16), False),
             (SERVE_BATCH, cfg, True),
             (SERVE_BATCH, dict(cfg, conv_layers=3), False),
             (SERVE_BATCH, cfg64, False), (N_PAIRS, cfg64, False),
             (SERVE_BATCH, cfg64, True),
             (SERVE_BATCH, dict(cfg64, conv_layers=3), False),
             (SERVE_BATCH, cfg128, False), (N_PAIRS, cfg128, False),
             (SERVE_BATCH, cfg128, True),
             (SERVE_BATCH, dict(cfg128, conv_layers=3), False)]
    with torch.no_grad():
        for bs, c, crowd in cases:
            model = model_of(c)
            tiles, args = first_batch(bs)
            atom_ids, _, mask, _, adj = decoded(args)
            enc = model.encoder
            msg_w, msg_b, gru = params_to_fused(enc)
            ro = enc.readout_0
            readout = (mask, ro.i.dense.weight.T.contiguous(), ro.i.dense.bias,
                       ro.j.dense.weight.T.contiguous(), ro.j.dense.bias)
            tag = (f"batch={bs} P={tiles} L={c['conv_layers']} "
                   f"H={c['fp_hidden_dim']} D={c['fp_out_dim']}")
            if crowd:
                adj, crowded = crowd_rows(adj, torch)
                tag += f" rows>16nnz={crowded}"
            n_layers, h0 = enc.n_layers, enc.embed(atom_ids)
            split = n_layers // 2
            k1_args = (n_layers, h0, adj, msg_w, msg_b, gru)
            # a seeded upstream gradient for the backward kernels
            p_tiles, hidden = h0.shape[0], h0.shape[-1]
            dout = torch.as_tensor(np.random.default_rng(SEED + bs).standard_normal(
                (p_tiles, 128, hidden)).astype(np.float32)).to(dev)
            # K3's halves: the top from h_mid and dout, the bottom from h0
            # and dout standing in for dh_mid
            h_mid = fused_ggnn_mid_reference(*k1_args)[1]
            top = (split, n_layers, h_mid, adj, msg_w, msg_b, gru, dout)
            bottom = (0, split, h0, adj, msg_w, msg_b, gru, dout)
            nnz = int(torch.count_nonzero(adj))
            if hidden == 128 and bs == N_PAIRS:
                # the H=128 reverse's stored activations, (P, layers, 4, T,
                # H) f32, beside the gradient rows and hs of the same call
                acts = p_tiles * 4 * TILE * hidden * 4
                print(f"acts [{tag}]: {acts * n_layers} bytes per K1b or K2b "
                      f"call, {acts * (n_layers - split)} / {acts * split} per "
                      f"K3 half (top / bottom)")

            def flops(lo, hi, **kw):  # (dense, sparse)
                return ggnn_terms(p_tiles, hidden, nnz, lo, hi, **kw)

            headline = bs == SERVE_BATCH and c is cfg and not crowd
            reps = REPS if headline else REPS_OTHER
            # the H=64 and H=128 kernels' entries: P=75 as ``ms``, P=387 as
            # ``ms_p387``
            wide = hidden in (64, 128)
            if wide:
                headline = c in (cfg64, cfg128) and not crowd
            width_key = ((lambda n: f"{n}_h{hidden}") if wide
                         else (lambda n: n))
            suffix = "_p387" if wide and bs == N_PAIRS else ""
            # the L=3 case is there for K1m's and K3's odd split
            odd = n_layers % 2 == 1
            # (name, range tag, kernel, plain, gradient names, headline,
            #  operations, inputs)
            pairs = [
                ("fused_ggnn", "", lambda: fused_ggnn(*k1_args),
                 lambda: fused_ggnn_reference(*k1_args), None, headline,
                 flops(0, n_layers), k1_args[1:]),
                ("fused_ggnn_mid", "", lambda: fused_ggnn_mid(*k1_args),
                 lambda: fused_ggnn_mid_reference(*k1_args), None, headline,
                 flops(0, n_layers), k1_args[1:]),
                ("fused_ggnn_readout", "",
                 lambda: fused_ggnn_readout(*k1_args, *readout),
                 lambda: fused_ggnn_readout_reference(*k1_args, *readout),
                 None, headline, flops(0, n_layers, readout=True),
                 (k1_args[1:], readout)),
                ("fused_ggnn_bwd", "", lambda: fused_ggnn_bwd(*k1_args, dout),
                 lambda: fused_ggnn_bwd_reference(*k1_args, dout),
                 GGNN_GRAD_NAMES, headline,
                 flops(0, n_layers, backward=True), (k1_args[1:], dout)),
                ("fused_ggnn_half_bwd", f" layers [{split}, {n_layers})",
                 lambda: fused_ggnn_half_bwd(*top),
                 lambda: fused_ggnn_half_bwd_reference(*top),
                 GGNN_GRAD_NAMES, headline,
                 flops(split, n_layers, backward=True), top[2:]),
                ("fused_ggnn_half_bwd", f" layers [0, {split})",
                 lambda: fused_ggnn_half_bwd(*bottom),
                 lambda: fused_ggnn_half_bwd_reference(*bottom),
                 GGNN_GRAD_NAMES, False, flops(0, split, backward=True),
                 bottom[2:]),
                ("fused_ggnn_readout_bwd", "",
                 lambda: fused_ggnn_readout_bwd(*k1_args, *readout, dout),
                 lambda: fused_ggnn_readout_bwd_reference(*k1_args, *readout,
                                                          dout),
                 GGNN_GRAD_NAMES, headline,
                 flops(0, n_layers, readout=True, backward=True),
                 (k1_args[1:], readout, dout)),
            ]
            for name, rng_tag, kern, plain, grads, head, ops, inputs in pairs:
                if odd and name not in ("fused_ggnn_mid", "fused_ggnn_half_bwd"):
                    continue
                # the H=64 and H=128 bodies run on the tensor cores
                record(name, tag + rng_tag,
                       *check_pair(name, tag + rng_tag, kern, plain, grads,
                                   GRU_KEYS, smi, torch, reps,
                                   width_key(name) if width_key(name)
                                   in WRAPPER_KERNELS else None),
                       head, sum(ops), inputs, key=width_key(name),
                       suffix=suffix, tc_terms=ops if wide else None)
            # K1m is K1 with one more store: the same h, bit for bit
            if not torch.equal(fused_ggnn_mid(*k1_args)[0], fused_ggnn(*k1_args)):
                raise AssertionError(f"K1m's h differs from K1's [{tag}]")
            if not odd:
                repeat_bits("K2", tag, lambda: fused_ggnn_readout(
                    *k1_args, *readout), torch)
            if not odd:
                repeat_bits("K2b", tag, lambda: fused_ggnn_readout_bwd(
                    *k1_args, *readout, dout), torch)
            # the two-pass backward (K1m's h_mid, K3 twice) against K1b
            two = lambda: fused_ggnn_twopass_bwd(
                n_layers, h0, fused_ggnn_mid(*k1_args)[1], adj, msg_w, msg_b,
                gru, dout)
            one = lambda: (fused_ggnn(*k1_args),
                           fused_ggnn_bwd(*k1_args, dout))[1]
            compare_grads(f"K3 top + bottom vs K1b [{tag}]",
                          named_grads(two(), GRU_KEYS, GGNN_GRAD_NAMES),
                          named_grads(one(), GRU_KEYS, GGNN_GRAD_NAMES), torch)
            time_pair("forward + backward, two-pass vs single-pass", tag, two,
                      one, smi, torch, labels=("K1m + K3 twice", "K1 + K1b"),
                      reps=reps)

    # 3b. MPNN: (batch, model, Set2Set table widths, crowded adjacency)
    h16 = dict(MPNN_CFG, fp_hidden_dim=16, fp_out_dim=16)
    mpnn_cases = [(SERVE_BATCH, MPNN_CFG, (24, 64), False),
                  (N_PAIRS, MPNN_CFG, (24, 64), False),
                  (SERVE_BATCH, MPNN_BENCH_CFG, (64,), False),
                  (SERVE_BATCH, h16, (24,), False),
                  (SERVE_BATCH, MPNN_CFG, (), True),
                  # one layer: with the L=4 and L=8 rows, K5 and K5b's cost
                  # per layer and the part that does not grow with L
                  (SERVE_BATCH, dict(MPNN_CFG, conv_layers=1), (), False)]
    with torch.no_grad():
        for bs, c, widths, crowd in mpnn_cases:
            model = model_of(c)
            tiles, args = first_batch(bs)
            atom_ids, mol_id, mask, num_mols, adj = decoded(args)
            enc = model.encoder
            tag = (f"batch={bs} P={tiles} L={c['conv_layers']} "
                   f"{'tied' if c['weight_tying'] else 'untied'} "
                   f"H={c['fp_hidden_dim']}")
            if crowd:
                adj, crowded = crowd_rows(adj, torch)
                tag += f" asymmetric rows>16nnz={crowded}"
            wt, m0t, gru = params_to_fused_mpnn(enc)
            k5_args = (enc.n_layers, enc.weight_tying, enc.embed(atom_ids), adj,
                       mol_id.contiguous(), mask, wt, m0t, gru)
            dh = torch.as_tensor(np.random.default_rng(SEED + bs).standard_normal(
                tuple(k5_args[2].shape)).astype(np.float32)).to(dev)
            headline = bs == SERVE_BATCH and c is MPNN_CFG and not crowd
            k5_work = (tiles, c["fp_hidden_dim"], enc.n_layers,
                       enc.weight_tying, int(torch.count_nonzero(adj)),
                       int(build_molmat(mol_id, mask).sum()))
            for name, kern, plain, grads, ops, inputs in (
                    ("fused_mpnn", lambda: fused_mpnn(*k5_args),
                     lambda: fused_mpnn_reference(*k5_args), None,
                     mpnn_flops(*k5_work), k5_args[2:]),
                    ("fused_mpnn_bwd", lambda: fused_mpnn_bwd(*k5_args, dh),
                     lambda: fused_mpnn_bwd_reference(*k5_args, dh),
                     MPNN_GRAD_NAMES, mpnn_flops(*k5_work, backward=True),
                     (k5_args[2:], dh))):
                record(name, tag, *check_pair(name, tag, kern, plain, grads,
                                              GRU_KEYS, smi, torch,
                                              REPS if headline else REPS_OTHER),
                       headline, ops, inputs)
            repeat_bits("K5", tag, lambda: fused_mpnn(*k5_args), torch)
            repeat_bits("K5b", tag, lambda: fused_mpnn_bwd(*k5_args, dh), torch)
            occupancy("K5b", tag, lib.fused_mpnn_bwd_occupancy, tiles,
                      c["fp_hidden_dim"])
            h = fused_mpnn_reference(*k5_args)
            s2s = enc.readout_0.set2set
            for n_max in widths:
                slots, amask, over = _device_slot_table(
                    mol_id.reshape(-1), mask.reshape(-1), num_mols, n_max)
                if bool(over):
                    raise AssertionError(f"a molecule is wider than {n_max}")
                atoms = gather_slot_table(
                    h.reshape(-1, h.shape[-1]), slots, amask,
                    mol_id.reshape(-1), identity_mol_row(num_mols, dev))
                k4_args = (S2S_STEPS, atoms, amask, *s2s.lstm.kernels())
                dg = torch.as_tensor(np.random.default_rng(SEED + n_max).standard_normal(
                    (num_mols, 2 * atoms.shape[-1])).astype(np.float32)).to(dev)
                stag = f"{tag} M={num_mols} n_max={n_max}"
                k4_work = (S2S_STEPS, num_mols, atoms.shape[-1],
                           int(amask.sum()))
                for name, kern, plain, grads, ops, inputs in (
                        ("fused_set2set", lambda: fused_set2set(*k4_args),
                         lambda: fused_set2set_reference(*k4_args), None,
                         set2set_flops(*k4_work), k4_args[1:]),
                        ("fused_set2set_bwd",
                         lambda: fused_set2set_bwd(*k4_args, dg),
                         lambda: fused_set2set_bwd_reference(*k4_args, dg),
                         S2S_GRAD_NAMES, set2set_flops(*k4_work, backward=True),
                         (k4_args[1:], dg))):
                    head = headline and n_max == 24
                    record(name, stag, *check_pair(name, stag, kern, plain,
                                                   grads, GRU_KEYS, smi, torch,
                                                   REPS if head else REPS_OTHER),
                           head, ops, inputs)
                repeat_bits("K4", stag, lambda: fused_set2set(*k4_args), torch)
                repeat_bits("K4b", stag, lambda: fused_set2set_bwd(*k4_args, dg),
                            torch)
                occupancy("K4", stag, lib.set2set_fwd_occupancy, num_mols,
                          n_max, atoms.shape[-1], S2S_STEPS, group_warps=4)
                occupancy("K4b", stag, lib.set2set_bwd_occupancy, num_mols,
                          n_max, atoms.shape[-1], S2S_STEPS)
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")

    # 4. GGNN serving through the predict CLI
    # a run of a packed layout: the CLIs score the others padded, as the
    # JAX CLIs do (phase 14)
    ggnn_config = {"method": "ggnn", "sim_method": "hole", "conv_layers": L,
                   "fp_hidden_dim": H, "fp_out_dim": D, "weight_tying": False,
                   "net_hidden_dims": [], "class_num": 1,
                   "compute_path": "coo"}
    serve_ggnn = serve_slice("ggnn", ggnn_config, cfg, ds, df, dev, smi,
                             reset_counts, read_counts, ["fused_ggnn_readout"])

    # 5. GGNN training through the train CLI; phase 11 takes its run
    preset = PRESETS["ggnn_hole_binary"]
    kept = tempfile.TemporaryDirectory(dir=ROOT)
    train_ggnn, train_pairs = train_slice(
        "ggnn", ["--preset", "ggnn_hole_binary", "--compute-path", "fused"],
        preset.batch_size, preset, cfg, {"fused_ggnn_readout_bwd": 1},
        ["fused_ggnn_readout"], ((preset.batch_size, 50), (N_PAIRS, 10)),
        dev, smi, reset_counts, read_counts, keep_dir=kept.name)
    print(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")

    # 6. MPNN serving through the predict CLI
    mpnn_config = {"method": "mpnn", "sim_method": "hole",
                   "conv_layers": MPNN_CFG["conv_layers"], "fp_hidden_dim": H,
                   "fp_out_dim": D, "weight_tying": True,
                   "net_hidden_dims": [], "class_num": 1,
                   "compute_path": "coo"}
    serve_mpnn = serve_slice("mpnn", mpnn_config, MPNN_CFG, ds, df, dev, smi,
                             reset_counts, read_counts,
                             ["fused_mpnn", "fused_set2set"])

    # 7. MPNN training through the train CLI, the quality row's flags
    mpnn_train_cfg = TrainConfig(
        method="mpnn", conv_layers=4, weight_tying=True, fp_hidden_dim=H,
        fp_out_dim=D, learning_rate=2e-3, compute_path="coo",
        compute_dtype="bfloat16", augment=True, batch_size=SERVE_BATCH)
    train_mpnn, _ = train_slice(
        "mpnn", MPNN_FLAGS, SERVE_BATCH, mpnn_train_cfg,
        dict(MPNN_CFG, s2s_n_max=24),
        {"fused_mpnn_bwd": 1, "fused_set2set_bwd": 1},
        ["fused_mpnn", "fused_set2set"], ((SERVE_BATCH, 20), (N_PAIRS, 10)),
        dev, smi, reset_counts, read_counts)
    print(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")

    # 8. the production recipe through the train CLI in the JAX package's
    # default fused form (K1 + the plain readout), two-pass, then one
    # epoch single-pass; then the batch-2048 step in all three forms
    prod = PRESETS["ggnn_hole_production"]
    prod_flags = ["--preset", "ggnn_hole_production", "--compute-path", "fused"]
    k2_kernels = ["fused_ggnn_readout", "fused_ggnn_readout_bwd"]
    saved_form = (packed_module.FUSED_READOUT, fused_ggnn_module.TWOPASS)

    def set_form(fused_readout, twopass):
        packed_module.FUSED_READOUT = fused_readout
        fused_ggnn_module.TWOPASS = twopass

    try:
        set_form(False, True)
        train_twopass, prod_ds = train_slice(
            "ggnn production two-pass", prod_flags, prod.batch_size, prod,
            cfg, {"fused_ggnn_half_bwd": 2}, ["fused_ggnn_mid"], (), dev, smi,
            reset_counts, read_counts, n_train=N_PROD_TRAIN,
            absent=k2_kernels + ["fused_ggnn_bwd"])
        set_form(False, False)
        train_single, _ = train_slice(
            "ggnn production single-pass", prod_flags, prod.batch_size, prod,
            cfg, {"fused_ggnn_bwd": 1}, ["fused_ggnn"], (), dev, smi,
            reset_counts, read_counts, n_train=N_PROD_TRAIN, epochs=1,
            absent=k2_kernels + ["fused_ggnn_mid", "fused_ggnn_half_bwd"])
        for form, flags in (("K2/K2b", (True, False)),
                            ("K1/K1b", (False, False)),
                            ("K1m/K3", (False, True))):
            set_form(*flags)
            time_train_step(f"ggnn production {form}", prod_ds, cfg, prod,
                            prod.batch_size, 10, dev, smi)
    finally:
        set_form(*saved_form)
    print(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")

    # 9. co-attention serving through the predict CLI: the
    # ggnn_coattention model (parallel co-attention, NTN head) on K1
    coattn_cfg = dict(cfg, sim_method="ntn", attn="para")
    coattn_config = dict(ggnn_config, sim_method="ntn", attn="para")
    serve_coattn = serve_slice(
        "co-attention (para, ntn)", coattn_config, coattn_cfg, ds, df, dev,
        smi, reset_counts, read_counts, ["fused_ggnn"],
        absent=k2_kernels + ["fused_ggnn_mid"])
    print(f"phase 9 done at {time.perf_counter() - t_start:.1f} s")

    # 10. co-attention training through the train CLI: the ref_scale_para
    # flags for 2 epochs on K1/K1b, then one scan epoch of nie under
    # TWOPASS on K1m/K3, then both steps timed at batch 2048
    coattn_flags = ["--method", "ggnn", "--conv-layers", str(L),
                    "--fp-hidden-dim", str(H), "--fp-out-dim", str(D),
                    "--weight-tying", "false", "--compute-path", "coo",
                    "--lr", "2e-3", "--augment", "--sim-method", "ntn"]
    coattn_train = TrainConfig(
        method="ggnn", sim_method="ntn", attn="para", conv_layers=L,
        fp_hidden_dim=H, fp_out_dim=D, weight_tying=False,
        compute_path="coo", learning_rate=2e-3, augment=True,
        batch_size=N_PAIRS)
    nie_cfg = dict(cfg, sim_method="ntn", attn="nie")
    nie_train = dataclasses.replace(coattn_train, attn="nie", scan_steps=10)
    k1b_kernels = ["fused_ggnn_bwd"]
    twopass_kernels = ["fused_ggnn_mid", "fused_ggnn_half_bwd"]
    try:
        set_form(False, False)
        train_coattn, _ = train_slice(
            "co-attention (para, ntn)", coattn_flags + ["--attn", "para"],
            N_PAIRS, coattn_train, coattn_cfg, {"fused_ggnn_bwd": 1},
            ["fused_ggnn"], ((N_PAIRS, 10),), dev, smi, reset_counts,
            read_counts, n_train=N_PROD_TRAIN,
            absent=k2_kernels + twopass_kernels)
        set_form(False, True)
        train_nie, _ = train_slice(
            "co-attention (nie, ntn) scan two-pass",
            coattn_flags + ["--attn", "nie", "--scan-steps", "10"], N_PAIRS,
            nie_train, nie_cfg,
            {"fused_ggnn_mid": 1, "fused_ggnn_half_bwd": 2}, [],
            ((N_PAIRS, 10),), dev, smi, reset_counts, read_counts,
            n_train=N_PROD_TRAIN, epochs=1, absent=k2_kernels + k1b_kernels)
    finally:
        set_form(*saved_form)
    print(f"phase 10 done at {time.perf_counter() - t_start:.1f} s")

    # 11. evaluation and the trainer's modes on phase 5's run
    t11 = time.perf_counter()
    evaluate_ggnn = run_modes(kept.name, df, dev, smi, reset_counts,
                              read_counts)
    print(f"phase 11: {time.perf_counter() - t11:.1f} s")
    print(f"phase 11 done at {time.perf_counter() - t_start:.1f} s")

    # 12. the packed encoders that run no kernel, and the generator
    t12 = time.perf_counter()
    encoder_slices(df, dev, smi, reset_counts, read_counts)
    print(f"phase 12: {time.perf_counter() - t12:.1f} s")
    print(f"phase 12 done at {time.perf_counter() - t_start:.1f} s")

    # 13. GWM, and compute_path packed through the GGNN and MPNN kernels
    t13 = time.perf_counter()
    gwm_slice(df, dev, smi, reset_counts, read_counts)
    train_packed_ggnn, _ = train_slice(
        "ggnn packed", ["--preset", "ggnn_hole_binary", "--compute-path",
                        "packed"], SERVE_BATCH,
        dataclasses.replace(preset, compute_path="packed"), cfg,
        {"fused_ggnn_readout_bwd": 1}, ["fused_ggnn_readout"],
        (), dev, smi, reset_counts, read_counts)
    train_packed_mpnn, _ = train_slice(
        "mpnn packed", [f if f != "coo" else "packed" for f in MPNN_FLAGS],
        SERVE_BATCH, dataclasses.replace(mpnn_train_cfg,
                                         compute_path="packed"),
        dict(MPNN_CFG, s2s_n_max=24),
        {"fused_mpnn_bwd": 1, "fused_set2set_bwd": 1},
        ["fused_mpnn", "fused_set2set"], (), dev, smi, reset_counts,
        read_counts)
    print(f"phase 13: {time.perf_counter() - t13:.1f} s")
    print(f"phase 13 done at {time.perf_counter() - t_start:.1f} s")

    # 14. the padded layout, the train CLI's default
    t14 = time.perf_counter()
    padded_slice(df, dev, smi, reset_counts, read_counts, cfg)
    print(f"phase 14: {time.perf_counter() - t14:.1f} s")
    print(f"phase 14 done at {time.perf_counter() - t_start:.1f} s")

    # 15. the analysis routes on the card against the CPU: saliency on
    # phase 5's run and a RelGCN run, fixed-embedding runs, the GAE
    t15 = time.perf_counter()
    try:
        analysis_slice(kept.name, df, smi, reset_counts, read_counts)
    finally:
        kept.cleanup()
    t15 = time.perf_counter() - t15
    print(f"phase 15: {t15:.1f} s, "
          f"{100 * t15 / (time.perf_counter() - t_start):.1f}% of the script")
    print(f"phase 15 done at {time.perf_counter() - t_start:.1f} s")

    # 16. GGNN's research options, GGNN-dev, the research predictor, MPNN's
    # ggnn forms, and MPNN with co-attention on coo (K5/K5b, K4/K4b)
    t16 = time.perf_counter()
    train_mpnn_coattn = research_slice(df, dev, smi, reset_counts,
                                       read_counts)
    t16 = time.perf_counter() - t16
    print(f"phase 16: {t16:.1f} s, "
          f"{100 * t16 / (time.perf_counter() - t_start):.1f}% of the script")
    print(f"phase 16 done at {time.perf_counter() - t_start:.1f} s")

    # 17. graph-sharded training (--multi-device) through the train CLI:
    # the flagship (K2/K2b), co-attention pair-local (K1/K1b), MPNN (K5/K5b,
    # K4/K4b), each against its single-device run
    multi_device = multi_device_slice(dev, smi, reset_counts, read_counts)
    print(f"phase 17 done at {time.perf_counter() - t_start:.1f} s")

    # 18. the prefetcher: four paths with prefetch=0 and 2 through the
    # Trainer on phase 8's pairs, then the race check
    prefetch_slice(prod_ds, dev, smi, reset_counts, read_counts)
    print(f"phase 18 done at {time.perf_counter() - t_start:.1f} s")

    # 19. the ref_scale_fused64 row (H = D = 64) through the train CLI in
    # the three forms, then its final parameters served
    try:
        fused64, serve64 = fused_train_slice(
            19, "fused64", FUSED64_CFG, ds, df, dev, smi, reset_counts,
            read_counts, set_form)
    finally:
        set_form(*saved_form)
    print(f"phase 19 done at {time.perf_counter() - t_start:.1f} s")

    # 20. the h=128 fused model (H = D = 128) served through the predict CLI
    # in the K2 and K1 forms and scored through the evaluate CLI
    try:
        serve128, serve128_k1, evaluate128 = fused128_slice(
            ds, df, dev, smi, reset_counts, read_counts, set_form)
    finally:
        set_form(*saved_form)
    print(f"phase 20 done at {time.perf_counter() - t_start:.1f} s")

    # 21. the h=128 model (H = D = 128) trained through the train CLI in the
    # three forms, then its final parameters served
    try:
        fused128, _ = fused_train_slice(
            21, "fused128", FUSED128_CFG, ds, df, dev, smi, reset_counts,
            read_counts, set_form)
    finally:
        set_form(*saved_form)
    print(f"phase 21 done at {time.perf_counter() - t_start:.1f} s")

    # 22. the dense packed layout on phase 5's pairs: the Python and native
    # dense packers, the flagship's dense predictor and fused_pair_logits in
    # the three forms, MPNN and GWM dense, the dense edgeshard step
    try:
        dense = dense_slice(train_pairs, cfg, dev, smi, reset_counts,
                            read_counts, set_form)
    finally:
        set_form(*saved_form)
    print(f"phase 22 done at {time.perf_counter() - t_start:.1f} s")

    sources = {"fused_ggnn": "fused_ggnn.cu", "fused_ggnn_mid": "fused_ggnn.cu",
               "fused_ggnn_readout": "fused_ggnn.cu",
               "fused_ggnn_bwd": "fused_ggnn_bwd.cu",
               "fused_ggnn_half_bwd": "fused_ggnn_bwd.cu",
               "fused_ggnn_readout_bwd": "fused_ggnn_bwd.cu",
               "fused_mpnn": "fused_mpnn.cu", "fused_mpnn_bwd": "fused_mpnn.cu",
               "fused_set2set": "set2set.cu", "fused_set2set_bwd": "set2set.cu"}
    replaces = {"fused_ggnn": "gcnbmp_tpu/ops/fused_ggnn.py:535",
                "fused_ggnn_mid": "gcnbmp_tpu/ops/fused_ggnn.py:526",
                "fused_ggnn_readout": "gcnbmp_tpu/ops/fused_ggnn.py:818",
                "fused_ggnn_bwd": "gcnbmp_tpu/ops/fused_ggnn.py:583",
                "fused_ggnn_half_bwd": "gcnbmp_tpu/ops/fused_ggnn.py:627",
                "fused_ggnn_readout_bwd": "gcnbmp_tpu/ops/fused_ggnn.py:876",
                "fused_mpnn": "gcnbmp_tpu/ops/fused_mpnn.py:295",
                "fused_mpnn_bwd": "gcnbmp_tpu/ops/fused_mpnn.py:342",
                "fused_set2set": "gcnbmp_tpu/ops/set2set_kernel.py:225",
                "fused_set2set_bwd": "gcnbmp_tpu/ops/set2set_kernel.py:253"}
    # each kernel's main path: the training run that launches it (K1 and
    # K1b the single-pass production epoch, K1m and K3 the two-pass run,
    # K2 and K2b phase 5, the MPNN kernels phase 7); serving counts ride
    # beside those of the kernels that serve
    main_path = {"fused_ggnn": train_single, "fused_ggnn_bwd": train_single,
                 "fused_ggnn_mid": train_twopass,
                 "fused_ggnn_half_bwd": train_twopass,
                 "fused_ggnn_readout": train_ggnn,
                 "fused_ggnn_readout_bwd": train_ggnn,
                 "fused_mpnn": train_mpnn, "fused_mpnn_bwd": train_mpnn,
                 "fused_set2set": train_mpnn, "fused_set2set_bwd": train_mpnn}
    serving = {"fused_ggnn_readout": serve_ggnn, "fused_mpnn": serve_mpnn,
               "fused_set2set": serve_mpnn}
    # the co-attention path's own runs (phases 9 and 10; MPNN: phase 16)
    coattention = {"fused_ggnn": train_coattn, "fused_ggnn_bwd": train_coattn,
                   "fused_ggnn_mid": train_nie,
                   "fused_ggnn_half_bwd": train_nie,
                   "fused_mpnn": train_mpnn_coattn,
                   "fused_mpnn_bwd": train_mpnn_coattn,
                   "fused_set2set": train_mpnn_coattn,
                   "fused_set2set_bwd": train_mpnn_coattn}
    # the runs with compute_path packed (phase 13)
    packed_path = {"fused_ggnn_readout": train_packed_ggnn,
                   "fused_ggnn_readout_bwd": train_packed_ggnn,
                   "fused_mpnn": train_packed_mpnn,
                   "fused_mpnn_bwd": train_packed_mpnn,
                   "fused_set2set": train_packed_mpnn,
                   "fused_set2set_bwd": train_packed_mpnn}
    kernels = []
    for name in sources:
        launches = main_path[name][name]
        if launches == 0:
            raise AssertionError(f"{name} never launched on its main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gcnbmp_tpu_torch/ops/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": launches,
            **({"launches_serving": serving[name][name]}
               if name in serving else {}),
            **({"launches_evaluate": evaluate_ggnn[name]}
               if name == "fused_ggnn_readout" else {}),
            **({"launches_coattention": coattention[name][name]}
               if name in coattention else {}),
            **({"launches_coattention_serving": serve_coattn[name]}
               if name == "fused_ggnn" else {}),
            **({"launches_packed": packed_path[name][name]}
               if name in packed_path else {}),
            # phase 17's NCCL runs; K1m and K3 (TWOPASS) are not on them
            "launches_multi_device": multi_device.get(name, 0),
            # phase 22's dense batches: the two steps of each GGNN form,
            # the MPNN step
            "launches_dense": dense[name],
            **{k: results[name][k] for k in
               ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by")},
            # no single PyTorch call computes any of these functions
            "library_ms": None})
    # the H=64 and H=128 bodies: launches from phase 19's (H=64) and phase
    # 21's (H=128) run of each form, times and bounds from phase 3a (P=75,
    # and P=387 under the _p387 keys); serving beside them (phase 19's
    # final parameters at H=64; phase 20's seeded model at H=128, K2 and K1
    # forms and the evaluate CLI)
    form_of = {"fused_ggnn": "K1/K1b", "fused_ggnn_bwd": "K1/K1b",
               "fused_ggnn_mid": "K1m/K3", "fused_ggnn_half_bwd": "K1m/K3",
               "fused_ggnn_readout": "K2/K2b", "fused_ggnn_readout_bwd": "K2/K2b"}
    beside = {64: {"fused_ggnn_readout": {"launches_serving": serve64}},
              128: {"fused_ggnn_readout": {"launches_serving": serve128,
                                           "launches_evaluate": evaluate128},
                    "fused_ggnn": {"launches_serving": serve128_k1}}}
    for width, (phase, runs) in ((64, (19, fused64)), (128, (21, fused128))):
        for name, form in form_of.items():
            launches = runs[form][name]
            if launches == 0:
                raise AssertionError(f"{name} at H={width} never launched in "
                                     f"phase {phase}")
            r = results[f"{name}_h{width}"]
            kernels.append({
                "name": f"{name}_h{width}", "route": "cuda",
                "source": f"gcnbmp_tpu_torch/ops/csrc/{sources[name]}",
                "replaces": replaces[name], "launches": launches,
                **{key: counts[name] for key, counts in
                   beside[width].get(name, {}).items()},
                **{k + p: r[k + p] for p in ("", "_p387") for k in
                   ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
                # the bound with every operation in f32 (``bound_ms`` is the
                # one on the route the bodies take, 3xTF32)
                **{"bound_f32_ms" + p: r["bound_f32_ms" + p]
                   for p in ("", "_p387")},
                "max_abs_err": r["max_abs_err"], "library_ms": None})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
