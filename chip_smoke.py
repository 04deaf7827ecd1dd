#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: the card's name and power limit; TF32 off.
2. build: compile the CUDA kernels from ``gcnbmp_tpu_torch/ops/csrc``,
   one nvcc per source, all at once; print ptxas's registers and spills,
   and those of each instance of the forward and backward bodies (K1,
   K1m, K2, the GGNN reverse body, K5, K5b, K4, K4b's two kernels); an
   instance of the GGNN or MPNN bodies or of K4 that spills fails.
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
      split); K1m's h must equal K1's bit for bit, K3's two halves summed
      must equal K1b within the gradient bound, and two K2 runs, and two
      K2b runs, on the same inputs must give the same bits;
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

Prints the kernels' JSON line (with each kernel's bound: the larger of
its bytes over 3.35 TB/s and its f32 operations over 67 TFLOP/s, counted
from this run's inputs, the sparse products by their nonzeros), the
nvidia-smi line, and last the device JSON line.  Exits non-zero when
CUDA is unavailable or the port's package is not beside this script.
"""

from __future__ import annotations

import collections
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
# NVIDIA's H100 SXM data sheet: HBM bytes/s, and f32 FLOP/s outside the
# tensor cores, the arithmetic every kernel here does
PEAK_BYTES_S, PEAK_F32_FLOPS = 3.35e12, 67e12


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


def ggnn_flops(p, hidden, nnz, lo, hi, readout=False, backward=False):
    """f32 operations of GGNN layers [lo, hi) over p tiles.  Per layer and
    tile: the message product 8TH^2, the GRU's input products 12TH^2 and
    state products 6TH^2 (none at layer 0, whose state is zero), the
    aggregation 2H per adjacency nonzero; the readout 6TH^2 (D = H).  A
    backward rebuilds the forward once (the kernels save only inputs)
    and takes two products for each dense product (input and weight
    gradients) and one for the aggregation (the adjacency gets none)."""
    dense = p * TILE * hidden ** 2 * (26 * (hi - lo) - (6 if lo == 0 else 0)
                                     + (6 if readout else 0))
    sparse = 2 * nnz * hidden * (hi - lo)
    return 3 * dense + 2 * sparse if backward else dense + sparse


def mpnn_flops(p, hidden, n_layers, carry_state, nnz, mol_pairs,
               backward=False):
    """As ``ggnn_flops`` for EdgeNet layers: per layer and tile the
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


# the bodies whose registers and spills phase 2 reports: the pattern of an
# instance's mangled name, and its name from the match
BODIES = (
    (r"fused_ggnn_kernelILi(\d+)ELb([01])ELb([01])E",
     lambda m: f"fused_ggnn_kernel<{m[1]}> "
               f"({'K2' if m[2] == '1' else 'K1m' if m[3] == '1' else 'K1'})"),
    (r"fused_mpnn_kernelILi(\d+)E", lambda m: f"fused_mpnn_kernel<{m[1]}> (K5)"),
    (r"fused_ggnn_bwd_kernelILi(\d+)ELb([01])E",
     lambda m: f"fused_ggnn_bwd_kernel<{m[1]}, {'true' if m[2] == '1' else 'false'}>"),
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
    ok = bool((err <= ATOL + RTOL * want.abs()).all())
    print(f"{name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(atol={ATOL}, rtol={RTOL}) {'ok' if ok else 'FAIL'}")
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
# the profiler's keys, with their launches per call
BWD_SUM = {"fused_ggnn_bwd_kernel": 1, "sum_tiles_kernel": 1}
WRAPPER_KERNELS = {
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
               reps=REPS):
    """Hold a kernel against its plain version, then time both.  Returns
    (max abs error, kernel ms, plain ms, kernel device ms, the kernel's
    output)."""
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
    dev_ms = device_ms(kern, name, torch)
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
    import ctypes

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
    """Device busy share and the top kernels by device time over n_steps
    calls of step(i), from torch.profiler."""
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
    busy = (f"device busy {100 * total / wall_us:.1f}% of {wall_us / 1e3 / n_steps:.3f} "
            f"ms wall per step (profiled)")
    return busy, "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3 / n_steps:.3f}"
                           for e in top)


def plain_logits(model, args, torch):
    """Logits of the model's plain layer stack (dense adjacency) on a
    wire batch."""
    from gcnbmp_tpu_torch.models.packed import decode_compact_wire
    from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo

    nodes, e_packed, n_edges, left, right = args
    num_mols = 2 * left.shape[0]
    atom_ids, mol_id, mask, *edges = decode_compact_wire(
        nodes, e_packed, n_edges, num_mols)
    adj = adj_from_coo(*edges, num_tiles=atom_ids.shape[0],
                       tile=atom_ids.shape[1])
    g, _ = model.encoder(atom_ids, adj, mol_id, mask, num_mols)
    return model.head(g[left.long()], g[right.long()])


def serve_slice(tag, config, cfg, ds, df, dev, smi, reset_counts, read_counts,
                kernels):
    """Serve the pairs through predict.main with seeded weights; each of
    ``kernels`` must launch once per request; the logits must match the
    plain layer stack.  Returns the launch counts."""
    import numpy as np
    import pandas as pd
    import torch

    from gcnbmp_tpu_torch.cli import predict
    from gcnbmp_tpu_torch.convert import (
        from_jax_params, init_params, save_params_npz)
    from gcnbmp_tpu_torch.data import estimate_coo_capacities
    from gcnbmp_tpu_torch.data.wire import (
        compact_coo_arrays, iter_coo_eval_batches)
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor

    n_batches = -(-N_PAIRS // SERVE_BATCH)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        cfg_path = os.path.join(tmp, "config.json")
        params_path = os.path.join(tmp, "params.npz")
        in_path = os.path.join(tmp, "pairs.csv")
        out_path = os.path.join(tmp, "preds.csv")
        with open(cfg_path, "w") as f:
            json.dump(config, f)
        save_params_npz(params_path, init_params(cfg, SEED))
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
        probs = pd.read_csv(out_path)["prob"].to_numpy()
        if len(probs) != N_PAIRS or not np.all(np.isfinite(probs)) or \
                probs.min() < 0 or probs.max() > 1:
            raise AssertionError("probs not finite in [0, 1] for every pair")

    # the same batches: kernel path vs the plain layer stack on the card
    model = from_jax_params(init_params(cfg, SEED),
                            make_packed_predictor(**cfg)).to(dev).eval()
    tiles, cap = estimate_coo_capacities([ds], SERVE_BATCH)
    got_l, want_l = [], []
    serve_s = 0.0
    with torch.no_grad():
        for batch, valid in iter_coo_eval_batches(ds, SERVE_BATCH, tiles, cap):
            args = [torch.as_tensor(np.asarray(a)).to(dev)
                    for a in compact_coo_arrays(batch)]
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
                read_counts, n_train=N_PAIRS, epochs=TRAIN_EPOCHS, absent=()):
    """The train CLI on the card with ``flags`` at ``batch_size`` on the
    first ``n_train`` train pairs for ``epochs`` epochs; each kernel of
    ``per_step`` must launch that many times per step, each of
    ``fwd_kernels`` at least once per step and each of ``absent`` never.
    Then one step's gradients vs the plain layer stack, and the step's
    time and profile at each of ``time_batches`` (batch size, steps).
    Returns the launch counts and the parsed train pairs."""
    import numpy as np
    import pandas as pd
    import torch

    from gcnbmp_tpu_torch.cli import predict
    from gcnbmp_tpu_torch.cli import train as train_cli
    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.data import CSVPairParser, estimate_coo_capacities
    from gcnbmp_tpu_torch.data.wire import (
        compact_coo_arrays, iter_coo_eval_batches)
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
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
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
            for a in compact_coo_arrays(batch)]
    labels = torch.as_tensor(batch.labels).to(dev)
    params = list(model.parameters())
    loss_k = train_loop.sigmoid_cross_entropy(model(*args), labels)
    grads_k = torch.autograd.grad(loss_k, params)
    loss_p = train_loop.sigmoid_cross_entropy(plain_logits(model, args, torch),
                                              labels)
    grads_p = torch.autograd.grad(loss_p, params)
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
    batches staged on the card beforehand; returns ms per step."""
    import numpy as np
    import torch

    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.data import estimate_coo_capacities
    from gcnbmp_tpu_torch.data.wire import (
        compact_coo_arrays, packed_coo_batch_iterator)
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor
    from gcnbmp_tpu_torch.train import loop as train_loop

    tiles, cap = estimate_coo_capacities([train_ds], bs)
    rng = np.random.default_rng(SEED)
    staged = []
    for b in packed_coo_batch_iterator(train_ds, bs, tiles, cap, rng):
        staged.append(([torch.as_tensor(np.asarray(a)).to(dev)
                        for a in compact_coo_arrays(b)],
                       torch.as_tensor(b.labels).to(dev)))
        if len(staged) == 8:
            break
    model = from_jax_params(init_params(model_cfg, SEED),
                            make_packed_predictor(**model_cfg)).to(dev)
    opt, _ = train_loop.build_optimizer(train_cfg, 1000,
                                        list(model.parameters()))
    for i in range(3):  # warm up
        train_loop.train_step(model, opt, *staged[i % len(staged)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_steps):
        train_loop.train_step(model, opt, *staged[i % len(staged)])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    busy, top = profile_steps(
        lambda i: train_loop.train_step(model, opt, *staged[i % len(staged)]),
        n_steps)
    print(f"{tag} train step: batch={bs} P={tiles}: {step_ms:.3f} ms per "
          f"step, {bs * 1e3 / step_ms:.1f} pairs/s (host clock around "
          f"{n_steps} back-to-back steps on staged batches) on {smi}")
    print(f"  where it goes (torch.profiler over {n_steps} steps): {busy}; "
          f"top kernels, device ms per step: {top}")
    return step_ms


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

    counters = {"fused_ggnn": fused_ggnn, "fused_ggnn_mid": fused_ggnn_mid,
                "fused_ggnn_readout": fused_ggnn_readout,
                "fused_ggnn_bwd": fused_ggnn_bwd,
                "fused_ggnn_half_bwd": fused_ggnn_half_bwd,
                "fused_ggnn_readout_bwd": fused_ggnn_readout_bwd,
                "fused_mpnn": fused_mpnn, "fused_mpnn_bwd": fused_mpnn_bwd,
                "fused_set2set": fused_set2set,
                "fused_set2set_bwd": fused_set2set_bwd}

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
               inputs):
        """Print the case's bound (from its inputs and the kernel's
        outputs); keep the worst error over the cases, and the headline
        case's times and bound."""
        b_ms, b_by = bound(flops, nbytes(inputs, got))
        print(f"  bound {name} [{tag}]: {b_ms:.4f} ms, by {b_by} "
              f"({flops / 1e9:.3f} GFLOP, {nbytes(inputs, got) / 1e6:.1f} MB)")
        r = results[name]
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        if headline:
            r["ms"], r["plain_ms"], r["device_ms"] = k_med, p_med, dev_ms
            r["bound_ms"], r["bound_by"] = b_ms, b_by

    # 3a. GGNN
    cfg = dict(fp_hidden_dim=H, fp_out_dim=D, conv_layers=L,
               weight_tying=False)
    cases = [(SERVE_BATCH, cfg, False), (N_PAIRS, cfg, False),
             (SERVE_BATCH, dict(cfg, fp_hidden_dim=16, fp_out_dim=16), False),
             (SERVE_BATCH, cfg, True),
             (SERVE_BATCH, dict(cfg, conv_layers=3), False)]
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

            def flops(lo, hi, **kw):
                return ggnn_flops(p_tiles, hidden, nnz, lo, hi, **kw)

            headline = bs == SERVE_BATCH and c is cfg and not crowd
            reps = REPS if headline else REPS_OTHER
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
                record(name, tag + rng_tag,
                       *check_pair(name, tag + rng_tag, kern, plain, grads,
                                   GRU_KEYS, smi, torch, reps),
                       head, ops, inputs)
            # K1m is K1 with one more store: the same h, bit for bit
            if not torch.equal(fused_ggnn_mid(*k1_args)[0], fused_ggnn(*k1_args)):
                raise AssertionError(f"K1m's h differs from K1's [{tag}]")
            if not odd:
                repeat_bits("K2", tag, lambda: fused_ggnn_readout(
                    *k1_args, *readout), torch)
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
    ggnn_config = {"method": "ggnn", "sim_method": "hole", "conv_layers": L,
                   "fp_hidden_dim": H, "fp_out_dim": D, "weight_tying": False,
                   "net_hidden_dims": [], "class_num": 1}
    serve_ggnn = serve_slice("ggnn", ggnn_config, cfg, ds, df, dev, smi,
                             reset_counts, read_counts, ["fused_ggnn_readout"])

    # 5. GGNN training through the train CLI
    preset = PRESETS["ggnn_hole_binary"]
    train_ggnn, _ = train_slice(
        "ggnn", ["--preset", "ggnn_hole_binary", "--compute-path", "fused"],
        preset.batch_size, preset, cfg, {"fused_ggnn_readout_bwd": 1},
        ["fused_ggnn_readout"], ((preset.batch_size, 50), (N_PAIRS, 10)),
        dev, smi, reset_counts, read_counts)
    print(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")

    # 6. MPNN serving through the predict CLI
    mpnn_config = {"method": "mpnn", "sim_method": "hole",
                   "conv_layers": MPNN_CFG["conv_layers"], "fp_hidden_dim": H,
                   "fp_out_dim": D, "weight_tying": True,
                   "net_hidden_dims": [], "class_num": 1}
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
            **{k: results[name][k] for k in
               ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by")},
            # no single PyTorch call computes any of these functions
            "library_ms": None})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
