#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: the card's name and power limit; TF32 off.
2. build: compile the CUDA kernels from ``gcnbmp_tpu_torch/ops/csrc``.
3. kernels vs plain: K1 (``fused_ggnn``) and K2 (``fused_ggnn_readout``)
   against their plain PyTorch versions on the card, at the shapes of real
   packed batches (the first 2048 pairs of dataset/synth546's drug test
   split at batch 256 and 2048; flagship L=8, H=32, D=32), one H=16
   case, and one batch-256 case whose adjacency has rows with more than
   the kernel's 16 neighbour slots; errors, and median CUDA-event times
   of both per call over runs of back-to-back calls.
4. the slice: ``gcnbmp_tpu_torch.cli.predict.main`` serves those 2048
   pairs at batch 256 (eight requests) with seeded random weights; the
   kernel launch counts must show the path went through K2 once per
   batch, every prob must be finite and in [0, 1], and the logits must
   match the plain layer stack of the same model on the card.

Prints the kernels' JSON line, the nvidia-smi line, and last the device
JSON line.  Exits non-zero when CUDA is unavailable or the port's
package is not beside this script.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_test.csv")
N_PAIRS = 2048
SERVE_BATCH = 256
L, H, D = 8, 32, 32
ATOL = RTOL = 1e-4  # f32 sums in another order across 8 layers
SEED = 2018
REPS = 20
BACK_TO_BACK = 10


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

    from gcnbmp_tpu_torch.cli import predict
    from gcnbmp_tpu_torch.convert import (
        from_jax_params, init_params, save_params_npz)
    from gcnbmp_tpu_torch.data import CSVPairParser, estimate_coo_capacities
    from gcnbmp_tpu_torch.data.wire import (
        compact_coo_arrays, iter_coo_eval_batches)
    from gcnbmp_tpu_torch.models.packed import (
        decode_compact_wire, make_packed_predictor)
    from gcnbmp_tpu_torch.ops import build
    from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo, adj_from_coo_flat
    from gcnbmp_tpu_torch.ops.fused_ggnn import (
        fused_ggnn, fused_ggnn_readout, fused_ggnn_readout_reference,
        fused_ggnn_reference, params_to_fused)

    # 1. device
    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{build.last_build_seconds} s)")
    for line in (build.last_build_log or "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")

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

    def kernel_inputs(model, args):
        nodes, e_packed, n_edges, left, _ = args
        num_mols = 2 * left.shape[0]
        atom_ids, _, mask, *edges = decode_compact_wire(
            nodes, e_packed, n_edges, num_mols)
        p, t = atom_ids.shape
        adj = adj_from_coo_flat(*edges, num_tiles=p, tile=t)
        enc = model.encoder
        msg_w, msg_b, gru = params_to_fused(enc)
        ro = enc.readout_0
        readout = (mask, ro.i.dense.weight.T.contiguous(), ro.i.dense.bias,
                   ro.j.dense.weight.T.contiguous(), ro.j.dense.bias)
        return (enc.n_layers, enc.embed(atom_ids), adj, msg_w, msg_b,
                gru), readout

    def crowd_rows(k1_args):
        """The same inputs with ~5% of the columns of every other adjacency
        row set to 1: rows with more nonzeros than the kernel's NBR_CAP=16
        neighbour slots, which it rescans densely at every layer."""
        n_layers, h0, adj, *rest = k1_args
        rng = np.random.default_rng(SEED)
        extra = torch.as_tensor(rng.random(tuple(adj.shape)) < 0.05).to(dev)
        extra[:, 1::2, :] = False
        adj = torch.where(extra, torch.ones_like(adj), adj).contiguous()
        crowded = int(((adj != 0).sum(-1) > 16).sum())
        if crowded == 0:
            raise AssertionError("no adjacency row above 16 nonzeros")
        return (n_layers, h0, adj, *rest), crowded

    cfg = dict(fp_hidden_dim=H, fp_out_dim=D, conv_layers=L,
               weight_tying=False)
    results = {"fused_ggnn": {}, "fused_ggnn_readout": {}}
    cases = [(SERVE_BATCH, cfg, False), (N_PAIRS, cfg, False),
             (SERVE_BATCH, dict(cfg, fp_hidden_dim=16, fp_out_dim=16), False),
             (SERVE_BATCH, cfg, True)]
    with torch.no_grad():
        for bs, c, crowd in cases:
            model = from_jax_params(init_params(c, SEED),
                                    make_packed_predictor(**c)).to(dev)
            tiles, args = first_batch(bs)
            k1_args, readout = kernel_inputs(model, args)
            tag = (f"batch={bs} P={tiles} L={c['conv_layers']} "
                   f"H={c['fp_hidden_dim']} D={c['fp_out_dim']}")
            if crowd:
                k1_args, crowded = crowd_rows(k1_args)
                tag += f" rows>16nnz={crowded}"
            pairs = [
                ("fused_ggnn", lambda: fused_ggnn(*k1_args),
                 lambda: fused_ggnn_reference(*k1_args)),
                ("fused_ggnn_readout",
                 lambda: fused_ggnn_readout(*k1_args, *readout),
                 lambda: fused_ggnn_readout_reference(*k1_args, *readout)),
            ]
            for name, kern, plain in pairs:
                err = compare(f"{name} [{tag}]", kern(), plain(), torch)
                kern(), plain()  # warm up
                k_ms, p_ms = [], []
                for _ in range(REPS):  # alternate plain and kernel
                    p_ms.append(cuda_ms(plain, torch))
                    k_ms.append(cuda_ms(kern, torch))
                k_med, p_med = statistics.median(k_ms), statistics.median(p_ms)
                print(f"  time {name} [{tag}]: kernel {k_med:.4f} ms, plain "
                      f"{p_med:.4f} ms per call (median of {REPS} runs of "
                      f"{BACK_TO_BACK} back-to-back calls, CUDA events) "
                      f"on {smi}")
                r = results[name]
                r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
                if bs == SERVE_BATCH and c is cfg and not crowd:
                    r["ms"], r["plain_ms"] = k_med, p_med

    # 4. the slice through the predict CLI
    n_batches = -(-N_PAIRS // SERVE_BATCH)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        cfg_path = os.path.join(tmp, "config.json")
        params_path = os.path.join(tmp, "params.npz")
        in_path = os.path.join(tmp, "pairs.csv")
        out_path = os.path.join(tmp, "preds.csv")
        with open(cfg_path, "w") as f:
            json.dump({"method": "ggnn", "sim_method": "hole",
                       "conv_layers": L, "fp_hidden_dim": H,
                       "fp_out_dim": D, "weight_tying": False,
                       "net_hidden_dims": [], "class_num": 1}, f)
        save_params_npz(params_path, init_params(cfg, SEED))
        df.to_csv(in_path, index=False)
        argv = ["--input", in_path, "--config", cfg_path,
                "--params", params_path, "--out", out_path,
                "--batch-size", str(SERVE_BATCH), "--device", "cuda"]
        fused_ggnn.launches = 0
        fused_ggnn_readout.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = predict.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fused_ggnn": fused_ggnn.launches,
                    "fused_ggnn_readout": fused_ggnn_readout.launches}
        if rc != 0:
            raise AssertionError(f"predict.main returned {rc}")
        print(f"slice: predict.main served {N_PAIRS} pairs in {n_batches} "
              f"requests in {wall:.3f} s = {N_PAIRS / wall:.1f} pairs/s "
              f"(CSV parse + pack + device, first call) on {smi}; "
              f"launches {launches}")
        if launches["fused_ggnn_readout"] != n_batches:
            raise AssertionError(f"K2 launched {launches['fused_ggnn_readout']}"
                                 f" times for {n_batches} batches")
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
            for batch, valid in iter_coo_eval_batches(ds, SERVE_BATCH,
                                                      tiles, cap):
                args = [torch.as_tensor(np.asarray(a)).to(dev)
                        for a in compact_coo_arrays(batch)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = model(*args)
                torch.cuda.synchronize()
                serve_s += time.perf_counter() - t0
                nodes, e_packed, n_edges, left, right = args
                num_mols = 2 * left.shape[0]
                atom_ids, mol_id, mask, *edges = decode_compact_wire(
                    nodes, e_packed, n_edges, num_mols)
                adj = adj_from_coo(*edges, num_tiles=atom_ids.shape[0],
                                   tile=atom_ids.shape[1])
                g, _ = model.encoder(atom_ids, adj, mol_id, mask, num_mols)
                plain = model.head(g[left.long()], g[right.long()])
                got_l.append(logits[:valid])
                want_l.append(plain[:valid])
        got, want = torch.cat(got_l), torch.cat(want_l)
        compare("slice logits (kernel path vs plain layer stack)", got,
                want, torch)
        want_p = torch.sigmoid(want).cpu().numpy().ravel()
        p_err = float(np.abs(probs - want_p).max())
        print(f"slice probs vs plain: max_abs_err={p_err:.3e}")
        if p_err > ATOL:
            raise AssertionError("served probs disagree with the plain model")
        print(f"slice device path: {N_PAIRS / serve_s:.1f} pairs/s "
              f"({serve_s * 1e3 / n_batches:.3f} ms per 256-pair request, "
              f"warm, host clock around synchronized forwards) on {smi}")

    kernels = [{
        "name": "fused_ggnn_readout", "route": "cuda",
        "source": "gcnbmp_tpu_torch/ops/csrc/fused_ggnn.cu",
        "replaces": "gcnbmp_tpu/ops/fused_ggnn.py:818",
        "launches": launches["fused_ggnn_readout"],
        **{k: results["fused_ggnn_readout"][k]
           for k in ("max_abs_err", "ms", "plain_ms")},
    }]
    # K1 shares K2's source and layer loop; the serving path launches K2
    checked = [{
        "name": "fused_ggnn", "route": "cuda",
        "source": "gcnbmp_tpu_torch/ops/csrc/fused_ggnn.cu",
        "replaces": "gcnbmp_tpu/ops/fused_ggnn.py:535",
        "launches": launches["fused_ggnn"],
        **{k: results["fused_ggnn"][k]
           for k in ("max_abs_err", "ms", "plain_ms")},
    }]
    print(json.dumps({"kernels": kernels, "checked_off_path": checked}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
