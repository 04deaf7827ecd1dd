#!/usr/bin/env python3
"""Where the fused kernels' time goes, on one NVIDIA GPU: K5b, K5, K2 and
K4 timed with one of their phases left out at a time, and the host's part
of one K4 call.

    python3 chip_phases.py

Writes copies of ``fused_mpnn.cu``, ``fused_ggnn.cu`` and ``set2set.cu``
(from ``gcnbmp_tpu_torch/ops/csrc``) in which each phase is guarded by a
SKIP_<phase> macro, builds one library per phase with nvcc (all at once)
into ``results/phases/``, and times each library's C entry point (CUDA
events around runs of 10 back-to-back calls, median of 7) on the first
packed batch of 256 and of 2048 pairs of dataset/synth546's drug test
split: K5b (``fused_mpnn_bwd``) and K5 (``fused_mpnn_fwd``) at the MPNN
quality row's model (L=4 tied, C=32), K2 (``fused_ggnn_readout_fwd``) at
the flagship GGNN (L=8 untied, H=32), K4 (``fused_set2set_fwd``) on the
Set2Set table the MPNN trainer builds from K5's output (M = 512 and 4096
molecules, n_max = 24, 3 steps), seeded random weights.  A library
without a phase computes wrong results: only its time is read.  The full
kernel is timed first and last, and once more at one layer (K4: one
step), which splits what grows with L from what does not.  Prints, per
phase, the time without it and the difference to the full kernel: what
the phase costs, overlap with the rest included.  Then K4's host split:
the host microseconds per call (host clock around 10 rounds of 100
back-to-back calls, before each round's synchronize) and the CUDA-event
microseconds per call of the C entry point, ``_fused_set2set_fwd`` (the
wrapper's checks, output and launch), ``fused_set2set`` (autograd's
Function, under no_grad, and with weights that require grad) and
``PackedSet2Set.forward(fused=True)`` (the slot table, the gather, the
LSTM's weight concatenation and the overflow select besides), and those
parts of it one by one.

Phases (the kernels share some):
  groups    the molecule sums Mmol h (K5, K5b)
  hm        the bg and hm_e products (K5, K5b)
  agg       the out-direction aggregations through the row lists
  scan      the adjacency scan, with empty row lists in its place: every
            aggregation, and in K5 the column build and the in-direction
            gather, then have nothing to do (K5, K2)
  buildcol  the column-list build (K5, K5b)
  ingather  the in-direction gather (K5, K5b)
  gates     the GRU's input products (K5, K5b; K2 the whole gates step)
  load      the weight loads after the first layer's (K5, K2: those
            overlapped with the layer before; K5b: the reverse loop's;
            K4: the bulk copy of wx and wh, its barrier completed empty)
  grad, dx, half, sparse   K5b's reverse: the weight-gradient passes, the
            products against transposed weights, the half-CTA x W^T
            products, the column gather and row scatter
  msg       the message products h W_e + b_e (K2)
  readout   the readout's products (K2)
  stage     K4's bulk copies of the atom tables (barriers completed empty)
  lstm      K4's LSTM products (the gates are then b)
  attend    K4's energies and softmax (p = amask)
  wsum      K4's weighted sums for r

Fails if an anchor of a source is not found (the source changed) or
there is no card.  To time another commit's kernels, run its own copy of
this script from an unpacked archive of that commit.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "results", "phases")
S2S_N_MAX, S2S_STEPS = 24, 3  # the MPNN trainer's Set2Set table and steps
# kernel -> (source, C entry point, its phases)
KERNELS = {
    "K5b": ("fused_mpnn.cu", "fused_mpnn_bwd",
            ("SKIP_GROUPS", "SKIP_HM", "SKIP_AGG", "SKIP_BUILDCOL",
             "SKIP_INGATHER", "SKIP_GATES", "SKIP_LOAD", "SKIP_GRAD",
             "SKIP_DX", "SKIP_HALF", "SKIP_SPARSE")),
    "K5": ("fused_mpnn.cu", "fused_mpnn_fwd",
           ("SKIP_GROUPS", "SKIP_HM", "SKIP_AGG", "SKIP_SCAN", "SKIP_BUILDCOL",
            "SKIP_INGATHER", "SKIP_GATES", "SKIP_LOAD")),
    "K2": ("fused_ggnn.cu", "fused_ggnn_readout_fwd",
           ("SKIP_MSG", "SKIP_AGG", "SKIP_SCAN", "SKIP_GATES", "SKIP_READOUT",
            "SKIP_LOAD")),
    "K4": ("set2set.cu", "fused_set2set_fwd",
           ("SKIP_LOAD", "SKIP_STAGE", "SKIP_LSTM", "SKIP_ATTEND", "SKIP_WSUM")),
}


def _guard(text, old, macro, new=""):
    if old not in text:
        raise RuntimeError(f"{macro}: anchor not found: {old[:70]!r}")
    return text.replace(old, f"#ifndef {macro}\n{old}\n#else\n{new}\n#endif\n", 1)


def _wrap(text, start, end, macro):
    """Guard text[start:end) (end is found after start)."""
    if start not in text:
        raise RuntimeError(f"{macro}: anchor not found: {start[:70]!r}")
    i = text.index(start)
    k = text.index(end, i)
    return text[:i] + f"#ifndef {macro}\n" + text[i:k] + "\n#endif\n" + text[k:]


def _k5b_reverse(t):
    """K5b's reverse-only phases."""
    for call in ("grad_pass<C, 7, 3, 64>(gp", "grad_pass<C, 3, 0, 0>(gp",
                 "grad_pass<C, NE, 0, 0>(gp"):
        t = _guard(t, f"      {call}, false, false, tid);", "SKIP_GRAD")
    t = _wrap(t, "#pragma unroll 1\n    for (int j0 = 0; j0 < C; j0 += 4) {\n      dx_chunk",
              "    __syncthreads();\n    // x, r*s and dn' are dead", "SKIP_DX")
    t = _guard(t, "      add_xwt<C, HALF>(s_gdbg, s.m0t, hcol, hrow0, acc);", "SKIP_HALF")
    t = _guard(t, "      for (int e = 0; e < NE; ++e)\n        add_xwt<C, HALF>("
               "s.hm + e * TC, s.wt + e * C * CP, hcol, hrow0, acc);", "SKIP_HALF")
    t = _guard(t, "    load_layer_padded<C>(w, l, s, tid);\n    for (int i = tid; i < TC; "
               "i += THREADS) s.h[i] = hs_t[size_t(l) * TC + i];", "SKIP_LOAD",
               "    for (int i = tid; i < TC; i += THREADS) s.h[i] = hs_t[size_t(l) * TC + i];")
    return _guard(t, "    column_gather<C>(adj_t, s.dh, s.cs, s.cr, s.cv, s.ov, n_ov, s.hm, tid);\n"
                  "    __syncthreads();\n    row_scatter<C>(adj_t, s.xi, s.hm, s, tid);",
                  "SKIP_SPARSE")


def _mpnn_layer_steps(t):
    """The layer steps K5 and K5b share: the molecule sums, the products,
    the in-direction gather and the gates' input products."""
    i = t.index("{", t.index("void group_sums(")) + 1
    k = t.index("\n}\n", i)
    t = t[:i] + "\n#ifndef SKIP_GROUPS" + t[i:k] + "\n#endif" + t[k:]
    t = _wrap(t, "#pragma unroll 1\n  for (int d0 = 0; d0 < C; d0 += 4) {\n    float wv[NE][4]",
              "\n#pragma unroll\n  for (int e = 0; e < NE; ++e)\n#pragma unroll\n"
              "    for (int k = 0; k < R::RPT; ++k)\n      s.hm[", "SKIP_HM")
    t = _wrap(t, "    for (int e = 0; e < NE; ++e) {\n      const int kc = e * TILE + j;",
              "    s.xi[j * C + col] = acc + bg[k];", "SKIP_INGATHER")
    return _guard(t, "  gate_inputs<C, false>(s.xo, g, 0, col, row0, z, r, n);\n"
                  "  gate_inputs<C, false>(s.xi, g, C, col, row0, z, r, n);", "SKIP_GATES")


def guard_mpnn(src: str) -> str:
    """fused_mpnn.cu with K5 and K5b on one copy of the layer steps."""
    t = _mpnn_layer_steps(src)
    t = _guard(t, "  aggregate<C>(adj_t, s.hm, s.xo, s.nk, s.nv, s.nc, tid);", "SKIP_AGG")
    t = _guard(t, "  scan_rows(adj_t, s.nk, s.nv, s.nc, tid);", "SKIP_SCAN",
               "  for (int i = tid; i < TILE; i += THREADS) s.nc[i] = 0;")
    t = _guard(t, "  count_columns(s.nk, s.nv, s.nc, s.cs, s.cr, s.cv, s.ov, s.ovn,\n"
               "                reinterpret_cast<unsigned*>(s.xi), tid);", "SKIP_BUILDCOL",
               "  for (int q = tid; q <= ROW_LEN; q += THREADS) s.cs[q] = 0;\n"
               "  if (tid == 0) *s.ovn = 0;\n  __syncthreads();")
    t = _guard(t, "    if (next < n_layers) load_messages<C, true>(w, next, s, tid);",
               "SKIP_LOAD")
    t = _guard(t, "    if (l + 1 < n_layers) load_gru<C, true>(w, l + 1, s, tid);", "SKIP_LOAD")
    return _k5b_reverse(t)


def guard_ggnn(src: str) -> str:
    """fused_ggnn.cu on the blocked layer steps of fused_ggnn_common.cuh."""
    t = _guard(src, "    edge_hw<H>(s_h, s_wmsg, s_bmsg, s_hw, tid);", "SKIP_MSG")
    t = _guard(t, "    aggregate<H>(adj_t, s_hw, s_m, s_nk, s_nv, s_nc, tid);", "SKIP_AGG")
    t = _guard(t, "  scan_rows(adj_t, s_nk, s_nv, s_nc, tid);", "SKIP_SCAN",
               "  for (int i = tid; i < TILE; i += THREADS) s_nc[i] = 0;")
    t = _guard(t, "    ggnn_gates<H>(first, s_h, s_m, g, s_rs, z, r, n, tid);",
               "SKIP_GATES", "    for (int k = 0; k < R::RPT; ++k) z[k] = r[k] = n[k] = 0.0f;")
    t = _guard(t, "    readout_pre<H>(s_h, s_h0, s_wi, s_wj, s_bi, s_bj, gi, gj, tid);",
               "SKIP_READOUT", "    for (int k = 0; k < R::RPT; ++k) gi[k] = gj[k] = 0.0f;")
    return _guard(t, "    if (l + 1 < n_layers)\n"
                  "      load_message_padded<H, true>(w, l + 1, s_wmsg, s_bmsg, tid);", "SKIP_LOAD")


def _span(text, start, end, macro, new=""):
    """Guard text from ``start`` up to ``end`` (found after it), with
    ``new`` in its place."""
    if start not in text:
        raise RuntimeError(f"{macro}: anchor not found: {start[:70]!r}")
    i = text.index(start)
    if end not in text[i:]:
        raise RuntimeError(f"{macro}: anchor not found: {end[:70]!r}")
    return _guard(text, text[i:text.index(end, i)], macro, new)


def guard_set2set(src: str) -> str:
    """set2set.cu's K4: a group of four warps per molecule."""
    t = _span(src, "    mbar_expect_tx(wbar, 3 * C * G * 4);", "  }\n  __syncthreads();",
              "SKIP_LOAD", "    mbar_expect_tx(wbar, 0);")
    t = _guard(t, "    mbar_expect_tx(tbar + buf, bytes);\n    bulk_copy(s_g + buf * pl.table, "
               "atoms + size_t(mol) * pl.table, bytes, tbar + buf);", "SKIP_STAGE",
               "    mbar_expect_tx(tbar + buf, 0);")
    t = _span(t, "      if (s > 0) {\n        float a0", "      s_y[tid] = tid / C",
              "SKIP_LSTM")
    t = _span(t, "    const int u = tid % EPT;", "    // r = sum_n", "SKIP_ATTEND",
              "    float p[NPL];\n    for (int k = 0; k < NPL; ++k) p[k] = am[k];")
    return _span(t, "    float acc = 0.0f;\n#pragma unroll\n    for (int k = 0; k < NPL",
                 "    s_part[part * C + ch] = acc;", "SKIP_WSUM",
                 "    const float acc = p[0];")


GUARDS = {"fused_mpnn.cu": guard_mpnn, "fused_ggnn.cu": guard_ggnn,
          "set2set.cu": guard_set2set}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_phases.py: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    import pandas as pd

    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.data import CSVPairParser, estimate_coo_capacities
    from gcnbmp_tpu_torch.data.wire import compact_coo_arrays, iter_coo_eval_batches
    from gcnbmp_tpu_torch.models.packed import (
        _device_slot_table, decode_compact_wire, make_packed_predictor)
    from gcnbmp_tpu_torch.ops import build
    from gcnbmp_tpu_torch.ops import fused_ggnn as fg
    from gcnbmp_tpu_torch.ops import fused_mpnn as fm
    from gcnbmp_tpu_torch.ops import set2set_kernel as sk
    from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo_flat
    from gcnbmp_tpu_torch.ops.slotgather import gather_slot_table, identity_mol_row

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    variants = {}  # (source, macro) -> library path
    for source, guard in GUARDS.items():
        with open(os.path.join(build.CSRC, source)) as f:
            text = guard(f.read())
        with open(os.path.join(OUT, source), "w") as f:
            f.write(text)
        for macro in {"NONE", *(m for s, _, ph in KERNELS.values() if s == source
                                for m in ph)}:
            variants[source, macro] = os.path.join(
                OUT, f"lib_{os.path.splitext(source)[0]}_{macro}.so")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    t0 = time.perf_counter()
    procs = {key: subprocess.Popen([build._nvcc(), *flags, "-I", build.CSRC,
                                    "-D" + key[1], "-o", path, os.path.join(OUT, key[0])],
                                   stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                   text=True) for key, path in variants.items()}
    for key, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"built {len(variants)} libraries from {build.CSRC} in "
          f"{time.perf_counter() - t0:.1f} s; {smi}")

    dev = torch.device("cuda", 0)
    df = pd.read_csv(os.path.join(ROOT, "dataset", "synth546", "drug",
                                  "ddi_drug_test.csv")).head(2048)
    ds = CSVPairParser().parse(df).dataset
    mpnn_cfg = dict(fp_hidden_dim=32, fp_out_dim=32, conv_layers=4,
                    weight_tying=True, method="mpnn", s2s_n_max=S2S_N_MAX)
    ggnn_cfg = dict(fp_hidden_dim=32, fp_out_dim=32, conv_layers=8,
                    weight_tying=False)
    encs = {name: from_jax_params(init_params(c, 2018),
                                  make_packed_predictor(**c)).to(dev).encoder
            for name, c in (("mpnn", mpnn_cfg), ("ggnn", ggnn_cfg))}
    libs = {}
    for (source, macro), path in variants.items():
        handle = ctypes.CDLL(path)
        for name, (src, entry, _) in KERNELS.items():
            if src == source:
                fn = getattr(handle, entry)
                fn.argtypes = build.SOURCES[source][entry]
                libs[name, macro] = fn

    def ms_of(fn, args):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(3):
            if fn(*args, stream) != 0:
                raise RuntimeError("launch failed")
        runs = []
        for _ in range(7):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(10):
                fn(*args, stream)
            b.record()
            b.synchronize()
            runs.append(a.elapsed_time(b) / 10)
        return sorted(runs)[3]

    for bs in (256, 2048):
        tiles, cap = estimate_coo_capacities([ds], bs)
        batch, _ = next(iter_coo_eval_batches(ds, bs, tiles, cap))
        nodes, e_packed, n_edges, left, _ = [
            torch.as_tensor(np.asarray(a)).to(dev) for a in compact_coo_arrays(batch)]
        atom_ids, mol_id, mask, *edges = decode_compact_wire(
            nodes, e_packed, n_edges, 2 * left.shape[0])
        p, t = atom_ids.shape
        adj = adj_from_coo_flat(*edges, num_tiles=p, tile=t)
        mol_id = mol_id.contiguous()
        keep = []  # tensors the pointers below refer to
        with torch.no_grad():
            enc = encs["mpnn"]
            wt, m0t, gru = fm.params_to_fused_mpnn(enc)
            h0 = enc.embed(atom_ids).contiguous()
            dh = torch.as_tensor(np.random.default_rng(2018).standard_normal(
                tuple(h0.shape)).astype(np.float32)).to(dev)
            bufs = fm._bwd_buffers(p, enc.n_layers, 32, dev)
            k5_out = torch.empty_like(h0)
            head = (h0.data_ptr(), adj.data_ptr(), mol_id.data_ptr(), mask.data_ptr(),
                    *fm._weight_ptrs(wt, m0t, gru))
            mpnn_layers = enc.n_layers
            args = {"K5b": lambda n: (*head, dh.data_ptr(), *(b.data_ptr() for b in bufs),
                                      p, n, 32, 1),
                    "K5": lambda n: (*head, k5_out.data_ptr(), p, n, 32, 1)}
            keep += [wt, m0t, gru, h0, dh, bufs, k5_out]
            genc = encs["ggnn"]
            msg_w, msg_b, ggru = fg.params_to_fused(genc)
            gh0 = genc.embed(atom_ids).contiguous()
            ro = genc.readout_0
            readout = (mask, ro.i.dense.weight.T.contiguous(), ro.i.dense.bias.contiguous(),
                       ro.j.dense.weight.T.contiguous(), ro.j.dense.bias.contiguous())
            k2_out = torch.empty_like(gh0)
            keep += [msg_w, msg_b, ggru, gh0, readout, k2_out]
            args["K2"] = lambda n: (gh0.data_ptr(), adj.data_ptr(),
                                    *fg._weight_ptrs(msg_w, msg_b, ggru),
                                    *(x.data_ptr() for x in readout), k2_out.data_ptr(),
                                    None, p, n, 32, 32)
            # K4 on the Set2Set table of K5's output, as the MPNN step builds it
            h = fm.fused_mpnn_reference(mpnn_layers, True, h0, adj, mol_id, mask,
                                        wt, m0t, gru)
            s2s = enc.readout_0.set2set
            num_mols = 2 * left.shape[0]
            ids = mol_id.reshape(-1)
            slots, amask, _ = _device_slot_table(ids, mask.reshape(-1), num_mols,
                                                 S2S_N_MAX)
            atoms = gather_slot_table(h.reshape(-1, 32), slots, amask, ids,
                                      identity_mol_row(num_mols, dev))
            wx, wh, b = s2s.lstm.kernels()
            k4_out = torch.empty((num_mols, 64), dtype=torch.float32, device=dev)
            keep += [h, atoms, amask, wx, wh, b, k4_out]
            args["K4"] = lambda n: (atoms.data_ptr(), amask.data_ptr(), wx.data_ptr(),
                                    wh.data_ptr(), b.data_ptr(), k4_out.data_ptr(),
                                    num_mols, S2S_N_MAX, 32, n)
        layers = {"K5b": mpnn_layers, "K5": mpnn_layers, "K2": genc.n_layers,
                  "K4": S2S_STEPS}
        labels = {"K5b": "L=4 tied C=32", "K5": "L=4 tied C=32",
                  "K2": "L=8 untied H=32 D=32",
                  "K4": f"M={num_mols} n_max={S2S_N_MAX} C=32 S={S2S_STEPS}"}
        for name, (_, _, phases) in KERNELS.items():
            full_args = args[name](layers[name])
            first = ms_of(libs[name, "NONE"], full_args)
            times = {m: ms_of(libs[name, m], full_args) for m in phases}
            last = ms_of(libs[name, "NONE"], full_args)
            one = ms_of(libs[name, "NONE"], args[name](1))
            full = (first + last) / 2
            print(f"{name} batch={bs} P={p} {labels[name]}: every phase {first:.4f} "
                  f"ms first, {last:.4f} ms last; one {'step' if name == 'K4' else 'layer'}"
                  f" {one:.4f} ms (CUDA events, C entry point) on {smi}")
            for m, ms in times.items():
                print(f"  {m[5:].lower():10s} left out: {ms:.4f} ms, costs "
                      f"{full - ms:+.4f} ms ({100 * (full - ms) / full:.1f}%)")
        # the host's part of one K4 call, layer by layer of the call
        lib = build.load_library()
        ptrs = args["K4"](S2S_STEPS)
        stream = torch.cuda.current_stream().cuda_stream
        k4 = (S2S_STEPS, atoms, amask, wx, wh, b)
        grads = [x.detach().clone().requires_grad_() for x in (wx, wh, b)]
        flat, mask_flat = h.reshape(-1, 32), mask.reshape(-1)
        mol_row = identity_mol_row(num_mols, dev)
        with torch.no_grad():
            host_split(torch, f"K4 batch={bs} {labels['K4']}", smi, [
                ("C entry point", lambda: lib.fused_set2set_fwd(*ptrs, stream)),
                ("_fused_set2set_fwd", lambda: sk._fused_set2set_fwd(*k4)),
                ("fused_set2set", lambda: sk.fused_set2set(*k4)),
                ("PackedSet2Set.forward(fused=True)",
                 lambda: s2s(h, mol_id, mask, num_mols, fused=True)),
                # the parts of PackedSet2Set.forward around K4
                ("_device_slot_table", lambda: _device_slot_table(
                    ids, mask_flat, num_mols, S2S_N_MAX)),
                ("identity_mol_row", lambda: identity_mol_row(num_mols, dev)),
                ("gather_slot_table", lambda: gather_slot_table(
                    flat, slots, amask, ids, mol_row)),
                ("OptimizedLSTMCell.kernels()", s2s.lstm.kernels)])
        host_split(torch, f"K4 batch={bs} {labels['K4']}, weights requiring grad",
                   smi, [("fused_set2set", lambda: sk.fused_set2set(
                       S2S_STEPS, atoms, amask, *grads))])
    return 0


def host_split(torch, tag, smi, parts, rounds=10, calls=100):
    """Each of ``parts`` (label, call) over rounds x calls back-to-back
    calls: the host's microseconds per call (host clock around each round's
    calls, before the round's synchronize: what the host spends to enqueue
    one) and the CUDA-event microseconds per call over all rounds."""
    print(f"{tag}: host split over {rounds * calls} calls on {smi}")
    for label, fn in parts:
        for _ in range(20):  # warm up
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        host = 0.0
        a.record()
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            host += time.perf_counter() - t0
            torch.cuda.synchronize()
        b.record()
        b.synchronize()
        n = rounds * calls
        print(f"  {label}: host {1e6 * host / n:.2f} us per call, CUDA events "
              f"{1e3 * a.elapsed_time(b) / n:.2f} us per call")


if __name__ == "__main__":
    sys.exit(main())
