#!/usr/bin/env python3
"""Where K5b's time goes, on one NVIDIA GPU: K5b timed with one of its
phases left out at a time.

    python3 chip_k5b_phases.py

Writes a copy of ``gcnbmp_tpu_torch/ops/csrc/fused_mpnn.cu`` in which each
phase of the backward body is guarded by a SKIP_<phase> macro, builds one
library per phase with nvcc (all at once) into ``results/k5b_phases/``,
and times each library's ``fused_mpnn_bwd`` (CUDA events around runs of 10
back-to-back calls of the C entry point, median of 7) on the first packed
batch of 256 and of 2048 pairs of dataset/synth546's drug test split,
with the MPNN quality row's model (L=4 tied, C=32) and seeded random
weights.  A library without a phase computes wrong gradients: only its
time is read.  The full kernel is timed first and last.  Prints, per
phase, the time without it and the difference to the full kernel: what
the phase costs, overlap with the rest included.  Fails if an anchor of
the source is not found (the source changed) or there is no card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "results", "k5b_phases")
PHASES = ("SKIP_GROUPS", "SKIP_HM", "SKIP_AGG", "SKIP_BUILDCOL",
          "SKIP_INGATHER", "SKIP_GATES", "SKIP_LOAD", "SKIP_GRAD", "SKIP_DX",
          "SKIP_HALF", "SKIP_SPARSE")


def _guard(text, old, macro, new=""):
    if old not in text:
        raise RuntimeError(f"{macro}: anchor not found in fused_mpnn.cu: {old[:60]!r}")
    return text.replace(old, f"#ifndef {macro}\n{old}\n#else\n{new}\n#endif\n", 1)


def _wrap(text, start, end, macro):
    """Guard text[start:end) (end is found after start)."""
    i = text.index(start)
    k = text.index(end, i)
    return text[:i] + f"#ifndef {macro}\n" + text[i:k] + "\n#endif\n" + text[k:]


def guarded_source(src: str) -> str:
    """The K5b part of fused_mpnn.cu with each phase under its macro."""
    cut = src.index("// K5b's own copies")
    head, t = src[:cut], src[cut:]
    i = t.index("{", t.index("void group_sums(")) + 1
    k = t.index("\n}\n", i)
    t = t[:i] + "\n#ifndef SKIP_GROUPS" + t[i:k] + "\n#endif" + t[k:]
    t = _wrap(t, "#pragma unroll 1\n  for (int d0 = 0; d0 < C; d0 += 4) {\n    float wv[NE][4]",
              "\n#pragma unroll\n  for (int e = 0; e < NE; ++e)\n#pragma unroll\n"
              "    for (int k = 0; k < R::RPT; ++k)\n      s.hm[", "SKIP_HM")
    t = _wrap(t, "    for (int e = 0; e < NE; ++e) {\n      const int kc = e * TILE + j;",
              "    s.xi[j * C + col] = acc + bg[k];", "SKIP_INGATHER")
    for call in ("grad_pass<C, 7, 3, 64>(gp", "grad_pass<C, 3, 0, 0>(gp",
                 "grad_pass<C, NE, 0, 0>(gp"):
        t = _guard(t, f"      {call}, false, false, tid);", "SKIP_GRAD")
    t = _wrap(t, "#pragma unroll 1\n    for (int j0 = 0; j0 < C; j0 += 4) {\n      dx_chunk",
              "    __syncthreads();\n    // x, r*s and dn' are dead", "SKIP_DX")
    t = _guard(t, "      add_xwt<C, HALF>(s_gdbg, s.m0t, hcol, hrow0, acc);", "SKIP_HALF")
    t = _guard(t, "      for (int e = 0; e < NE; ++e)\n        add_xwt<C, HALF>("
               "s.hm + e * TC, s.wt + e * C * CP, hcol, hrow0, acc);", "SKIP_HALF")
    t = _guard(t, "  aggregate<C>(scan, adj_t, s.hm, s.xo, s.nk, s.nv, s.nc, tid);",
               "SKIP_AGG",
               "  if (scan) aggregate<C>(scan, adj_t, s.hm, s.xo, s.nk, s.nv, s.nc, tid);")
    t = _guard(t, "  if (scan) build_columns(s.nk, s.nv, s.nc, s.cs, s.cr, s.cv, s.ov, "
               "s.ovn, tid);", "SKIP_BUILDCOL",  # empty column lists instead
               "  if (scan) { for (int q = tid; q <= ROW_LEN; q += THREADS) s.cs[q] = 0;\n"
               "    if (tid == 0) *s.ovn = 0; __syncthreads(); }")
    t = _guard(t, "  gate_inputs<C, false>(s.xo, g, 0, col, row0, z, r, n);\n"
               "  gate_inputs<C, false>(s.xi, g, C, col, row0, z, r, n);", "SKIP_GATES")
    t = _guard(t, "    load_layer_padded<C>(w, l, s, tid);\n    for (int i = tid; i < TC; "
               "i += THREADS) s.h[i] = hs_t[size_t(l) * TC + i];", "SKIP_LOAD",
               "    for (int i = tid; i < TC; i += THREADS) s.h[i] = hs_t[size_t(l) * TC + i];")
    t = _guard(t, "    column_gather<C>(adj_t, s.dh, s.cs, s.cr, s.cv, s.ov, n_ov, s.hm, tid);\n"
               "    __syncthreads();\n    row_scatter<C>(adj_t, s.xi, s.hm, s, tid);",
               "SKIP_SPARSE")
    return head + t


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_k5b_phases.py: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    import pandas as pd

    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.data import CSVPairParser, estimate_coo_capacities
    from gcnbmp_tpu_torch.data.wire import compact_coo_arrays, iter_coo_eval_batches
    from gcnbmp_tpu_torch.models.packed import decode_compact_wire, make_packed_predictor
    from gcnbmp_tpu_torch.ops import build
    from gcnbmp_tpu_torch.ops import fused_mpnn as fm
    from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo_flat

    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(build.CSRC, "fused_mpnn.cu")) as f:
        src = guarded_source(f.read())
    with open(os.path.join(OUT, "fused_mpnn.cu"), "w") as f:
        f.write(src)
    variants = ["NONE", *PHASES]
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    t0 = time.perf_counter()
    procs = {m: subprocess.Popen([build._nvcc(), *flags, "-I", build.CSRC,
                                  "-D" + m, "-o",
                                  os.path.join(OUT, f"lib_{m}.so"),
                                  os.path.join(OUT, "fused_mpnn.cu")],
                                 stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                 text=True) for m in variants}
    for m, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {m}:\n{err}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"built {len(variants)} libraries in {time.perf_counter() - t0:.1f} s; {smi}")

    dev = torch.device("cuda", 0)
    df = pd.read_csv(os.path.join(ROOT, "dataset", "synth546", "drug",
                                  "ddi_drug_test.csv")).head(2048)
    ds = CSVPairParser().parse(df).dataset
    cfg = dict(fp_hidden_dim=32, fp_out_dim=32, conv_layers=4,
               weight_tying=True, method="mpnn")
    enc = from_jax_params(init_params(cfg, 2018),
                          make_packed_predictor(**cfg)).to(dev).encoder
    libs = {}
    for m in variants:
        fn = ctypes.CDLL(os.path.join(OUT, f"lib_{m}.so")).fused_mpnn_bwd
        fn.argtypes = build.SOURCES["fused_mpnn.cu"]["fused_mpnn_bwd"]
        libs[m] = fn
    for bs in (256, 2048):
        tiles, cap = estimate_coo_capacities([ds], bs)
        batch, _ = next(iter_coo_eval_batches(ds, bs, tiles, cap))
        nodes, e_packed, n_edges, left, _ = [
            torch.as_tensor(np.asarray(a)).to(dev) for a in compact_coo_arrays(batch)]
        atom_ids, mol_id, mask, *edges = decode_compact_wire(
            nodes, e_packed, n_edges, 2 * left.shape[0])
        p, t = atom_ids.shape
        adj = adj_from_coo_flat(*edges, num_tiles=p, tile=t)
        with torch.no_grad():
            wt, m0t, gru = fm.params_to_fused_mpnn(enc)
            h0 = enc.embed(atom_ids).contiguous()
        mol_id = mol_id.contiguous()
        dh = torch.as_tensor(np.random.default_rng(2018).standard_normal(
            tuple(h0.shape)).astype(np.float32)).to(dev)
        dh0, partial, grads, hs = fm._bwd_buffers(p, enc.n_layers, 32, dev)
        ptrs = (h0.data_ptr(), adj.data_ptr(), mol_id.data_ptr(), mask.data_ptr(),
                *fm._weight_ptrs(wt, m0t, gru), dh.data_ptr(), dh0.data_ptr(),
                partial.data_ptr(), grads.data_ptr(), hs.data_ptr(), p,
                enc.n_layers, 32, 1)

        def ms_of(fn):
            stream = torch.cuda.current_stream().cuda_stream
            for _ in range(3):
                if fn(*ptrs, stream) != 0:
                    raise RuntimeError("launch failed")
            runs = []
            for _ in range(7):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(10):
                    fn(*ptrs, stream)
                b.record()
                b.synchronize()
                runs.append(a.elapsed_time(b) / 10)
            return sorted(runs)[3]

        first = ms_of(libs["NONE"])
        times = {m: ms_of(libs[m]) for m in PHASES}
        last = ms_of(libs["NONE"])
        full = (first + last) / 2
        print(f"K5b batch={bs} P={p} L={enc.n_layers} tied C=32: every phase "
              f"{first:.4f} ms first, {last:.4f} ms last (CUDA events, C entry "
              f"point) on {smi}")
        for m, ms in times.items():
            print(f"  {m[5:].lower():10s} left out: {ms:.4f} ms, costs "
                  f"{full - ms:+.4f} ms ({100 * (full - ms) / full:.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
