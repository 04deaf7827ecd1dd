#!/usr/bin/env python3
"""Where the H=64 GGNN reverse body's time goes, on one NVIDIA GPU: the
rates of the instructions its 3xTF32 products are made of, and its phases
timed inside the kernel.

    python3 chip_tc64.py

1. mma.sync.m16n8k8 TF32 alone: one CTA of 512 threads per SM (16 warps,
   as the reverse body runs), each warp issuing 1, 2, 4 or 8 independent
   accumulator chains: products per microsecond per SM and TFLOP/s.
2. The split's rounding to TF32 (10 mantissa bits, ties away from zero),
   cvt.rna.tf32.f32 against the same rounding in two integer instructions
   (the body's ``tf32_rna``), each after one f32 add, and an f32 add and
   multiply alone: elements per nanosecond per SM.
3. K2b (``fused_ggnn_readout_bwd``) at H = D = 64, L = 8 untied (the
   ``ref_scale_fused64`` model, seeded random weights) on the first packed
   batch of 2048 pairs of dataset/synth546's drug test split (P = 387),
   from a copy of ``fused_ggnn_bwd.cu`` in which thread 0 of every CTA
   reads clock64 at the ends of the body's phases and adds each phase's
   cycles to a global counter: the mean cycles per CTA of each phase and
   its share.  Thread 0 waits at the barriers with the rest of the CTA,
   so a phase's cycles are the CTA's.  The copy's time beside the
   unchanged source's (CUDA events, median of 14 runs of 5 calls, in
   turns) gives what the markers cost.
4. The same K2b built with cvt.rna.tf32.f32 in ``tf32_rna`` in place of
   its two integer instructions: its time in turns with the unchanged
   source's, and whether the two give the same bits.

Builds into ``results/tc64/`` with nvcc (all at once).  Fails if an anchor
of the source is not found (the source changed) or there is no card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "results", "tc64")

BENCH = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a, const unsigned* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <int CH>
__global__ void mma_rate(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  float d[CH][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c) mma_tf32(d[c], a, b);
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__device__ __forceinline__ float cvt_rna(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}
__device__ __forceinline__ float int_rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}
template <int MODE>
__global__ void round_rate(float* out, int iters, float d) {
  float x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = threadIdx.x * 1e-3f + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float y = x[i] + d;
      x[i] = MODE == 0 ? y * 0.75f : MODE == 1 ? cvt_rna(y) : int_rna(y);
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += x[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_mma(int ch, float* out, int blocks, int threads, int iters) {
  if (ch == 1) mma_rate<1><<<blocks, threads>>>(out, iters);
  if (ch == 2) mma_rate<2><<<blocks, threads>>>(out, iters);
  if (ch == 4) mma_rate<4><<<blocks, threads>>>(out, iters);
  if (ch == 8) mma_rate<8><<<blocks, threads>>>(out, iters);
  return int(cudaGetLastError());
}
extern "C" int run_round(int mode, float* out, int blocks, int threads, int iters) {
  if (mode == 0) round_rate<0><<<blocks, threads>>>(out, iters, 1e-7f);
  if (mode == 1) round_rate<1><<<blocks, threads>>>(out, iters, 1e-7f);
  if (mode == 2) round_rate<2><<<blocks, threads>>>(out, iters, 1e-7f);
  return int(cudaGetLastError());
}
"""

# the phase counter: thread 0 adds the cycles since its last marker
PROF = r"""
__device__ unsigned long long g_phase_cycles[16];
__device__ __forceinline__ void phase_end(int i) {
  extern __shared__ float phase_smem[];
  if (threadIdx.x == 0) {
    long long* last = reinterpret_cast<long long*>(phase_smem + h64::Plan<true>::PTRS + 6);
    const long long t = clock64();
    if (i >= 0) atomicAdd(&g_phase_cycles[i], (unsigned long long)(t - *last));
    *last = t;
  }
}
"""
READ = r"""
extern "C" int phase_cycles(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[16] = {};
    return int(cudaMemcpyToSymbol(g_phase_cycles, z, sizeof(z)));
  }
  return int(cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles)));
}
"""
PHASES = ["set-up: h0, row and column lists", "forward over the range (hs)",
          "seed dh (K2b's readout)", "reverse: messages recomputed",
          "reverse: gates recomputed", "GRU: dz', dn', drs, ds, dh_in",
          "GRU: weight gradients", "GRU: dm", "messages: column gather",
          "messages: gradients beside dh W_e^T", "dh to global"]
# (anchor in the H=64 part of fused_ggnn_bwd.cu, text put after it)
MARKS = [
    ("  auto gru_part = [&] { return s_ptrs[2] + G::gru0(n_range); };\n",
     "  __syncthreads();\n  phase_end(-1);\n"),
    ("  const int n_ov = *s_ovn;\n", "  phase_end(0);\n"),
    ("    layer_forward<Tc>(t, w, l, p, next, tid);\n  }\n", "  phase_end(1);\n"),
    ("    for (int i = tid; i < TH; i += THREADS) s_dh[Tc::at(i / H, i % H)] = dh_t[i];\n  }\n",
     "  phase_end(2);\n"),
    ("    messages<Tc>(t, w, l, p, w.wz, tid);\n", "    phase_end(3);\n"),
    ("      gates<Tc>(t, w, zero_state, hf, true, p, w.un, n, tid);\n", "      phase_end(4);\n"),
    ("  tc_grad_pass<1, 3, 256>(g4, HALF, acc_gru, false, tid);\n", "  phase_end(6);\n"),
    ("    for (int k = 0; k < RPH; ++k) m[o.at(k)] = acc[k];\n  }\n", "  phase_end(7);\n"),
    ("      column_gather_edge<Tc>(t.adj_t, e, t.m, s_cs, s_cr, s_cv, s_ov, n_ov, t.work, tid);\n"
     "      __syncthreads();\n", "      phase_end(8);\n"),
    ("          for (int k = 0; k < RPH; ++k) dh[o.at(k)] = acc[k];\n        }\n      }\n",
     "      __syncthreads();\n      phase_end(9);\n"),
    ("    dh0[i] = READOUT ? v + dh0[i] : v;\n  }\n", "  __syncthreads();\n  phase_end(10);\n"),
]
# the GRU's products against transposed weights end where its gradients begin
GRU_GRADS = "  // the GRU's weight gradients over the half's rows"
# tf32_rna's integer rounding, and cvt.rna.tf32.f32 in its place
INT_RNA = "  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);\n"
CVT_RNA = """  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
"""


def instrumented(text: str) -> str:
    """fused_ggnn_bwd.cu with the phase markers in its H=64 reverse body."""
    cut = text.index("// The reverse of one GRU half of layer l at H = 64")
    head, body = text[:cut], text[cut:]
    for anchor, mark in MARKS:
        if body.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in fused_ggnn_bwd.cu: {anchor!r}")
        body = body.replace(anchor, anchor + mark)
    if body.count(GRU_GRADS) != 1:
        raise RuntimeError("anchor of the GRU's gradients not found")
    body = body.replace(GRU_GRADS, "  phase_end(5);\n" + GRU_GRADS)
    ns = "namespace {\n\nusing namespace ggnn;\n"
    if head.count(ns) != 1:
        raise RuntimeError("namespace anchor not found")
    return head.replace(ns, ns + PROF) + body + READ


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_tc64.py: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    import pandas as pd

    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.data import CSVPairParser, estimate_coo_capacities
    from gcnbmp_tpu_torch.data.wire import compact_coo_arrays, iter_coo_eval_batches
    from gcnbmp_tpu_torch.models.packed import decode_compact_wire, make_packed_predictor
    from gcnbmp_tpu_torch.ops import build
    from gcnbmp_tpu_torch.ops import fused_ggnn as fg
    from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo_flat

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    with open(os.path.join(build.CSRC, "fused_ggnn_bwd.cu")) as f:
        source = f.read()
    for name, text in (("bench.cu", BENCH), ("bwd_phases.cu", instrumented(source)),
                       ("bwd.cu", source)):
        with open(os.path.join(OUT, name), "w") as f:
            f.write(text)
    # the cvt variant: its own copy of the sources, so its header is found first
    cvt_dir = os.path.join(OUT, "cvt")
    os.makedirs(cvt_dir)
    for name in ("fused_ggnn_bwd.cu", *build.HEADERS):
        with open(os.path.join(build.CSRC, name)) as f:
            text = f.read()
        if name == "fused_ggnn64.cuh":
            if text.count(INT_RNA) != 1:
                raise RuntimeError("tf32_rna's rounding not found in fused_ggnn64.cuh")
            text = text.replace(INT_RNA, CVT_RNA)
        with open(os.path.join(cvt_dir, name), "w") as f:
            f.write(text)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    t0 = time.perf_counter()
    sources = {"bench": os.path.join(OUT, "bench.cu"),
               "bwd_phases": os.path.join(OUT, "bwd_phases.cu"),
               "bwd": os.path.join(OUT, "bwd.cu"),
               "bwd_cvt": os.path.join(cvt_dir, "fused_ggnn_bwd.cu")}
    procs = {name: subprocess.Popen(
        [build._nvcc(), *flags, *([] if name == "bwd_cvt" else ["-I", build.CSRC]),
         "-o", os.path.join(OUT, f"lib{name}.so"), path],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for name, path in sources.items()}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"built {len(sources)} libraries in {time.perf_counter() - t0:.1f} s; {smi}")
    dev = torch.device("cuda", 0)

    def event_ms(fn, n=1):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    # 1. and 2.
    bench = ctypes.CDLL(os.path.join(OUT, "libbench.so"))
    for fn in (bench.run_mma, bench.run_round):
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 8 * 256, device=dev)
    iters = 4096
    for ch in (1, 2, 4, 8):
        run = lambda: bench.run_mma(ch, out.data_ptr(), sms, 512, iters)
        run()
        ms = event_ms(run)
        rate = sms * 16 * iters * ch / sms / (ms * 1e3)
        print(f"mma.sync m16n8k8 TF32, 16 warps per SM, {ch} chain(s) per warp: "
              f"{ms:.3f} ms, {rate:.1f} per us per SM, "
              f"{rate * 2048 * sms / 1e6:.1f} TFLOP/s")
    for mode, label in ((0, "f32 add + multiply"), (1, "f32 add + cvt.rna.tf32.f32"),
                        (2, "f32 add + integer rounding (add, and)")):
        run = lambda: bench.run_round(mode, out.data_ptr(), sms * 8, 256, iters)
        run()
        ms = event_ms(run)
        print(f"{label}: {ms:.3f} ms, "
              f"{sms * 8 * 256 * iters * 8 / (ms * 1e6) / sms:.1f} elements per ns per SM")

    # 3. K2b's phases
    df = pd.read_csv(os.path.join(ROOT, "dataset", "synth546", "drug",
                                  "ddi_drug_test.csv")).head(2048)
    ds = CSVPairParser().parse(df).dataset
    tiles, cap = estimate_coo_capacities([ds], 2048)
    batch, _ = next(iter_coo_eval_batches(ds, 2048, tiles, cap))
    nodes, e_packed, n_edges, left, _ = [
        torch.as_tensor(np.asarray(a)).to(dev) for a in compact_coo_arrays(batch)]
    atom_ids, _, mask, *edges = decode_compact_wire(nodes, e_packed, n_edges,
                                                    2 * left.shape[0])
    p, t = atom_ids.shape
    adj = adj_from_coo_flat(*edges, num_tiles=p, tile=t)
    cfg = dict(fp_hidden_dim=64, fp_out_dim=64, conv_layers=8, weight_tying=False)
    with torch.no_grad():
        enc = from_jax_params(init_params(cfg, 2018),
                              make_packed_predictor(**cfg)).to(dev).encoder
        msg_w, msg_b, gru = fg.params_to_fused(enc)
        h0 = enc.embed(atom_ids).contiguous()
        ro = enc.readout_0
        readout = (mask, ro.i.dense.weight.T.contiguous(), ro.i.dense.bias.contiguous(),
                   ro.j.dense.weight.T.contiguous(), ro.j.dense.bias.contiguous())
        dg = torch.as_tensor(np.random.default_rng(2018).standard_normal(
            (p, t, 64)).astype(np.float32)).to(dev)
    n_layers = enc.n_layers
    bufs = fg._bwd_buffers(p, n_layers, 64, 64, dev)[:4]
    stream = torch.cuda.current_stream().cuda_stream
    libs = {}
    for name in ("bwd", "bwd_phases", "bwd_cvt"):
        handle = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        handle.fused_ggnn_readout_bwd.argtypes = \
            build.SOURCES["fused_ggnn_bwd.cu"]["fused_ggnn_readout_bwd"]
        libs[name] = handle
    libs["bwd_phases"].phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]

    def k2b(handle):
        err = handle.fused_ggnn_readout_bwd(
            h0.data_ptr(), adj.data_ptr(), *fg._weight_ptrs(msg_w, msg_b, gru),
            *(x.data_ptr() for x in readout), dg.data_ptr(),
            *(b.data_ptr() for b in bufs), p, n_layers, 64, 64, stream)
        if err != 0:
            raise RuntimeError(f"K2b launch failed: {err}")

    def timed_in_turns(a, b):
        """Median ms per call of libs a and b, 7 rounds of a, b, b, a."""
        times = {a: [], b: []}
        for name in (a, b):
            k2b(libs[name])
        for _ in range(7):
            for name in (a, b, b, a):
                times[name].append(event_ms(lambda: k2b(libs[name]), 5))
        return [sorted(times[n])[len(times[n]) // 2] for n in (a, b)]

    plain_ms, marked_ms = timed_in_turns("bwd", "bwd_phases")
    print(f"K2b H=64 P={p} L={n_layers}: {plain_ms:.4f} ms per call, "
          f"{marked_ms:.4f} ms with the phase markers")
    outs = {}
    for name in ("bwd", "bwd_cvt"):
        k2b(libs[name])
        torch.cuda.synchronize()
        outs[name] = [b.clone() for b in (bufs[0], bufs[2])]  # dh0, grads
    same = all(torch.equal(x, y) for x, y in zip(outs["bwd"], outs["bwd_cvt"]))
    int_ms, cvt_ms = timed_in_turns("bwd", "bwd_cvt")
    print(f"K2b with tf32_rna as two integer instructions: {int_ms:.4f} ms, as "
          f"cvt.rna.tf32.f32: {cvt_ms:.4f} ms per call; the same bits: {same}")
    counts = np.zeros(16, np.uint64)
    phases = libs["bwd_phases"].phase_cycles
    if phases(counts.ctypes.data, 1) != 0:
        raise RuntimeError("phase counters not reset")
    k2b(libs["bwd_phases"])
    torch.cuda.synchronize()
    if phases(counts.ctypes.data, 0) != 0:
        raise RuntimeError("phase counters not read")
    total = float(counts[:len(PHASES)].sum())
    for i, name in enumerate(PHASES):
        print(f"  {name:40s} {float(counts[i]) / p:12.0f} cycles per CTA "
              f"{100 * float(counts[i]) / total:6.1f}%")
    print(f"  {'all phases':40s} {total / p:12.0f} cycles per CTA")
    return 0


if __name__ == "__main__":
    sys.exit(main())
