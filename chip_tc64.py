#!/usr/bin/env python3
"""Where the H=64 GGNN bodies' time goes, on one NVIDIA GPU: the rates of
the instructions their 3xTF32 products are made of, the reverse body's and
the forward body's phases timed inside the kernel, and the forward's
variants timed in turns.

    python3 chip_tc64.py [--fma-src DIR] [--forward-only]

1. mma.sync.m16n8k8 TF32 alone: one CTA of 512 threads per SM (16 warps,
   as the bodies run), each warp issuing 1, 2, 4 or 8 independent
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
   source's, and whether the two give the same bits.  Then the reverse
   body built with ``tc_mma``'s SEP in every product (the correction terms
   in an accumulator of their own, as the forward bodies take them): its
   ptxas registers and spills beside the source's, and K2b's time in
   turns with the source's.
5. The forward body (``fused_ggnn.cu``'s ``fused_ggnn_kernel64``: K2 and
   K1) on chip_smoke.py phase 3a's inputs at H = D = 64, L = 8 (the first
   packed batches of 256 and 2048 of those pairs, P = 75 and 387), built
   in variants by string edits of copies of the sources, all timed in
   turns (CUDA events, median of 14 runs of 5 calls): ``tile_hs`` the
   source as it is (every product in 3xTF32 over the whole tile, h read
   from the TF32 parts its writers keep); ``tile`` every operand split
   where it is loaded; ``halves`` that, with the layer step and the readout
   by halves of the tile (the reverse body's steps: the body as it first
   ran on the tensor cores); ``tile_w`` the weight panels split once when
   staged (a float4 of a B fragment's high and low parts at both depths)
   and h split at load; ``tile_hs_u1`` and ``tile_hs_u4`` the source with
   the split-h product's 8-deep steps unrolled 1 and 4 times (2 as it is);
   ``agg_rows4`` the forward's aggregation with four rows of a warp in
   flight (its loads before its adds, the same terms in the same order);
   and, with ``--fma-src``, ``fma`` the f32 FMA body from that directory (a
   copy of ``gcnbmp_tpu_torch/ops/csrc`` from before the forward took the
   tensor cores: ``git archive 04b42f0 gcnbmp_tpu_torch/ops/csrc``).  Each
   variant's ptxas registers and spills, and whether its K2 and K1 give
   the source's bits.
6. K2 at P = 387 from copies of the forward source (and of ``--fma-src``'s)
   with clock64 markers, as in 3: set-up, the messages' products h W_e,
   the aggregation m += A_e hw_e, the GRU gates' products, the update
   h' = z n + (1 - z) s, the readout.  Every marker follows a barrier, all
   but the messages' first put in for it.

7. The forward bodies at H = D = 64 (``fused_ggnn64.cuh``, the
   ref_scale_fused64 model) and 128 (``fused_ggnn128.cuh``, the h=128
   model of bench.py), K2 and K1 at L = 8 with seeded weights, on the same
   pairs (P = 75 and 387), in variants timed in turns as in 5: ``sep`` the
   source as it is (every product's two correction terms, lo*hi and
   hi*lo, summed in an accumulator of their own and added at the end,
   ``tc_mma``'s SEP), ``nosep`` all three terms into one accumulator (the
   reverse body's form), and at 128 ``sep_gru`` SEP in the GRU's products
   only; each variant's registers and spills, and its K1 on chip_smoke.py
   phase 3a's crowded batch (P = 75, every other row with ~5% of its
   columns set) against the plain f32 version and a float64 one: the entry
   closest to the bound (atol = rtol = 1e-4) as a fraction of it.

Builds into ``results/tc64/`` with nvcc (all at once).  Fails if an anchor
of the source is not found (the source changed) or there is no card.
``--forward-only`` runs phases 5 to 7 alone, ``--sep-only`` phase 7.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import re
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

# -- the forward body (phases 5 and 6) --------------------------------------

# The forward body's variants: name -> [(file, anchor, replacement, count)],
# each anchor found `count` times (the replacement put in for each)
HEADER, SOURCE = "fused_ggnn64.cuh", "fused_ggnn.cu"
# the h parts kept beside h (split_store) written by no one, for the
# variants whose products do not read them
NO_SPLIT_STORE = (HEADER,
                  "void split_store(float* hs, int i, float v) {\n"
                  "  split_tf32(v, hs[i], hs[TH + i]);\n}",
                  "void split_store(float*, int, float) {}", 1)
# every product of h split where it is loaded
SPLIT_AT_LOAD = [(HEADER, "product_h(t, ", "Tc::product_tile(t.h, ", 6),
                 (SOURCE, "product_h(t, ", "Tc::product_tile(t.h, ", 2), NO_SPLIT_STORE]
SPLIT_A_UNROLL = "  const float* arow = xs + (R + lr + 8 * (lj & 1)) * H;\n#pragma unroll 2\n"
READOUT_TILE = """    for (int i = tid; i < TH; i += THREADS) s_h0[Tc::at(i / H, i % H)] = h0_t[i];
    const Tc::Own o(tid);
    float gi[2 * RPH], gj[2 * RPH];
    fill_cols(gi, s_bi, o);
    product_h(t, panels_next<Tc>(p, ro.wi, ro.wi + H * H, tid), o, gi);
    Tc::product_tile(s_h0, panels_next<Tc>(p, ro.wi + H * H, ro.wj, tid), o, gi);
    fill_cols(gj, s_bj, o);
    product_h(t, panels_next<Tc>(p, ro.wj, nullptr, tid), o, gj);
    const float* mask_t = ro.mask + tile * TILE;
#pragma unroll
    for (int j = 0; j < 2 * RPH; ++j) {
      const int row = (j / RPH) * HALF + o.row(j % RPH);
      out_t[row * H + o.col(j % RPH)] = sigmoidf(gi[j]) * gj[j] * mask_t[row];
    }
"""
# halves: the body as its step 1 first ran, the reverse body's layer step
# and readout by halves of the tile, every operand split at load
READOUT_HALVES = """    for (int i = tid; i < TH; i += THREADS) s_h0[Tc::at(i / H, i % H)] = h0_t[i];
    readout_gate<Tc>(t.h, s_h0, ro, s_bi, t.work, p, tid);
    const float* wj = panels_next<Tc>(p, ro.wj, nullptr, tid);
    const float* mask_t = ro.mask + tile * TILE;
    const Tc::Own o(tid);
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float gj[RPH];
#pragma unroll
      for (int k = 0; k < RPH; ++k) gj[k] = s_bj[o.col(k)];
      Tc::product(t.h + hf * HALF * H, wj, o, gj);
      const float* gate = t.work + hf * HALF * H;
#pragma unroll
      for (int k = 0; k < RPH; ++k) {
        const int row = hf * HALF + o.row(k);
        out_t[row * H + o.col(k)] = gate[o.at(k)] * gj[k] * mask_t[row];
      }
    }
"""
# tile_w: the weight panels split once when staged (TcW), their float4
# holding a B fragment's high and low parts at both depths, h split at load
TCW = r"""
// acc += x w over the tile for the warp's 16 x 16 blocks at rows R and
// R + HALF, columns C (x: rows in the Tc layout, w: a TcW panel), in 3xTF32
// as tc_mma<false, false, 2, 2, HALF> takes it, term for term: the same
// split values in the same mma order, the same bits.  A lane's B fragments
// of 8-deep step kb and n-tile nj are one float4 (TcW::b_at).
__device__ __forceinline__ void tc_mma_w(const float* a, const float* w, int R, int C,
                                         int g, int q, float* acc) {
  const int lr = (4 * g + q) & 7, lj = (4 * g + q) >> 3, slr = swz(lr);
  const float* arow = a + (R + lr + 8 * (lj & 1)) * H;
  const float4* w4 = reinterpret_cast<const float4*>(w) + q * H + C;
  const int b0 = g ^ (2 * q) ^ ((C >> 3) & 3), b1 = 8 + (g ^ (2 * q) ^ (((C >> 3) + 1) & 3));
#pragma unroll 2
  for (int k0 = 0; k0 < H; k0 += 8) {
    float ah[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      float v[4];
      ldsm_x4(v, arow + mi * HALF * H + ((k0 + 4 * (lj >> 1)) ^ slr));
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], ah[mi][i], al[mi][i]);
    }
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const float4 b = w4[(k0 / 2) * H + (nj ? b1 : b0)];
      const float bh[2] = {b.x, b.z}, bl[2] = {b.y, b.w};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float* d = acc + 4 * (2 * mi + nj);
        mma_tf32(d, al[mi], bh);
        mma_tf32(d, ah[mi], bl);
        mma_tf32(d, ah[mi], bh);
      }
    }
  }
}

// The forward's weight panels split once, when staged.  Depth k = 8 kb +
// q + 4 u (q < 4, u < 2) of column c sits in float4 (4 kb + q) H + (c ^ 2q
// ^ (c / 8 % 4)) as (hi, lo of u = 0, hi, lo of u = 1): a lane's B fragment
// of an 8-deep step in both parts.  The XORs put the eight lanes of each
// quarter warp on eight distinct 16-byte bank groups, for the products'
// loads and for the split's.  Thread t stages the four columns 4 (t % 16)
// .. + 3 of depths 8 kb + q and 8 kb + q + 4, (kb, q) = (t / 64, t / 16 %
// 4): four float4 in a row, slot(t) .. + 3, in an order XORed by flip(t);
// cp.async lands the two f32 rows in two of them, and panel_split (before
// the barrier that hands the panel out) puts the four split columns in
// place.
struct TcW : Tc {
  static constexpr bool SPLIT = true;
  static constexpr int PANEL_WORDS = 2 * PANEL;
  // the float4 of column c at depth rows 8 (kq / 4) + kq % 4 (+ 4)
  __device__ static int b_at(int kq, int c) {
    return kq * H + (c ^ (2 * (kq & 3)) ^ ((c >> 3) & 3));
  }
  __device__ static int slot(int t) { return b_at(t >> 4, 4 * (t & 15)) & ~3; }
  __device__ static int flip(int t) { return (2 * ((t >> 4) & 1)) ^ ((t >> 1) & 3); }
  __device__ static int order(int t) { return (t >> 1) & 3; }
  __device__ static void panel_load(const float* __restrict__ src, float* dst) {
    const int t = fresh_tid();
    const int r = 8 * (t >> 6) + ((t >> 4) & 3), c = 4 * (t & 15);
    float4* s = reinterpret_cast<float4*>(dst) + slot(t);
    __pipeline_memcpy_async(s + order(t), src + r * H + c, 16);
    __pipeline_memcpy_async(s + (order(t) ^ 1), src + (r + 4) * H + c, 16);
  }
  // this thread's columns of a panel whose cp.async have completed
  __device__ static void panel_split(float* panel) {
    const int t = fresh_tid();
    float4* s = reinterpret_cast<float4*>(panel) + slot(t);
    const float4 x0 = s[order(t)], x1 = s[order(t) ^ 1];
    const float r0[4] = {x0.x, x0.y, x0.z, x0.w}, r1[4] = {x1.x, x1.y, x1.z, x1.w};
    const int f = flip(t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 v;
      split_tf32(r0[i], v.x, v.y);
      split_tf32(r1[i], v.z, v.w);
      s[i ^ f] = v;
    }
  }
  __device__ static void product_tile(const float* x, const float* w, const Own& o,
                                      float (&acc)[2 * RPH]) {
    tc_mma_w(x, w, o.R, o.C, o.g, o.q, acc);
  }
};
"""
PANEL_LOAD = """#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = P::panel_tid(tid) + s * THREADS;
    const int row = q / (H / 4), c = (q % (H / 4)) * 4;
    __pipeline_memcpy_async(dst + P::panel_at(row, c), src + row * LD + c, 16);
  }
}"""
PANEL_WAIT = """  __pipeline_wait_prior(0);
  __syncthreads();
  float* here = p.buf + (p.j & 1) * PANEL;
"""
PANEL_NEXT = "  if (next != nullptr) panel_load<P, LD>(next, p.buf + ((p.j + 1) & 1) * PANEL, tid);\n"
TILE_W = [
    (HEADER, "#pragma once\n", "#pragma once\n#include <type_traits>\n", 1),
    (HEADER, "// acc += x w^T for the rows of x at o's block (w a panel: the product",
     TCW + "\n// acc += x w^T for the rows of x at o's block (w a panel: the product", 1),
    (HEADER, "  static constexpr int PANELS = HS + (BWD ? 0 : 2) * TH; // 2 PANEL\n"
             "  static constexpr int B_MSG = PANELS + 2 * PANEL;",
     "  static constexpr int PANELS = HS;\n"
     "  static constexpr int B_MSG = PANELS + (BWD ? 2 : 4) * PANEL;", 1),
    (HEADER, PANEL_LOAD, "  if constexpr (std::is_same_v<P, TcW>) {\n    TcW::panel_load(src, dst);\n"
                         "    return;\n  }\n" + PANEL_LOAD, 1),
    (HEADER, PANEL_WAIT,
     "  __pipeline_wait_prior(0);\n"
     "  constexpr int words = std::is_same_v<P, TcW> ? 2 * PANEL : PANEL;\n"
     "  if constexpr (std::is_same_v<P, TcW>) TcW::panel_split(p.buf + (p.j & 1) * words);\n"
     "  __syncthreads();\n  float* here = p.buf + (p.j & 1) * words;\n", 1),
    (HEADER, PANEL_NEXT, PANEL_NEXT.replace("* PANEL", "* words"), 1),
    (HEADER, "product_h(t, ", "TcW::product_tile(t.h, ", 6),
    (HEADER, "Tc::product_tile(t.", "TcW::product_tile(t.", 4),
    (HEADER, "panels_next<Tc>(", "panels_next<TcW>(", 10),
    (SOURCE, "product_h(t, ", "TcW::product_tile(t.h, ", 2),
    (SOURCE, "Tc::product_tile(s_h0", "TcW::product_tile(s_h0", 1),
    (SOURCE, "panels_next<Tc>(", "panels_next<TcW>(", 3),
    (SOURCE, "panels_start<Tc>(", "panels_start<TcW>(", 1),
    NO_SPLIT_STORE]
# agg_rows4: the aggregation with four rows of a warp in flight (the
# forward's messages only), the same terms in the same order
PRODUCT_H = "// acc += h w over the tile, h from its TF32 parts"
AGG_ROWS4 = r"""// m (+)= A_e hw_e (hw_e in t.work) as aggregate_edge takes it, each row
// summing the same terms in the same order, with RW rows of a warp in
// flight at once: each step loads the rows' n-th list entries and the hw
// rows they select (clamped into the tile, the product kept only for an
// entry of e's columns) before it adds them, so the loads' latencies
// overlap; a crowded row then takes aggregate_edge's dense path.
__device__ __forceinline__ void aggregate_tile(const Tile& t, int e, int tid) {
  constexpr int RW = 4;
  const int lane = tid & 31, warp = tid >> 5, lo = e * TILE;
#pragma unroll 1
  for (int i0 = warp; i0 < TILE; i0 += RW * WARPS) {
    float a0[RW], a1[RW];
    int cnt[RW], most = 0;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int i = i0 + r * WARPS;
      a0[r] = e == 0 ? 0.0f : t.m[Tc::at(i, lane)];
      a1[r] = e == 0 ? 0.0f : t.m[Tc::at(i, lane + 32)];
      cnt[r] = t.nc[i];
      if (cnt[r] <= NBR_CAP) most = max(most, cnt[r]);
    }
#pragma unroll 1
    for (int n = 0; n < most; ++n) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int i = i0 + r * WARPS;
        const int k = int(t.nk[i * NBR_CAP + n]) - lo;
        const float v = t.nv[i * NBR_CAP + n];
        const bool take = n < cnt[r] && cnt[r] <= NBR_CAP && k >= 0 && k < TILE;
        const int kc = min(max(k, 0), TILE - 1);
        const float x0 = t.work[Tc::at(kc, lane)], x1 = t.work[Tc::at(kc, lane + 32)];
        a0[r] = take ? fmaf(v, x0, a0[r]) : a0[r];
        a1[r] = take ? fmaf(v, x1, a1[r]) : a1[r];
      }
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int i = i0 + r * WARPS;
      if (cnt[r] > NBR_CAP) {
        const float* arow = t.adj_t + size_t(i) * ROW_LEN + lo;
        float av[TILE / 32];
#pragma unroll
        for (int q = 0; q < TILE / 32; ++q) av[q] = __ldg(arow + q * 32 + lane);
#pragma unroll
        for (int q = 0; q < TILE / 32; ++q) {
          unsigned nz = __ballot_sync(0xffffffffu, av[q] != 0.0f);
          while (nz) {
            const int b = __ffs(nz) - 1;
            nz &= nz - 1;
            const float v = __shfl_sync(0xffffffffu, av[q], b);
            const int k = q * 32 + b;
            a0[r] = fmaf(v, t.work[Tc::at(k, lane)], a0[r]);
            a1[r] = fmaf(v, t.work[Tc::at(k, lane + 32)], a1[r]);
          }
        }
      }
      t.m[Tc::at(i, lane)] = a0[r];
      t.m[Tc::at(i, lane + 32)] = a1[r];
    }
  }
}

"""
FWD_VARIANTS = {
    "tile_hs": [],
    "tile": SPLIT_AT_LOAD,
    "halves": [(SOURCE, "    layer_forward_tile(t, w, l, p, next, tid);\n",
                "    layer_forward<Tc>(t, w, l, p, next, tid);\n", 1),
               (SOURCE, READOUT_TILE, READOUT_HALVES, 1), NO_SPLIT_STORE],
    "tile_w": TILE_W,
    "agg_rows4": [(HEADER, PRODUCT_H, AGG_ROWS4 + PRODUCT_H, 1),
                  (HEADER, "    aggregate_edge<Tc>(t.adj_t, e, t.work, t.m, t.nk, t.nv, t.nc, tid);\n",
                   "    aggregate_tile(t, e, tid);\n", 1)],
    "tile_hs_u1": [(HEADER, SPLIT_A_UNROLL, SPLIT_A_UNROLL.replace("unroll 2", "unroll 1"), 1)],
    "tile_hs_u4": [(HEADER, SPLIT_A_UNROLL, SPLIT_A_UNROLL.replace("unroll 2", "unroll 4"), 1)],
}

# phase 7: the forward bodies' variants by width (file, anchor,
# replacement, count): the source (SEP in every product), SEP in none, and
# at H=128 SEP in the GRU's products (over a half of the tile) only
H128 = "fused_ggnn128.cuh"
_SEP_TILE = "h64::tc_mma<false, false, 2, 2, HALF, H, true>("
_SEP_HALF = "h64::tc_mma<false, false, 1, 2, 16, H, true>("
_SEP_TILE64 = "tc_mma<false, false, 2, 2, HALF, H, true>(x, w, H,"
_SEP_SPLIT = "        float* e = cor + 4 * (2 * mi + nj);\n"
SEP_VARIANTS = {
    64: {"sep": [],
         "nosep": [(HEADER, _SEP_TILE64, _SEP_TILE64.replace(", H, true>", ">"), 1),
                   (HEADER, _SEP_SPLIT, "        float* e = d;\n", 1)]},
    128: {"sep": [],
          "nosep": [(H128, _SEP_TILE, _SEP_TILE.replace(", true>", ">"), 1),
                    (H128, _SEP_HALF, _SEP_HALF.replace(", true>", ">"), 1)],
          "sep_gru": [(H128, _SEP_TILE, _SEP_TILE.replace(", true>", ">"), 1)]},
}
# phase 4: tc_mma's SEP on by default, so in every product of the reverse body
SEP_OFF = "int LDA = H, bool SEP = false>"
SEP_ON = "int LDA = H, bool SEP = true>"

# phase 6: thread 0 of each CTA adds the cycles since its last marker (its
# last reading kept in global memory by block)
FWD_PROF = r"""
__device__ unsigned long long g_phase_cycles[16];
__device__ long long g_phase_last[4096];
__device__ __forceinline__ void phase_end(int i) {
  if (threadIdx.x == 0) {
    const long long t = clock64();
    if (i >= 0)
      atomicAdd(&g_phase_cycles[i], (unsigned long long)(t - g_phase_last[blockIdx.x]));
    g_phase_last[blockIdx.x] = t;
  }
}
"""
FWD_READ = r"""
extern "C" int phase_cycles(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[16] = {};
    return int(cudaMemcpyToSymbol(ggnn::h64::g_phase_cycles, z, sizeof(z)));
  }
  return int(cudaMemcpyFromSymbol(out, ggnn::h64::g_phase_cycles,
                                  16 * sizeof(unsigned long long)));
}
"""
FWD_PHASES = ["set-up: h0, biases, row lists", "messages: h W_e (panel waits)",
              "messages: m += A_e hw_e", "GRU: the gates' products",
              "GRU: h' = z n + (1 - z) s", "readout: [h, h0] Wi, h Wj, store"]
# (file, anchor, text put after it) of each body's markers: the FMA body's
# layer step by halves of the tile, the tensor-core body's over the tile
FWD_MARKS = {
    "fma": [
        (SOURCE, "  const float* h0_t = h0 + tile * TH;\n", "  phase_end(-1);\n"),
        (HEADER, "    __syncthreads();\n    aggregate_edge<P>(t.adj_t, e, t.work, t.m, t.nk, t.nv, t.nc, tid);\n",
         "    __syncthreads();\n    phase_end(2);\n"),
        (HEADER, "    gates<P>(t, w, zero_state, hf, false, p, hf == 0 ? w.wz : next, n, tid);\n",
         "    __syncthreads();\n    phase_end(3);\n"),
        (HEADER, "      h[i] = z * n[k] + (1.0f - z) * s;\n    }\n",
         "    __syncthreads();\n    phase_end(4);\n")],
    "tile": [
        (SOURCE, "  const float* h0_t = h0 + tile * TH;\n", "  phase_end(-1);\n"),
        (HEADER, "    __syncthreads();\n    aggregate_edge<Tc>(t.adj_t, e, t.work, t.m, t.nk, t.nv, t.nc, tid);\n",
         "    __syncthreads();\n    phase_end(2);\n"),
        (HEADER, "  gates_tile(t, w, zero_state, p, next, z, n, tid);\n",
         "  __syncthreads();\n  phase_end(3);\n"),
        (HEADER, "    split_store(t.hs, i, v);\n  }\n",
         "  __syncthreads();\n  phase_end(4);\n")],
}
# the messages' products end at the barrier before the aggregation
MSG_BARRIER = {"fma": ("    __syncthreads();\n    aggregate_edge<P>(",
                       "    __syncthreads();\n    phase_end(1);\n    aggregate_edge<P>("),
               "tile": ("    __syncthreads();\n    aggregate_edge<Tc>(",
                        "    __syncthreads();\n    phase_end(1);\n    aggregate_edge<Tc>(")}
LAYER_LOOP = ("#pragma unroll 1\n  for (int l = 0; l < n_layers; ++l) {\n"
              "    if constexpr (MID) {  // K1m: layer split's input\n")
KERNEL_END = "\n}\n\ntemplate <bool READOUT, bool MID = false>\ncudaError_t launch64("


def edited(text: str, edits, what: str) -> str:
    """text with each (anchor, replacement[, count]) applied; each anchor must
    occur `count` times (once by default)."""
    for anchor, replacement, *count in edits:
        n = count[0] if count else 1
        if text.count(anchor) != n:
            raise RuntimeError(f"anchor not found {n} times in {what}: {anchor!r}")
        text = text.replace(anchor, replacement)
    return text


def fwd_instrumented(src: str, header: str, body: str):
    """(fused_ggnn.cu, fused_ggnn64.cuh) with phase 6's markers."""
    h_edits, s_edits = [("namespace h64 {\n", "namespace h64 {\n" + FWD_PROF)], []
    for name, anchor, mark in FWD_MARKS[body]:
        (h_edits if name == HEADER else s_edits).append((anchor, anchor + mark))
    s_edits += [(LAYER_LOOP, "  phase_end(0);\n" + LAYER_LOOP),
                (KERNEL_END, "\n  __syncthreads();\n  phase_end(5);" + KERNEL_END)]
    header = edited(header, h_edits + [MSG_BARRIER[body]], HEADER)
    return edited(src, s_edits, SOURCE) + FWD_READ, header


def write_tree(directory: str, src_dir: str, edits=(), instrument=None,
               source: str = SOURCE):
    """Copy ``source`` (fused_ggnn.cu unless given) and the headers src_dir
    holds into directory, with edits (file, anchor, replacement) or phase
    6's markers for the body ``instrument`` ("fma" or "tile")."""
    from gcnbmp_tpu_torch.ops import build

    os.makedirs(directory)
    texts = {}
    for name in (source, *build.HEADERS):
        if name == source or os.path.exists(os.path.join(src_dir, name)):
            with open(os.path.join(src_dir, name)) as f:
                texts[name] = f.read()
    for name, anchor, replacement, count in edits:
        texts[name] = edited(texts[name], [(anchor, replacement, count)], name)
    if instrument:
        texts[SOURCE], texts[HEADER] = fwd_instrumented(texts[SOURCE], texts[HEADER],
                                                        instrument)
    for name, text in texts.items():
        with open(os.path.join(directory, name), "w") as f:
            f.write(text)
    return os.path.join(directory, source)


def kernel_registers(log: str, width: int = 64, reverse: bool = False) -> list[str]:
    """ptxas's registers and spills of each fused_ggnn_kernel<width>
    instance (64 or 128), or with ``reverse`` of each
    fused_ggnn_bwd_kernel64 instance (K2b with the readout, else K1b/K3)."""
    out, body = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m and reverse:
            k = re.search(r"fused_ggnn_bwd_kernel64ILb([01])E", m.group(1))
            body = None if k is None else "K2b" if k[1] == "1" else "K1b/K3"
        elif m:
            k = re.search(rf"fused_ggnn_kernel{width}ILb([01])ELb([01])E", m.group(1))
            body = (None if k is None else
                    "K2" if k[1] == "1" else "K1m" if k[2] == "1" else "K1")
        elif body and ("spill" in line or "registers" in line):
            out.append(f"{body}: {line.split(':', 1)[-1].strip()}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fma-src", help="a directory holding the f32 FMA forward "
                    "body's fused_ggnn.cu and headers (phases 5 and 6)")
    ap.add_argument("--forward-only", action="store_true",
                    help="phases 5 to 7 alone")
    ap.add_argument("--sep-only", action="store_true", help="phase 7 alone")
    args = ap.parse_args()
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
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    # name -> (source, nvcc flags): the reverse phases' with the headers of
    # ops/csrc; every forward tree its own copies, its ptxas report kept
    sources = {}
    if not (args.forward_only or args.sep_only):
        with open(os.path.join(build.CSRC, "fused_ggnn_bwd.cu")) as f:
            source = f.read()
        for name, text in (("bench.cu", BENCH), ("bwd_phases.cu", instrumented(source)),
                           ("bwd.cu", source)):
            with open(os.path.join(OUT, name), "w") as f:
                f.write(text)
        for name in ("bench", "bwd_phases"):
            sources[name] = (os.path.join(OUT, f"{name}.cu"), [*flags, "-I", build.CSRC])
        # the source's and the SEP variant's ptxas reports kept
        sources["bwd"] = (os.path.join(OUT, "bwd.cu"), [*build.NVCC_FLAGS, "-I", build.CSRC])
        # the cvt and SEP variants: each its own copy of the sources, so that
        # its header is found first
        for variant, anchor, replacement, f in (("cvt", INT_RNA, CVT_RNA, flags),
                                                ("sep", SEP_OFF, SEP_ON, build.NVCC_FLAGS)):
            path = write_tree(os.path.join(OUT, variant), build.CSRC,
                              [(HEADER, anchor, replacement, 1)],
                              source="fused_ggnn_bwd.cu")
            sources[f"bwd_{variant}"] = (path, f)
    trees = {}
    if not args.sep_only:
        trees.update({f"fwd_{name}": (build.CSRC, edits, None)
                      for name, edits in FWD_VARIANTS.items()})
        trees["fwdp_tile_hs"] = (build.CSRC, (), "tile")
        if args.fma_src:
            trees["fwd_fma"] = (args.fma_src, (), None)
            trees["fwdp_fma"] = (args.fma_src, (), "fma")
    trees.update({f"fwd{width}_{name}": (build.CSRC, edits, None)
                  for width, variants in SEP_VARIANTS.items()
                  for name, edits in variants.items()})
    for name, (src_dir, edits, instrument) in trees.items():
        path = write_tree(os.path.join(OUT, name), src_dir, edits, instrument)
        sources[name] = (path, build.NVCC_FLAGS)
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [build._nvcc(), *f, "-o", os.path.join(OUT, f"lib{name}.so"), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (path, f) in sources.items()}
    logs = {}
    for name, p in procs.items():
        logs[name], _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
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

    def in_turns(fns, rounds=7, n=5):
        """Median ms per call of each of fns, 7 rounds of the order and its
        reverse, 5 calls a run."""
        times = {name: [] for name in fns}
        for fn in fns.values():
            fn()
        order = list(fns)
        for _ in range(rounds):
            for name in order + order[::-1]:
                times[name].append(event_ms(fns[name], n))
        return {name: sorted(t)[len(t) // 2] for name, t in times.items()}

    # the ref_scale_fused64 model (and bench.py's h=128 one) and the first
    # packed batches of 256 and 2048 pairs (chip_smoke.py phase 3a's inputs)
    df = pd.read_csv(os.path.join(ROOT, "dataset", "synth546", "drug",
                                  "ddi_drug_test.csv")).head(2048)
    ds = CSVPairParser().parse(df).dataset
    stream = torch.cuda.current_stream().cuda_stream
    torch.backends.cuda.matmul.allow_tf32 = False

    def model(hidden):
        cfg = dict(fp_hidden_dim=hidden, fp_out_dim=hidden, conv_layers=8,
                   weight_tying=False)
        with torch.no_grad():
            enc = from_jax_params(init_params(cfg, 2018),
                                  make_packed_predictor(**cfg)).to(dev).encoder
            return enc, fg.params_to_fused(enc)

    def batch(enc, bs):
        tiles, cap = estimate_coo_capacities([ds], bs)
        b, _ = next(iter_coo_eval_batches(ds, bs, tiles, cap))
        nodes, e_packed, n_edges, left, _ = [
            torch.as_tensor(np.asarray(a)).to(dev) for a in compact_coo_arrays(b)]
        atom_ids, _, mask, *edges = decode_compact_wire(nodes, e_packed, n_edges,
                                                        2 * left.shape[0])
        p, t = atom_ids.shape
        with torch.no_grad():
            h0 = enc.embed(atom_ids).contiguous()
            ro = enc.readout_0
            readout = (mask, ro.i.dense.weight.T.contiguous(),
                       ro.i.dense.bias.contiguous(),
                       ro.j.dense.weight.T.contiguous(), ro.j.dense.bias.contiguous())
        return p, h0, adj_from_coo_flat(*edges, num_tiles=p, tile=t), readout

    enc, (msg_w, msg_b, gru) = model(64)
    n_layers = enc.n_layers
    batches = {bs: batch(enc, bs) for bs in (256, 2048)}
    if not (args.forward_only or args.sep_only):
        reverse_phases(torch, np, fg, build, dev, stream, n_layers, msg_w,
                       msg_b, gru, batches[2048], event_ms, logs)
    if not args.sep_only:
        forward_phases(torch, fg, build, stream, n_layers, msg_w, msg_b, gru,
                       batches, logs, in_turns, smi, bool(args.fma_src))
    sep_phase(torch, np, fg, build, stream, 64, n_layers, msg_w, msg_b, gru,
              batches, logs, in_turns, smi)
    enc, weights = model(128)
    sep_phase(torch, np, fg, build, stream, 128, enc.n_layers, *weights,
              {bs: batch(enc, bs) for bs in (256, 2048)}, logs, in_turns, smi)
    return 0


def reverse_phases(torch, np, fg, build, dev, stream, n_layers, msg_w, msg_b, gru,
                   batch, event_ms, logs):
    """Phases 1 to 4 (the instruction rates, K2b's phases, its cvt and SEP
    forms)."""
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
    p, h0, adj, readout = batch
    dg = torch.as_tensor(np.random.default_rng(2018).standard_normal(
        (p, 128, 64)).astype(np.float32)).to(dev)
    bufs = fg._bwd_buffers(p, n_layers, 64, 64, dev)[:4]
    libs = {}
    for name in ("bwd", "bwd_phases", "bwd_cvt", "bwd_sep"):
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
    for name in ("bwd", "bwd_sep"):
        print(f"ptxas {name}: " + "; ".join(kernel_registers(logs[name], reverse=True)))
    src_ms, sep_ms = timed_in_turns("bwd", "bwd_sep")
    print(f"K2b H=64 P={p}: {src_ms:.4f} ms as the source, {sep_ms:.4f} ms with SEP "
          f"in every product")
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


def forward_phases(torch, fg, build, stream, n_layers, msg_w, msg_b, gru, batches,
                   logs, in_turns, smi, with_fma):
    """Phases 5 and 6: the forward body's variants in turns, K2's phases."""
    import numpy as np

    names = [f"fwd_{v}" for v in FWD_VARIANTS] + (["fwd_fma"] if with_fma else [])
    libs = {}
    for name in names + ["fwdp_tile_hs"] + (["fwdp_fma"] if with_fma else []):
        handle = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        for entry, argtypes in build.SOURCES["fused_ggnn.cu"].items():
            getattr(handle, entry).argtypes = argtypes
        libs[name] = handle
    for name in names:
        print(f"ptxas {name}: " + "; ".join(kernel_registers(logs[name])))
    out = {bs: torch.empty_like(b[1]) for bs, b in batches.items()}

    def k2(name, bs):
        p, h0, adj, readout = batches[bs]
        err = libs[name].fused_ggnn_readout_fwd(
            h0.data_ptr(), adj.data_ptr(), *fg._weight_ptrs(msg_w, msg_b, gru),
            *(x.data_ptr() for x in readout), out[bs].data_ptr(), p, n_layers, 64,
            64, stream)
        if err != 0:
            raise RuntimeError(f"K2 {name} launch failed: {err}")

    def k1(name, bs):
        p, h0, adj, _ = batches[bs]
        err = libs[name].fused_ggnn_fwd(
            h0.data_ptr(), adj.data_ptr(), *fg._weight_ptrs(msg_w, msg_b, gru),
            out[bs].data_ptr(), p, n_layers, 64, stream)
        if err != 0:
            raise RuntimeError(f"K1 {name} launch failed: {err}")

    # 5. the variants: bits against the source's, then times in turns
    for bs, (p, *_rest) in batches.items():
        for label, run in (("K2", k2), ("K1", k1)):
            got = {}
            for name in names:
                run(name, bs)
                torch.cuda.synchronize()
                got[name] = out[bs].clone()
            same = [n[4:] for n in names if torch.equal(got[n], got["fwd_tile_hs"])]
            ms = in_turns({n: (lambda n=n: run(n, bs)) for n in names})
            print(f"{label} H=64 P={p} L={n_layers} ({smi}): " + ", ".join(
                f"{n[4:]} {ms[n]:.4f} ms" for n in names)
                + f"; the source's bits: {', '.join(same)}")

    # 6. K2's phases at P=387
    p = batches[2048][0]
    for body in ("tile_hs", "fma") if with_fma else ("tile_hs",):
        plain, marked = f"fwd_{body}", f"fwdp_{body}"
        ms = in_turns({plain: lambda: k2(plain, 2048), marked: lambda: k2(marked, 2048)})
        counts = np.zeros(16, np.uint64)
        phases = libs[marked].phase_cycles
        phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if phases(counts.ctypes.data, 1) != 0:
            raise RuntimeError("phase counters not reset")
        k2(marked, 2048)
        torch.cuda.synchronize()
        if phases(counts.ctypes.data, 0) != 0:
            raise RuntimeError("phase counters not read")
        total = float(counts[:len(FWD_PHASES)].sum())
        print(f"K2 H=64 P={p} L={n_layers}, {body} body: {ms[plain]:.4f} ms per call, "
              f"{ms[marked]:.4f} ms with the phase markers")
        for i, name in enumerate(FWD_PHASES):
            print(f"  {name:40s} {float(counts[i]) / p:12.0f} cycles per CTA "
                  f"{100 * float(counts[i]) / total:6.1f}%")
        print(f"  {'all phases':40s} {total / p:12.0f} cycles per CTA")


def sep_phase(torch, np, fg, build, stream, width, n_layers, msg_w, msg_b, gru,
              batches, logs, in_turns, smi):
    """Phase 7 at one width: the forward body's variants in turns, and each
    one's K1 error on phase 3a's crowded batch."""
    names = [f"fwd{width}_{v}" for v in SEP_VARIANTS[width]]
    cut = len(f"fwd{width}_")
    libs = {}
    for name in names:
        handle = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        for entry, argtypes in build.SOURCES["fused_ggnn.cu"].items():
            getattr(handle, entry).argtypes = argtypes
        libs[name] = handle
        print(f"ptxas {name}: " + "; ".join(kernel_registers(logs[name], width)))
    out = {bs: torch.empty_like(b[1]) for bs, b in batches.items()}

    def k2(name, bs):
        p, h0, adj, readout = batches[bs]
        err = libs[name].fused_ggnn_readout_fwd(
            h0.data_ptr(), adj.data_ptr(), *fg._weight_ptrs(msg_w, msg_b, gru),
            *(x.data_ptr() for x in readout), out[bs].data_ptr(), p, n_layers, width,
            width, stream)
        if err != 0:
            raise RuntimeError(f"K2 {name} launch failed: {err}")

    def k1(name, p, h0, adj, dst):
        err = libs[name].fused_ggnn_fwd(
            h0.data_ptr(), adj.data_ptr(), *fg._weight_ptrs(msg_w, msg_b, gru),
            dst.data_ptr(), p, n_layers, width, stream)
        if err != 0:
            raise RuntimeError(f"K1 {name} launch failed: {err}")

    for bs, (p, h0, adj, _) in batches.items():
        for label, run in (("K2", lambda n, bs=bs: k2(n, bs)),
                           ("K1", lambda n, b=batches[bs], bs=bs: k1(n, *b[:3], out[bs]))):
            ms = in_turns({n: (lambda n=n: run(n)) for n in names})
            print(f"{label} H={width} P={p} L={n_layers} ({smi}): " + ", ".join(
                f"{n[cut:]} {ms[n]:.4f} ms" for n in names))
    # chip_smoke.py phase 3a's crowded batch (crowd_rows)
    p, h0, adj, _ = batches[256]
    extra = torch.as_tensor(np.random.default_rng(2018).random(tuple(adj.shape))
                            < 0.05).to(adj.device)
    extra[:, 1::2, :] = False
    adj = torch.where(extra, torch.ones_like(adj), adj).contiguous()
    with torch.no_grad():
        plain = fg.fused_ggnn_reference(n_layers, h0, adj, msg_w, msg_b, gru)
        f64 = fg.fused_ggnn_reference(
            n_layers, h0.double(), adj.double(), msg_w.double(), msg_b.double(),
            {k: v.double() for k, v in gru.items()})

    def closest(x, ref):
        return float(((x.double() - ref).abs() / (1e-4 + 1e-4 * ref.abs())).max())

    print(f"K1 H={width} crowded P={p}: plain f32 against float64, closest to the "
          f"bound {closest(plain, f64.float()):.3f} of it")
    for name in names:
        got = torch.empty_like(h0)
        k1(name, p, h0, adj, got)
        torch.cuda.synchronize()
        print(f"K1 H={width} crowded P={p}, {name[cut:]}: against plain f32 "
              f"{closest(got, plain):.3f}, against float64 {closest(got, f64):.3f} "
              f"of the bound; max abs err vs plain {float((got - plain).abs().max()):.3e}")


if __name__ == "__main__":
    sys.exit(main())
