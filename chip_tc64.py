#!/usr/bin/env python3
"""Where the H=64 GGNN bodies' time goes, on one NVIDIA GPU: the rates of
the instructions their 3xTF32 products are made of, the reverse body's and
the forward body's phases timed inside the kernel, and the forward's
variants timed in turns.

    python3 chip_tc64.py [--fma-src DIR] [--forward-only] [--sep-only]
                         [--parent-src DIR] [--bwd128-only]

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

8. The reverse body at H = D = 128 (``fused_ggnn128_bwd.cuh``; bench.py's
   h=128 model, L = 8 untied, seeded weights) on the same pairs (P = 75
   and 387), from the tree's ``fused_ggnn_bwd.cu`` and, with
   ``--parent-src``, from a directory holding an earlier one and its
   headers (``git archive 3c1b68b gcnbmp_tpu_torch/ops/csrc``: the body
   that rebuilt the forward in every reversed layer): each body's ptxas
   registers and spills; the tree's body as it is and in variants by the
   constants of its products (``with_constants``: ``step1`` no SEP and
   nothing unrolled, the arithmetic and the unrolling of the parent's
   reverse, the forward's m, r, z and n stored and read back in place of
   its rebuild; ``fu``, ``ru``, ``sep`` the tree's FWD_UNROLL, REV_UNROLL
   and REV_SEP each flipped alone; ``loops`` R's reloads of h and m by
   thread loops and barriers, as the parent took them, in place of bulk
   copies on an mbarrier), each against the parent's bits for
   K1b, each K3 half (the top from h_mid) and K2b, and its K1b on chip_smoke.py
   phase 3a's crowded batch (P = 75) against the plain version (the
   tensor closest to the gradient bound, as a fraction of it); K2b (both
   launches) and K1b of each timed in turns (CUDA events, median of 14
   runs of 5 calls); and at P = 387 each body's phases by
   clock64 as in 3 (markers each after a barrier, most of them put in
   for it; K2b's cycles summed over its launches): set-up, the forward
   over the range, the readout's backward, the per-layer rebuild of the
   messages and of the gates (the parent's), the GRU reverse's products,
   its weight gradients, the message backward's column gathers and its
   products, and the reloads of h and m with the parking.  Each line
   carries the card's name and power limit.

Builds into ``results/tc64/`` with nvcc (all at once).  Fails if an anchor
of the source is not found (the source changed) or there is no card.
``--forward-only`` runs phases 5 to 7 alone, ``--sep-only`` phase 7,
``--bwd128-only`` phase 8.
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
SEP_OFF = "int LDA = H, bool SEP = false,"
SEP_ON = "int LDA = H, bool SEP = true,"

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
    ap.add_argument("--parent-src", help="a directory holding an earlier "
                    "fused_ggnn_bwd.cu and its headers (phase 8)")
    ap.add_argument("--bwd128-only", action="store_true", help="phase 8 alone")
    args = ap.parse_args()
    only = args.forward_only or args.sep_only or args.bwd128_only
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
    if not only:
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
    if not (args.sep_only or args.bwd128_only):
        trees.update({f"fwd_{name}": (build.CSRC, edits, None)
                      for name, edits in FWD_VARIANTS.items()})
        trees["fwdp_tile_hs"] = (build.CSRC, (), "tile")
        if args.fma_src:
            trees["fwd_fma"] = (args.fma_src, (), None)
            trees["fwdp_fma"] = (args.fma_src, (), "fma")
    if not args.bwd128_only:
        trees.update({f"fwd{width}_{name}": (build.CSRC, edits, None)
                      for width, variants in SEP_VARIANTS.items()
                      for name, edits in variants.items()})
    for name, (src_dir, edits, instrument) in trees.items():
        path = write_tree(os.path.join(OUT, name), src_dir, edits, instrument)
        sources[name] = (path, build.NVCC_FLAGS)
    rev128 = {}
    if args.bwd128_only or not (args.forward_only or args.sep_only):
        rev128 = reverse128_sources(args.parent_src)
        sources.update({name: spec[:2] for name, spec in rev128.items()})
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

    if args.bwd128_only:
        enc, weights = model(128)
        reverse128_phase(torch, np, fg, stream, enc.n_layers, *weights,
                         {bs: batch(enc, bs) for bs in (256, 2048)}, rev128, logs,
                         in_turns, smi)
        return 0
    enc, (msg_w, msg_b, gru) = model(64)
    n_layers = enc.n_layers
    batches = {bs: batch(enc, bs) for bs in (256, 2048)}
    if not only:
        reverse_phases(torch, np, fg, build, dev, stream, n_layers, msg_w,
                       msg_b, gru, batches[2048], event_ms, logs)
    if not args.sep_only:
        forward_phases(torch, fg, build, stream, n_layers, msg_w, msg_b, gru,
                       batches, logs, in_turns, smi, bool(args.fma_src))
    sep_phase(torch, np, fg, build, stream, 64, n_layers, msg_w, msg_b, gru,
              batches, logs, in_turns, smi)
    enc, weights = model(128)
    batches = {bs: batch(enc, bs) for bs in (256, 2048)}
    sep_phase(torch, np, fg, build, stream, 128, enc.n_layers, *weights,
              batches, logs, in_turns, smi)
    if rev128:
        reverse128_phase(torch, np, fg, stream, enc.n_layers, *weights, batches, rev128,
                         logs, in_turns, smi)
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
    bufs = fg._bwd_buffers(p, n_layers, 64, 64, dev)[:5]  # dh0 .. hs, acts (None)
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
            *(fg._ptr(b) for b in bufs), p, n_layers, 64, 64, stream)
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

# -- phase 8: the H=128 reverse body -----------------------------------------

BWD_SOURCE, BWD128_HEADER = "fused_ggnn_bwd.cu", "fused_ggnn128_bwd.cuh"
# thread 0 of each CTA adds the cycles since its last marker, kept in global
# memory by block, so that a launch's first marker (-1) starts its count
PROF128 = r"""
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
PHASES128 = ["set-up: pointers, row and column lists", "forward over the range",
             "readout backward (K2b)", "rebuild: messages (parent)",
             "rebuild: gates (parent); dz', dn'",
             "GRU reverse: drs, ds, dh_in, dm products", "GRU weight gradients",
             "message backward: column gathers",
             "message backward: gradients, dh += dhw W^T", "reloads: h, m, parking, dh"]


def _mark(i, indent="  ", sync=True):
    return (f"{indent}__syncthreads();\n" if sync else "") + f"{indent}phase_end({i});\n"


# (anchor in the H=128 part of fused_ggnn_bwd.cu, text put after it): the
# GRU reverse's and the message backward's, in both bodies
_GRU_MARKS = [
    ("  col_sums<2, H, H>({dz, dn}, {g.gru() + G::BZ, g.gru() + G::BN}, HALF, acc_gru, tid);\n",
     _mark(6)),
    ("  col_sums<1, H, H>({rs}, {g.gru() + G::BR}, HALF, acc_gru, tid);\n", _mark(6)),
    ("  const Globals g = {s_ptrs};\n", _mark(-1, sync=False)),
]
# the parent's (3c1b68b): one launch of K1b and K3 (MODE 0), the reverse
# rebuilding the forward in every layer
PARENT_MARKS128 = _GRU_MARKS + [
    ("    count_columns(t.nk, t.nv, t.nc, s_cs, s_cr, s_cv, s_ov, s_ovn,\n"
     "                  reinterpret_cast<unsigned*>(t.work), tid);\n", _mark(0)),
    ("                        fwd_seq, p, tid);\n      __syncthreads();\n    }\n  }\n",
     _mark(1, sync=False)),
    ("    readout_bwd128(t, g, smem + S::BI, smem + S::BJ, ro_seq, p, tid);\n",
     _mark(2, "    ")),
    ("    for (int i = tid; i < TH; i += THREADS) g.dh()[i] = g.dout()[i];\n", _mark(9)),
    ("    for (int i = tid; i < TH; i += THREADS) t.h[i] = g.hs(l - lo)[i];\n",
     _mark(9, "    ")),
    ("    for (int i = tid; i < NE * H; i += THREADS) t.bmsg[i] = w.msg_b[size_t(l) * NE * H + i];\n"
     "    messages_looped(t, g, rev_seq, p, tid);\n", _mark(3, "    ")),
    ("        park[i] = t.m[hf == 0 ? HALF * H + i : i];\n      }\n", _mark(9, "      ")),
    ("        dz[i] = dhv * (nv - s) * z * (1.0f - z);\n      }\n    }\n  }\n"
     "  __syncthreads();\n", _mark(4, sync=False)),
    ("      rs[i] = a[k] * s * rv * (1.0f - rv);\n    }\n  }\n  __syncthreads();\n",
     _mark(5, sync=False)),
    ("        *d = zero_state ? a[k] : a[k] + *d;\n      }\n    }\n  }\n", _mark(5)),
    ("      for (int i = tid; i < TH; i += THREADS) g.dh()[i] += g.part()[Scratch::DIRECT + i];\n"
     "    }\n", _mark(9, "    ")),
    ("                                        *s_ovn, t.work, tid);\n      __syncthreads();\n",
     _mark(7, "      ", sync=False)),
    ("rev_seq.take(p, tid), g.dh() + kb * HB, true);\n", _mark(8, "      ")),
]
# the tree's: F (the forward storing hs and acts, then the seed) and R (the
# reloads' phase is the wait for each bulk copy, with the parked dm's loop)
MARKS128 = _GRU_MARKS + [
    ("    __syncthreads();\n    RSeq<MODE, 0> fwd_seq = {w, ro, lo, hi};\n",
     _mark(0, "    ", sync=False)),
    ("                        g.act(l - lo, ACT_N), fwd_seq, p, tid);\n      __syncthreads();\n"
     "    }\n", _mark(1, "    ", sync=False)),
    ("      readout_bwd128(t, g, smem + S::BI, smem + S::BJ, ro_seq, p, tid);\n",
     _mark(2, "      ")),
    ("      for (int i = tid; i < TH; i += THREADS) g.dh()[i] = g.dout()[i];\n",
     _mark(9, "      ")),
    ("    RSeq<MODE, 0> rev_seq = {w, ro, lo, hi};\n", _mark(0, "    ")),
    ("      rl.wait(3 * j);  // the layer's h and m\n", _mark(9, "      ")),
    ("          rl.wait(3 * j + 1);\n", _mark(9, "          ")),
    ("      dz[i] = dhv[k] * (nv[k] - s) * z * (1.0f - z);\n    }\n  }\n  __syncthreads();\n",
     _mark(4, sync=False)),
    ("      rs[i] = a[k] * s * rv[k] * (1.0f - rv[k]);\n    }\n  }\n  __syncthreads();\n",
     _mark(5, sync=False)),
    ("      for (int k = 0; k < RPH; ++k) *dh_at(k, kb) = zero_state ? a[k] : a[k] + dhv[k];\n"
     "    }\n  }\n", _mark(5)),
    ("      rl.wait(3 * j + 2);\n", _mark(9, "      ")),
    ("                                          *s_ovn, t.work, tid);\n        __syncthreads();\n",
     _mark(7, "        ", sync=False)),
    ("          xwt_tile_global(t.work, wb, g.dh() + kb * HB, true);\n        }\n",
     _mark(8, "        ")),
]
# the tree's reloads by thread loops, as the parent's (a barrier in place
# of the mbarrier's wait): (anchor in fused_ggnn128_bwd.cuh, replacement)
LOOP_RELOADS = [
    ("    if (tid == 0) mbar_expect_tx(bar, unsigned(words) * 4);\n", ""),
    ("    if (tid == 0) {\n      fence_proxy_async();\n      bulk_copy(dst, src, unsigned(words) * 4, bar);\n"
     "    }\n", "    for (int i = tid; i < words; i += THREADS) dst[i] = src[i];\n"),
    ("  __device__ void wait(int phase) const { mbar_wait(bar, unsigned(phase) & 1u); }",
     "  __device__ void wait(int) const { __syncthreads(); }"),
]


def instrumented128(text: str, marks) -> str:
    """fused_ggnn_bwd.cu with phase 8's markers in its H=128 reverse body."""
    cut = text.index("// The reverse of one GRU half of layer l at H = 128")
    head, body = text[:cut], text[cut:]
    body = edited(body, [(anchor, anchor + mark) for anchor, mark in marks], BWD_SOURCE)
    ns = "namespace {\n\nusing namespace ggnn;\n"
    if head.count(ns) != 1:
        raise RuntimeError("namespace anchor not found")
    return head.replace(ns, ns + PROF128) + body + READ


def with_constants(text: str, **values) -> str:
    """fused_ggnn128_bwd.cuh with its constexpr FWD_UNROLL, REV_UNROLL and
    REV_SEP set to ``values``."""
    for name, value in values.items():
        text, n = re.subn(rf"constexpr (int|bool) {name} = [^;]+;",
                          rf"constexpr \g<1> {name} = {value};", text)
        if n != 1:
            raise RuntimeError(f"{name} not found once in {BWD128_HEADER}")
    return text


def constants_of(text: str) -> dict:
    return {name: re.search(rf"constexpr (?:int|bool) {name} = ([^;]+);", text)[1]
            for name in ("FWD_UNROLL", "REV_UNROLL", "REV_SEP")}


# the parent's C entry points (no acts scratch), as build.SOURCES had them
PARENT_ENTRIES = {"fused_ggnn_range_bwd": [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p],
                  "fused_ggnn_readout_bwd": [ctypes.c_void_p] * 23 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p]}


def reverse128_sources(parent_dir: str | None):
    """Phase 8's libraries: name -> (source path, nvcc flags, C entry
    points).  The tree's body, plain and marked, and its variants by
    tc_mma's unrolling and SEP (``with_constants``): step 1's (no SEP,
    nothing unrolled: the parent's arithmetic) and each constant of the
    tree's flipped; with ``parent_dir`` the parent's body, plain and
    marked.  Where the tree holds the parent's body, that one alone."""
    from gcnbmp_tpu_torch.ops import build

    def read(directory, name):
        with open(os.path.join(directory, name)) as f:
            return f.read()

    tree = read(build.CSRC, BWD_SOURCE)
    parent = read(parent_dir, BWD_SOURCE) if parent_dir else None
    out = {}

    def add(name, src_dir, text, entries, header=None):
        path = write_tree(os.path.join(OUT, name), src_dir, source=BWD_SOURCE)
        with open(path, "w") as f:
            f.write(text)
        if header is not None:
            with open(os.path.join(OUT, name, BWD128_HEADER), "w") as f:
                f.write(header)
        out[name] = (path, build.NVCC_FLAGS, entries)

    if parent is not None and parent != tree:
        add("b128_parent", parent_dir, parent, PARENT_ENTRIES)
        add("b128_parent_p", parent_dir,
            instrumented128(parent, PARENT_MARKS128), PARENT_ENTRIES)
    entries = build.SOURCES[BWD_SOURCE]
    if "messages_looped(t, g, rev_seq" in tree:  # the parent's body
        add("b128", build.CSRC, tree, entries)
        add("b128_p", build.CSRC, instrumented128(tree, PARENT_MARKS128), entries)
        return out
    add("b128", build.CSRC, tree, entries)
    add("b128_p", build.CSRC, instrumented128(tree, MARKS128), entries)
    header = read(build.CSRC, BWD128_HEADER)
    now = constants_of(header)
    variants = {"step1": dict(FWD_UNROLL=1, REV_UNROLL=1, REV_SEP="false"),
                "fu": dict(FWD_UNROLL=3 - int(now["FWD_UNROLL"])),
                "ru": dict(REV_UNROLL=3 - int(now["REV_UNROLL"])),
                "sep": dict(REV_SEP="false" if now["REV_SEP"] == "true" else "true")}
    for name, values in variants.items():
        add(f"b128_{name}", build.CSRC, tree, entries, with_constants(header, **values))
    add("b128_loops", build.CSRC, tree, entries, edited(header, LOOP_RELOADS, BWD128_HEADER))
    return out


def bwd128_registers(log: str) -> list[str]:
    """ptxas's registers and spills of each fused_ggnn_bwd_kernel128 instance."""
    out, body = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"fused_ggnn_bwd_kernel128ILi(\d+)E", m.group(1))
            body = None if k is None else f"<{k[1]}>"
        elif body and ("spill" in line or "registers" in line):
            out.append(f"{body}: {line.split(':', 1)[-1].strip()}")
    return out


def reverse128_phase(torch, np, fg, stream, n_layers, msg_w, msg_b, gru, batches, libs_spec,
                     logs, in_turns, smi):
    """Phase 8: the H=128 reverse body's variants (registers, the parent's
    bits, the crowded K1b's error against the plain version, times in
    turns: K2b and K1b at P=75 and 387) and each body's phases by clock64
    (K2b's two launches and K1b at P=387)."""
    hidden, split = 128, n_layers // 2
    libs = {}
    for name, (path, _, entries) in libs_spec.items():
        handle = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        for entry, argtypes in entries.items():
            getattr(handle, entry).argtypes = argtypes
        # a body with the acts scratch takes one pointer more
        libs[name] = (handle, len(entries["fused_ggnn_range_bwd"])
                      > len(PARENT_ENTRIES["fused_ggnn_range_bwd"]))
        if not name.endswith("_p"):
            with open(os.path.join(os.path.dirname(path), BWD128_HEADER)) as f:
                header = f.read()
            consts = constants_of(header) if "REV_SEP" in header else "the parent's"
            print(f"ptxas {name} ({consts}): " + "; ".join(bwd128_registers(logs[name])))
    f32 = dict(dtype=torch.float32, device=msg_w.device)

    def buffers(p):
        n_grad = sum(int(np.prod(s)) for s in fg._grad_shapes(n_layers, hidden, hidden))
        return (torch.empty((p, 128, hidden), **f32), torch.empty((p, n_grad), **f32),
                torch.empty((n_grad,), **f32), torch.empty((p, n_layers, 128, hidden), **f32),
                torch.empty((p, n_layers, 4, 128, hidden), **f32))

    cases = {}
    for bs, (p, h0, adj, readout) in batches.items():
        dout = torch.as_tensor(np.random.default_rng(2018 + bs).standard_normal(
            (p, 128, hidden)).astype(np.float32)).to(msg_w.device)
        with torch.no_grad():
            h_mid = fg.fused_ggnn_mid_reference(n_layers, h0, adj, msg_w, msg_b, gru)[1]
        cases[bs] = (p, h0, adj, readout, dout, h_mid, buffers(p))
        bufs = cases[bs][-1]
        print(f"phase 8 P={p}: acts {bufs[4].numel() * 4} bytes, hs "
              f"{bufs[3].numel() * 4}, partial rows {bufs[1].numel() * 4}")
    wptrs = fg._weight_ptrs(msg_w, msg_b, gru)

    def scratch(name, bufs):
        return [b.data_ptr() for b in bufs[1:4]] + ([bufs[4].data_ptr()] if libs[name][1] else [])

    def k2b(name, case):
        p, h0, adj, readout, dout, _, bufs = case
        err = libs[name][0].fused_ggnn_readout_bwd(
            h0.data_ptr(), adj.data_ptr(), *wptrs, *(x.data_ptr() for x in readout),
            dout.data_ptr(), bufs[0].data_ptr(), *scratch(name, bufs), p, n_layers, hidden,
            hidden, stream)
        if err != 0:
            raise RuntimeError(f"K2b {name} launch failed: {err}")

    def rng(name, case, lo, hi):
        p, h0, adj, _, dout, h_mid, bufs = case
        hin = h_mid if lo > 0 else h0
        err = libs[name][0].fused_ggnn_range_bwd(
            hin.data_ptr(), adj.data_ptr(), *wptrs, dout.data_ptr(), bufs[0].data_ptr(),
            *scratch(name, bufs), p, lo, hi, hidden, stream)
        if err != 0:
            raise RuntimeError(f"range [{lo}, {hi}) {name} launch failed: {err}")

    ranges = {"K2b": (0, n_layers), "K1b": (0, n_layers), "K3 top": (split, n_layers),
              "K3 bottom": (0, split)}
    kernels = {"K2b": k2b,
               **{label: (lambda n, c, r=r: rng(n, c, *r)) for label, r in ranges.items()
                  if label != "K2b"}}
    plain = [n for n in libs if not n.endswith("_p")]

    def results(name, label, case):
        """dh_bot and the summed gradients of one run."""
        lo, hi = ranges[label]
        n_grad = sum(int(np.prod(s)) for s in fg._grad_shapes(
            hi - lo, hidden, hidden if label == "K2b" else None))
        kernels[label](name, case)
        torch.cuda.synchronize()
        return case[-1][0].clone(), case[-1][2][:n_grad].clone()

    # each variant's bits against the parent's, and its forward's (the
    # layer inputs hs)
    if "b128_parent" in libs:
        for bs, case in cases.items():
            for label in kernels:
                want = results("b128_parent", label, case)
                want_hs = case[-1][3].clone()
                same, same_hs = [], []
                for n in plain:
                    if n == "b128_parent":
                        continue
                    tag = n[5:] or "tree"
                    if all(torch.equal(a, b) for a, b in zip(results(n, label, case), want)):
                        same.append(tag)
                    if torch.equal(case[-1][3], want_hs):
                        same_hs.append(tag)
                print(f"{label} H=128 P={case[0]}: the parent's bits from "
                      f"{', '.join(same) or 'none'}; its forward's (hs) from "
                      f"{', '.join(same_hs) or 'none'}")

    # the crowded K1b (chip_smoke.py phase 3a's adjacency at P=75) against
    # the plain version: the tensor closest to the gradient bound
    p, h0, adj, readout, dout, h_mid, bufs = cases[min(cases)]
    extra = torch.as_tensor(np.random.default_rng(2018).random(tuple(adj.shape))
                            < 0.05).to(adj.device)
    extra[:, 1::2, :] = False
    crowded = (p, h0, torch.where(extra, torch.ones_like(adj), adj).contiguous(), readout,
               dout, h_mid, bufs)
    with torch.no_grad():
        want = fg.fused_ggnn_bwd_reference(n_layers, h0, crowded[2], msg_w, msg_b, gru, dout)
    flat = [*want[:3], *(want[3][k] for k in fg.GRU_KEYS)]
    bound = [1e-4 * float(w.abs().max()) + 1e-6 for w in flat]
    shapes = fg._grad_shapes(n_layers, hidden)
    sizes = [int(np.prod(s)) for s in shapes]
    for name in plain:
        dh, grads = results(name, "K1b", crowded)
        dmsg_w, dmsg_b, dgru, _ = fg._split_grads(grads, shapes, sizes)
        got = [dh, dmsg_w, dmsg_b, *(dgru[k] for k in fg.GRU_KEYS)]
        worst = max(float((g - w).abs().max()) / b for g, w, b in zip(got, flat, bound))
        print(f"K1b H=128 crowded P={p}, {name}: closest to the gradient bound "
              f"{worst:.3f} of it")

    # the bodies in turns
    for bs, case in cases.items():
        for label in ("K2b", "K1b"):
            ms = in_turns({n: (lambda n=n: kernels[label](n, case)) for n in plain})
            print(f"{label} H=128 P={case[0]} L={n_layers} ({smi}): " + ", ".join(
                f"{n} {ms[n]:.4f} ms" for n in plain))

    # the phases at P=387, of each body
    case = cases[max(cases)]
    p = case[0]
    for name in [n for n in plain if n + "_p" in libs]:
        marked = name + "_p"
        phases = libs[marked][0].phase_cycles
        phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for label in ("K2b", "K1b"):
            ms = in_turns({name: lambda: kernels[label](name, case),
                           marked: lambda: kernels[label](marked, case)})
            counts = np.zeros(16, np.uint64)
            if phases(counts.ctypes.data, 1) != 0:
                raise RuntimeError("phase counters not reset")
            kernels[label](marked, case)
            torch.cuda.synchronize()
            if phases(counts.ctypes.data, 0) != 0:
                raise RuntimeError("phase counters not read")
            total = float(counts[:len(PHASES128)].sum())
            print(f"{label} H=128 P={p} L={n_layers}, {name}: {ms[name]:.4f} ms per call, "
                  f"{ms[marked]:.4f} ms with the phase markers ({smi})")
            for i, phase in enumerate(PHASES128):
                print(f"  {phase:44s} {float(counts[i]) / p:12.0f} cycles per CTA "
                      f"{100 * float(counts[i]) / total:6.1f}%")
            print(f"  {'all phases':44s} {total / p:12.0f} cycles per CTA")

if __name__ == "__main__":
    sys.exit(main())
