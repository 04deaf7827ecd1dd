// The GGNN kernels' layer steps at H = 64, shared by the forward body
// (fused_ggnn.cu: K1, K1m, K2) and the reverse body (fused_ggnn_bwd.cu:
// K1b, K3, K2b) at that width: the shared-memory plan, the weight panels,
// the message step one edge type at a time, the GRU gates by halves of the
// tile, the readout's pre-activations and the blocked products.
//
// Why H = 64 has a design of its own: GgnnPlan (fused_ggnn_common.cuh)
// keeps every weight, h, m and the 4T x H hw stack in shared memory.  At
// H = 64 that is 442 KB forward and 493 KB backward, against 227 KB per
// CTA; the weights alone (the GRU and one layer's messages, rows padded)
// take 226 KB.  So at this width:
// - The weights stay in global memory (L2) and pass through two staged
//   panels of one (64, 64) block each (rows padded to HP = 68 words):
//   while the CTA multiplies by block j, cp.async brings block j + 1 into
//   the other panel (panels_next).  Every product is split into products
//   by (64, 64) blocks: the message weight W_e, the GRU's Wz, Wr, Wn by
//   their h and m halves, Uz, Ur, Un, the readout's Wi by halves and Wj.
// - The message step takes one edge type at a time: hw_e = h W_e + b_e
//   (T x H) into one buffer, then m += A_e hw_e, each row's sum running on
//   in ascending column order across e, so m adds the same terms in the
//   same order as the 4T x H stack of the narrower widths.  The reverse
//   gathers dhw_e = A_e^T dm one edge type at a time the same way.
// - The GRU runs on the tile's rows in two halves of 64 (its gates are
//   row-local): each thread then owns one column of 8 rows, as at H = 32,
//   and the reverse's r*s, dz', dr', dn' take 64 rows each (64 KB
//   together) instead of 128.  The gates are taken one at a time, z and r
//   parked in shared memory, so one set of accumulators is live.
// - Every product keeps at most 8 rows a thread in registers: the
//   message and readout products also go by halves of the tile, and the
//   weight gradients by 4 x 4 blocks; the bodies then fit 128 registers
//   a thread without spilling.
// - Index lists are 16-bit (columns < 512, rows < 128).
// The plan comes to 148,224 bytes forward and 228,672 backward (Plan).
// Arithmetic is plain f32 FMAs, as at the narrower widths.
//
// Thread layout of the row-wise products: thread `tid` owns column
// col = tid % 64 of the rows r0 + 8k (r0 = tid / 64) of its row set.

#pragma once

#include "fused_ggnn_common.cuh"

namespace ggnn {
namespace h64 {

constexpr int H = 64;
constexpr int HP = H + 4;             // padded row of a weight panel
constexpr int TH = TILE * H;
constexpr int HALF = TILE / 2;        // rows of half the tile
constexpr int RS = THREADS / H;       // 8: stride of a thread's rows
constexpr int RPH = HALF / RS;        // 8 rows per thread over a half
constexpr int PANEL = H * HP;         // words of one staged (64, 64) block
using Idx = unsigned short;           // row- and column-list indices

// Shared-memory plan in 4-byte words; BWD adds dh, a second T x H of work
// space and the column lists.  WORK holds hw_e / dhw_e (T x H); in a GRU
// half r*s and z (64 x H each), in the reverse's also r, then r*s, dz',
// dr', dn' (z and r where dz' and dr' go); the readout's gate (T x D) and
// in K2b's seed d(pre-gate) and d(h Wj + bj) (T x H each); the column
// build's row masks.
template <bool BWD>
struct Plan {
  static constexpr int HIN = 0;                          // T H: h
  static constexpr int MS = HIN + TH;                    // T H: m, then dm; h0 (readout)
  static constexpr int DH = MS + TH;                     // T H: dh (BWD)
  static constexpr int WORK = DH + (BWD ? TH : 0);
  static constexpr int PANELS = WORK + (BWD ? 2 : 1) * TH;  // 2 PANEL
  static constexpr int B_MSG = PANELS + 2 * PANEL;       // 4 H: layer l's b_e
  static constexpr int BZ = B_MSG + NE * H;              // H each
  static constexpr int BR = BZ + H;
  static constexpr int BN = BR + H;
  static constexpr int BI = BN + H;                      // readout biases
  static constexpr int BJ = BI + H;
  static constexpr int NV = BJ + H;                      // T NBR_CAP row-list values
  static constexpr int NK = NV + TILE * NBR_CAP;         // T NBR_CAP row-list columns (16-bit)
  static constexpr int NC = NK + TILE * NBR_CAP / 2;     // T row nonzero counts
  static constexpr int CS = NC + TILE;                   // 4T + 1 column starts
  static constexpr int CR = CS + ROW_LEN + 4;            // T NBR_CAP column-list rows (16-bit)
  static constexpr int CV = CR + TILE * NBR_CAP / 2;     // T NBR_CAP column-list values
  static constexpr int OV = CV + TILE * NBR_CAP;         // T crowded rows
  static constexpr int OVN = OV + TILE;                  // their count
  static constexpr int PTRS = OVN + 4;                   // 4 global pointers (BWD)
  static constexpr int WORDS = BWD ? PTRS + 8 : CS;
  static constexpr size_t BYTES = size_t(WORDS) * 4;
  static_assert(PANELS % 4 == 0 && B_MSG % 4 == 0 && HP % 4 == 0 && WORK % 4 == 0,
                "16-byte aligned rows");
  static_assert(!BWD || 2 * TH >= COLUMN_MASK_WORDS, "row masks fit in WORK");
  static_assert(BYTES <= 232448, "shared-memory plan exceeds 227 KB");
};

__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// ---------------------------------------------------------------------------
// weight panels

// Two staged (64, 64) weight blocks; block j of a kernel's sequence sits in
// buf + (j & 1) PANEL.  Each call of panels_next names the block it hands
// out and the one to load behind it, so the sequence is written out where
// the blocks are used.
struct Panels {
  float* buf;
  int j;
#ifndef __CUDACC__
  const float* src[2];  // the CPU stand-in checks the names against the loads
#endif
};

// One (64, 64) block (rows of 64 contiguous floats, 16-byte aligned) into
// a panel with rows of HP, by cp.async: 1,024 16-byte copies, 2 a thread.
__device__ __forceinline__ void panel_load(const float* __restrict__ src,
                                           float* dst, int tid) {
  static_assert(H * H / 4 == 2 * THREADS, "two copies a thread");
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = tid + s * THREADS;
    const int row = q / (H / 4), c = (q % (H / 4)) * 4;
    __pipeline_memcpy_async(dst + row * HP + c, src + row * H + c, 16);
  }
}

__device__ __forceinline__ void panels_start(Panels& p, float* buf,
                                             const float* first, int tid) {
  p.buf = buf;
  p.j = 0;
#ifndef __CUDACC__
  p.src[0] = first;
  p.src[1] = nullptr;
#endif
  panel_load(first, buf, tid);
  __pipeline_commit();
}

// Wait for block j (loaded from `cur`) and synchronise the CTA: every
// thread is then done with block j - 1 and with whatever it wrote before
// the call.  Then start loading `next` (nullptr: nothing) into block j - 1's
// panel, and return block j.
__device__ __forceinline__ const float* panels_next(Panels& p, const float* cur,
                                                    const float* next, int tid) {
  __pipeline_wait_prior(0);
  __syncthreads();
  float* here = p.buf + (p.j & 1) * PANEL;
#ifndef __CUDACC__
  if (p.src[p.j & 1] != cur) __builtin_trap();
  p.src[(p.j + 1) & 1] = next;
#endif
  if (next != nullptr) panel_load(next, p.buf + ((p.j + 1) & 1) * PANEL, tid);
  __pipeline_commit();
  ++p.j;
  return here;
}

__device__ __forceinline__ const float* msg_panel(const Weights& w, int l, int e) {
  return w.msg_w + size_t(l * NE + e) * H * H;
}

// ---------------------------------------------------------------------------
// products

// acc[k] += sum_d x[i_k, d] w[d, col] for the rows i_k = r0 + RS k of x
// (row stride H; w a panel): per chunk of four d, four entries of w's rows
// (consecutive columns over a warp) and one 16-byte broadcast of each row.
template <int N>
__device__ __forceinline__ void xw(const float* x, const float* w, int col,
                                   int r0, float (&acc)[N]) {
#pragma unroll 1
  for (int d0 = 0; d0 < H; d0 += 4) {
    float wv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wv[q] = w[(d0 + q) * HP + col];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float xv[4];
      ld4(x + (r0 + RS * k) * H + d0, xv);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[k] = fmaf(xv[q], wv[q], acc[k]);
    }
  }
}

// acc[k] += sum_j x[i_k, j] w[c, j] for the rows i_k = r0 + STRIDE k (x W^T,
// w a panel): per chunk of four j, one 16-byte load of w's row c (the
// padding puts the rows of a quarter warp in distinct banks) and one
// broadcast of each row.
template <int N, int STRIDE>
__device__ __forceinline__ void xwt(const float* x, const float* w, int c,
                                    int r0, float (&acc)[N]) {
#pragma unroll 1
  for (int j0 = 0; j0 < H; j0 += 4) {
    float wv[4];
    ld4(w + c * HP + j0, wv);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float xv[4];
      ld4(x + (r0 + STRIDE * k) * H + j0, xv);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[k] = fmaf(xv[q], wv[q], acc[k]);
    }
  }
}

// Weight gradients over `rows` rows, as grad_pass of the narrower widths:
//   out_p (H, H) (+)= a_p^T b_p for p < NP (out2_p, where set, takes the
//   same product, or zeros without `add2`), s_out_q (H) (+)= column sums
//   of s_q for q < NS.
// A product takes 256 threads, each owning a 4 x 4 block of outputs: per
// row, one 16-byte load of a_p's row and one of b_p's, and 16 FMAs (the
// rows not unrolled, so the reverse body stays within its registers).
// Threads [256 NP, 256 NP + NSUM) own columns of the sums.  Each output
// belongs to one thread and sums the rows in order.
template <int NP, int NS, int NSUM>
__device__ __forceinline__ void grad_pass(const GradPass<NP, NS>& gp, int rows,
                                          bool accumulate, bool add2, int tid) {
  constexpr int B = 4;                   // rows and columns of a thread's block
  constexpr int TPP = (H / B) * (H / B);  // threads of a product
  static_assert(NP * TPP + NSUM <= THREADS, "threads of a gradient pass");
  if (tid < NP * TPP) {
    const int p = tid / TPP, ta = (tid % TPP) / (H / B), tc = tid % (H / B);
    float acc[B][B] = {};
    const float* a = gp.a[p] + ta * B;
    const float* b = gp.b[p] + tc * B;
#pragma unroll 1
    for (int i = 0; i < rows; ++i) {
      float av[B], bv[B];
      ld4(a + i * H, av);
      ld4(b + i * H, bv);
#pragma unroll
      for (int x = 0; x < B; ++x)
#pragma unroll
        for (int y = 0; y < B; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
    }
    float* out = gp.out[p] + (ta * B) * H + tc * B;
    float* out2 = gp.out2[p];
#pragma unroll
    for (int x = 0; x < B; ++x)
#pragma unroll
      for (int y = 0; y < B; ++y) {
        float* o = out + x * H + y;
        *o = accumulate ? *o + acc[x][y] : acc[x][y];
        if (out2 != nullptr) {
          float* o2 = out2 + (ta * B + x) * H + tc * B + y;
          const float v = add2 ? acc[x][y] : 0.0f;
          *o2 = accumulate ? *o2 + v : v;
        }
      }
  } else if constexpr (NS > 0) {
    if (tid >= NP * TPP + NSUM) return;
    constexpr int COLS = NS * H;
    constexpr int PER = (COLS + NSUM - 1) / NSUM;
    const int j = tid - NP * TPP;
    float acc[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) acc[q] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < rows; ++i)
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int f = j + q * NSUM;
        if (f < COLS) acc[q] += gp.s[f / H][i * H + f % H];
      }
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int f = j + q * NSUM;
      if (f < COLS) {
        float* o = gp.s_out[f / H] + f % H;
        *o = accumulate ? *o + acc[q] : acc[q];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the layer's steps

// m (+)= A_e hw_e (s_hw: hw_e, T x H) for edge type e: one warp per row,
// lane c owns columns c and c + 32.  The row-list entries of e's columns
// [eT, eT + T), or a crowded row's dense columns there, in ascending
// order; m starts at zero for e = 0 and carries on for e > 0, so each row
// sums its terms in ascending column order of A_flat.
__device__ __forceinline__ void aggregate_edge(const float* adj_t, int e,
                                               const float* s_hw, float* s_m,
                                               const Idx* s_nk, const float* s_nv,
                                               const int* s_nc, int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lo = e * TILE;
  for (int i = warp; i < TILE; i += WARPS) {
    float a0 = e == 0 ? 0.0f : s_m[i * H + lane];
    float a1 = e == 0 ? 0.0f : s_m[i * H + lane + 32];
    const int cnt = s_nc[i];
    if (cnt > NBR_CAP) {
      const float* arow = adj_t + size_t(i) * ROW_LEN + lo;
      float av[TILE / 32];
#pragma unroll
      for (int q = 0; q < TILE / 32; ++q) av[q] = __ldg(arow + q * 32 + lane);
#pragma unroll
      for (int q = 0; q < TILE / 32; ++q) {
        const float a = av[q];
        unsigned nz = __ballot_sync(0xffffffffu, a != 0.0f);
        while (nz) {
          const int b = __ffs(nz) - 1;
          nz &= nz - 1;
          const float v = __shfl_sync(0xffffffffu, a, b);
          const float* src = s_hw + (q * 32 + b) * H;
          a0 = fmaf(v, src[lane], a0);
          a1 = fmaf(v, src[lane + 32], a1);
        }
      }
    } else {
      for (int n = 0; n < cnt; ++n) {
        const int k = int(s_nk[i * NBR_CAP + n]) - lo;
        if (k < 0 || k >= TILE) continue;
        const float v = s_nv[i * NBR_CAP + n];
        a0 = fmaf(v, s_hw[k * H + lane], a0);
        a1 = fmaf(v, s_hw[k * H + lane + 32], a1);
      }
    }
    s_m[i * H + lane] = a0;
    s_m[i * H + lane + 32] = a1;
  }
}

// dhw_e (T x H) = A_e^T dm for edge type e: thread owns column c of the
// rows k of dhw_e, column eT + k of A_flat: its column list in ascending
// row order, then the crowded rows in ascending order, as column_gather.
__device__ __forceinline__ void column_gather_edge(const float* adj_t, int e,
                                                   const float* s_dm,
                                                   const int* s_cs, const Idx* s_cr,
                                                   const float* s_cv, const int* s_ov,
                                                   int n_ov, float* s_dhw, int tid) {
  const int c = tid % H;
  for (int k = tid / H; k < TILE; k += RS) {
    const int kk = e * TILE + k;
    float acc = 0.0f;
    const int end = s_cs[kk + 1];
    for (int q = s_cs[kk]; q < end; ++q)
      acc = fmaf(s_cv[q], s_dm[int(s_cr[q]) * H + c], acc);
    for (int o = 0; o < n_ov; ++o) {
      const int i = s_ov[o];
      const float a = __ldg(adj_t + size_t(i) * ROW_LEN + kk);
      if (a != 0.0f) acc = fmaf(a, s_dm[i * H + c], acc);
    }
    s_dhw[k * H + c] = acc;
  }
}

// The shared-memory buffers of a layer step.
struct Tile {
  const float* adj_t;
  float* h;            // T x H: the layer's input, updated in place forward
  float* m;            // T x H
  float* work;         // hw_e; r*s at the head of the GRU halves
  float* bmsg;         // 4 H: layer l's message biases
  const float* bz; const float* br; const float* bn;
  const Idx* nk; const float* nv; const int* nc;
};

// m = A_flat [h W_e + b_e]_e, one edge type at a time (panels W_0..W_3 of
// layer l, then `next`); hw_e by halves of the tile (8 rows a thread).
// The caller synchronises before m is read.
__device__ __forceinline__ void messages(const Tile& t, const Weights& w, int l,
                                         Panels& p, const float* next, int tid) {
  const int col = tid % H, r0 = tid / H;
#pragma unroll 1
  for (int e = 0; e < NE; ++e) {
    const float* we = panels_next(
        p, msg_panel(w, l, e), e + 1 < NE ? msg_panel(w, l, e + 1) : next, tid);
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float acc[RPH];
#pragma unroll
      for (int k = 0; k < RPH; ++k) acc[k] = t.bmsg[e * H + col];
      xw<RPH>(t.h + hf * HALF * H, we, col, r0, acc);
      float* hw = t.work + hf * HALF * H;
#pragma unroll
      for (int k = 0; k < RPH; ++k) hw[(r0 + RS * k) * H + col] = acc[k];
    }
    __syncthreads();
    aggregate_edge(t.adj_t, e, t.work, t.m, t.nk, t.nv, t.nc, tid);
  }
}

// The GRU gates of the rows [hf HALF, hf HALF + HALF), x = [h, m], state
// s = h (zero at layer 0, `zero_state`), for the thread's 8 rows:
//   z = sigmoid(x Wz + s Uz + bz), r = sigmoid(x Wr + s Ur + br),
//   n = tanh(x Wn + (r*s) Un + bn),
// through the panels Wz[:H], Uz, Wz[H:], Wr[:H], Ur, Wr[H:], Wn[:H],
// Wn[H:], Un, then `next` (the state's blocks are loaded at layer 0 too,
// and not used).  One gate at a time, so that one set of accumulators is
// live: z goes to t.work + HALF H, r*s to t.work, r to t.work + 2 HALF H
// when `keep_r` (the reverse's), each (HALF x H) entry by the thread that
// owns it; n stays in registers.
__device__ __forceinline__ void gates(const Tile& t, const Weights& w, bool zero_state,
                                      int hf, bool keep_r, Panels& p,
                                      const float* next, float (&n)[RPH], int tid) {
  const int col = tid % H, r0 = tid / H;
  const float* h = t.h + hf * HALF * H;
  const float* m = t.m + hf * HALF * H;
  float* s_rs = t.work;
  float* s_z = t.work + HALF * H;
  float* s_r = t.work + 2 * HALF * H;
  const float* wz1 = w.wz + H * H;
  const float* wr1 = w.wr + H * H;
  const float* wn1 = w.wn + H * H;
  {
    float z[RPH];
#pragma unroll
    for (int k = 0; k < RPH; ++k) z[k] = t.bz[col];
    xw<RPH>(h, panels_next(p, w.wz, w.uz, tid), col, r0, z);
    const float* uz = panels_next(p, w.uz, wz1, tid);
    if (!zero_state) xw<RPH>(h, uz, col, r0, z);
    xw<RPH>(m, panels_next(p, wz1, w.wr, tid), col, r0, z);
#pragma unroll
    for (int k = 0; k < RPH; ++k) s_z[(r0 + RS * k) * H + col] = sigmoidf(z[k]);
  }
  {
    float r[RPH];
#pragma unroll
    for (int k = 0; k < RPH; ++k) r[k] = t.br[col];
    xw<RPH>(h, panels_next(p, w.wr, w.ur, tid), col, r0, r);
    const float* ur = panels_next(p, w.ur, wr1, tid);
    if (!zero_state) xw<RPH>(h, ur, col, r0, r);
    xw<RPH>(m, panels_next(p, wr1, w.wn, tid), col, r0, r);
#pragma unroll
    for (int k = 0; k < RPH; ++k) {
      const int i = (r0 + RS * k) * H + col;
      const float rk = sigmoidf(r[k]);
      s_rs[i] = zero_state ? 0.0f : rk * h[i];
      if (keep_r) s_r[i] = rk;
    }
  }
#pragma unroll
  for (int k = 0; k < RPH; ++k) n[k] = t.bn[col];
  xw<RPH>(h, panels_next(p, w.wn, wn1, tid), col, r0, n);
  xw<RPH>(m, panels_next(p, wn1, w.un, tid), col, r0, n);
  const float* un = panels_next(p, w.un, next, tid);  // r*s visible after its sync
  if (!zero_state) xw<RPH>(s_rs, un, col, r0, n);
#pragma unroll
  for (int k = 0; k < RPH; ++k) n[k] = tanhf(n[k]);
}

// One GGNN layer l on the tile, h updated in place: the message step, then
// each GRU half, h' = z n + (1 - z) s.  Ends synchronised; `next` is the
// block after the layer's last.
__device__ __forceinline__ void layer_forward(const Tile& t, const Weights& w, int l,
                                              Panels& p, const float* next, int tid) {
  const int col = tid % H, r0 = tid / H;
  const bool zero_state = (l == 0);
  // the previous layer's readers of the biases are past its last barrier
  for (int i = tid; i < NE * H; i += THREADS) t.bmsg[i] = w.msg_b[size_t(l) * NE * H + i];
  messages(t, w, l, p, w.wz, tid);
#pragma unroll 1
  for (int hf = 0; hf < 2; ++hf) {
    float n[RPH];
    gates(t, w, zero_state, hf, false, p, hf == 0 ? w.wz : next, n, tid);
    // no thread reads this half's h after the last panel's barrier
    float* h = t.h + hf * HALF * H;
    const float* s_z = t.work + HALF * H;
#pragma unroll
    for (int k = 0; k < RPH; ++k) {
      const int i = (r0 + RS * k) * H + col;
      const float z = s_z[i];
      const float s = zero_state ? 0.0f : h[i];
      h[i] = z * n[k] + (1.0f - z) * s;
    }
  }
  __syncthreads();
}

// The readout's gate sigmoid([h, h0] Wi + bi) (D = H) into s_gate (T x D),
// through the panels Wi[:H], Wi[H:], then Wj (the caller's next panel):
// the pre-activation by halves of the tile, carried in s_gate between the
// two panels by the thread that owns each entry.
__device__ __forceinline__ void readout_gate(const float* s_h, const float* s_h0,
                                             const Readout& ro, const float* s_bi,
                                             float* s_gate, Panels& p, int tid) {
  const int col = tid % H, r0 = tid / H;
  const float* wi0 = panels_next(p, ro.wi, ro.wi + H * H, tid);
#pragma unroll 1
  for (int hf = 0; hf < 2; ++hf) {
    float acc[RPH];
#pragma unroll
    for (int k = 0; k < RPH; ++k) acc[k] = s_bi[col];
    xw<RPH>(s_h + hf * HALF * H, wi0, col, r0, acc);
    float* g = s_gate + hf * HALF * H;
#pragma unroll
    for (int k = 0; k < RPH; ++k) g[(r0 + RS * k) * H + col] = acc[k];
  }
  const float* wi1 = panels_next(p, ro.wi + H * H, ro.wj, tid);
#pragma unroll 1
  for (int hf = 0; hf < 2; ++hf) {
    float* g = s_gate + hf * HALF * H;
    float acc[RPH];
#pragma unroll
    for (int k = 0; k < RPH; ++k) acc[k] = g[(r0 + RS * k) * H + col];
    xw<RPH>(s_h0 + hf * HALF * H, wi1, col, r0, acc);
#pragma unroll
    for (int k = 0; k < RPH; ++k) g[(r0 + RS * k) * H + col] = sigmoidf(acc[k]);
  }
}

// True when every weight block the panels load is 16-byte aligned (cp.async).
inline bool panels_aligned(const Weights& w, const Readout* ro) {
  const void* ptrs[] = {w.msg_w, w.wz, w.uz, w.wr, w.ur, w.wn, w.un,
                        ro ? ro->wi : nullptr, ro ? ro->wj : nullptr};
  for (const void* q : ptrs)
    if (reinterpret_cast<size_t>(q) % 16 != 0) return false;
  return true;
}

}  // namespace h64
}  // namespace ggnn
