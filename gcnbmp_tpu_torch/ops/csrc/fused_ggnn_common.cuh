// Pieces shared by the fused GGNN forward (fused_ggnn.cu) and backward
// (fused_ggnn_bwd.cu) kernels and by the fused MPNN kernels
// (fused_mpnn.cu): constants, weight pointers, the GGNN kernels'
// shared-memory plan, the adjacency's row lists (scan_rows) and column
// lists (count_columns), weight loads into rows padded to H + 4 words (at
// once or by cp.async), one copy of each register-blocked GGNN layer step
// on a 128-atom tile held in shared memory (the forwards run them, and
// the backward runs them to recompute), the backward's blocked products
// (weight gradients, products against transposed weights) and the
// in-order sum of per-tile gradient rows.
//
// Thread layout of the row-wise steps: thread `tid` owns column
// col = tid % H of the rows row0 + k*RS, k < RPT (RS = THREADS / H).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#ifdef __CUDACC__
// Hopper's named barriers, mbarriers and bulk copies, in PTX, for K4
// (set2set.cu) and the H = 128 reverse body's reloads (fused_ggnn_bwd.cu);
// the CPU stand-in of tests/cuda_emu defines the same functions.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// arrive, and expect `bytes` more to land before the phase completes
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// order this thread's generic-proxy accesses of shared memory before its
// later bulk copies into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// global -> shared, `bytes` a multiple of 16 at 16-byte-aligned addresses;
// completes its bytes on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}
#endif

namespace ggnn {

constexpr int TILE = 128;
constexpr int NE = 4;               // edge types
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int NBR_CAP = 16;         // neighbour list slots per adjacency row
constexpr int ROW_LEN = NE * TILE;  // 512 columns of the flat adjacency
constexpr int COLUMN_MASK_WORDS = ROW_LEN * TILE / 32;  // count_columns' row masks
constexpr int MAX_DEVICES = 64;     // devices whose shared-memory opt-in is cached

struct Weights {
  const float* msg_w;  // (L, 4, H, H)
  const float* msg_b;  // (L, 4, H)
  const float* wz; const float* uz; const float* bz;  // (2H, H) (H, H) (H)
  const float* wr; const float* ur; const float* br;
  const float* wn; const float* un; const float* bn;
};

struct Readout {
  const float* mask;  // (P, T)
  const float* wi;    // (2H, D)
  const float* bi;    // (D)
  const float* wj;    // (H, D)
  const float* bj;    // (D)
};

inline Weights make_weights(const float* msg_w, const float* msg_b,
                            const float* wz, const float* uz, const float* bz,
                            const float* wr, const float* ur, const float* br,
                            const float* wn, const float* un, const float* bn) {
  Weights w;
  w.msg_w = msg_w; w.msg_b = msg_b;
  w.wz = wz; w.uz = uz; w.bz = bz;
  w.wr = wr; w.ur = ur; w.br = br;
  w.wn = wn; w.un = un; w.bn = bn;
  return w;
}

template <int H>
struct Rows {
  static constexpr int RS = THREADS / H;   // row stride between a thread's rows
  static constexpr int RPT = TILE / RS;    // rows per thread
  static_assert(THREADS % H == 0 && TILE % RS == 0, "H");
};

// Shared-memory copies of the GRU weights (kernels (in, out), biases summed).
struct GruSmem {
  float* wz; float* wr; float* wn;  // (2H, H)
  float* uz; float* ur; float* un;  // (H, H)
  float* bz; float* br; float* bn;  // (H)
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The row lists of one tile's adjacency, once per call: one warp per row
// reads the dense row from global memory (16 coalesced 128-byte loads,
// all in flight before the scan), finds its nonzeros with a warp ballot
// per 32 columns, each lane writing its own, and keeps the first NBR_CAP
// (column, value) pairs in ascending column order, with the row's full
// count in s_nc.  Idx, the type of the lists' columns, is int or a 16-bit
// type (columns < 512).  The caller synchronises before the lists are read.
template <typename Idx>
__device__ __forceinline__ void scan_rows(const float* adj_t, Idx* s_nk,
                                          float* s_nv, int* s_nc, int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = warp; i < TILE; i += WARPS) {
    const float* arow = adj_t + size_t(i) * ROW_LEN;
    float av[ROW_LEN / 32];
#pragma unroll
    for (int q = 0; q < ROW_LEN / 32; ++q) av[q] = __ldg(arow + q * 32 + lane);
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < ROW_LEN / 32; ++q) {
      const unsigned nz = __ballot_sync(0xffffffffu, av[q] != 0.0f);
      const int pos = cnt + __popc(nz & ((1u << lane) - 1u));
      if (av[q] != 0.0f && pos < NBR_CAP) {
        s_nk[i * NBR_CAP + pos] = Idx(q * 32 + lane);
        s_nv[i * NBR_CAP + pos] = av[q];
      }
      cnt += __popc(nz);
    }
    if (lane == 0) s_nc[i] = cnt;
  }
}

// m = A_flat @ hw: one warp per row, lane c < H owns column c.  Rows with
// at most NBR_CAP nonzeros gather through their lists (scan_rows); the
// others rescan their dense row.  Both sum in ascending column order, so
// any input is summed exactly and in the same order.
template <int H, typename Idx>
__device__ __forceinline__ void aggregate(const float* adj_t, const float* s_hw,
                                          float* s_m, const Idx* s_nk,
                                          const float* s_nv, const int* s_nc,
                                          int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = warp; i < TILE; i += WARPS) {
    float acc = 0.0f;
    const int cnt = s_nc[i];
    if (cnt > NBR_CAP) {
      const float* arow = adj_t + size_t(i) * ROW_LEN;
      float av[ROW_LEN / 32];  // all 16 loads in flight before the scan
#pragma unroll
      for (int q = 0; q < ROW_LEN / 32; ++q) av[q] = __ldg(arow + q * 32 + lane);
#pragma unroll
      for (int q = 0; q < ROW_LEN / 32; ++q) {
        const float a = av[q];
        unsigned nz = __ballot_sync(0xffffffffu, a != 0.0f);
        while (nz) {
          const int b = __ffs(nz) - 1;
          nz &= nz - 1;
          const float v = __shfl_sync(0xffffffffu, a, b);
          if (lane < H) acc = fmaf(v, s_hw[(q * 32 + b) * H + lane], acc);
        }
      }
    } else {
      for (int n = 0; n < cnt; ++n) {
        const int kcol = s_nk[i * NBR_CAP + n];
        const float v = s_nv[i * NBR_CAP + n];
        if (lane < H) acc = fmaf(v, s_hw[kcol * H + lane], acc);
      }
    }
    if (lane < H) s_m[i * H + lane] = acc;
  }
}

// Shared-memory plan of the GGNN kernels, in 4-byte words.  The weights'
// rows are padded to HP = H + 4 words, so that 16-byte loads of one
// reduction chunk from the rows of consecutive output columns fall in
// distinct banks; every offset is a multiple of 4 words (16-byte loads).
// The backward (BWD) adds dh and the column lists.
template <int H, bool BWD>
struct GgnnPlan {
  static constexpr int HP = H + 4;
  static constexpr int TH = TILE * H;
  static constexpr int W_MSG = 0;                   // 4 (H, HP) (layer l)
  static constexpr int B_MSG = W_MSG + NE * H * HP;  // 4 H
  static constexpr int WZ = B_MSG + NE * H;         // (2H, HP) each
  static constexpr int WR = WZ + 2 * H * HP;
  static constexpr int WN = WR + 2 * H * HP;
  static constexpr int UZ = WN + 2 * H * HP;        // (H, HP) each
  static constexpr int UR = UZ + H * HP;
  static constexpr int UN = UR + H * HP;
  static constexpr int BZ = UN + H * HP;            // H each
  static constexpr int BR = BZ + H;
  static constexpr int BN = BR + H;
  static constexpr int HIN = BN + H;                // T H: layer input h (= s)
  static constexpr int MS = HIN + TH;               // T H: m, then dm; h0 (readout)
  static constexpr int DH = MS + TH;                // T H: dh (backward)
  static constexpr int BIG = DH + (BWD ? TH : 0);   // 4T H: hw | rs dz' dr' dn' | dhw; readout weights
  static constexpr int NV = BIG + NE * TH;          // T NBR_CAP row-list values
  static constexpr int NK = NV + TILE * NBR_CAP;    // T NBR_CAP row-list columns (int)
  static constexpr int NC = NK + TILE * NBR_CAP;    // T row nonzero counts (int)
  static constexpr int CS = NC + TILE;              // 4T+1 column starts (int)
  static constexpr int CR = CS + ROW_LEN + 1;       // T NBR_CAP column-list rows (int)
  static constexpr int CV = CR + TILE * NBR_CAP;    // T NBR_CAP column-list values
  static constexpr int OV = CV + TILE * NBR_CAP;    // T overflow rows (int)
  static constexpr int OVN = OV + TILE;             // 1 overflow row count (int)
  static constexpr int WORDS = BWD ? OVN + 1 : CS;
  static constexpr size_t BYTES = size_t(WORDS) * 4;
  static_assert(B_MSG % 4 == 0 && WZ % 4 == 0 && HP % 4 == 0 && BZ % 4 == 0 &&
                HIN % 4 == 0 && BIG % 4 == 0, "16-byte aligned rows");
  static_assert(!BWD || NE * TH >= COLUMN_MASK_WORDS, "row masks fit in BIG");
};

// n consecutive floats (n = 4 or 2) from 16- or 8-byte aligned memory
template <int N>
__device__ __forceinline__ void ldv(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    static_assert(N == 2, "2 or 4 floats");
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}

// One pass of weight-gradient products over the tile's rows:
//   out_p (H, H) (+)= a_p^T b_p  for p < NP   (a_p, b_p (T, H) in shared
//   memory, a_p == nullptr a zero operand; out_p a global row of
//   partials, row stride H; out2_p, where set, takes the same product
//   (zeros without `add2`)),
//   s_out_q (H) (+)= column sums of s_q (T, H)  for q < NS.
// Threads [0, 64 NP) own one (H/8) x (H/8) block of one product each: per
// row i they read H/8 entries of a_p's row and H/8 of b_p's and issue
// (H/8)^2 FMAs.  A warp covers 4 x 8 blocks, so its two loads per row are
// one 64-byte and one 128-byte span: two shared-memory wavefronts for
// (H/8)^2 warp FMAs.  Threads [64 NP, 64 NP + NSUM) own columns of the
// sums.  Each output belongs to one thread and sums the rows in order.
template <int NP, int NS>
struct GradPass {
  const float* a[NP];
  const float* b[NP];
  float* out[NP];
  float* out2[NP];
  const float* s[NS > 0 ? NS : 1];  // unused when NS == 0
  float* s_out[NS > 0 ? NS : 1];
};

template <int H, int NP, int NS, int NSUM>
__device__ __forceinline__ void grad_pass(const GradPass<NP, NS>& gp,
                                          bool accumulate, bool add2,
                                          int tid) {
  constexpr int BK = H / 8;
  static_assert(64 * NP + NSUM <= THREADS, "threads of a gradient pass");
  if (tid < 64 * NP) {
    const int p = tid / 64, ta = (tid % 64) / 8, tc = tid % 8;
    float acc[BK][BK] = {};
    if (gp.a[p] != nullptr) {
      const float* a = gp.a[p] + ta * BK;
      const float* b = gp.b[p] + tc * BK;
#pragma unroll 2
      for (int i = 0; i < TILE; ++i) {
        float av[BK], bv[BK];
        ldv<BK>(a + i * H, av);
        ldv<BK>(b + i * H, bv);
#pragma unroll
        for (int x = 0; x < BK; ++x)
#pragma unroll
          for (int y = 0; y < BK; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
      }
    }
    float* out = gp.out[p] + (ta * BK) * H + tc * BK;
    float* out2 = gp.out2[p];
#pragma unroll
    for (int x = 0; x < BK; ++x)
#pragma unroll
      for (int y = 0; y < BK; ++y) {
        float* o = out + x * H + y;
        *o = accumulate ? *o + acc[x][y] : acc[x][y];
        if (out2 != nullptr) {
          float* o2 = out2 + (ta * BK + x) * H + tc * BK + y;
          const float v = add2 ? acc[x][y] : 0.0f;
          *o2 = accumulate ? *o2 + v : v;
        }
      }
  } else if constexpr (NS > 0) {
    if (tid >= 64 * NP + NSUM) return;
    constexpr int COLS = NS * H;
    constexpr int PER = (COLS + NSUM - 1) / NSUM;
    const int j = tid - 64 * NP;
    const float* src[PER];
    float acc[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int f = j + q * NSUM;
      src[q] = f < COLS ? gp.s[f / H] + f % H : nullptr;
      acc[q] = 0.0f;
    }
#pragma unroll 4
    for (int i = 0; i < TILE; ++i)
#pragma unroll
      for (int q = 0; q < PER; ++q)
        if (src[q] != nullptr) acc[q] += src[q][i * H];
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

// *dst = *src from global to shared memory: at once, or (ASYNC) by an
// asynchronous 4-byte copy (cp.async) that runs while the thread goes on;
// the caller commits it (__pipeline_commit) and waits for it
// (__pipeline_wait_prior, then a barrier) before any thread reads dst.
template <bool ASYNC>
__device__ __forceinline__ void to_shared(float* dst, const float* src) {
  if constexpr (ASYNC)
    __pipeline_memcpy_async(dst, src, sizeof(float));
  else
    *dst = *src;
}

// Copy `rows` rows of H floats into shared memory with rows of H + 4.
template <int H, bool ASYNC = false>
__device__ __forceinline__ void load_padded(const float* __restrict__ src,
                                            float* dst, int rows, int tid) {
  for (int i = tid; i < rows * H; i += THREADS)
    to_shared<ASYNC>(dst + (i / H) * (H + 4) + i % H, src + i);
}

// Copy n floats into shared memory.
template <bool ASYNC = false>
__device__ __forceinline__ void copy_in(float* dst, const float* src, int n,
                                        int tid) {
  for (int i = tid; i < n; i += THREADS) to_shared<ASYNC>(dst + i, src + i);
}

template <int H>
__device__ __forceinline__ void load_gru_padded(const Weights& w,
                                                const GruSmem& g, int tid) {
  load_padded<H>(w.wz, g.wz, 2 * H, tid);
  load_padded<H>(w.wr, g.wr, 2 * H, tid);
  load_padded<H>(w.wn, g.wn, 2 * H, tid);
  load_padded<H>(w.uz, g.uz, H, tid);
  load_padded<H>(w.ur, g.ur, H, tid);
  load_padded<H>(w.un, g.un, H, tid);
  copy_in(g.bz, w.bz, H, tid);
  copy_in(g.br, w.br, H, tid);
  copy_in(g.bn, w.bn, H, tid);
}

template <int H, bool ASYNC = false>
__device__ __forceinline__ void load_message_padded(const Weights& w, int l,
                                                    float* s_wmsg,
                                                    float* s_bmsg, int tid) {
  load_padded<H, ASYNC>(w.msg_w + size_t(l) * NE * H * H, s_wmsg, NE * H, tid);
  copy_in<ASYNC>(s_bmsg, w.msg_b + size_t(l) * NE * H, NE * H, tid);
}

// Rows of the threads [T0, T0 + NT) in a product against transposed
// weights: thread t owns column (t - T0) % H of the rows
// (t - T0) / H + k NT / H, k < RPT.
template <int H, int NT>
struct RowSet {
  static constexpr int RS = NT / H;
  static constexpr int RPT = TILE / RS;
  static_assert(NT % H == 0 && TILE % RS == 0, "row set");
};

// acc[k] += sum_j x[i_k, j] w[c, j] for the thread's rows i_k of a
// RowSet<H, NT> (x (T, H) row stride H, w rows padded to H + 4, c the
// thread's column): per chunk of four j, one 16-byte load of w's row c and
// one (a warp-wide broadcast) of each of the thread's x rows.
template <int H, int NT>
__device__ __forceinline__ void add_xwt(const float* x, const float* w, int c,
                                        int row0, float (&acc)[RowSet<H, NT>::RPT]) {
  using R = RowSet<H, NT>;
#pragma unroll 2
  for (int j0 = 0; j0 < H; j0 += 4) {
    float wv[4];
    ldv<4>(w + c * (H + 4) + j0, wv);
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      float xv[4];
      ldv<4>(x + (row0 + k * R::RS) * H + j0, xv);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[k] = fmaf(xv[q], wv[q], acc[k]);
    }
  }
}

// dxh += x Wt^T, dxm += x Wb^T (Wt, Wb the top and bottom halves of a
// (2H, H) gate kernel) and, with U, dsu += x U^T, over the reduction
// chunk [j0, j0 + 4) for the thread's rows (column c of each product).
template <int H, bool WITH_U>
__device__ __forceinline__ void dx_chunk(const float* x, const float* w,
                                         const float* u, int c, int row0,
                                         int j0, float (&dxh)[Rows<H>::RPT],
                                         float (&dxm)[Rows<H>::RPT],
                                         float (&dsu)[Rows<H>::RPT]) {
  using R = Rows<H>;
  constexpr int HP = H + 4;
  float wh[4], wm[4], wu[4];
  ldv<4>(w + c * HP + j0, wh);
  ldv<4>(w + (H + c) * HP + j0, wm);
  if constexpr (WITH_U) ldv<4>(u + c * HP + j0, wu);
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) {
    float xv[4];
    ldv<4>(x + (row0 + k * R::RS) * H + j0, xv);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dxh[k] = fmaf(xv[q], wh[q], dxh[k]);
      dxm[k] = fmaf(xv[q], wm[q], dxm[k]);
      if constexpr (WITH_U) dsu[k] = fmaf(xv[q], wu[q], dsu[k]);
    }
  }
}

// z, r, n pre-activations += x_part W{z,r,n}[rows lo .. lo + H) (+ s
// U{z,r} with STATE) for the thread's rows (column col), the weights'
// rows padded to H + 4: per chunk of four d, four entries of each
// weight's rows d and one 16-byte load (a warp-wide broadcast) of each of
// the thread's x rows.
template <int H, bool STATE>
__device__ __forceinline__ void gate_inputs(const float* x, const GruSmem& g,
                                            int lo, int col, int row0,
                                            float (&z)[Rows<H>::RPT],
                                            float (&r)[Rows<H>::RPT],
                                            float (&n)[Rows<H>::RPT]) {
  using R = Rows<H>;
  constexpr int HP = H + 4;
#pragma unroll 1
  for (int d0 = 0; d0 < H; d0 += 4) {
    float wz[4], wr[4], wn[4], uz[4], ur[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = (lo + d0 + q) * HP + col;
      wz[q] = g.wz[row]; wr[q] = g.wr[row]; wn[q] = g.wn[row];
      if constexpr (STATE) {
        uz[q] = g.uz[(d0 + q) * HP + col];
        ur[q] = g.ur[(d0 + q) * HP + col];
      }
    }
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      float xv[4];
      ldv<4>(x + (row0 + k * R::RS) * H + d0, xv);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        z[k] = fmaf(xv[q], wz[q], z[k]);
        r[k] = fmaf(xv[q], wr[q], r[k]);
        n[k] = fmaf(xv[q], wn[q], n[k]);
        if constexpr (STATE) {
          z[k] = fmaf(xv[q], uz[q], z[k]);
          r[k] = fmaf(xv[q], ur[q], r[k]);
        }
      }
    }
  }
}

// hw[(e*T + i), c] = (h W_e + b_e)[i, c] for the thread's rows i and
// column c, all four edge types at once: per chunk of four d, four
// entries of W_e's rows d (padded to H + 4) for each e and one 16-byte
// load (a warp-wide broadcast) of each of the thread's h rows.
template <int H>
__device__ __forceinline__ void edge_hw(const float* s_h, const float* s_wmsg,
                                        const float* s_bmsg, float* s_hw,
                                        int tid) {
  using R = Rows<H>;
  constexpr int HP = H + 4;
  const int col = tid % H;
  const int row0 = tid / H;
  float acc[NE][R::RPT];
#pragma unroll
  for (int e = 0; e < NE; ++e)
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) acc[e][k] = s_bmsg[e * H + col];
#pragma unroll 1
  for (int d0 = 0; d0 < H; d0 += 4) {
    float wv[NE][4];
#pragma unroll
    for (int e = 0; e < NE; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[e][q] = s_wmsg[(e * H + d0 + q) * HP + col];
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      float xv[4];
      ldv<4>(s_h + (row0 + k * R::RS) * H + d0, xv);
#pragma unroll
      for (int e = 0; e < NE; ++e)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[e][k] = fmaf(xv[q], wv[e][q], acc[e][k]);
    }
  }
#pragma unroll
  for (int e = 0; e < NE; ++e)
#pragma unroll
    for (int k = 0; k < R::RPT; ++k)
      s_hw[(e * TILE + row0 + k * R::RS) * H + col] = acc[e][k];
}

// The GRU gates of one layer for the thread's rows, x = [h, m], state
// s = h (0 at layer 0, `zero_state`):
//   z = sigmoid(x Wz + s Uz + bz), r = sigmoid(x Wr + s Ur + br),
//   n = tanh(x Wn + (r*s) Un + bn).
// Writes r*s to s_rs (all threads), synchronises once, and returns z, r,
// n in registers.
template <int H>
__device__ __forceinline__ void ggnn_gates(bool zero_state, const float* s_h,
                                           const float* s_m, const GruSmem& g,
                                           float* s_rs, float (&z)[Rows<H>::RPT],
                                           float (&r)[Rows<H>::RPT],
                                           float (&n)[Rows<H>::RPT], int tid) {
  using R = Rows<H>;
  constexpr int HP = H + 4;
  const int col = tid % H;
  const int row0 = tid / H;
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) {
    z[k] = g.bz[col]; r[k] = g.br[col]; n[k] = g.bn[col];
  }
  if (zero_state)
    gate_inputs<H, false>(s_h, g, 0, col, row0, z, r, n);
  else
    gate_inputs<H, true>(s_h, g, 0, col, row0, z, r, n);
  gate_inputs<H, false>(s_m, g, H, col, row0, z, r, n);
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) {
    const int i = row0 + k * R::RS;
    z[k] = sigmoidf(z[k]);
    r[k] = sigmoidf(r[k]);
    s_rs[i * H + col] = zero_state ? 0.0f : r[k] * s_h[i * H + col];
  }
  __syncthreads();
  if (!zero_state) {
#pragma unroll 1
    for (int d0 = 0; d0 < H; d0 += 4) {
      float un[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) un[q] = g.un[(d0 + q) * HP + col];
#pragma unroll
      for (int k = 0; k < R::RPT; ++k) {
        float xv[4];
        ldv<4>(s_rs + (row0 + k * R::RS) * H + d0, xv);
#pragma unroll
        for (int q = 0; q < 4; ++q) n[k] = fmaf(xv[q], un[q], n[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) n[k] = tanhf(n[k]);
}

// The readout's pre-activations for the thread's rows (K2's output, K2b's
// seed): gi = [h, h0] Wi + bi, gj = h Wj + bj (D = H), the readout
// weights' rows padded to H + 4; blocked as edge_hw.
template <int H>
__device__ __forceinline__ void readout_pre(const float* s_h, const float* s_h0,
                                            const float* s_wi, const float* s_wj,
                                            const float* s_bi, const float* s_bj,
                                            float (&gi)[Rows<H>::RPT],
                                            float (&gj)[Rows<H>::RPT], int tid) {
  using R = Rows<H>;
  constexpr int HP = H + 4;
  const int col = tid % H;
  const int row0 = tid / H;
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) { gi[k] = s_bi[col]; gj[k] = s_bj[col]; }
#pragma unroll 1
  for (int d0 = 0; d0 < H; d0 += 4) {
    float wih[4], wi0[4], wjh[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      wih[q] = s_wi[(d0 + q) * HP + col];
      wi0[q] = s_wi[(H + d0 + q) * HP + col];
      wjh[q] = s_wj[(d0 + q) * HP + col];
    }
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      float hv[4], h0v[4];
      ldv<4>(s_h + (row0 + k * R::RS) * H + d0, hv);
      ldv<4>(s_h0 + (row0 + k * R::RS) * H + d0, h0v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        gi[k] = fmaf(hv[q], wih[q], fmaf(h0v[q], wi0[q], gi[k]));
        gj[k] = fmaf(hv[q], wjh[q], gj[k]);
      }
    }
  }
}

// Column lists (CSR: starts s_cs, rows s_cr and values s_cv) of the rows
// that fit their row lists (scan_rows), each in ascending row order, and
// the rows that do not, ascending, in s_ov (their count in *s_ovn).  Built
// by counting, one thread per row-list slot (THREADS x 4 = T x NBR_CAP):
// each slot adds one to its column's count (shared atomicAdd) and sets
// its row's bit in the column's row mask (atomicOr; TILE / 32 words per
// column); a warp scan turns the counts into starts; each slot then goes
// to its column's start plus its rank, the number of lower rows that list
// the column (__popc of the mask's lower bits).  The atomics only count
// and set bits, so the lists are the same in every run, and the same as a
// walk of the rows in order gives.  `bits` is COLUMN_MASK_WORDS = 2,048
// words of scratch that nothing else uses during the call.  The lists'
// indices are Idx (int, or a 16-bit type).  The caller synchronises after
// the scan; this synchronises before it returns.
template <typename Idx>
__device__ __forceinline__ void count_columns(const Idx* s_nk, const float* s_nv,
                                              const int* s_nc, int* s_cs,
                                              Idx* s_cr, float* s_cv, int* s_ov,
                                              int* s_ovn, unsigned* bits, int tid) {
  constexpr int MW = TILE / 32;  // mask words per column
  constexpr int SLOTS = TILE * NBR_CAP;
  for (int q = tid; q < COLUMN_MASK_WORDS; q += THREADS) bits[q] = 0u;
  for (int q = tid; q <= ROW_LEN; q += THREADS) s_cs[q] = 0;
  if (tid == 0) {  // the crowded rows (a ballot here makes callers spill)
    int n = 0;
    for (int i = 0; i < TILE; ++i)
      if (s_nc[i] > NBR_CAP) s_ov[n++] = i;
    *s_ovn = n;
  }
  __syncthreads();
#pragma unroll 1
  for (int q = tid; q < SLOTS; q += THREADS) {
    const int i = q / NBR_CAP;
    const int nc = s_nc[i];
    if (nc <= NBR_CAP && q % NBR_CAP < nc) {
      const int k = s_nk[q];
      atomicAdd(s_cs + k + 1, 1);
      atomicOr(bits + k * MW + i / 32, 1u << (i % 32));
    }
  }
  __syncthreads();
  if (tid < 32) {  // inclusive scan of the counts: lane owns 16 columns
    constexpr int PER = ROW_LEN / 32;
    const int base = 1 + tid * PER;
    int sum = 0;
    for (int q = 0; q < PER; ++q) sum += s_cs[base + q];
    int incl = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    int run = incl - sum;
    for (int q = 0; q < PER; ++q) {
      run += s_cs[base + q];
      s_cs[base + q] = run;
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int q = tid; q < SLOTS; q += THREADS) {
    const int i = q / NBR_CAP;
    const int nc = s_nc[i];
    if (nc <= NBR_CAP && q % NBR_CAP < nc) {
      const int k = s_nk[q];
      const unsigned* mask = bits + k * MW;
      int rank = 0;
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        const unsigned m = mask[w];
        rank += __popc(w < i / 32 ? m : w == i / 32 ? m & ((1u << (i % 32)) - 1u) : 0u);
      }
      const int pos = s_cs[k] + rank;
      s_cr[pos] = Idx(i);
      s_cv[pos] = s_nv[q];
    }
  }
  __syncthreads();
}

// dhw (4T, H) = A_flat^T dm: thread owns column c of rows k of dhw.
template <int H, typename Idx>
__device__ __forceinline__ void column_gather(const float* adj_t,
                                              const float* s_dm,
                                              const int* s_cs, const Idx* s_cr,
                                              const float* s_cv,
                                              const int* s_ov, int n_ov,
                                              float* s_dhw, int tid) {
  const int c = tid % H;
  for (int k = tid / H; k < ROW_LEN; k += THREADS / H) {
    float acc = 0.0f;
    const int end = s_cs[k + 1];
    for (int e = s_cs[k]; e < end; ++e)
      acc = fmaf(s_cv[e], s_dm[s_cr[e] * H + c], acc);
    for (int o = 0; o < n_ov; ++o) {
      const int i = s_ov[o];
      const float a = __ldg(adj_t + size_t(i) * ROW_LEN + k);
      if (a != 0.0f) acc = fmaf(a, s_dm[i * H + c], acc);
    }
    s_dhw[k * H + c] = acc;
  }
}

// grads[j] = sum over tiles p (in order) of partial[p, j]
__global__ void sum_tiles_kernel(const float* __restrict__ partial,
                                 float* __restrict__ grads, int n_tiles,
                                 int n_grad) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_grad) return;
  float acc = 0.0f;
  for (int p = 0; p < n_tiles; ++p) acc += partial[size_t(p) * n_grad + j];
  grads[j] = acc;
}

// Opt a kernel into `bytes` of dynamic shared memory on the current
// device, once per device (the call costs host time on a host-bound path).
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes));
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

}  // namespace ggnn
