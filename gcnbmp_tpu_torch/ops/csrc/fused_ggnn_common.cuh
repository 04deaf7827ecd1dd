// Pieces shared by the fused GGNN forward (fused_ggnn.cu) and backward
// (fused_ggnn_bwd.cu) kernels and by the fused MPNN kernels
// (fused_mpnn.cu): constants, weight pointers, one GGNN layer's forward
// steps on a 128-atom tile held in shared memory, the adjacency's row and
// column lists, the backward's register-blocked products (weight
// gradients, products against transposed weights, the GRU's
// pre-activations; weights' rows padded to H + 4 words in shared memory)
// and the in-order sum of per-tile gradient rows.
//
// Thread layout of the row-wise steps: thread `tid` owns column
// col = tid % H of the rows row0 + k*RS, k < RPT (RS = THREADS / H).

#pragma once

#include <cuda_runtime.h>

namespace ggnn {

constexpr int TILE = 128;
constexpr int NE = 4;               // edge types
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int NBR_CAP = 16;         // neighbour list slots per adjacency row
constexpr int ROW_LEN = NE * TILE;  // 512 columns of the flat adjacency
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

template <int H>
__device__ __forceinline__ void load_gru(const Weights& w, const GruSmem& g,
                                         int tid) {
  for (int i = tid; i < 2 * H * H; i += THREADS) {
    g.wz[i] = w.wz[i]; g.wr[i] = w.wr[i]; g.wn[i] = w.wn[i];
  }
  for (int i = tid; i < H * H; i += THREADS) {
    g.uz[i] = w.uz[i]; g.ur[i] = w.ur[i]; g.un[i] = w.un[i];
  }
  for (int i = tid; i < H; i += THREADS) {
    g.bz[i] = w.bz[i]; g.br[i] = w.br[i]; g.bn[i] = w.bn[i];
  }
}

template <int H>
__device__ __forceinline__ void load_message(const Weights& w, int l,
                                             float* s_wmsg, float* s_bmsg,
                                             int tid) {
  for (int i = tid; i < NE * H * H; i += THREADS)
    s_wmsg[i] = w.msg_w[size_t(l) * NE * H * H + i];
  for (int i = tid; i < NE * H; i += THREADS)
    s_bmsg[i] = w.msg_b[size_t(l) * NE * H + i];
}

// hw[(e*T + j), c] = (h W_e + b_e)[j, c]
template <int H>
__device__ __forceinline__ void message_hw(const float* s_h,
                                           const float* s_wmsg,
                                           const float* s_bmsg, float* s_hw,
                                           int tid) {
  using R = Rows<H>;
  const int col = tid % H;
  const int row0 = tid / H;
  for (int e = 0; e < NE; ++e) {
    const float* we = s_wmsg + e * H * H;
    float acc[R::RPT];
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) acc[k] = s_bmsg[e * H + col];
#pragma unroll 4
    for (int d = 0; d < H; ++d) {
      const float wv = we[d * H + col];
#pragma unroll
      for (int k = 0; k < R::RPT; ++k)
        acc[k] = fmaf(s_h[(row0 + k * R::RS) * H + d], wv, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < R::RPT; ++k)
      s_hw[(e * TILE + row0 + k * R::RS) * H + col] = acc[k];
  }
}

// m = A_flat @ hw: one warp per row, lane c < H owns column c.  With
// `scan` the rows are read from global memory and the first NBR_CAP
// nonzeros of each row are kept as (column, value) lists, in ascending
// column order, with the row's full count in s_nc; otherwise rows with at
// most NBR_CAP nonzeros gather through their lists and the others rescan
// their dense row, so any input is summed exactly.  Idx, the type of the
// list's columns, is int or a 16-bit type (columns < 512).
template <int H, typename Idx>
__device__ __forceinline__ void aggregate(bool scan, const float* adj_t,
                                          const float* s_hw, float* s_m,
                                          Idx* s_nk, float* s_nv, int* s_nc,
                                          int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = warp; i < TILE; i += WARPS) {
    float acc = 0.0f;
    if (scan || s_nc[i] > NBR_CAP) {
      const float* arow = adj_t + size_t(i) * ROW_LEN;
      int cnt = 0;
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
          const int kcol = q * 32 + b;
          if (lane < H) acc = fmaf(v, s_hw[kcol * H + lane], acc);
          if (scan && lane == 0 && cnt < NBR_CAP) {
            s_nk[i * NBR_CAP + cnt] = kcol;
            s_nv[i * NBR_CAP + cnt] = v;
          }
          ++cnt;
        }
      }
      if (scan && lane == 0) s_nc[i] = cnt;
    } else {
      const int cnt = s_nc[i];
      for (int n = 0; n < cnt; ++n) {
        const int kcol = s_nk[i * NBR_CAP + n];
        const float v = s_nv[i * NBR_CAP + n];
        if (lane < H) acc = fmaf(v, s_hw[kcol * H + lane], acc);
      }
    }
    if (lane < H) s_m[i * H + lane] = acc;
  }
}

// The GRU gates of one layer for the thread's rows, x = [h, m], state s =
// h (or 0 when `zero_state`, layer 0):
//   z = sigmoid(x Wz + s Uz + bz), r = sigmoid(x Wr + s Ur + br),
//   n = tanh(x Wn + (r*s) Un + bn).
// Writes r*s to s_rs (all threads), synchronises once, and returns z, r, n
// in registers.
template <int H>
__device__ __forceinline__ void gru_gates(bool zero_state, const float* s_h,
                                          const float* s_m, const GruSmem& g,
                                          float* s_rs, float (&z)[Rows<H>::RPT],
                                          float (&r)[Rows<H>::RPT],
                                          float (&n)[Rows<H>::RPT], int tid) {
  using R = Rows<H>;
  const int col = tid % H;
  const int row0 = tid / H;
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) {
    z[k] = g.bz[col]; r[k] = g.br[col]; n[k] = g.bn[col];
  }
#pragma unroll 2
  for (int d = 0; d < H; ++d) {
    const float wzh = g.wz[d * H + col], wzm = g.wz[(H + d) * H + col];
    const float wrh = g.wr[d * H + col], wrm = g.wr[(H + d) * H + col];
    const float wnh = g.wn[d * H + col], wnm = g.wn[(H + d) * H + col];
    const float uz = zero_state ? 0.0f : g.uz[d * H + col];
    const float ur = zero_state ? 0.0f : g.ur[d * H + col];
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      const float hv = s_h[i * H + d], mv = s_m[i * H + d];
      z[k] = fmaf(hv, wzh, fmaf(mv, wzm, z[k]));
      r[k] = fmaf(hv, wrh, fmaf(mv, wrm, r[k]));
      n[k] = fmaf(hv, wnh, fmaf(mv, wnm, n[k]));
      if (!zero_state) {
        z[k] = fmaf(hv, uz, z[k]);
        r[k] = fmaf(hv, ur, r[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) {
    const int i = row0 + k * R::RS;
    z[k] = sigmoidf(z[k]);
    r[k] = sigmoidf(r[k]);
    s_rs[i * H + col] = zero_state ? 0.0f : r[k] * s_h[i * H + col];
  }
  __syncthreads();
  if (!zero_state) {
#pragma unroll 2
    for (int d = 0; d < H; ++d) {
      const float un = g.un[d * H + col];
#pragma unroll
      for (int k = 0; k < R::RPT; ++k)
        n[k] = fmaf(s_rs[(row0 + k * R::RS) * H + d], un, n[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) n[k] = tanhf(n[k]);
}

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

// Copy `rows` rows of H floats into shared memory with rows of H + 4.
template <int H>
__device__ __forceinline__ void load_padded(const float* __restrict__ src,
                                            float* dst, int rows, int tid) {
  for (int i = tid; i < rows * H; i += THREADS)
    dst[(i / H) * (H + 4) + i % H] = src[i];
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

// Column lists of the rows that fit their row lists, in ascending row
// order, and the list of rows that do not.  Thread k owns column k.  The
// lists' indices are Idx (int, or a 16-bit type).
template <typename Idx>
__device__ __forceinline__ void build_columns(const Idx* s_nk, const float* s_nv,
                                              const int* s_nc, int* s_cs,
                                              Idx* s_cr, float* s_cv,
                                              int* s_ov, int* s_ovn, int tid) {
  static_assert(THREADS == ROW_LEN, "one thread per adjacency column");
  const int k = tid;
  int cnt = 0;
  for (int i = 0; i < TILE; ++i) {
    const int nc = s_nc[i];
    if (nc <= NBR_CAP)
      for (int n = 0; n < nc; ++n) cnt += (s_nk[i * NBR_CAP + n] == k);
  }
  s_cs[k + 1] = cnt;
  if (tid == 0) {
    s_cs[0] = 0;
    int ov = 0;
    for (int i = 0; i < TILE; ++i)
      if (s_nc[i] > NBR_CAP) s_ov[ov++] = i;
    *s_ovn = ov;
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
  int pos = s_cs[k];
  for (int i = 0; i < TILE; ++i) {
    const int nc = s_nc[i];
    if (nc <= NBR_CAP)
      for (int n = 0; n < nc; ++n)
        if (s_nk[i * NBR_CAP + n] == k) {
          s_cr[pos] = i;
          s_cv[pos] = s_nv[i * NBR_CAP + n];
          ++pos;
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
