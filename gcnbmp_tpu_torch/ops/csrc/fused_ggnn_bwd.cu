// Fused multi-layer GGNN backward over packed 128-atom tiles, for Hopper
// (sm_90a).  Built by gcnbmp_tpu_torch/ops/build.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.
//
// Replaces the TPU kernels of gcnbmp_tpu/ops/fused_ggnn.py:
//   fused_ggnn_range_bwd    <- _fused_ggnn_bwd / _bwd_kernel (K1b) over
//                              layers [0, L), and _half_bwd_call /
//                              _bwd_half_kernel (K3) over each half of
//                              _fused_ggnn_bwd_twopass
//   fused_ggnn_readout_bwd  <- _fused_ggnn_readout_bwd / _bwd_readout_kernel (K2b)
//
// Per tile, as the TPU kernels do (_reverse_layers, AGG_FLAT branch):
// recompute the forward keeping each layer's input h, seed dh (dh_final
// for K1b; the gated readout's backward for K2b, whose direct h0 term is
// added to dh0 at the end), then for l = L-1 .. 0 recompute layer l's
// m, z, r, n and take
//   dz = dh (n - s), dn = dh z, ds = dh (1 - z)
//   dn' = dn (1 - n^2), dz' = dz z (1 - z)
//   drs = dn' Un^T, dr' = drs s r (1 - r), ds += drs r
//   [dh_in, dm] = dz' Wz^T + dr' Wr^T + dn' Wn^T, ds += dz' Uz^T + dr' Ur^T
//   dW{z,r,n} += [h, m]^T d{z,r,n}',  dU{z,r} += s^T d{z,r}',
//   dUn += (r s)^T dn',  db += column sums
//   dhw = A_flat^T dm,  dW_e = h^T dhw_e,  db_e = sum dhw_e,
//   dh_in += dhw_e W_e^T,  dh = dh_in + ds (ds is dropped at layer 0,
//   whose state is zero).
// One kernel body runs over a layer range [lo, hi): K1b and K2b take
// [0, L) from h0; K3 (the two-pass backward) takes [split, L) from the
// forward's h_mid (K1m) with dh_final, hands dh_mid back through global
// memory, then [0, split) from h0 with dh_mid.  Each half's recompute
// scratch is (P, hi - lo, T, H), and it writes the gradients of its own
// layers and its share of the shared GRU's.  Two traps of the range, both
// easy to miss because a [0, L) range hides them:
// (a) the adjacency scan that builds the row lists, and the column lists
//     built from them, runs at the FIRST LAYER OF THE RANGE (l == lo), not
//     at layer 0: the top half never visits layer 0.
// (b) the GRU state is zero only at the GLOBAL layer 0 (l == 0).  At
//     lo > 0 the state of layer lo is its input hin itself, and the
//     gradient handed out (dh_mid) keeps that state's term ds, as
//     _reverse_layers does at fused_ggnn.py:369.
//
// What bounds it on this card, and what the design does about it:
// - The TPU kernel accumulates the weight gradients across its sequential
//   grid.  CTAs here run in no order, so each CTA (one tile) writes its
//   own row of a (P, n_grad) partial buffer, and a second kernel sums the
//   rows over P in tile order.  Nothing is atomic, and every output of the
//   body belongs to one thread that sums in a fixed order, so a run
//   repeats bit for bit.  The partials are ~185 KB per tile at L=8, H=32.
// - Shared memory: the forward's plan plus dh, the column lists and the
//   GRU's pre-activation gradients comes to ~214 KB at H=32 (one CTA per
//   SM).  The L per-layer inputs (128 KB per tile) do not fit beside it:
//   they go to a global scratch (P, hi - lo, T, H) during the first
//   forward and are read back one layer at a time; K3's halves need half
//   of K1b's (25 MB instead of 51 MB at P=387, L=8, H=32).  In the reverse the hw stack's
//   4T x H buffer holds r*s and dz', dr', dn', and then dhw; z, r and n
//   stay in registers for the (row, column) each thread owns.  Weight
//   gradients go straight to the tile's partial row (the GRU's summed
//   over layers in place by the thread that owns each entry), so no
//   L-sized accumulator lives on chip.
// - The transposed aggregation A_flat^T dm needs the adjacency's column
//   view.  After the range's first scan builds the row lists (up to
//   NBR_CAP per row), a pass builds column lists (CSR, ascending row
//   order) from the rows that fit their lists: at most 128 x 16 entries, so they always
//   fit.  Rows with more nonzeros are listed apart and read from global
//   memory in every reverse layer, so any input stays exact, and the sum
//   of each output runs in a fixed order.
// - Shared-memory bandwidth bounds the dense products.  An SM's shared
//   memory serves one 128-byte wavefront per clock where its f32 pipes
//   take four warp-wide FMAs, so a product that loads an operand from
//   shared memory for each FMA (as the forward's do) runs at a fraction of
//   the f32 peak.  Every dense product of the body is a register-blocked
//   f32 product (plain FMAs: no TF32, no tensor cores): a thread loads
//   the operands of one reduction step, or of four, into registers once
//   and issues all of its block's FMAs from them.
//   * Weight gradients (grad_pass): one (H/8) x (H/8) block of outputs per
//     thread; two wavefronts per row for (H/8)^2 warp FMAs (0.125 per
//     warp FMA at H=32).  Products that share operands run as one pass:
//     the GRU's seven (h^T dz' is dWz's top half and dUz alike) with
//     their three bias sums, the four message products with theirs.
//   * Products against transposed weights (x W^T: drs, [dh_in, dm], the
//     state's dz' Uz^T + dr' Ur^T, the message and readout dh): per chunk
//     of four reduction steps, one 16-byte load of each weight row the
//     thread needs and one broadcast 16-byte load of each of its rows.
//     The weights' rows are padded to H + 4 words in shared memory, so
//     the lanes' rows of one chunk fall in distinct banks (0.22-0.375
//     wavefronts per warp FMA).
//   * The recompute (h W_e + b_e, the GRU gates, the readout's
//     pre-activations) in the body's own copies: per chunk of four, the
//     weights of all four edge types (all gates) and one broadcast
//     16-byte load of each row (0.19-0.375).  The forward kernels keep
//     theirs, so K1m's h stays K1's bit for bit.
//   The message gradients and the message dh run side by side on the two
//   halves of the CTA, as do the readout's gradients and its dh.
// - Later work: tensor cores for the dense products (3xTF32 to hold the
//   f32 bounds), more CTAs per tile at small P (75 tiles fill 75 of 132
//   SMs), fewer passes over the partial buffer.

#include "fused_ggnn_common.cuh"

namespace {

using namespace ggnn;

// Shared-memory plan, in 4-byte words.  The weights' rows are padded to
// HP = H + 4 words, so that 16-byte loads of one reduction chunk from the
// rows of consecutive output columns fall in distinct banks; every
// offset is a multiple of 4 words (16-byte loads).
template <int H>
struct BwdPlan {
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
  static constexpr int DH = MS + TH;                // T H: dh
  static constexpr int BIG = DH + TH;               // 4T H: hw | rs dz' dr' dn' | dhw
  static constexpr int NV = BIG + NE * TH;          // T NBR_CAP row-list values
  static constexpr int NK = NV + TILE * NBR_CAP;    // T NBR_CAP row-list columns (int)
  static constexpr int NC = NK + TILE * NBR_CAP;    // T row nonzero counts (int)
  static constexpr int CS = NC + TILE;              // 4T+1 column starts (int)
  static constexpr int CR = CS + ROW_LEN + 1;       // T NBR_CAP column-list rows (int)
  static constexpr int CV = CR + TILE * NBR_CAP;    // T NBR_CAP column-list values
  static constexpr int OV = CV + TILE * NBR_CAP;    // T overflow rows (int)
  static constexpr int OVN = OV + TILE;             // 1 overflow row count (int)
  static constexpr int WORDS = OVN + 1;
  static constexpr size_t BYTES = size_t(WORDS) * 4;
  static_assert(B_MSG % 4 == 0 && WZ % 4 == 0 && HP % 4 == 0 && BZ % 4 == 0 &&
                HIN % 4 == 0 && BIG % 4 == 0, "16-byte aligned rows");
};

// Offsets in one tile's row of gradient partials: msg_w (n,4,H,H),
// msg_b (n,4,H) for the n = hi - lo layers of the range, the GRU in the order wz uz bz wr ur br wn un bn, then
// (K2b) wi (2H,D) bi (D) wj (H,D) bj (D).  ops/fused_ggnn.py splits the
// summed row in the same order.
template <int H>
struct GradLayout {
  static constexpr int WZ = 0, UZ = 2 * H * H, BZ = 3 * H * H;
  static constexpr int WR = BZ + H, UR = WR + 2 * H * H, BR = UR + H * H;
  static constexpr int WN = BR + H, UN = WN + 2 * H * H, BN = UN + H * H;
  static constexpr int GRU_WORDS = BN + H;  // 9 H H + 3 H
  static constexpr int WI = 0, BI = 2 * H * H, WJ = BI + H, BJ = WJ + H * H;
  static constexpr int RO_WORDS = BJ + H;   // 3 H D + 2 D with D = H
  __host__ __device__ static size_t msg_b0(int n_layers) { return size_t(n_layers) * NE * H * H; }
  __host__ __device__ static size_t gru0(int n_layers) { return size_t(n_layers) * NE * H * (H + 1); }
  __host__ __device__ static size_t words(int n_layers, bool readout) {
    return gru0(n_layers) + GRU_WORDS + (readout ? RO_WORDS : 0);
  }
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
//   memory; out_p a global row of partials, row stride H; out2_p, where
//   set, takes the same product (zeros without `add2`)),
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
  const float* s[NS];
  float* s_out[NS];
};

template <int H, int NP, int NS, int NSUM>
__device__ __forceinline__ void grad_pass(const GradPass<NP, NS>& gp,
                                          bool accumulate, bool add2,
                                          int tid) {
  constexpr int BK = H / 8;
  static_assert(64 * NP + NSUM <= THREADS, "threads of a gradient pass");
  if (tid < 64 * NP) {
    const int p = tid / 64, ta = (tid % 64) / 8, tc = tid % 8;
    const float* a = gp.a[p] + ta * BK;
    const float* b = gp.b[p] + tc * BK;
    float acc[BK][BK] = {};
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
  } else if (tid < 64 * NP + NSUM) {
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

template <int H>
__device__ __forceinline__ void load_gru_padded(const Weights& w,
                                                const GruSmem& g, int tid) {
  load_padded<H>(w.wz, g.wz, 2 * H, tid);
  load_padded<H>(w.wr, g.wr, 2 * H, tid);
  load_padded<H>(w.wn, g.wn, 2 * H, tid);
  load_padded<H>(w.uz, g.uz, H, tid);
  load_padded<H>(w.ur, g.ur, H, tid);
  load_padded<H>(w.un, g.un, H, tid);
  for (int i = tid; i < H; i += THREADS) {
    g.bz[i] = w.bz[i]; g.br[i] = w.br[i]; g.bn[i] = w.bn[i];
  }
}

template <int H>
__device__ __forceinline__ void load_message_padded(const Weights& w, int l,
                                                    float* s_wmsg,
                                                    float* s_bmsg, int tid) {
  load_padded<H>(w.msg_w + size_t(l) * NE * H * H, s_wmsg, NE * H, tid);
  for (int i = tid; i < NE * H; i += THREADS)
    s_bmsg[i] = w.msg_b[size_t(l) * NE * H + i];
}

// hw[(e*T + i), c] = (h W_e + b_e)[i, c] for the thread's rows i and
// column c, all four edge types at once: per chunk of four d, four
// entries of W_e's rows d (padded to H + 4) for each e and one 16-byte
// load (a warp-wide broadcast) of each of the thread's h rows.
template <int H>
__device__ __forceinline__ void bwd_message_hw(const float* s_h,
                                               const float* s_wmsg,
                                               const float* s_bmsg,
                                               float* s_hw, int tid) {
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

// z, r, n pre-activations += x_part W{z,r,n}[rows lo .. lo + H) (+ s
// U{z,r} with STATE), blocked as bwd_message_hw.
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

// The GRU gates of one layer for the thread's rows, x = [h, m], state
// s = h (0 at layer 0, `zero_state`):
//   z = sigmoid(x Wz + s Uz + bz), r = sigmoid(x Wr + s Ur + br),
//   n = tanh(x Wn + (r*s) Un + bn).
// Writes r*s to s_rs (all threads), synchronises once, and returns z, r,
// n in registers.
template <int H>
__device__ __forceinline__ void bwd_gru_gates(bool zero_state, const float* s_h,
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

// The readout's pre-activations for the thread's rows (K2b's seed):
// gi = [h, h0] Wi + bi, gj = h Wj + bj, the readout weights' rows padded
// to H + 4; blocked as bwd_message_hw.
template <int H>
__device__ __forceinline__ void bwd_readout_pre(const float* s_h,
                                                const float* s_h0,
                                                const float* s_wi,
                                                const float* s_wj,
                                                const float* s_bi,
                                                const float* s_bj,
                                                float (&gi)[Rows<H>::RPT],
                                                float (&gj)[Rows<H>::RPT],
                                                int tid) {
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

// One CTA per SM (the shared-memory plan), so up to 128 registers a thread.
template <int H, bool READOUT>
__global__ void __launch_bounds__(THREADS, 1)
fused_ggnn_bwd_kernel(const float* __restrict__ hin, const float* __restrict__ adj,
                      Weights w, Readout ro, const float* __restrict__ dout,
                      float* dh_bot, float* partial, float* hs, int lo, int hi,
                      int n_grad) {
  using S = BwdPlan<H>;
  using R = Rows<H>;
  using G = GradLayout<H>;
  constexpr int HALF = THREADS / 2;
  using RH = RowSet<H, HALF>;  // the row products of half the CTA
  constexpr int D = H;
  constexpr int TH = S::TH;
  constexpr int HP = S::HP;
  extern __shared__ float smem[];
  float* s_wmsg = smem + S::W_MSG;
  float* s_bmsg = smem + S::B_MSG;
  const GruSmem g = {smem + S::WZ, smem + S::WR, smem + S::WN,
                     smem + S::UZ, smem + S::UR, smem + S::UN,
                     smem + S::BZ, smem + S::BR, smem + S::BN};
  float* s_hin = smem + S::HIN;
  float* s_m = smem + S::MS;
  float* s_dh = smem + S::DH;
  float* s_big = smem + S::BIG;
  float* s_rs = s_big;            // reverse: r*s, dz', dr', dn'
  float* s_dz = s_big + TH;
  float* s_dr = s_big + 2 * TH;
  float* s_dn = s_big + 3 * TH;
  float* s_nv = smem + S::NV;
  int* s_nk = reinterpret_cast<int*>(smem + S::NK);
  int* s_nc = reinterpret_cast<int*>(smem + S::NC);
  int* s_cs = reinterpret_cast<int*>(smem + S::CS);
  int* s_cr = reinterpret_cast<int*>(smem + S::CR);
  float* s_cv = smem + S::CV;
  int* s_ov = reinterpret_cast<int*>(smem + S::OV);
  int* s_ovn = reinterpret_cast<int*>(smem + S::OVN);

  const int tid = threadIdx.x;
  const int col = tid % H;
  const int row0 = tid / H;
  // the half-CTA row products: threads [HALF, THREADS)
  const int hcol = (tid - HALF) % H;
  const int hrow0 = (tid - HALF) / H;
  const size_t tile = blockIdx.x;
  const int n_range = hi - lo;
  const float* h0_t = hin + tile * TH;  // h0 when lo == 0, else h_mid
  const float* adj_t = adj + tile * TILE * ROW_LEN;
  float* hs_t = hs + tile * size_t(n_range) * TH;
  float* dh0_t = dh_bot + tile * TH;
  float* part = partial + tile * size_t(n_grad);
  float* gru_part = part + G::gru0(n_range);

  // 1. forward over the range, keeping each layer's input in hs
  load_gru_padded<H>(w, g, tid);
  for (int i = tid; i < TH; i += THREADS) s_hin[i] = h0_t[i];
  for (int l = lo; l < hi; ++l) {
    const bool scan = (l == lo);       // trap (a)
    const bool zero_state = (l == 0);  // trap (b)
    load_message_padded<H>(w, l, s_wmsg, s_bmsg, tid);
    __syncthreads();
    for (int i = tid; i < TH; i += THREADS) hs_t[size_t(l - lo) * TH + i] = s_hin[i];
    bwd_message_hw<H>(s_hin, s_wmsg, s_bmsg, s_big, tid);
    __syncthreads();
    aggregate<H>(scan, adj_t, s_big, s_m, s_nk, s_nv, s_nc, tid);
    __syncthreads();
    if (scan)
      build_columns(s_nk, s_nv, s_nc, s_cs, s_cr, s_cv, s_ov, s_ovn, tid);
    float z[R::RPT], r[R::RPT], n[R::RPT];
    bwd_gru_gates<H>(zero_state, s_hin, s_m, g, s_rs, z, r, n, tid);
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      const float s = zero_state ? 0.0f : s_hin[i * H + col];
      s_hin[i * H + col] = z[k] * n[k] + (1.0f - z[k]) * s;
    }
    __syncthreads();
  }
  const int n_ov = *s_ovn;

  // 2. seed dh: the readout's backward (K2b) or dh_final (K1b)
  if constexpr (READOUT) {
    float* s_wi = s_big;                // (2H, HP): Wi (2H, D), rows padded
    float* s_wj = s_wi + 2 * H * HP;    // (H, HP)
    float* s_bi = s_wj + H * HP;
    float* s_bj = s_bi + D;
    float* s_dpi = s_bj + D;            // (T, D) d(pre-gate)
    float* s_doj = s_dpi + TILE * D;    // (T, D) d(h Wj + bj)
    float* s_h0 = s_m;
    static_assert(3 * H * HP + 2 * D + 2 * TILE * D <= NE * TILE * H, "readout");
    static_assert((3 * H * HP + 2 * D) % 4 == 0, "16-byte rows");
    load_padded<H>(ro.wi, s_wi, 2 * H, tid);
    load_padded<H>(ro.wj, s_wj, H, tid);
    for (int i = tid; i < D; i += THREADS) { s_bi[i] = ro.bi[i]; s_bj[i] = ro.bj[i]; }
    for (int i = tid; i < TH; i += THREADS) s_h0[i] = h0_t[i];
    __syncthreads();
    float gi[R::RPT], gj[R::RPT];
    bwd_readout_pre<H>(s_hin, s_h0, s_wi, s_wj, s_bi, s_bj, gi, gj, tid);
    const float* mask_t = ro.mask + tile * TILE;
    const float* dg_t = dout + tile * TILE * D;
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      const float gate = sigmoidf(gi[k]);
      const float dgv = dg_t[i * D + col] * mask_t[i];
      s_dpi[i * D + col] = dgv * gj[k] * gate * (1.0f - gate);
      s_doj[i * D + col] = dgv * gate;
    }
    __syncthreads();
    // the readout's weight gradients (threads [0, 256)) beside
    // dh = dpi Wi[:H]^T + doj Wj^T and h0's direct term dpi Wi[H:]^T
    // (threads [256, 512)), which goes to dh0 now and is added to the
    // reverse's result at the end
    float* ro_part = gru_part + G::GRU_WORDS;
    const GradPass<3, 2> rp = {
        {s_hin, s_h0, s_hin}, {s_dpi, s_dpi, s_doj},
        {ro_part + G::WI, ro_part + G::WI + H * D, ro_part + G::WJ},
        {nullptr, nullptr, nullptr},
        {s_dpi, s_doj}, {ro_part + G::BI, ro_part + G::BJ}};
    grad_pass<H, 3, 2, 64>(rp, false, false, tid);
    if (tid >= HALF) {
      float dh[RH::RPT] = {}, d0[RH::RPT] = {};
      add_xwt<H, HALF>(s_dpi, s_wi, hcol, hrow0, dh);
      add_xwt<H, HALF>(s_doj, s_wj, hcol, hrow0, dh);
      add_xwt<H, HALF>(s_dpi, s_wi + H * HP, hcol, hrow0, d0);
#pragma unroll
      for (int k = 0; k < RH::RPT; ++k) {
        const int i = hrow0 + k * RH::RS;
        s_dh[i * H + hcol] = dh[k];
        dh0_t[i * H + hcol] = d0[k];
      }
    }
  } else {
    const float* dh_t = dout + tile * TH;
    for (int i = tid; i < TH; i += THREADS) s_dh[i] = dh_t[i];
  }
  __syncthreads();

  // 3. reverse the range's layers
  for (int l = hi - 1; l >= lo; --l) {
    const bool zero_state = (l == 0);  // trap (b): ds survives at l == lo > 0
    const bool acc_gru = (l != hi - 1);
    load_message_padded<H>(w, l, s_wmsg, s_bmsg, tid);
    for (int i = tid; i < TH; i += THREADS) s_hin[i] = hs_t[size_t(l - lo) * TH + i];
    __syncthreads();
    bwd_message_hw<H>(s_hin, s_wmsg, s_bmsg, s_big, tid);
    __syncthreads();
    aggregate<H>(false, adj_t, s_big, s_m, s_nk, s_nv, s_nc, tid);
    __syncthreads();
    float z[R::RPT], r[R::RPT], n[R::RPT];
    bwd_gru_gates<H>(zero_state, s_hin, s_m, g, s_rs, z, r, n, tid);

    float ds[R::RPT];
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      const float s = zero_state ? 0.0f : s_hin[i * H + col];
      const float dhv = s_dh[i * H + col];
      const float dz = dhv * (n[k] - s);
      const float dn = dhv * z[k];
      ds[k] = dhv * (1.0f - z[k]);
      s_dn[i * H + col] = dn * (1.0f - n[k] * n[k]);
      s_dz[i * H + col] = dz * z[k] * (1.0f - z[k]);
    }
    __syncthreads();
    {  // drs = dn' Un^T
      float drs[R::RPT] = {};
      add_xwt<H, THREADS>(s_dn, g.un, col, row0, drs);
#pragma unroll
      for (int k = 0; k < R::RPT; ++k) {
        const int i = row0 + k * R::RS;
        const float s = zero_state ? 0.0f : s_hin[i * H + col];
        ds[k] = fmaf(drs[k], r[k], ds[k]);
        s_dr[i * H + col] = drs[k] * s * r[k] * (1.0f - r[k]);
      }
    }
    __syncthreads();

    // [dh_in, dm] = d{z,r,n}' W{z,r,n}^T, ds += d{z,r}' U{z,r}^T
    float dhn[R::RPT] = {}, dm[R::RPT] = {}, dsu[R::RPT] = {};
#pragma unroll 1
    for (int j0 = 0; j0 < H; j0 += 4) {
      dx_chunk<H, true>(s_dz, g.wz, g.uz, col, row0, j0, dhn, dm, dsu);
      dx_chunk<H, true>(s_dr, g.wr, g.ur, col, row0, j0, dhn, dm, dsu);
      dx_chunk<H, false>(s_dn, g.wn, nullptr, col, row0, j0, dhn, dm, dsu);
    }
#pragma unroll
    for (int k = 0; k < R::RPT; ++k)
      s_dh[(row0 + k * R::RS) * H + col] =
          zero_state ? dhn[k] : dhn[k] + (ds[k] + dsu[k]);

    // GRU weight gradients, summed over the layers in the tile's row, in
    // one pass: the state s is h (zero at layer 0), so h^T dz' is both
    // dWz's top half and dUz (likewise dr'); (r s)^T dn' is dUn (r s is
    // stored as zero at layer 0)
    {
      float* o = gru_part;
      const GradPass<7, 3> gp = {
          {s_hin, s_hin, s_hin, s_m, s_m, s_m, s_rs},
          {s_dz, s_dr, s_dn, s_dz, s_dr, s_dn, s_dn},
          {o + G::WZ, o + G::WR, o + G::WN, o + G::WZ + H * H,
           o + G::WR + H * H, o + G::WN + H * H, o + G::UN},
          {o + G::UZ, o + G::UR, nullptr, nullptr, nullptr, nullptr, nullptr},
          {s_dz, s_dr, s_dn}, {o + G::BZ, o + G::BR, o + G::BN}};
      grad_pass<H, 7, 3, 64>(gp, acc_gru, !zero_state, tid);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) s_m[(row0 + k * R::RS) * H + col] = dm[k];
    __syncthreads();

    // message backward: dhw = A_flat^T dm, then layer l's message grads
    // (threads [0, 256) their products, [256, 384) their biases) beside
    // dh = dh_in + ds + sum_e dhw_e W_e^T (threads [256, 512))
    column_gather<H>(adj_t, s_m, s_cs, s_cr, s_cv, s_ov, n_ov, s_big, tid);
    __syncthreads();
    {
      float* mw = part + size_t(l - lo) * NE * H * H;
      float* mb = part + G::msg_b0(n_range) + size_t(l - lo) * NE * H;
      const GradPass<NE, NE> mp = {
          {s_hin, s_hin, s_hin, s_hin},
          {s_big, s_big + TH, s_big + 2 * TH, s_big + 3 * TH},
          {mw, mw + H * H, mw + 2 * H * H, mw + 3 * H * H},
          {nullptr, nullptr, nullptr, nullptr},
          {s_big, s_big + TH, s_big + 2 * TH, s_big + 3 * TH},
          {mb, mb + H, mb + 2 * H, mb + 3 * H}};
      grad_pass<H, NE, NE, 2 * 64>(mp, false, false, tid);
    }
    if (tid >= HALF) {
      float acc[RH::RPT];
#pragma unroll
      for (int k = 0; k < RH::RPT; ++k)
        acc[k] = s_dh[(hrow0 + k * RH::RS) * H + hcol];
      for (int e = 0; e < NE; ++e)
        add_xwt<H, HALF>(s_big + e * TH, s_wmsg + e * H * HP, hcol, hrow0, acc);
#pragma unroll
      for (int k = 0; k < RH::RPT; ++k)
        s_dh[(hrow0 + k * RH::RS) * H + hcol] = acc[k];
    }
    __syncthreads();
  }

  // 4. dh at the bottom of the range: dh0, or dh_mid for the top half
  // (+ the readout's direct h0 term, written to dh0 in step 2)
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) {
    const int i = row0 + k * R::RS;
    const float v = s_dh[i * H + col];
    dh0_t[i * H + col] = READOUT ? v + dh0_t[i * H + col] : v;
  }
}

template <int H, bool READOUT>
cudaError_t launch_bwd(const float* hin, const float* adj, const Weights& w,
                       const Readout& ro, const float* dout, float* dh_bot,
                       float* partial, float* grads, float* hs, int n_tiles,
                       int lo, int hi, cudaStream_t stream) {
  constexpr size_t bytes = BwdPlan<H>::BYTES;
  static_assert(bytes <= 232448, "shared-memory plan exceeds 227 KB");
  static bool opted_in[MAX_DEVICES] = {};
  cudaError_t err = opt_in_smem(fused_ggnn_bwd_kernel<H, READOUT>, bytes, opted_in);
  if (err != cudaSuccess) return err;
  const int n_grad = int(GradLayout<H>::words(hi - lo, READOUT));
  fused_ggnn_bwd_kernel<H, READOUT><<<n_tiles, THREADS, bytes, stream>>>(
      hin, adj, w, ro, dout, dh_bot, partial, hs, lo, hi, n_grad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int SUM_THREADS = 256;
  sum_tiles_kernel<<<(n_grad + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0,
                     stream>>>(partial, grads, n_tiles, n_grad);
  return cudaGetLastError();
}

}  // namespace

// K1b over [0, n_layers) and each half of K3: the backward over layers
// [lo, hi) of the stack (0 <= lo < hi <= n_layers): from hin (h0 for
// lo == 0, else the input of layer lo) and dh_top (the gradient of layer
// hi-1's output), dh_bot (the gradient of layer lo's input) and the
// summed gradients of the range's message weights (hi - lo layers) and of
// the shared GRU, in the GradLayout order.  partial (P, n_grad) and hs
// (P, hi - lo, T, H) are scratch.  Returns a cudaError_t.
extern "C" int fused_ggnn_range_bwd(
    const float* hin, const float* adj, const float* msg_w, const float* msg_b,
    const float* wz, const float* uz, const float* bz,
    const float* wr, const float* ur, const float* br,
    const float* wn, const float* un, const float* bn,
    const float* dh_top, float* dh_bot, float* partial, float* grads, float* hs,
    int n_tiles, int lo, int hi, int hidden, void* stream) {
  if (n_tiles <= 0 || lo < 0 || hi <= lo) return int(cudaErrorInvalidValue);
  const Weights w = make_weights(msg_w, msg_b, wz, uz, bz, wr, ur, br, wn, un, bn);
  const Readout ro = {};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 16: return int(launch_bwd<16, false>(hin, adj, w, ro, dh_top, dh_bot, partial, grads, hs, n_tiles, lo, hi, st));
    case 32: return int(launch_bwd<32, false>(hin, adj, w, ro, dh_top, dh_bot, partial, grads, hs, n_tiles, lo, hi, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// K2b: as K1b for K2's upstream gradient dg (P, T, D), with the readout's
// weight gradients after the GRU's in grads.  Returns a cudaError_t.
extern "C" int fused_ggnn_readout_bwd(
    const float* h0, const float* adj, const float* msg_w, const float* msg_b,
    const float* wz, const float* uz, const float* bz,
    const float* wr, const float* ur, const float* br,
    const float* wn, const float* un, const float* bn,
    const float* mask, const float* wi, const float* bi,
    const float* wj, const float* bj,
    const float* dg, float* dh0, float* partial, float* grads, float* hs,
    int n_tiles, int n_layers, int hidden, int out_dim, void* stream) {
  if (n_tiles <= 0 || n_layers <= 0) return int(cudaErrorInvalidValue);
  if (out_dim != hidden) return int(cudaErrorInvalidValue);
  const Weights w = make_weights(msg_w, msg_b, wz, uz, bz, wr, ur, br, wn, un, bn);
  const Readout ro = {mask, wi, bi, wj, bj};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 16: return int(launch_bwd<16, true>(h0, adj, w, ro, dg, dh0, partial, grads, hs, n_tiles, 0, n_layers, st));
    case 32: return int(launch_bwd<32, true>(h0, adj, w, ro, dg, dh0, partial, grads, hs, n_tiles, 0, n_layers, st));
    default: return int(cudaErrorInvalidValue);
  }
}
