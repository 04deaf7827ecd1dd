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
//   rows over P in tile order.  Nothing is atomic, so a run repeats
//   bit for bit.  The partials are ~185 KB per tile at L=8, H=32.
// - Shared memory: the forward's plan plus dh, the column lists and the
//   GRU's pre-activation gradients comes to ~205 KB at H=32 (one CTA per
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
// - Products of H-wide rows against transposed weights (x W^T) would have
//   every lane of a warp read one shared-memory bank; each thread walks
//   the reduction index rotated by its column, so the lanes read distinct
//   banks.
// - Arithmetic is plain f32 FMAs (no TF32, no tensor cores), as in the
//   forward.  Later work: tensor cores for the dense products, fewer
//   passes over the partial buffer, more CTAs per SM.

#include "fused_ggnn_common.cuh"

namespace {

using namespace ggnn;

// Shared-memory plan, in 4-byte words.
template <int H>
struct BwdPlan {
  static constexpr int TH = TILE * H;
  static constexpr int W_MSG = 0;                   // 4 H H (layer l)
  static constexpr int B_MSG = W_MSG + NE * H * H;  // 4 H
  static constexpr int WZ = B_MSG + NE * H;         // 2H H each
  static constexpr int WR = WZ + 2 * H * H;
  static constexpr int WN = WR + 2 * H * H;
  static constexpr int UZ = WN + 2 * H * H;         // H H each
  static constexpr int UR = UZ + H * H;
  static constexpr int UN = UR + H * H;
  static constexpr int BZ = UN + H * H;             // H each
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

template <int H, bool READOUT>
__global__ void __launch_bounds__(THREADS)
fused_ggnn_bwd_kernel(const float* __restrict__ hin, const float* __restrict__ adj,
                      Weights w, Readout ro, const float* __restrict__ dout,
                      float* dh_bot, float* partial, float* hs, int lo, int hi,
                      int n_grad) {
  using S = BwdPlan<H>;
  using R = Rows<H>;
  using G = GradLayout<H>;
  constexpr int D = H;
  constexpr int TH = S::TH;
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
  const size_t tile = blockIdx.x;
  const int n_range = hi - lo;
  const float* h0_t = hin + tile * TH;  // h0 when lo == 0, else h_mid
  const float* adj_t = adj + tile * TILE * ROW_LEN;
  float* hs_t = hs + tile * size_t(n_range) * TH;
  float* dh0_t = dh_bot + tile * TH;
  float* part = partial + tile * size_t(n_grad);
  float* gru_part = part + G::gru0(n_range);

  // 1. forward over the range, keeping each layer's input in hs
  load_gru<H>(w, g, tid);
  for (int i = tid; i < TH; i += THREADS) s_hin[i] = h0_t[i];
  for (int l = lo; l < hi; ++l) {
    const bool scan = (l == lo);       // trap (a)
    const bool zero_state = (l == 0);  // trap (b)
    load_message<H>(w, l, s_wmsg, s_bmsg, tid);
    __syncthreads();
    for (int i = tid; i < TH; i += THREADS) hs_t[size_t(l - lo) * TH + i] = s_hin[i];
    message_hw<H>(s_hin, s_wmsg, s_bmsg, s_big, tid);
    __syncthreads();
    aggregate<H>(scan, adj_t, s_big, s_m, s_nk, s_nv, s_nc, tid);
    __syncthreads();
    if (scan)
      build_columns(s_nk, s_nv, s_nc, s_cs, s_cr, s_cv, s_ov, s_ovn, tid);
    float z[R::RPT], r[R::RPT], n[R::RPT];
    gru_gates<H>(zero_state, s_hin, s_m, g, s_rs, z, r, n, tid);
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
    float* s_wi = s_big;               // (2H, D)
    float* s_wj = s_wi + 2 * H * D;    // (H, D)
    float* s_bi = s_wj + H * D;
    float* s_bj = s_bi + D;
    float* s_dpi = s_bj + D;           // (T, D) d(pre-gate)
    float* s_doj = s_dpi + TILE * D;   // (T, D) d(h Wj + bj)
    float* s_h0 = s_m;
    static_assert(3 * H * D + 2 * D + 2 * TILE * D <= NE * TILE * H, "readout");
    for (int i = tid; i < 2 * H * D; i += THREADS) s_wi[i] = ro.wi[i];
    for (int i = tid; i < H * D; i += THREADS) s_wj[i] = ro.wj[i];
    for (int i = tid; i < D; i += THREADS) { s_bi[i] = ro.bi[i]; s_bj[i] = ro.bj[i]; }
    for (int i = tid; i < TH; i += THREADS) s_h0[i] = h0_t[i];
    __syncthreads();
    float gi[R::RPT], gj[R::RPT];
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) { gi[k] = s_bi[col]; gj[k] = s_bj[col]; }
#pragma unroll 2
    for (int d = 0; d < H; ++d) {
      const float wih = s_wi[d * D + col], wi0 = s_wi[(H + d) * D + col];
      const float wjh = s_wj[d * D + col];
#pragma unroll
      for (int k = 0; k < R::RPT; ++k) {
        const int i = row0 + k * R::RS;
        const float hv = s_hin[i * H + d];
        gi[k] = fmaf(hv, wih, fmaf(s_h0[i * H + d], wi0, gi[k]));
        gj[k] = fmaf(hv, wjh, gj[k]);
      }
    }
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
    float* ro_part = gru_part + G::GRU_WORDS;
    grad_AtB<H, 2 * H>(s_hin, s_h0, s_dpi, ro_part + G::WI, false, tid);
    grad_AtB<H, H>(s_hin, nullptr, s_doj, ro_part + G::WJ, false, tid);
    bias_sum<H>(s_dpi, ro_part + G::BI, false, tid);
    bias_sum<H>(s_doj, ro_part + G::BJ, false, tid);
    // dh = dpi Wi[:H]^T + doj Wj^T; h0's direct term dpi Wi[H:]^T goes to
    // dh0 now and is added to the reverse's result by the same thread
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      float dh = 0.0f, d0 = 0.0f;
#pragma unroll 4
      for (int j = 0; j < D; ++j) {
        const int a = (j + col) & (D - 1);
        const float dpi = s_dpi[i * D + a];
        dh = fmaf(dpi, s_wi[col * D + a], fmaf(s_doj[i * D + a], s_wj[col * D + a], dh));
        d0 = fmaf(dpi, s_wi[(H + col) * D + a], d0);
      }
      s_dh[i * H + col] = dh;
      dh0_t[i * H + col] = d0;
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
    load_message<H>(w, l, s_wmsg, s_bmsg, tid);
    for (int i = tid; i < TH; i += THREADS) s_hin[i] = hs_t[size_t(l - lo) * TH + i];
    __syncthreads();
    message_hw<H>(s_hin, s_wmsg, s_bmsg, s_big, tid);
    __syncthreads();
    aggregate<H>(false, adj_t, s_big, s_m, s_nk, s_nv, s_nc, tid);
    __syncthreads();
    float z[R::RPT], r[R::RPT], n[R::RPT];
    gru_gates<H>(zero_state, s_hin, s_m, g, s_rs, z, r, n, tid);

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
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      float drs = 0.0f;
#pragma unroll 4
      for (int j = 0; j < H; ++j) {
        const int a = (j + col) & (H - 1);
        drs = fmaf(s_dn[i * H + a], g.un[col * H + a], drs);
      }
      const float s = zero_state ? 0.0f : s_hin[i * H + col];
      ds[k] = fmaf(drs, r[k], ds[k]);
      s_dr[i * H + col] = drs * s * r[k] * (1.0f - r[k]);
    }
    __syncthreads();

    float dhn[R::RPT], dm[R::RPT];
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      float dxh = 0.0f, dxm = 0.0f, dsu = 0.0f;
#pragma unroll 2
      for (int j = 0; j < H; ++j) {
        const int a = (j + col) & (H - 1);
        const float dzp = s_dz[i * H + a], drp = s_dr[i * H + a], dnp = s_dn[i * H + a];
        dxh = fmaf(dzp, g.wz[col * H + a], dxh);
        dxh = fmaf(drp, g.wr[col * H + a], dxh);
        dxh = fmaf(dnp, g.wn[col * H + a], dxh);
        dxm = fmaf(dzp, g.wz[(H + col) * H + a], dxm);
        dxm = fmaf(drp, g.wr[(H + col) * H + a], dxm);
        dxm = fmaf(dnp, g.wn[(H + col) * H + a], dxm);
        dsu = fmaf(dzp, g.uz[col * H + a], dsu);
        dsu = fmaf(drp, g.ur[col * H + a], dsu);
      }
      dhn[k] = zero_state ? dxh : dxh + ds[k] + dsu;
      dm[k] = dxm;
    }

    // GRU weight gradients, summed over the layers in the tile's row
    grad_AtB<H, 2 * H>(s_hin, s_m, s_dz, gru_part + G::WZ, acc_gru, tid);
    grad_AtB<H, 2 * H>(s_hin, s_m, s_dr, gru_part + G::WR, acc_gru, tid);
    grad_AtB<H, 2 * H>(s_hin, s_m, s_dn, gru_part + G::WN, acc_gru, tid);
    grad_AtB<H, H>(zero_state ? nullptr : s_hin, nullptr, s_dz, gru_part + G::UZ, acc_gru, tid);
    grad_AtB<H, H>(zero_state ? nullptr : s_hin, nullptr, s_dr, gru_part + G::UR, acc_gru, tid);
    grad_AtB<H, H>(zero_state ? nullptr : s_rs, nullptr, s_dn, gru_part + G::UN, acc_gru, tid);
    bias_sum<H>(s_dz, gru_part + G::BZ, acc_gru, tid);
    bias_sum<H>(s_dr, gru_part + G::BR, acc_gru, tid);
    bias_sum<H>(s_dn, gru_part + G::BN, acc_gru, tid);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) s_m[(row0 + k * R::RS) * H + col] = dm[k];
    __syncthreads();

    // message backward: dhw = A_flat^T dm, then layer l's message grads
    column_gather<H>(adj_t, s_m, s_cs, s_cr, s_cv, s_ov, n_ov, s_big, tid);
    __syncthreads();
    for (int e = 0; e < NE; ++e)
      grad_AtB<H, H>(s_hin, nullptr, s_big + e * TH,
                     part + (size_t(l - lo) * NE + e) * H * H, false, tid);
    if (tid < NE * H) {
      const int e = tid / H, c = tid % H;
      float acc = 0.0f;
      for (int j = 0; j < TILE; ++j) acc += s_big[(e * TILE + j) * H + c];
      part[G::msg_b0(n_range) + (size_t(l - lo) * NE + e) * H + c] = acc;
    }
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      float acc = dhn[k];
      for (int e = 0; e < NE; ++e) {
        const float* dhw_e = s_big + (e * TILE + i) * H;
        const float* we = s_wmsg + e * H * H;
#pragma unroll 4
        for (int j = 0; j < H; ++j) {
          const int a = (j + col) & (H - 1);
          acc = fmaf(dhw_e[a], we[col * H + a], acc);
        }
      }
      s_dh[i * H + col] = acc;
    }
    __syncthreads();
  }

  // 4. dh at the bottom of the range: dh0, or dh_mid for the top half
  // (+ the readout's direct h0 term, written above by this thread)
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
