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
// (a) the adjacency's row and column lists come from a scan BEFORE THE
//     RANGE'S FIRST LAYER, not from layer 0's step: the top half never
//     visits layer 0.
// (b) the GRU state is zero only at the GLOBAL layer 0 (l == 0).  At
//     lo > 0 the state of layer lo is its input hin itself, and the
//     gradient handed out (dh_mid) keeps that state's term ds, as
//     _reverse_layers does at fused_ggnn.py:369.
//
// What bounds it on this card, and what the design does about it:
// - The TPU kernel accumulates the weight gradients across its sequential
//   grid.  CTAs here run in no order, so each CTA (one tile) writes its
//   own row of a (P, n_grad) partial buffer, and a second kernel sums the
//   rows over P in tile order.  No sum is atomic (the column build's
//   atomics only count), and every output of the body belongs to one
//   thread that sums in a fixed order, so a run repeats bit for bit.  The partials are ~185 KB per tile at L=8, H=32.
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
//   view.  Right after the scan builds the row lists (up to NBR_CAP per
//   row), count_columns builds column lists (CSR, ascending row order)
//   from the rows that fit their lists, by counting: at most 128 x 16
//   entries, so they always fit.  Rows with more nonzeros are listed apart and read from global
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
//     pre-activations) in the forward kernels' own steps (edge_hw,
//     ggnn_gates, readout_pre in fused_ggnn_common.cuh): per chunk of
//     four, the weights of all four edge types (all gates) and one
//     broadcast 16-byte load of each row (0.19-0.375).
//   The message gradients and the message dh run side by side on the two
//   halves of the CTA, as do the readout's gradients and its dh.
// - Later work: tensor cores for the dense products at these widths
//   (3xTF32 to hold the f32 bounds, as at H = 64 below), more CTAs per
//   tile at small P (75 tiles fill 75 of 132 SMs), fewer passes over the
//   partial buffer.
//
// At H = 64 (fused_ggnn_bwd_kernel64) the plan above would take 493 KB:
// that width has a reverse body of its own on fused_ggnn64.cuh's steps
// (weights through two staged panels, the messages and their reverse one
// edge type at a time, the GRU and its reverse one half of the tile at a
// time, every intermediate in shared memory with the thread that owns
// it), 226,624 bytes of shared memory.  Its per-tile partial row is
// 170,176 words at L = 8 (182,592 with the readout's): 263 MB (283 MB) at
// P = 387, summed by the same sum_tiles_kernel.
// - Every dense product of that body runs on the tensor cores (h64::Tc):
//   the recompute's h W_e, x W{z,r,n}, s U{z,r}, (r s) Un and the
//   readout's [h, h0] Wi, h Wj; the products against transposed weights
//   (drs, ds, dh_in, dm, the message and readout dh, dh0's term); the
//   weight gradients a^T b.  Each in 3xTF32: both operands split into a
//   TF32 high part and a TF32 remainder, three m16n8k8 mma.sync per
//   8-deep step (lo*hi, hi*lo, hi*hi) into f32 accumulators, within
//   about 2^-21 of each term.  All three terms go into one accumulator
//   (not the forward's SEP, which needs 8 or 16 more registers a product:
//   with it the body spills 20-24 bytes, chip_tc64.py phase 4).  A warp owns a 16 x 16 block of a half-tile
//   product (32 x 16 of a weight gradient), and the elementwise steps
//   work on the entries the accumulators hand each lane.  The T x H
//   buffers and the panels swizzle their 4-word column groups by the row
//   (h64::swz), so the fragment loads of all three orientations are free
//   of bank conflicts without padding rows (which the plan has no room
//   for).
// - What bounds it, on an H100 (chip_tc64.py: the instruction rates
//   alone, and K2b's phases by clock64): neither the tensor pipe, whose
//   TF32 work K2b issues at about a fifth of the rate mma.sync reaches
//   alone, nor shared memory, whose fragment loads are conflict-free.
//   Each 8-deep step of a warp issues some fifty instructions for its six
//   mma (the fragment loads, five to split each operand value), with four
//   warps per scheduler to cover the latency of its chain; the phases
//   made of products (the forward recomputed twice, the GRU's reverse and
//   its weight gradients, the message gradients) take most of the time,
//   the column gathers about 4%.
// - Later work at H = 64: wgmma with TMA (its TF32 form reads both
//   operands K-major from shared memory, so W, W^T and a^T b would need
//   copies the plan has no room for), dropping the recompute of the
//   forward (half of the products), more CTAs per tile at small P.
//
// At H = 128 (fused_ggnn_bwd_kernel128) the H = 64 plan's five T x H
// buffers alone would take 320 KB: that width's reverse body runs on the
// H = 128 forward's plan (fused_ggnn128.cuh: the weights through the two
// panels in one sequence, the forward with its terms in its order) plus
// the column lists, 228,992 bytes, with dh in global memory (the output
// dh_bot, each entry owned by one thread), the GRU's reverse by row halves
// in the work buffer and the other half's rows of h and m, and the message
// backward by column halves (fused_ggnn128_bwd.cuh has the plan and why).
// Every form takes two launches of it: F, the forward over the range, which
// stores each layer's input (hs) and its m, r, z and n (acts) and seeds dh
// (K2b's F by the readout's backward), then R, the reverse, which reads
// them and rebuilds nothing (h128::rev_block).  Its per-tile partial row is
// 676,224 words at L = 8 (725,632 with the readout's): 1.05 GB (1.12 GB)
// at P = 387, summed by the same sum_tiles_kernel; the first NE H H words
// of the row are R's global scratch until it writes them last.

#include "fused_ggnn128_bwd.cuh"

namespace {

using namespace ggnn;

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

// One CTA per SM (the shared-memory plan), so up to 128 registers a thread.
template <int H, bool READOUT>
__global__ void __launch_bounds__(THREADS, 1)
fused_ggnn_bwd_kernel(const float* __restrict__ hin, const float* __restrict__ adj,
                      Weights w, Readout ro, const float* __restrict__ dout,
                      float* dh_bot, float* partial, float* hs, int lo, int hi,
                      int n_grad) {
  using S = GgnnPlan<H, true>;
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

  // 1. the row and column lists (trap (a)), then the forward over the
  // range, keeping each layer's input in hs
  load_gru_padded<H>(w, g, tid);
  for (int i = tid; i < TH; i += THREADS) s_hin[i] = h0_t[i];
  scan_rows(adj_t, s_nk, s_nv, s_nc, tid);
  __syncthreads();
  // the column build's row masks in the hw stack, dead until the forward
  count_columns(s_nk, s_nv, s_nc, s_cs, s_cr, s_cv, s_ov, s_ovn,
                reinterpret_cast<unsigned*>(s_big), tid);
  const int n_ov = *s_ovn;
  for (int l = lo; l < hi; ++l) {
    const bool zero_state = (l == 0);  // trap (b)
    load_message_padded<H>(w, l, s_wmsg, s_bmsg, tid);
    __syncthreads();
    for (int i = tid; i < TH; i += THREADS) hs_t[size_t(l - lo) * TH + i] = s_hin[i];
    edge_hw<H>(s_hin, s_wmsg, s_bmsg, s_big, tid);
    __syncthreads();
    aggregate<H>(adj_t, s_big, s_m, s_nk, s_nv, s_nc, tid);
    __syncthreads();
    float z[R::RPT], r[R::RPT], n[R::RPT];
    ggnn_gates<H>(zero_state, s_hin, s_m, g, s_rs, z, r, n, tid);
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      const float s = zero_state ? 0.0f : s_hin[i * H + col];
      s_hin[i * H + col] = z[k] * n[k] + (1.0f - z[k]) * s;
    }
    __syncthreads();
  }

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
    readout_pre<H>(s_hin, s_h0, s_wi, s_wj, s_bi, s_bj, gi, gj, tid);
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
    edge_hw<H>(s_hin, s_wmsg, s_bmsg, s_big, tid);
    __syncthreads();
    aggregate<H>(adj_t, s_big, s_m, s_nk, s_nv, s_nc, tid);
    __syncthreads();
    float z[R::RPT], r[R::RPT], n[R::RPT];
    ggnn_gates<H>(zero_state, s_hin, s_m, g, s_rs, z, r, n, tid);

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
  constexpr size_t bytes = GgnnPlan<H, true>::BYTES;
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

// The reverse of one GRU half of layer l at H = 64 (rows [hf HALF, hf HALF
// + HALF)), after `gates` left n in registers and r*s, z, r in rs, dz, dr:
// d{z,r,n}' (HALF x H each, in dz, dr, dn), dh = dh_in + ds into s_dh
// (dh_in alone at layer 0; the state's term ds is carried there until
// then), the half's GRU weight gradients (`acc_gru`: added to the tile's
// row), then dm into s_m, which the gradients have read.  Every product
// runs on the tensor cores (h64::Tc), and every intermediate lives in
// shared memory at the entries of the thread that owns it, so each step
// keeps one set of 8 accumulators in registers.  Panels Un, Uz, Ur,
// Wz[:H], Wr[:H], Wn[:H], Wz[H:], Wr[H:], Wn[H:], then `next`.
__device__ __forceinline__ void gru_reverse64(
    const h64::Tile& t, const Weights& w, float* s_dh, float* gru_part,
    bool zero_state, bool acc_gru, int hf, h64::Panels& p, const float* next,
    const float (&n)[h64::RPH], int tid) {
  using namespace h64;
  using G = GradLayout<H>;
  const Tc::Own o(tid);
  float* h = t.h + hf * HALF * H;
  float* m = t.m + hf * HALF * H;
  float* dh = s_dh + hf * HALF * H;  // dh, then ds, then the new dh
  float* rs = t.work;
  float* dz = rs + HALF * H;
  float* dr = dz + HALF * H;
  float* dn = dr + HALF * H;
#pragma unroll
  for (int k = 0; k < RPH; ++k) {
    const int i = o.at(k);
    const float s = zero_state ? 0.0f : h[i];
    const float dhv = dh[i];
    const float z = dz[i];
    dh[i] = dhv * (1.0f - z);
    dn[i] = dhv * z * (1.0f - n[k] * n[k]);
    dz[i] = dhv * (n[k] - s) * z * (1.0f - z);
  }
  {  // drs = dn' Un^T
    float drs[RPH] = {};
    tc_xwt(dn, panels_next<Tc>(p, w.un, w.uz, tid), o, drs);
#pragma unroll
    for (int k = 0; k < RPH; ++k) {
      const int i = o.at(k);
      const float s = zero_state ? 0.0f : h[i];
      const float r = dr[i];
      dh[i] = fmaf(drs[k], r, dh[i]);
      dr[i] = drs[k] * s * r * (1.0f - r);
    }
  }
  // ds += d{z,r}' U{z,r}^T, then dh_in = d{z,r,n}' W{z,r,n}[:H]^T and
  // dh = dh_in + ds, as the narrower widths take them
  const float* wz1 = w.wz + H * H;
  const float* wr1 = w.wr + H * H;
  const float* wn1 = w.wn + H * H;
  {
    float dsu[RPH] = {};
    const float* uz = panels_next<Tc>(p, w.uz, w.ur, tid);
    if (!zero_state) tc_xwt(dz, uz, o, dsu);
    const float* ur = panels_next<Tc>(p, w.ur, w.wz, tid);
    if (!zero_state) tc_xwt(dr, ur, o, dsu);
#pragma unroll
    for (int k = 0; k < RPH; ++k) dh[o.at(k)] += dsu[k];
  }
  {
    float dhn[RPH] = {};
    tc_xwt(dz, panels_next<Tc>(p, w.wz, w.wr, tid), o, dhn);
    tc_xwt(dr, panels_next<Tc>(p, w.wr, w.wn, tid), o, dhn);
    tc_xwt(dn, panels_next<Tc>(p, w.wn, wz1, tid), o, dhn);
#pragma unroll
    for (int k = 0; k < RPH; ++k) {
      const int i = o.at(k);
      dh[i] = zero_state ? dhn[k] : dhn[k] + dh[i];
    }
  }

  // the GRU's weight gradients over the half's rows, in four passes: h^T
  // dz' is dWz's top half and dUz alike (likewise dr'; the state is h,
  // zero at layer 0); (r s)^T dn' is dUn (r s is stored as zero at layer 0)
  float* g = gru_part;
  const GradPass<2, 0> g1 = {{h, h}, {dz, dr}, {g + G::WZ, g + G::WR},
                             {g + G::UZ, g + G::UR}, {nullptr}, {nullptr}};
  tc_grad_pass<2, 0, 0>(g1, HALF, acc_gru, !zero_state, tid);
  const GradPass<2, 0> g2 = {{h, m}, {dn, dz}, {g + G::WN, g + G::WZ + H * H},
                             {nullptr, nullptr}, {nullptr}, {nullptr}};
  tc_grad_pass<2, 0, 0>(g2, HALF, acc_gru, false, tid);
  const GradPass<2, 0> g3 = {{m, m}, {dr, dn}, {g + G::WR + H * H, g + G::WN + H * H},
                             {nullptr, nullptr}, {nullptr}, {nullptr}};
  tc_grad_pass<2, 0, 0>(g3, HALF, acc_gru, false, tid);
  const GradPass<1, 3> g4 = {{rs}, {dn}, {g + G::UN}, {nullptr},
                             {dz, dr, dn}, {g + G::BZ, g + G::BR, g + G::BN}};
  tc_grad_pass<1, 3, 256>(g4, HALF, acc_gru, false, tid);

  // dm = d{z,r,n}' W{z,r,n}[H:]^T into m, once every thread has read m
  // (the first panel's barrier), carried there between the panels
  const float* wp[3] = {wz1, wr1, wn1};
  const float* dx[3] = {dz, dr, dn};
#pragma unroll
  for (int gi = 0; gi < 3; ++gi) {
    const float* wg = panels_next<Tc>(p, wp[gi], gi < 2 ? wp[gi + 1] : next, tid);
    float acc[RPH];
#pragma unroll
    for (int k = 0; k < RPH; ++k) acc[k] = gi == 0 ? 0.0f : m[o.at(k)];
    tc_xwt(dx[gi], wg, o, acc);
#pragma unroll
    for (int k = 0; k < RPH; ++k) m[o.at(k)] = acc[k];
  }
}

// The reverse body at H = 64 (fused_ggnn64.cuh): the steps of the body
// above, with the weights through two staged panels, the message step one
// edge type at a time and the GRU one half of the tile at a time; its
// forward is the forward body's layer step on the tensor-core products
// (h64::Tc), and every T x H buffer, hs included, is in Tc's layout.
template <bool READOUT>
__global__ void __launch_bounds__(THREADS, 1)
fused_ggnn_bwd_kernel64(const float* __restrict__ hin, const float* __restrict__ adj,
                        Weights w, Readout ro, const float* __restrict__ dout,
                        float* dh_bot, float* partial, float* hs, int lo, int hi,
                        int n_grad) {
  using namespace h64;
  using S = Plan<true>;
  using G = GradLayout<H>;
  constexpr int HALF_CTA = THREADS / 2;
  extern __shared__ float smem[];
  const Tile t = {adj + size_t(blockIdx.x) * TILE * ROW_LEN,
                  smem + S::HIN, smem + S::MS, smem + S::WORK, smem + S::B_MSG,
                  smem + S::BZ, smem + S::BR, smem + S::BN,
                  reinterpret_cast<const Idx*>(smem + S::NK), smem + S::NV,
                  reinterpret_cast<const int*>(smem + S::NC)};
  float* s_dh = smem + S::DH;
  float* s_bi = smem + S::BI;
  float* s_bj = smem + S::BJ;
  int* s_cs = reinterpret_cast<int*>(smem + S::CS);
  Idx* s_cr = reinterpret_cast<Idx*>(smem + S::CR);
  float* s_cv = smem + S::CV;
  int* s_ov = reinterpret_cast<int*>(smem + S::OV);
  int* s_ovn = reinterpret_cast<int*>(smem + S::OVN);

  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;
  const int n_range = hi - lo;
  const float* h0_t = hin + tile * TH;  // h0 when lo == 0, else h_mid
  // the tile's rows of the global buffers, kept in shared memory and read
  // where used, so that no register holds them across the body
  float** s_ptrs = reinterpret_cast<float**>(smem + S::PTRS);
  if (tid == 0) {
    s_ptrs[0] = hs + tile * size_t(n_range) * TH;
    s_ptrs[1] = dh_bot + tile * TH;
    s_ptrs[2] = partial + tile * size_t(n_grad);
  }
  auto hs_t = [&] { return s_ptrs[0]; };
  auto dh0_t = [&] { return s_ptrs[1]; };
  auto part = [&] { return s_ptrs[2]; };
  auto gru_part = [&] { return s_ptrs[2] + G::gru0(n_range); };

  // 1. the row and column lists (trap (a)), then the forward over the
  // range, keeping each layer's input in hs
  Panels p;
  panels_start<Tc>(p, smem + S::PANELS, msg_panel(w, lo, 0), tid);
  for (int i = tid; i < H; i += THREADS) {
    smem[S::BZ + i] = w.bz[i]; smem[S::BR + i] = w.br[i]; smem[S::BN + i] = w.bn[i];
    if (READOUT) { s_bi[i] = ro.bi[i]; s_bj[i] = ro.bj[i]; }
  }
  for (int i = tid; i < TH; i += THREADS) t.h[Tc::at(i / H, i % H)] = h0_t[i];
  scan_rows(t.adj_t, reinterpret_cast<Idx*>(smem + S::NK), smem + S::NV,
            reinterpret_cast<int*>(smem + S::NC), tid);
  __syncthreads();
  count_columns(t.nk, t.nv, t.nc, s_cs, s_cr, s_cv, s_ov, s_ovn,
                reinterpret_cast<unsigned*>(t.work), tid);
  const int n_ov = *s_ovn;
  const float* first_back = msg_panel(w, hi - 1, 0);
#pragma unroll 1
  for (int l = lo; l < hi; ++l) {
    for (int i = tid; i < TH; i += THREADS) hs_t()[size_t(l - lo) * TH + i] = t.h[i];
    const float* next = l + 1 < hi ? msg_panel(w, l + 1, 0)
                        : READOUT ? ro.wi : first_back;
    layer_forward<Tc>(t, w, l, p, next, tid);
  }

  // 2. seed dh: the readout's backward (K2b) or dh_final (K1b)
  if constexpr (READOUT) {
    float* s_h0 = t.m;
    float* s_dpi = t.work;        // (T, D) the gate, then d(pre-gate)
    float* s_doj = t.work + TH;   // (T, D) d(h Wj + bj)
    for (int i = tid; i < TH; i += THREADS) s_h0[Tc::at(i / H, i % H)] = h0_t[i];
    readout_gate<Tc>(t.h, s_h0, ro, s_bi, s_dpi, p, tid);
    const Tc::Own o(tid);
    {
      const float* wj = panels_next<Tc>(p, ro.wj, ro.wi, tid);
      const float* mask_t = ro.mask + tile * TILE;
      const float* dg_t = dout + tile * TH;
#pragma unroll 1
      for (int hf = 0; hf < 2; ++hf) {
        float gj[RPH];
#pragma unroll
        for (int k = 0; k < RPH; ++k) gj[k] = s_bj[o.col(k)];
        Tc::product(t.h + hf * HALF * H, wj, o, gj);
#pragma unroll
        for (int k = 0; k < RPH; ++k) {
          const int row = hf * HALF + o.row(k), col = o.col(k);
          const int i = hf * HALF * H + o.at(k);
          const float gate = s_dpi[i];
          const float dgv = dg_t[row * H + col] * mask_t[row];
          s_dpi[i] = dgv * gj[k] * gate * (1.0f - gate);
          s_doj[i] = dgv * gate;
        }
      }
    }
    __syncthreads();
    float* ro_part = gru_part() + G::GRU_WORDS;
    const GradPass<2, 0> r1 = {
        {t.h, s_h0}, {s_dpi, s_dpi}, {ro_part + G::WI, ro_part + G::WI + H * H},
        {nullptr, nullptr}, {nullptr}, {nullptr}};
    tc_grad_pass<2, 0, 0>(r1, TILE, false, false, tid);
    const GradPass<1, 2> r2 = {{t.h}, {s_doj}, {ro_part + G::WJ}, {nullptr},
                               {s_dpi, s_doj}, {ro_part + G::BI, ro_part + G::BJ}};
    tc_grad_pass<1, 2, 256>(r2, TILE, false, false, tid);
    // dh = dpi Wi[:H]^T + doj Wj^T, carried in s_dh between the panels;
    // h0's direct term dpi Wi[H:]^T goes to dh0 now and is added to the
    // reverse's result at the end
    const float* wi0 = panels_next<Tc>(p, ro.wi, ro.wj, tid);
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float acc[RPH] = {};
      tc_xwt(s_dpi + hf * HALF * H, wi0, o, acc);
#pragma unroll
      for (int k = 0; k < RPH; ++k)
        s_dh[hf * HALF * H + o.at(k)] = acc[k];
    }
    const float* wj = panels_next<Tc>(p, ro.wj, ro.wi + H * H, tid);
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float* dh = s_dh + hf * HALF * H;
      float acc[RPH];
#pragma unroll
      for (int k = 0; k < RPH; ++k) acc[k] = dh[o.at(k)];
      tc_xwt(s_doj + hf * HALF * H, wj, o, acc);
#pragma unroll
      for (int k = 0; k < RPH; ++k) dh[o.at(k)] = acc[k];
    }
    const float* wi1 = panels_next<Tc>(p, ro.wi + H * H, first_back, tid);
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float acc[RPH] = {};
      tc_xwt(s_dpi + hf * HALF * H, wi1, o, acc);
#pragma unroll
      for (int k = 0; k < RPH; ++k)
        dh0_t()[(hf * HALF + o.row(k)) * H + o.col(k)] = acc[k];
    }
  } else {
    const float* dh_t = dout + tile * TH;
    for (int i = tid; i < TH; i += THREADS) s_dh[Tc::at(i / H, i % H)] = dh_t[i];
  }

  // 3. reverse the range's layers
#pragma unroll 1
  for (int l = hi - 1; l >= lo; --l) {
    const bool zero_state = (l == 0);  // trap (b): ds survives at l == lo > 0
    __syncthreads();  // the last readers of h and the message biases are done
    for (int i = tid; i < TH; i += THREADS) t.h[i] = hs_t()[size_t(l - lo) * TH + i];
    for (int i = tid; i < NE * H; i += THREADS) t.bmsg[i] = w.msg_b[size_t(l) * NE * H + i];
    messages<Tc>(t, w, l, p, w.wz, tid);
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float n[RPH];
      gates<Tc>(t, w, zero_state, hf, true, p, w.un, n, tid);
      gru_reverse64(t, w, s_dh, gru_part(), zero_state, l != hi - 1 || hf != 0, hf, p,
                    hf == 0 ? w.wz : msg_panel(w, l, 0), n, tid);
    }
    // message backward, one edge type at a time: dhw_e = A_e^T dm, then
    // layer l's message gradients (warps 0-7 their product, threads [256,
    // 320) their biases) beside dh += dhw_e W_e^T (warps 8-15, by quarters
    // of the tile: warp 8 + v owns Tc::Own(v)'s 16 x 16 block of each)
#pragma unroll 1
    for (int e = 0; e < NE; ++e) {
      const float* next = e + 1 < NE ? msg_panel(w, l, e + 1)
                          : l > lo ? msg_panel(w, l - 1, 0) : nullptr;
      const float* we = panels_next<Tc>(p, msg_panel(w, l, e), next, tid);
      column_gather_edge<Tc>(t.adj_t, e, t.m, s_cs, s_cr, s_cv, s_ov, n_ov, t.work, tid);
      __syncthreads();
      float* mw = part() + (size_t(l - lo) * NE + e) * H * H;
      float* mb = part() + G::msg_b0(n_range) + (size_t(l - lo) * NE + e) * H;
      const GradPass<1, 1> mp = {{t.h}, {t.work}, {mw}, {nullptr}, {t.work}, {mb}};
      tc_grad_pass<1, 1, 64>(mp, TILE, false, false, tid);
      if (tid >= HALF_CTA) {
        constexpr int QR = TILE / 4;  // rows of a quarter of the tile
        const Tc::Own o((tid - HALF_CTA) >> 5, tid & 31);
#pragma unroll 1
        for (int q = 0; q < 4; ++q) {
          float* dh = s_dh + q * QR * H;
          float acc[RPH];
#pragma unroll
          for (int k = 0; k < RPH; ++k) acc[k] = dh[o.at(k)];
          tc_xwt(t.work + q * QR * H, we, o, acc);
#pragma unroll
          for (int k = 0; k < RPH; ++k) dh[o.at(k)] = acc[k];
        }
      }
    }
  }

  // 4. dh at the bottom of the range: dh0, or dh_mid for the top half
  // (+ the readout's direct h0 term, written to dh0 in step 2)
  __syncthreads();
  float* dh0 = dh0_t();
  for (int i = tid; i < TH; i += THREADS) {
    const float v = s_dh[Tc::at(i / H, i % H)];
    dh0[i] = READOUT ? v + dh0[i] : v;
  }
}

template <bool READOUT>
cudaError_t launch_bwd64(const float* hin, const float* adj, const Weights& w,
                         const Readout& ro, const float* dout, float* dh_bot,
                         float* partial, float* grads, float* hs, int n_tiles,
                         int lo, int hi, cudaStream_t stream) {
  if (!h64::panels_aligned(w, READOUT ? &ro : nullptr)) return cudaErrorInvalidValue;
  constexpr size_t bytes = h64::Plan<true>::BYTES;
  static bool opted_in[MAX_DEVICES] = {};
  cudaError_t err = opt_in_smem(fused_ggnn_bwd_kernel64<READOUT>, bytes, opted_in);
  if (err != cudaSuccess) return err;
  const int n_grad = int(GradLayout<64>::words(hi - lo, READOUT));
  fused_ggnn_bwd_kernel64<READOUT><<<n_tiles, THREADS, bytes, stream>>>(
      hin, adj, w, ro, dout, dh_bot, partial, hs, lo, hi, n_grad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int SUM_THREADS = 256;
  sum_tiles_kernel<<<(n_grad + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0,
                     stream>>>(partial, grads, n_tiles, n_grad);
  return cudaGetLastError();
}

// The reverse of one GRU half of layer l at H = 128 (rows [hf HALF, hf HALF
// + HALF)), h and m of the layer in shared memory: from r, z and n as the
// forward stored them (acts, `rzn` r's rows of the half, z's and n's TH and
// 2 TH after; each entry read by the thread that wrote it), d{z,r,n}', dh =
// dh_in + ds in place in global memory (dh_in alone at layer 0; the state's
// term ds is carried there until then), the half's GRU weight gradients
// (`acc_gru`: added to the tile's row) and dm: the second half's into its
// rows of m, the first half's into global memory (Scratch::PARK), since the
// second half's dz' takes its rows.  The 64 x H buffers: r*s, then dr', in
// the work buffer; dz' in the other half's rows of m; dn' in the other
// half's rows of h.  Each product runs in a loop over its blocks.  Each
// step loads its global values (r, z, n, dh) before its first store, which
// could alias them as far as the compiler knows, so the loads go out
// together.
template <class S>
__device__ __forceinline__ void gru_reverse128(const h128::Tile& t, const h128::Globals& g,
                                               const float* rzn, bool zero_state, bool acc_gru,
                                               int hf, S& seq, h64::Panels& p, int tid) {
  using namespace h128;
  using G = GradLayout<H>;
  const Tc::Own o(h64::fresh_tid());
  const float* h = t.h + hf * HALF * H;
  const float* m = t.m + hf * HALF * H;
  float* rs = t.work;
  float* dz = t.m + (1 - hf) * HALF * H;
  float* dn = t.h + (1 - hf) * HALF * H;
  // o's k-th output of column half c in dh (row-major)
  auto dh_at = [&](int k, int c) {
    return g.dh() + (hf * HALF + o.row(k)) * H + c * HB + o.col(k);
  };
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    float rv[RPH], zv[RPH], nv[RPH], dhv[RPH];
#pragma unroll
    for (int k = 0; k < RPH; ++k) {
      const int i = own_at(o, k, 0, c);
      rv[k] = rzn[i];
      zv[k] = rzn[TH + i];
      nv[k] = rzn[2 * TH + i];
      dhv[k] = *dh_at(k, c);
    }
#pragma unroll
    for (int k = 0; k < RPH; ++k) {
      const int i = own_at(o, k, 0, c);
      const float s = zero_state ? 0.0f : h[i], z = zv[k];
      rs[i] = zero_state ? 0.0f : rv[k] * h[i];
      *dh_at(k, c) = dhv[k] * (1.0f - z);
      dn[i] = dhv[k] * z * (1.0f - nv[k] * nv[k]);
      dz[i] = dhv[k] * (nv[k] - s) * z * (1.0f - z);
    }
  }
  __syncthreads();

  // the gradients of dz' and dn': h^T dz' is dWz's top half and dUz alike
  // (the state is h, zero at layer 0), m^T dz' its bottom half, likewise
  // dn' and dWn; (r s)^T dn' is dUn (r s is stored as zero at layer 0)
  {
    float* o1 = g.gru();
    const GradPass128<5> g1 = {
        {h, h, m, m, rs}, {dz, dn, dz, dn, dn},
        {o1 + G::WZ, o1 + G::WN, o1 + G::WZ + H * H, o1 + G::WN + H * H, o1 + G::UN},
        {o1 + G::UZ, nullptr, nullptr, nullptr, nullptr}};
    grad_pass128(g1, HALF, acc_gru, !zero_state, tid);
  }
  col_sums<2, H, H>({dz, dn}, {g.gru() + G::BZ, g.gru() + G::BN}, HALF, acc_gru, tid);

  // drs = dn' Un^T by column halves; ds += drs r, and dr' = drs s r (1 - r)
  // where r*s was (dUn read it before the first block's barrier)
#pragma unroll 1
  for (int kb = 0; kb < 2; ++kb) {
    float a[RPH] = {};
#pragma unroll 1
    for (int cb = 0; cb < 2; ++cb) xwt<H>(dn + cb * HB, seq.take(p, tid), o, a);
    float rv[RPH], dhv[RPH];
#pragma unroll
    for (int k = 0; k < RPH; ++k) {
      rv[k] = rzn[own_at(o, k, 0, kb)];
      dhv[k] = *dh_at(k, kb);
    }
#pragma unroll
    for (int k = 0; k < RPH; ++k) {
      const int i = own_at(o, k, 0, kb);
      const float s = zero_state ? 0.0f : h[i];
      *dh_at(k, kb) = fmaf(a[k], rv[k], dhv[k]);
      rs[i] = a[k] * s * rv[k] * (1.0f - rv[k]);
    }
  }
  __syncthreads();
  {
    float* o2 = g.gru();
    const GradPass128<2> g2 = {{h, m}, {rs, rs}, {o2 + G::WR, o2 + G::WR + H * H},
                               {o2 + G::UR, nullptr}};
    grad_pass128(g2, HALF, acc_gru, !zero_state, tid);
  }
  col_sums<1, H, H>({rs}, {g.gru() + G::BR}, HALF, acc_gru, tid);

  // per output column half kb: ds += d{z,r}' U{z,r}^T, then dh = d{z,r,n}'
  // W{z,r,n}[:H]^T + ds, as the narrower widths take them; then dm =
  // d{z,r,n}' W{z,r,n}[H:]^T (the second half's into its rows of m, which
  // the gradients read before the first block's barrier).  Blocks u of a
  // pass: Uz, Ur (the dh pass only), Wz, Wr, Wn, by the operand's column
  // halves.
  float* dm = hf == 0 ? g.part() + Scratch::PARK : t.m + HALF * H;
#pragma unroll 1
  for (int pk = 0; pk < 4; ++pk) {
    const bool to_m = pk >= 2;
    const int kb = pk & 1;
    float a[RPH] = {};
#pragma unroll 1
    for (int u = to_m ? 4 : 0; u < 10; ++u) {
      if (u == 4 && !to_m) {  // ds += d{z,r}' U{z,r}^T is complete
        float dhv[RPH];
#pragma unroll
        for (int k = 0; k < RPH; ++k) dhv[k] = *dh_at(k, kb);
#pragma unroll
        for (int k = 0; k < RPH; ++k) {
          *dh_at(k, kb) = dhv[k] + a[k];
          a[k] = 0.0f;
        }
      }
      const float* x = (u >= 8 ? dn : (u & 2) ? rs : dz) + (u & 1) * HB;
      const float* wb = seq.take(p, tid);
      if (u >= 4 || !zero_state) xwt<H>(x, wb, o, a);
    }
    if (to_m) {
#pragma unroll
      for (int k = 0; k < RPH; ++k) dm[own_at(o, k, 0, kb)] = a[k];
    } else {
      float dhv[RPH];
#pragma unroll
      for (int k = 0; k < RPH; ++k) dhv[k] = zero_state ? 0.0f : *dh_at(k, kb);
#pragma unroll
      for (int k = 0; k < RPH; ++k) *dh_at(k, kb) = zero_state ? a[k] : a[k] + dhv[k];
    }
  }
}

// K2b's seed at H = 128: the gated readout's backward from dg (T x D, D =
// H) by column halves c of D, h the stack's output in t.h and h0 loaded
// into t.m (the products by row halves, as the forward's readout takes
// them over the tile).  Its weight gradients go to the tile's row, dh = dpi Wi[:H]^T
// + doj Wj^T to dh and h0's direct term dpi Wi[H:]^T to Scratch::DIRECT
// (both row-major in global memory); the gate, then dpi, of a column half
// in the work buffer, doj in global memory (Scratch::DOJ, the owner's
// entries) until dpi is done.
template <class S>
__device__ __forceinline__ void readout_bwd128(const h128::Tile& t, const h128::Globals& g,
                                               const float* s_bi, const float* s_bj, S& seq,
                                               h64::Panels& p, int tid) {
  using namespace h128;
  using G = GradLayout<H>;
  float* s_h0 = t.m;  // read after the first block's barrier
  for (int i = tid; i < TH; i += THREADS) s_h0[at(i / H, i % H)] = g.hin()[i];
  const Tc::Own o(h64::fresh_tid());
  auto doj = [&] { return g.part() + Scratch::DOJ; };
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    // by row halves: the gate sigmoid([h, h0] Wi + bi) into the work
    // buffer, then h Wj + bj, as the forward's readout takes them; then dpi
    // and doj
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float acc[RPH];
#pragma unroll 1
      for (int k = 0; k < 6; ++k) {
        if (k == 4) {
#pragma unroll
          for (int j = 0; j < RPH; ++j)
            t.work[hf * HALF * HB + o.at(j)] = sigmoidf(acc[j]);
        }
        if (k == 0 || k == 4) fill_half(acc, (k == 0 ? s_bi : s_bj) + c * HB, o);
        product_half1(k == 2 || k == 3 ? s_h0 : t.h, hf, k & 1, seq.take(p, tid), o, acc);
      }
#pragma unroll
      for (int j = 0; j < RPH; ++j) {
        const int row = hf * HALF + o.row(j), col = c * HB + o.col(j);
        const int i = hf * HALF * HB + o.at(j);
        const float gate = t.work[i];
        const float dgv = g.dout()[row * H + col] * g.mask()[row];
        t.work[i] = dgv * acc[j] * gate * (1.0f - gate);
        doj()[i] = dgv * gate;
      }
    }
    __syncthreads();
    // dWi[:, c] = [h, h0]^T dpi (blocks ib and ib + 2 on each half of the
    // CTA) and dbi; dh (+)= dpi Wi[:H]^T, h0's direct term (+)= dpi Wi[H:]^T
#pragma unroll 1
    for (int ib = tid >> 8; ib < 4; ib += 2)  // blocks ib, ib + 2 on this half of the CTA
      grad_block<H, HB>((ib < 2 ? t.h : s_h0) + (ib & 1) * HB, t.work,
                        g.ro() + G::WI + ib * HB * H + c * HB, nullptr, TILE, false,
                        false);
    col_sums<1, HB, HB>({t.work}, {g.ro() + G::BI + c * HB}, TILE, false, tid);
#pragma unroll 1
    for (int u = 0; u < 4; ++u)
      xwt_tile_global(t.work, seq.take(p, tid),
                      (u < 2 ? g.dh() : g.part() + Scratch::DIRECT) + (u & 1) * HB, c > 0);
    // doj into the work buffer once every thread is done with dpi;
    // dWj[:, c] = h^T doj and dbj; dh += doj Wj^T
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2 * RPH; ++j) t.work[h64::tile_at(o, j)] = doj()[h64::tile_at(o, j)];
    __syncthreads();
    const int ia = tid >> 8;
    grad_block<H, HB>(t.h + ia * HB, t.work, g.ro() + G::WJ + ia * HB * H + c * HB,
                      nullptr, TILE, false, false);
    col_sums<1, HB, HB>({t.work}, {g.ro() + G::BJ + c * HB}, TILE, false, tid);
#pragma unroll 1
    for (int kb = 0; kb < 2; ++kb)
      xwt_tile_global(t.work, seq.take(p, tid), g.dh() + kb * HB, true);
  }
}

// The reverse body at H = 128 (fused_ggnn128_bwd.cuh), in the launches of
// MODE (h128::rev_block).  F (modes 0 and 1): the forward over the range
// (the H = 128 forward's layer step, each product in a loop), storing each
// layer's input in hs and its m, r, z and n in acts, then dh = dh_top (mode
// 0) or K2b's readout backward (mode 1).  R (mode 2): the reverse from hs,
// acts and dh (dh_bot, in global memory), the GRU by row halves and the
// message backward by edge types and column halves, nothing of the forward
// rebuilt.  Every weight block passes through the panels in one sequence
// per launch.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
fused_ggnn_bwd_kernel128(const float* __restrict__ hin, const float* __restrict__ adj,
                         Weights w, Readout ro, const float* __restrict__ dout,
                         float* dh_bot, float* partial, float* hs, float* acts, int lo,
                         int hi, int n_grad) {
  using namespace h128;
  using S = RPlan;
  using G = GradLayout<H>;
  extern __shared__ float smem[];
  // the adjacency is read through g (Globals), not t
  const Tile t = {nullptr, smem + S::HIN, smem + S::MS, smem + S::WORK, smem + S::B_MSG,
                  smem + S::BZ, smem + S::BR, smem + S::BN,
                  reinterpret_cast<const Idx*>(smem + S::NK), smem + S::NV,
                  reinterpret_cast<const int*>(smem + S::NC)};
  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;
  const float* adj_t = adj + tile * TILE * ROW_LEN;
  float** s_ptrs = reinterpret_cast<float**>(smem + S::PTRS);
  if (tid == 0) {
    const int n_range = hi - lo;
    float* part = partial + tile * size_t(n_grad);
    const float* rows[] = {adj_t,
                           hs + tile * size_t(n_range) * TH,
                           dh_bot + tile * TH,
                           part,
                           part + G::msg_b0(n_range),
                           part + G::gru0(n_range),
                           part + G::gru0(n_range) + G::GRU_WORDS,
                           hin + tile * TH,
                           dout + tile * TH,
                           MODE == 1 ? ro.mask + tile * TILE : nullptr,
                           acts + tile * size_t(n_range) * ACTS * TH};
    for (int i = 0; i < 11; ++i) s_ptrs[i] = const_cast<float*>(rows[i]);
  }
  const Globals g = {s_ptrs};
  Panels p;
  h64::panels_start<Tc, H>(p, smem + S::PANELS, rev_block<MODE, 0>(w, ro, lo, hi, 0), tid);

  if constexpr (MODE != R_MODE) {
    // F: the row lists, then the forward over the range
    for (int i = tid; i < H; i += THREADS) {
      smem[S::BZ + i] = w.bz[i]; smem[S::BR + i] = w.br[i]; smem[S::BN + i] = w.bn[i];
      if (MODE == 1) { smem[S::BI + i] = ro.bi[i]; smem[S::BJ + i] = ro.bj[i]; }
    }
    const float* h0_t = hin + tile * TH;  // h0 when lo == 0, else h_mid
    for (int i = tid; i < TH; i += THREADS) t.h[at(i / H, i % H)] = h0_t[i];
    scan_rows(adj_t, reinterpret_cast<Idx*>(smem + S::NK), smem + S::NV,
              reinterpret_cast<int*>(smem + S::NC), tid);
    __syncthreads();
    RSeq<MODE, 0> fwd_seq = {w, ro, lo, hi};
#pragma unroll 1
    for (int l = lo; l < hi; ++l) {
      for (int i = tid; i < TH; i += THREADS) g.hs(l - lo)[i] = t.h[i];
      // the previous layer's readers of the biases are past its last barrier
      for (int i = tid; i < NE * H; i += THREADS) t.bmsg[i] = w.msg_b[size_t(l) * NE * H + i];
      messages_looped(t, g, fwd_seq, p, tid);
      __syncthreads();
      for (int i = tid; i < TH; i += THREADS) g.act(l - lo, ACT_M)[i] = t.m[i];
#pragma unroll 1
      for (int hf = 0; hf < 2; ++hf)
        gru_half_looped(t, l == 0, hf, g.act(l - lo, ACT_R), g.act(l - lo, ACT_Z),
                        g.act(l - lo, ACT_N), fwd_seq, p, tid);
      __syncthreads();
    }
    // seed dh: the readout's backward (K2b) or dh_top (K1b, K3)
    if constexpr (MODE == 1) {
      RSeq<MODE, 1> ro_seq = {w, ro, lo, hi};
      readout_bwd128(t, g, smem + S::BI, smem + S::BJ, ro_seq, p, tid);
    } else {
      for (int i = tid; i < TH; i += THREADS) g.dh()[i] = g.dout()[i];
    }
  } else {
    // R: the row lists, the first reversed layer's h and m on their way
    // (Reloads), the column lists (from a scan before the range's first
    // layer: trap (a)), then the range's layers in reverse
    int* s_cs = reinterpret_cast<int*>(smem + S::CS);
    Idx* s_cr = reinterpret_cast<Idx*>(smem + S::CR);
    float* s_cv = smem + S::CV;
    int* s_ov = reinterpret_cast<int*>(smem + S::OV);
    int* s_ovn = reinterpret_cast<int*>(smem + S::OVN);
    const Reloads rl = {reinterpret_cast<unsigned long long*>(smem + S::BAR)};
    if (tid == 0) {
      mbar_init(rl.bar, 1);
      mbar_fence_init();
    }
    scan_rows(adj_t, reinterpret_cast<Idx*>(smem + S::NK), smem + S::NV,
              reinterpret_cast<int*>(smem + S::NC), tid);
    __syncthreads();  // the mbarrier and the pointers are set before any thread uses them
    rl.expect(2 * TH, tid);
    rl.copy(t.h, g.hs(hi - 1 - lo), TH, tid);
    rl.copy(t.m, g.act(hi - 1 - lo, ACT_M), TH, tid);
    count_columns(t.nk, t.nv, t.nc, s_cs, s_cr, s_cv, s_ov, s_ovn,
                  reinterpret_cast<unsigned*>(t.work), tid);
    RSeq<MODE, 0> rev_seq = {w, ro, lo, hi};
#pragma unroll 1
    for (int l = hi - 1; l >= lo; --l) {
      const int j = hi - 1 - l;
      const bool zero_state = (l == 0);  // trap (b): ds survives at l == lo > 0
      rl.wait(3 * j);  // the layer's h and m
      // the GRU by row halves, each borrowing the other half's rows of h
      // and m: the second half's reloaded from hs and acts before it runs,
      // the first half's after (m's from its dm, parked in global memory)
#pragma unroll 1
      for (int hf = 0; hf < 2; ++hf) {
        __syncthreads();  // the last readers of what the half overwrites are done
        if (hf == 1) {
          rl.expect(2 * HALF * H, tid);
          rl.copy(t.m + HALF * H, g.act(l - lo, ACT_M) + HALF * H, HALF * H, tid);
          rl.copy(t.h + HALF * H, g.hs(l - lo) + HALF * H, HALF * H, tid);
          rl.wait(3 * j + 1);
        }
        gru_reverse128(t, g, g.act(l - lo, ACT_R) + hf * HALF * H, zero_state,
                       l != hi - 1 || hf != 0, hf, rev_seq, p, tid);
      }
      __syncthreads();
      rl.expect(HALF * H, tid);
      rl.copy(t.h, g.hs(l - lo), HALF * H, tid);
      for (int i = tid; i < HALF * H; i += THREADS) t.m[i] = g.part()[Scratch::PARK + i];
      if (ro.mask != nullptr && l == 0) {  // K2b: dh0's direct term, once layer 0's GRU has consumed dh
        for (int i = tid; i < TH; i += THREADS) g.dh()[i] += g.part()[Scratch::DIRECT + i];
      }
      rl.wait(3 * j + 2);
      // message backward, by edge types and column halves: dhw_e[:, c] =
      // A_e^T dm[:, c] into the work buffer, then layer l's message
      // gradients of those columns (two blocks, one on each half of the
      // CTA) and dh += dhw_e[:, c] W_e[:, c]^T.  The scratch above is dead
      // before layer lo's gradients overwrite it (the first block's barrier).
      // The next layer's m is brought in once the last gather is done, its h
      // once the last gradient block is.
#pragma unroll 1
      for (int ec = 0; ec < 2 * NE; ++ec) {
        const int e = ec >> 1, c = ec & 1;
        const bool last = ec == 2 * NE - 1 && l > lo;
        const float* w0 = rev_seq.take(p, tid);
        h64::column_gather_edge<Tc, Wide>(g.adj(), e, t.m + c * HB, s_cs, s_cr, s_cv, s_ov,
                                          *s_ovn, t.work, tid);
        __syncthreads();
        if (last) {
          rl.expect(2 * TH, tid);
          rl.copy(t.m, g.act(l - 1 - lo, ACT_M), TH, tid);
        }
        const size_t le = size_t(l - lo) * NE + e;
        const int ia = tid >> 8;
        grad_block<H, HB>(t.h + ia * HB, t.work, g.part() + le * H * H + ia * HB * H + c * HB,
                          nullptr, TILE, false, false);
        col_sums<1, HB, HB>({t.work}, {g.msg_b() + le * H + c * HB}, TILE, false, tid);
#pragma unroll 1
        for (int kb = 0; kb < 2; ++kb) {
          const float* wb = kb == 0 ? w0 : rev_seq.take(p, tid);
          if (kb == 1 && last) rl.copy(t.h, g.hs(l - 1 - lo), TH, tid);
          xwt_tile_global(t.work, wb, g.dh() + kb * HB, true);
        }
      }
    }
    // dh_bot holds dh at the bottom of the range: dh0 (with the readout's
    // direct term), or dh_mid for the top half
  }
}

template <int MODE>
cudaError_t launch_body128(const float* hin, const float* adj, const Weights& w,
                           const Readout& ro, const float* dout, float* dh_bot,
                           float* partial, float* hs, float* acts, int n_tiles, int lo,
                           int hi, int n_grad, cudaStream_t stream) {
  constexpr size_t bytes = h128::RPlan::BYTES;
  static bool opted_in[MAX_DEVICES] = {};
  cudaError_t err = opt_in_smem(fused_ggnn_bwd_kernel128<MODE>, bytes, opted_in);
  if (err != cudaSuccess) return err;
  fused_ggnn_bwd_kernel128<MODE><<<n_tiles, THREADS, bytes, stream>>>(
      hin, adj, w, ro, dout, dh_bot, partial, hs, acts, lo, hi, n_grad);
  return cudaGetLastError();
}

// Every form in two launches of the body (rev_block): F, then R; then the
// in-order sum of the tiles' gradient rows
template <bool READOUT>
cudaError_t launch_bwd128(const float* hin, const float* adj, const Weights& w,
                          const Readout& ro, const float* dout, float* dh_bot,
                          float* partial, float* grads, float* hs, float* acts, int n_tiles,
                          int lo, int hi, cudaStream_t stream) {
  if (!h64::panels_aligned(w, READOUT ? &ro : nullptr) || acts == nullptr)
    return cudaErrorInvalidValue;
  const int n_grad = int(GradLayout<128>::words(hi - lo, READOUT));
  cudaError_t err = launch_body128<READOUT ? 1 : 0>(hin, adj, w, ro, dout, dh_bot, partial, hs,
                                                    acts, n_tiles, lo, hi, n_grad, stream);
  if (err != cudaSuccess) return err;
  err = launch_body128<2>(hin, adj, w, ro, dout, dh_bot, partial, hs, acts, n_tiles, lo, hi,
                          n_grad, stream);
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
// the shared GRU, in the GradLayout order.  partial (P, n_grad), hs (P, hi
// - lo, T, H) and, at H = 128 only (else unused), acts (P, hi - lo, 4, T, H)
// are scratch.  Returns a cudaError_t.
extern "C" int fused_ggnn_range_bwd(
    const float* hin, const float* adj, const float* msg_w, const float* msg_b,
    const float* wz, const float* uz, const float* bz,
    const float* wr, const float* ur, const float* br,
    const float* wn, const float* un, const float* bn,
    const float* dh_top, float* dh_bot, float* partial, float* grads, float* hs,
    float* acts, int n_tiles, int lo, int hi, int hidden, void* stream) {
  if (n_tiles <= 0 || lo < 0 || hi <= lo) return int(cudaErrorInvalidValue);
  const Weights w = make_weights(msg_w, msg_b, wz, uz, bz, wr, ur, br, wn, un, bn);
  const Readout ro = {};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 16: return int(launch_bwd<16, false>(hin, adj, w, ro, dh_top, dh_bot, partial, grads, hs, n_tiles, lo, hi, st));
    case 32: return int(launch_bwd<32, false>(hin, adj, w, ro, dh_top, dh_bot, partial, grads, hs, n_tiles, lo, hi, st));
    case 64: return int(launch_bwd64<false>(hin, adj, w, ro, dh_top, dh_bot, partial, grads, hs, n_tiles, lo, hi, st));
    case 128: return int(launch_bwd128<false>(hin, adj, w, ro, dh_top, dh_bot, partial, grads, hs, acts, n_tiles, lo, hi, st));
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
    const float* dg, float* dh0, float* partial, float* grads, float* hs, float* acts,
    int n_tiles, int n_layers, int hidden, int out_dim, void* stream) {
  if (n_tiles <= 0 || n_layers <= 0) return int(cudaErrorInvalidValue);
  if (out_dim != hidden) return int(cudaErrorInvalidValue);
  const Weights w = make_weights(msg_w, msg_b, wz, uz, bz, wr, ur, br, wn, un, bn);
  const Readout ro = {mask, wi, bi, wj, bj};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 16: return int(launch_bwd<16, true>(h0, adj, w, ro, dg, dh0, partial, grads, hs, n_tiles, 0, n_layers, st));
    case 32: return int(launch_bwd<32, true>(h0, adj, w, ro, dg, dh0, partial, grads, hs, n_tiles, 0, n_layers, st));
    case 64: return int(launch_bwd64<true>(h0, adj, w, ro, dg, dh0, partial, grads, hs, n_tiles, 0, n_layers, st));
    case 128: return int(launch_bwd128<true>(h0, adj, w, ro, dg, dh0, partial, grads, hs, acts, n_tiles, 0, n_layers, st));
    default: return int(cudaErrorInvalidValue);
  }
}
