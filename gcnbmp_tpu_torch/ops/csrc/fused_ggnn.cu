// Fused multi-layer GGNN forward over packed 128-atom tiles, for Hopper
// (sm_90a).  Built by gcnbmp_tpu_torch/ops/build.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.
//
// Replaces the TPU kernels of gcnbmp_tpu/ops/fused_ggnn.py:
//   fused_ggnn_fwd          <- _fused_ggnn_fwd / _fwd_kernel (K1)
//   fused_ggnn_mid_fwd      <- _fused_ggnn_fwd's TWOPASS branch /
//                              _fwd_mid_kernel (K1m)
//   fused_ggnn_readout_fwd  <- _fused_ggnn_readout_fwd / _fwd_readout_kernel (K2)
//
// Per layer l, on one tile of T=128 atoms (h: (T, H)):
//   hw_e = h W_e + b_e                       e = 0..3 (edge types)
//   m    = A_flat (T, 4T) @ [hw_0; hw_1; hw_2; hw_3] (4T, H)
//   x    = [h, m]
//   z    = sigmoid(x Wz + s Uz + bz)
//   r    = sigmoid(x Wr + s Ur + br)
//   n    = tanh(x Wn + (r*s) Un + bn)
//   h'   = z*n + (1-z)*s                     s = 0 at layer 0, else h
// K2 ends with the gated readout
//   g = sigmoid([h, h0] Wi + bi) * (h Wj + bj) * mask.
// K1m is K1 with one more store: h_mid, the input of layer split = L/2,
// which the two-pass backward (K3, fused_ggnn_bwd.cu) starts its top half
// from.  It is the same kernel body, so its final h is bit for bit K1's;
// the extra output costs one (T, H) f32 write per tile.
// Weight layout is the fused format of ops/fused_ggnn.py (kernels (in, out)).
//
// What bounds it on this card, and what the design does about it:
// - The TPU kernel holds 16 f32 adjacency tiles (128 x 512, 256 KB each)
//   in fast memory at once; a Hopper block has 227 KB of shared memory.
//   Here one CTA owns one tile and loops over all L layers itself, so the
//   grid is P and nothing carries between blocks.
// - The adjacency is ~0.4% dense.  Layer 0 reads each adjacency row once
//   from global memory (16 coalesced 128-byte loads per row, all issued
//   before the scan, a warp per row), finds the nonzeros with a warp
//   ballot and keeps up to NBR_CAP (column, value) pairs per row in
//   shared memory.  Later layers gather
//   through those lists; a row with more nonzeros than NBR_CAP rescans its
//   dense row every layer, so any input is handled exactly.  The
//   adjacency therefore costs one pass over global memory per forward
//   instead of one per layer, and the aggregation's work scales with the
//   number of edges, not with 128 x 512.
// - Everything else is small dense products (H <= 32 wide).  All weights,
//   h, m and the four hw_e blocks stay in shared memory (about 165 KB at
//   H = 32), so one CTA fits an SM; it runs 512 threads (16 warps) to hide
//   shared-memory latency.  Each thread owns one column and a strided
//   set of rows, loading each weight once into a register and reusing it
//   across its rows, so the loop is bound by shared-memory loads and f32
//   FMAs.  Arithmetic is plain f32 (no TF32, no tensor cores), matching
//   the JAX package's default f32 matmuls.
// The layer's steps live in fused_ggnn_common.cuh, shared with the
// backward kernels (fused_ggnn_bwd.cu), which recompute this forward.
// Later work: tensor cores (wgmma) for the dense products, and more CTAs
// per SM by shrinking the shared-memory plan.

#include "fused_ggnn_common.cuh"

namespace {

using namespace ggnn;

// Shared-memory plan, in 4-byte words.
template <int H>
struct Plan {
  static constexpr int W_MSG = 0;                   // 4 H H
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
  static constexpr int HS = BN + H;                 // T H: h (the GRU state)
  static constexpr int MS = HS + TILE * H;          // T H: m; h0 for the readout
  static constexpr int HW = MS + TILE * H;          // 4T H: hw stack; r*s; readout weights
  static constexpr int NV = HW + NE * TILE * H;     // T NBR_CAP neighbour values
  static constexpr int NK = NV + TILE * NBR_CAP;    // T NBR_CAP neighbour columns (int)
  static constexpr int NC = NK + TILE * NBR_CAP;    // T neighbour counts (int)
  static constexpr int WORDS = NC + TILE;
  static constexpr size_t BYTES = size_t(WORDS) * 4;
};

template <int H, int D, bool READOUT, bool MID>
__global__ void __launch_bounds__(THREADS)
fused_ggnn_kernel(const float* __restrict__ h0, const float* __restrict__ adj,
                  Weights w, Readout ro, float* __restrict__ out,
                  float* __restrict__ mid, int n_layers, int split) {
  using S = Plan<H>;
  using R = Rows<H>;
  extern __shared__ float smem[];
  float* s_wmsg = smem + S::W_MSG;
  float* s_bmsg = smem + S::B_MSG;
  const GruSmem g = {smem + S::WZ, smem + S::WR, smem + S::WN,
                     smem + S::UZ, smem + S::UR, smem + S::UN,
                     smem + S::BZ, smem + S::BR, smem + S::BN};
  float* s_h = smem + S::HS;
  float* s_m = smem + S::MS;
  float* s_hw = smem + S::HW;
  float* s_rs = s_hw;  // r*s reuses the hw stack once m is built
  float* s_nv = smem + S::NV;
  int* s_nk = reinterpret_cast<int*>(smem + S::NK);
  int* s_nc = reinterpret_cast<int*>(smem + S::NC);

  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;
  const float* h0_t = h0 + tile * TILE * H;
  const float* adj_t = adj + tile * TILE * ROW_LEN;

  load_gru<H>(w, g, tid);
  for (int i = tid; i < TILE * H; i += THREADS) s_h[i] = h0_t[i];

  const int col = tid % H;
  const int row0 = tid / H;

  for (int l = 0; l < n_layers; ++l) {
    const bool first = (l == 0);
    if constexpr (MID) {  // K1m: layer split's input, complete since the last sync
      if (l == split) {
        float* mid_t = mid + tile * TILE * H;
        for (int i = tid; i < TILE * H; i += THREADS) mid_t[i] = s_h[i];
      }
    }
    load_message<H>(w, l, s_wmsg, s_bmsg, tid);
    __syncthreads();
    message_hw<H>(s_h, s_wmsg, s_bmsg, s_hw, tid);
    __syncthreads();
    aggregate<H>(first, adj_t, s_hw, s_m, s_nk, s_nv, s_nc, tid);
    __syncthreads();
    float z[R::RPT], r[R::RPT], n[R::RPT];
    gru_gates<H>(first, s_h, s_m, g, s_rs, z, r, n, tid);
    // h' = z n + (1-z) s; each thread rewrites only its own elements
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      const float s = first ? 0.0f : s_h[i * H + col];
      s_h[i * H + col] = z[k] * n[k] + (1.0f - z[k]) * s;
    }
    __syncthreads();
  }

  if constexpr (!READOUT) {
    float* out_t = out + tile * TILE * H;
    for (int i = tid; i < TILE * H; i += THREADS) out_t[i] = s_h[i];
  } else {
    float* s_wi = s_hw;              // (2H, D)
    float* s_wj = s_wi + 2 * H * D;  // (H, D)
    float* s_bi = s_wj + H * D;
    float* s_bj = s_bi + D;
    float* s_h0 = s_m;
    for (int i = tid; i < 2 * H * D; i += THREADS) s_wi[i] = ro.wi[i];
    for (int i = tid; i < H * D; i += THREADS) s_wj[i] = ro.wj[i];
    for (int i = tid; i < D; i += THREADS) { s_bi[i] = ro.bi[i]; s_bj[i] = ro.bj[i]; }
    for (int i = tid; i < TILE * H; i += THREADS) s_h0[i] = h0_t[i];
    __syncthreads();

    constexpr int ORS = THREADS / D;
    constexpr int ORPT = TILE / ORS;
    const int oc = tid % D;
    const int orow0 = tid / D;
    float gi[ORPT], gj[ORPT];
#pragma unroll
    for (int k = 0; k < ORPT; ++k) { gi[k] = s_bi[oc]; gj[k] = s_bj[oc]; }
#pragma unroll 2
    for (int d = 0; d < H; ++d) {
      const float wih = s_wi[d * D + oc], wi0 = s_wi[(H + d) * D + oc];
      const float wjh = s_wj[d * D + oc];
#pragma unroll
      for (int k = 0; k < ORPT; ++k) {
        const int i = orow0 + k * ORS;
        const float hv = s_h[i * H + d];
        gi[k] = fmaf(hv, wih, fmaf(s_h0[i * H + d], wi0, gi[k]));
        gj[k] = fmaf(hv, wjh, gj[k]);
      }
    }
    float* out_t = out + tile * TILE * D;
    const float* mask_t = ro.mask + tile * TILE;
#pragma unroll
    for (int k = 0; k < ORPT; ++k) {
      const int i = orow0 + k * ORS;
      out_t[i * D + oc] = sigmoidf(gi[k]) * gj[k] * mask_t[i];
    }
  }
}

template <int H, int D, bool READOUT, bool MID = false>
cudaError_t launch(const float* h0, const float* adj, const Weights& w,
                   const Readout& ro, float* out, int n_tiles, int n_layers,
                   cudaStream_t stream, float* mid = nullptr, int split = 0) {
  constexpr size_t bytes = Plan<H>::BYTES;
  static_assert(bytes <= 232448, "shared-memory plan exceeds 227 KB");
  static_assert(THREADS % H == 0 && TILE % (THREADS / H) == 0, "H");
  static_assert(THREADS % D == 0 && TILE % (THREADS / D) == 0, "D");
  static_assert(3 * H * D + 2 * D <= NE * TILE * H, "readout weights");
  static bool opted_in[MAX_DEVICES] = {};
  cudaError_t err = opt_in_smem(fused_ggnn_kernel<H, D, READOUT, MID>, bytes, opted_in);
  if (err != cudaSuccess) return err;
  fused_ggnn_kernel<H, D, READOUT, MID><<<n_tiles, THREADS, bytes, stream>>>(
      h0, adj, w, ro, out, mid, n_layers, split);
  return cudaGetLastError();
}

}  // namespace

// K1: h (P, T, H) after n_layers GGNN layers.  Returns a cudaError_t.
extern "C" int fused_ggnn_fwd(
    const float* h0, const float* adj, const float* msg_w, const float* msg_b,
    const float* wz, const float* uz, const float* bz,
    const float* wr, const float* ur, const float* br,
    const float* wn, const float* un, const float* bn,
    float* out, int n_tiles, int n_layers, int hidden, void* stream) {
  if (n_tiles <= 0 || n_layers <= 0) return int(cudaErrorInvalidValue);
  const Weights w = make_weights(msg_w, msg_b, wz, uz, bz, wr, ur, br, wn, un, bn);
  const Readout ro = {};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 16: return int(launch<16, 16, false>(h0, adj, w, ro, out, n_tiles, n_layers, st));
    case 32: return int(launch<32, 32, false>(h0, adj, w, ro, out, n_tiles, n_layers, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// K1m: K1's h (P, T, H) and h_mid (P, T, H), the input of layer split
// (0 < split < n_layers).  Returns a cudaError_t.
extern "C" int fused_ggnn_mid_fwd(
    const float* h0, const float* adj, const float* msg_w, const float* msg_b,
    const float* wz, const float* uz, const float* bz,
    const float* wr, const float* ur, const float* br,
    const float* wn, const float* un, const float* bn,
    float* out, float* mid, int n_tiles, int n_layers, int split, int hidden,
    void* stream) {
  if (n_tiles <= 0 || split <= 0 || split >= n_layers) return int(cudaErrorInvalidValue);
  const Weights w = make_weights(msg_w, msg_b, wz, uz, bz, wr, ur, br, wn, un, bn);
  const Readout ro = {};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 16: return int(launch<16, 16, false, true>(h0, adj, w, ro, out, n_tiles, n_layers, st, mid, split));
    case 32: return int(launch<32, 32, false, true>(h0, adj, w, ro, out, n_tiles, n_layers, st, mid, split));
    default: return int(cudaErrorInvalidValue);
  }
}

// K2: g_nodes (P, T, D) = the gated readout of K1's h.  Returns a cudaError_t.
extern "C" int fused_ggnn_readout_fwd(
    const float* h0, const float* adj, const float* msg_w, const float* msg_b,
    const float* wz, const float* uz, const float* bz,
    const float* wr, const float* ur, const float* br,
    const float* wn, const float* un, const float* bn,
    const float* mask, const float* wi, const float* bi,
    const float* wj, const float* bj,
    float* out, int n_tiles, int n_layers, int hidden, int out_dim,
    void* stream) {
  if (n_tiles <= 0 || n_layers <= 0) return int(cudaErrorInvalidValue);
  const Weights w = make_weights(msg_w, msg_b, wz, uz, bz, wr, ur, br, wn, un, bn);
  const Readout ro = {mask, wi, bi, wj, bj};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dim != hidden) return int(cudaErrorInvalidValue);
  switch (hidden) {
    case 16: return int(launch<16, 16, true>(h0, adj, w, ro, out, n_tiles, n_layers, st));
    case 32: return int(launch<32, 32, true>(h0, adj, w, ro, out, n_tiles, n_layers, st));
    default: return int(cudaErrorInvalidValue);
  }
}
