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
// - The adjacency is ~0.4% dense.  Before the first layer the kernel reads
//   each adjacency row once from global memory (scan_rows: 16 coalesced
//   128-byte loads per row, all issued before the scan, a warp per row),
//   finds the nonzeros with a warp ballot and keeps up to NBR_CAP
//   (column, value) pairs per row in shared memory.  Every layer gathers
//   through those lists; a row with more nonzeros than NBR_CAP rescans its
//   dense row every layer, so any input is handled exactly.  The
//   adjacency therefore costs one pass over global memory per forward
//   instead of one per layer, and the aggregation's work scales with the
//   number of edges, not with 128 x 512.
// - Everything else is small dense products (H <= 32 wide), bound by
//   shared-memory bandwidth: an SM's shared memory serves one 128-byte
//   wavefront per clock where its f32 pipes take four warp FMAs.  All
//   weights (their rows padded to H + 4 words, so that one chunk of the
//   rows of consecutive columns falls in distinct banks), h, m and the
//   four hw_e blocks stay in shared memory (about 172 KB at H = 32), so one
//   CTA of 512 threads (16 warps) fits an SM.  Each thread owns one column
//   and a strided set of rows, and every product is register-blocked: per
//   chunk of four reduction steps a thread loads the weights of all four
//   edge types (of all three gates) once and one 16-byte broadcast of each
//   of its rows, and issues all its FMAs from registers.  Arithmetic is
//   plain f32 (no TF32, no tensor cores), matching the JAX package's
//   default f32 matmuls.
// - Each layer has its own message weights (16 KB at H = 32): the next
//   layer's load by cp.async into the same buffer once the layer's
//   messages have read it, and arrive while the layer aggregates and
//   gates.
// The layer's steps (edge_hw, aggregate, ggnn_gates, readout_pre) live in
// fused_ggnn_common.cuh, and the backward kernels (fused_ggnn_bwd.cu)
// recompute this forward with the same copies: K1's h is bit for bit what
// the backward recomputes.
// Later work: tensor cores (wgmma) for the dense products, and more CTAs
// per SM by shrinking the shared-memory plan.
//
// At H = 64 (fused_ggnn_kernel64) the plan above would take 442 KB, so
// that width has a body of its own (fused_ggnn64.cuh): the weights stream
// from L2 through two staged 17 KB panels, the messages go one edge type
// at a time through one T x H buffer, the GRU one half of the tile at a
// time; 148,224 bytes of shared memory, the same arithmetic in plain f32.

#include "fused_ggnn64.cuh"

namespace {

using namespace ggnn;

// One CTA per SM (the shared-memory plan), so up to 128 registers a thread.
template <int H, bool READOUT, bool MID>
__global__ void __launch_bounds__(THREADS, 1)
fused_ggnn_kernel(const float* __restrict__ h0, const float* __restrict__ adj,
                  Weights w, Readout ro, float* __restrict__ out,
                  float* __restrict__ mid, int n_layers, int split) {
  using S = GgnnPlan<H, false>;
  using R = Rows<H>;
  constexpr int HP = S::HP;
  extern __shared__ float smem[];
  float* s_wmsg = smem + S::W_MSG;
  float* s_bmsg = smem + S::B_MSG;
  const GruSmem g = {smem + S::WZ, smem + S::WR, smem + S::WN,
                     smem + S::UZ, smem + S::UR, smem + S::UN,
                     smem + S::BZ, smem + S::BR, smem + S::BN};
  float* s_h = smem + S::HIN;
  float* s_m = smem + S::MS;
  float* s_hw = smem + S::BIG;
  float* s_rs = s_hw;  // r*s reuses the hw stack once m is built
  float* s_nv = smem + S::NV;
  int* s_nk = reinterpret_cast<int*>(smem + S::NK);
  int* s_nc = reinterpret_cast<int*>(smem + S::NC);

  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;
  const float* h0_t = h0 + tile * TILE * H;
  const float* adj_t = adj + tile * TILE * ROW_LEN;

  load_gru_padded<H>(w, g, tid);
  load_message_padded<H>(w, 0, s_wmsg, s_bmsg, tid);
  for (int i = tid; i < TILE * H; i += THREADS) s_h[i] = h0_t[i];
  scan_rows(adj_t, s_nk, s_nv, s_nc, tid);  // read after the loop's first sync

  const int col = tid % H;
  const int row0 = tid / H;

  for (int l = 0; l < n_layers; ++l) {
    const bool first = (l == 0);  // the zero state
    if constexpr (MID) {  // K1m: layer split's input, complete since the last sync
      if (l == split) {
        float* mid_t = mid + tile * TILE * H;
        for (int i = tid; i < TILE * H; i += THREADS) mid_t[i] = s_h[i];
      }
    }
    __pipeline_wait_prior(0);  // layer l's message weights
    __syncthreads();
    edge_hw<H>(s_h, s_wmsg, s_bmsg, s_hw, tid);
    __syncthreads();
    // the message weights are read: layer l + 1's load (cp.async) while
    // this layer aggregates and gates
    if (l + 1 < n_layers)
      load_message_padded<H, true>(w, l + 1, s_wmsg, s_bmsg, tid);
    __pipeline_commit();
    aggregate<H>(adj_t, s_hw, s_m, s_nk, s_nv, s_nc, tid);
    __syncthreads();
    float z[R::RPT], r[R::RPT], n[R::RPT];
    ggnn_gates<H>(first, s_h, s_m, g, s_rs, z, r, n, tid);
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
  } else {  // D = H
    float* s_wi = s_hw;              // (2H, HP): Wi (2H, D), rows padded
    float* s_wj = s_wi + 2 * H * HP;  // (H, HP)
    float* s_bi = s_wj + H * HP;
    float* s_bj = s_bi + H;
    float* s_h0 = s_m;
    static_assert(3 * H * HP + 2 * H <= NE * TILE * H, "readout weights");
    load_padded<H>(ro.wi, s_wi, 2 * H, tid);
    load_padded<H>(ro.wj, s_wj, H, tid);
    for (int i = tid; i < H; i += THREADS) { s_bi[i] = ro.bi[i]; s_bj[i] = ro.bj[i]; }
    for (int i = tid; i < TILE * H; i += THREADS) s_h0[i] = h0_t[i];
    __syncthreads();
    float gi[R::RPT], gj[R::RPT];
    readout_pre<H>(s_h, s_h0, s_wi, s_wj, s_bi, s_bj, gi, gj, tid);
    float* out_t = out + tile * TILE * H;
    const float* mask_t = ro.mask + tile * TILE;
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      out_t[i * H + col] = sigmoidf(gi[k]) * gj[k] * mask_t[i];
    }
  }
}

template <int H, bool READOUT, bool MID = false>
cudaError_t launch(const float* h0, const float* adj, const Weights& w,
                   const Readout& ro, float* out, int n_tiles, int n_layers,
                   cudaStream_t stream, float* mid = nullptr, int split = 0) {
  constexpr size_t bytes = GgnnPlan<H, false>::BYTES;
  static_assert(bytes <= 232448, "shared-memory plan exceeds 227 KB");
  static bool opted_in[MAX_DEVICES] = {};
  cudaError_t err = opt_in_smem(fused_ggnn_kernel<H, READOUT, MID>, bytes, opted_in);
  if (err != cudaSuccess) return err;
  fused_ggnn_kernel<H, READOUT, MID><<<n_tiles, THREADS, bytes, stream>>>(
      h0, adj, w, ro, out, mid, n_layers, split);
  return cudaGetLastError();
}

// The forward body at H = 64 (fused_ggnn64.cuh): the weights pass through
// two staged panels, the message step takes one edge type at a time and
// the GRU one half of the tile at a time; the same steps as the reverse
// body's recompute.
template <bool READOUT, bool MID>
__global__ void __launch_bounds__(THREADS, 1)
fused_ggnn_kernel64(const float* __restrict__ h0, const float* __restrict__ adj,
                    Weights w, Readout ro, float* __restrict__ out,
                    float* __restrict__ mid, int n_layers, int split) {
  using namespace h64;
  using S = Plan<false>;
  extern __shared__ float smem[];
  const Tile t = {adj + size_t(blockIdx.x) * TILE * ROW_LEN,
                  smem + S::HIN, smem + S::MS, smem + S::WORK, smem + S::B_MSG,
                  smem + S::BZ, smem + S::BR, smem + S::BN,
                  reinterpret_cast<const Idx*>(smem + S::NK), smem + S::NV,
                  reinterpret_cast<const int*>(smem + S::NC)};
  float* s_bi = smem + S::BI;
  float* s_bj = smem + S::BJ;
  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;
  const float* h0_t = h0 + tile * TH;

  Panels p;
  panels_start(p, smem + S::PANELS, msg_panel(w, 0, 0), tid);
  for (int i = tid; i < H; i += THREADS) {
    smem[S::BZ + i] = w.bz[i]; smem[S::BR + i] = w.br[i]; smem[S::BN + i] = w.bn[i];
    if (READOUT) { s_bi[i] = ro.bi[i]; s_bj[i] = ro.bj[i]; }
  }
  for (int i = tid; i < TH; i += THREADS) t.h[i] = h0_t[i];
  scan_rows(t.adj_t, reinterpret_cast<Idx*>(smem + S::NK), smem + S::NV,
            reinterpret_cast<int*>(smem + S::NC), tid);
  __syncthreads();

#pragma unroll 1
  for (int l = 0; l < n_layers; ++l) {
    if constexpr (MID) {  // K1m: layer split's input
      if (l == split) {
        float* mid_t = mid + tile * TH;
        for (int i = tid; i < TH; i += THREADS) mid_t[i] = t.h[i];
      }
    }
    const float* next = l + 1 < n_layers ? msg_panel(w, l + 1, 0)
                        : READOUT ? ro.wi : nullptr;
    layer_forward(t, w, l, p, next, tid);
  }

  float* out_t = out + tile * TH;
  if constexpr (!READOUT) {
    for (int i = tid; i < TH; i += THREADS) out_t[i] = t.h[i];
  } else {  // D = H
    float* s_h0 = t.m;
    for (int i = tid; i < TH; i += THREADS) s_h0[i] = h0_t[i];
    readout_gate(t.h, s_h0, ro, s_bi, t.work, p, tid);
    const float* wj = panels_next(p, ro.wj, nullptr, tid);
    const float* mask_t = ro.mask + tile * TILE;
    const int col = tid % H, r0 = tid / H;
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float gj[RPH];
#pragma unroll
      for (int k = 0; k < RPH; ++k) gj[k] = s_bj[col];
      xw<RPH>(t.h + hf * HALF * H, wj, col, r0, gj);
#pragma unroll
      for (int k = 0; k < RPH; ++k) {
        const int i = hf * HALF + r0 + RS * k;
        out_t[i * H + col] = t.work[i * H + col] * gj[k] * mask_t[i];
      }
    }
  }
}

template <bool READOUT, bool MID = false>
cudaError_t launch64(const float* h0, const float* adj, const Weights& w,
                     const Readout& ro, float* out, int n_tiles, int n_layers,
                     cudaStream_t stream, float* mid = nullptr, int split = 0) {
  if (!h64::panels_aligned(w, READOUT ? &ro : nullptr)) return cudaErrorInvalidValue;
  constexpr size_t bytes = h64::Plan<false>::BYTES;
  static bool opted_in[MAX_DEVICES] = {};
  cudaError_t err = opt_in_smem(fused_ggnn_kernel64<READOUT, MID>, bytes, opted_in);
  if (err != cudaSuccess) return err;
  fused_ggnn_kernel64<READOUT, MID><<<n_tiles, THREADS, bytes, stream>>>(
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
    case 16: return int(launch<16, false>(h0, adj, w, ro, out, n_tiles, n_layers, st));
    case 32: return int(launch<32, false>(h0, adj, w, ro, out, n_tiles, n_layers, st));
    case 64: return int(launch64<false>(h0, adj, w, ro, out, n_tiles, n_layers, st));
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
    case 16: return int(launch<16, false, true>(h0, adj, w, ro, out, n_tiles, n_layers, st, mid, split));
    case 32: return int(launch<32, false, true>(h0, adj, w, ro, out, n_tiles, n_layers, st, mid, split));
    case 64: return int(launch64<false, true>(h0, adj, w, ro, out, n_tiles, n_layers, st, mid, split));
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
    case 16: return int(launch<16, true>(h0, adj, w, ro, out, n_tiles, n_layers, st));
    case 32: return int(launch<32, true>(h0, adj, w, ro, out, n_tiles, n_layers, st));
    case 64: return int(launch64<true>(h0, adj, w, ro, out, n_tiles, n_layers, st));
    default: return int(cudaErrorInvalidValue);
  }
}
