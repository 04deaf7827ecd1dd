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
// from L2 through two staged panels, the messages go one edge type at a
// time through one T x H buffer; 211,712 bytes of shared memory.  There
// every dense product (the messages h W_e, the GRU's x W{z,r,n}, s U{z,r},
// (r s) Un, the readout's [h, h0] Wi and h Wj) runs on the tensor cores in
// 3xTF32, as the reverse body's do (fused_ggnn_bwd.cu): about 2^-21 of each
// term is dropped (lo*lo), within the f32 bounds, and the correction terms
// sum in accumulators of their own (h64::tc_mma's SEP), which halves the
// crowded batch's K1 error against plain f32 for 1.5-2.3% of the time
// (chip_tc64.py phase 7, NVIDIA H100 80GB HBM3 at 700 W; 122-128
// registers a thread, no spill).  Each product covers the
// whole tile, so the two halves share each staged panel and each B
// fragment, and the products of h read it from the TF32 parts the threads
// that write h keep beside it, so that no h value is split more than once.
// The aggregation m += A_e hw_e stays in f32.
//
// At H = 128 (fused_ggnn_kernel128) one T x H buffer is 64 KB, and h, m and
// one hw_e beside the panels already exceed the CTA's 227 KB, so that width
// has a body of its own again (fused_ggnn128_fwd.cuh): a cluster of two
// CTAs per tile, each owning 64 rows (h, h's TF32 parts, m, r*s) and
// reading the peer's rows of hw_e through distributed shared memory in the
// aggregation; the same 3xTF32 products with SEP, hw_e by column halves,
// the GRU on the CTA's 64 rows at once; the weight blocks through a
// three-stage ring on mbarriers, each by one bulk copy from a blocked copy
// of the weights that block_weights128 makes before the body; 224,048
// bytes of shared memory a CTA.

#include "fused_ggnn128_fwd.cuh"

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
// two staged panels, the message step takes one edge type at a time, and
// every product covers the whole tile (the reverse body's recompute takes
// the same terms by halves).  Every dense product runs on the tensor cores
// in 3xTF32 (h64::Tc, the T x H buffers in its layout), h read from the
// TF32 parts its writers keep (t.hs).
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
                  reinterpret_cast<const int*>(smem + S::NC), smem + S::HS};
  float* s_bi = smem + S::BI;
  float* s_bj = smem + S::BJ;
  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;
  const float* h0_t = h0 + tile * TH;

  Panels p;
  panels_start<Tc>(p, smem + S::PANELS, msg_panel(w, 0, 0), tid);
  for (int i = tid; i < H; i += THREADS) {
    smem[S::BZ + i] = w.bz[i]; smem[S::BR + i] = w.br[i]; smem[S::BN + i] = w.bn[i];
    if (READOUT) { s_bi[i] = ro.bi[i]; s_bj[i] = ro.bj[i]; }
  }
  for (int i = tid; i < TH; i += THREADS) {
    const int at = Tc::at(i / H, i % H);
    t.h[at] = h0_t[i];
    split_store(t.hs, at, h0_t[i]);
  }
  scan_rows(t.adj_t, reinterpret_cast<Idx*>(smem + S::NK), smem + S::NV,
            reinterpret_cast<int*>(smem + S::NC), tid);
  __syncthreads();

#pragma unroll 1
  for (int l = 0; l < n_layers; ++l) {
    if constexpr (MID) {  // K1m: layer split's input
      if (l == split) {
        float* mid_t = mid + tile * TH;
        for (int i = tid; i < TH; i += THREADS) mid_t[i] = t.h[Tc::at(i / H, i % H)];
      }
    }
    const float* next = l + 1 < n_layers ? msg_panel(w, l + 1, 0)
                        : READOUT ? ro.wi : nullptr;
    layer_forward_tile(t, w, l, p, next, tid);
  }

  float* out_t = out + tile * TH;
  if constexpr (!READOUT) {
    for (int i = tid; i < TH; i += THREADS) out_t[i] = t.h[Tc::at(i / H, i % H)];
  } else {  // D = H
    // g = sigmoid([h, h0] Wi + bi) * (h Wj + bj) * mask, in registers
    float* s_h0 = t.m;
    for (int i = tid; i < TH; i += THREADS) s_h0[Tc::at(i / H, i % H)] = h0_t[i];
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

// The forward body at H = 128 (fused_ggnn128_fwd.cuh): a cluster of two
// CTAs per tile, rank r owning rows 64 r .. 64 r + 63, the aggregation
// reading the peer's rows of hw_e through distributed shared memory, the
// weight blocks through a three-stage ring on mbarriers.  Ends at a
// cluster barrier, so that no CTA leaves while its peer may read its
// shared memory.
template <bool READOUT, bool MID>
__global__ void __launch_bounds__(THREADS, 1)
fused_ggnn_kernel128(const float* __restrict__ h0, const float* __restrict__ adj,
                     Weights w, Readout ro, const float* __restrict__ blocked,
                     float* __restrict__ out, float* __restrict__ mid, int n_layers,
                     int split) {
  using namespace h128c;
  using S = Plan;
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int rank = int(cluster_rank());
  // the CTA's first row of the batch's (P T) rows
  const size_t row0 = size_t(blockIdx.x / CLUSTER) * TILE + size_t(rank) * ROWS;
  const Bufs t = {adj + row0 * ROW_LEN, smem + S::HIN, smem + S::HS, smem + S::MS,
                  smem + S::WORK, cluster_map(smem + S::WORK, unsigned(rank ^ 1)), rank,
                  smem + S::B_MSG, smem + S::BZ, smem + S::BR, smem + S::BN,
                  reinterpret_cast<const Idx*>(smem + S::NK), smem + S::NV,
                  reinterpret_cast<const int*>(smem + S::NC)};
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + S::BARS);
  Ring ring = {smem + S::STAGE0, bars, bars + STAGES, blocked, w, ro, n_layers,
               n_layers * LAYER_BLOCKS + (READOUT ? READOUT_BLOCKS : 0), 0};
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  ring.start(tid);
  const float* h0_rows = h0 + row0 * H;
  for (int i = tid; i < H; i += THREADS) {
    smem[S::BZ + i] = w.bz[i]; smem[S::BR + i] = w.br[i]; smem[S::BN + i] = w.bn[i];
    if (READOUT) { smem[S::BI + i] = ro.bi[i]; smem[S::BJ + i] = ro.bj[i]; }
  }
  for (int i = tid; i < NE * H; i += THREADS) t.bmsg[i] = w.msg_b[i];
  for (int i = tid; i < RH; i += THREADS) {
    const int at = h128::at(i / H, i % H);
    t.h[at] = h0_rows[i];
    split_store(t.hs, at, h0_rows[i]);
  }
  scan_rows<Idx, ROWS>(t.adj_t, reinterpret_cast<Idx*>(smem + S::NK), smem + S::NV,
                       reinterpret_cast<int*>(smem + S::NC), tid);
  __syncthreads();

#pragma unroll 1
  for (int l = 0; l < n_layers; ++l) {
    if constexpr (MID) {  // K1m: h_mid, the input of layer split, of the CTA's rows
      if (l == split) {
        float* mid_rows = mid + row0 * H;
        for (int i = tid; i < RH; i += THREADS) mid_rows[i] = t.h[h128::at(i / H, i % H)];
      }
    }
    layer_forward(t, l == 0, l + 1 < n_layers ? w.msg_b + size_t(l + 1) * NE * H : nullptr,
                  ring, tid);
  }

  float* out_rows = out + row0 * H;
  if constexpr (!READOUT) {
    for (int i = tid; i < RH; i += THREADS) out_rows[i] = t.h[h128::at(i / H, i % H)];
  } else {  // D = H; h0 where m was
    float* s_h0 = t.m;
    for (int i = tid; i < RH; i += THREADS) s_h0[h128::at(i / H, i % H)] = h0_rows[i];
    __syncthreads();
    readout(t, s_h0, smem + S::BI, smem + S::BJ, ro.mask + row0, out_rows, ring, tid);
  }
  cluster_arrive();
  cluster_wait();
}

// The blocked copy of the H = 128 forward's weights (h128c::distinct_blocks),
// one CTA a block: block b at blocked + b PANEL in the staged layout.
__global__ void block_weights128(Weights w, Readout ro, int n_layers, float* blocked) {
  const float* src = h128c::block(w, ro, n_layers, h128c::first_use(n_layers, blockIdx.x));
  float* dst = blocked + size_t(blockIdx.x) * h64::PANEL;
  for (int i = threadIdx.x; i < h64::PANEL; i += blockDim.x)
    dst[h64::Tc::panel_at(i / h64::H, i % h64::H)] = src[(i / h64::H) * h128::H + i % h64::H];
}

// A launch of the H = 128 forward: a cluster of two CTAs per tile.
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int n_tiles, size_t bytes, cudaStream_t stream) : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = h128c::CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(unsigned(n_tiles) * h128c::CLUSTER, 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The weights' blocked copy goes to `blocked` (the caller's scratch of
// h128c::distinct_blocks(n_layers, READOUT) blocks of PANEL words) on the
// stream before the body reads it.  A cluster launch the card refuses
// returns its error: nothing takes another body in its place.
template <bool READOUT, bool MID = false>
cudaError_t launch128(const float* h0, const float* adj, const Weights& w,
                      const Readout& ro, float* blocked, float* out, int n_tiles,
                      int n_layers, cudaStream_t stream, float* mid = nullptr,
                      int split = 0) {
  if (!h64::panels_aligned(w, READOUT ? &ro : nullptr) || blocked == nullptr)
    return cudaErrorInvalidValue;
  constexpr size_t bytes = h128c::Plan::BYTES;
  static bool opted_in[MAX_DEVICES] = {};
  cudaError_t err = opt_in_smem(fused_ggnn_kernel128<READOUT, MID>, bytes, opted_in);
  if (err != cudaSuccess) return err;
  block_weights128<<<h128c::distinct_blocks(n_layers, READOUT), 128, 0, stream>>>(
      w, ro, n_layers, blocked);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const ClusterLaunch launch(n_tiles, bytes, stream);
  err = cudaLaunchKernelEx(&launch.cfg, fused_ggnn_kernel128<READOUT, MID>, h0, adj, w, ro,
                           static_cast<const float*>(blocked), out, mid, n_layers, split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// K1: h (P, T, H) after n_layers GGNN layers.  `blocked`: at H = 128 the
// scratch of the weights' blocked copy (h128c::distinct_blocks(n_layers,
// false) blocks of 64 x 64 floats), unread at the other widths.  Returns a
// cudaError_t.
extern "C" int fused_ggnn_fwd(
    const float* h0, const float* adj, const float* msg_w, const float* msg_b,
    const float* wz, const float* uz, const float* bz,
    const float* wr, const float* ur, const float* br,
    const float* wn, const float* un, const float* bn,
    float* out, float* blocked, int n_tiles, int n_layers, int hidden, void* stream) {
  if (n_tiles <= 0 || n_layers <= 0) return int(cudaErrorInvalidValue);
  const Weights w = make_weights(msg_w, msg_b, wz, uz, bz, wr, ur, br, wn, un, bn);
  const Readout ro = {};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 16: return int(launch<16, false>(h0, adj, w, ro, out, n_tiles, n_layers, st));
    case 32: return int(launch<32, false>(h0, adj, w, ro, out, n_tiles, n_layers, st));
    case 64: return int(launch64<false>(h0, adj, w, ro, out, n_tiles, n_layers, st));
    case 128: return int(launch128<false>(h0, adj, w, ro, blocked, out, n_tiles, n_layers, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// K1m: K1's h (P, T, H) and h_mid (P, T, H), the input of layer split
// (0 < split < n_layers); `blocked` as K1's.  Returns a cudaError_t.
extern "C" int fused_ggnn_mid_fwd(
    const float* h0, const float* adj, const float* msg_w, const float* msg_b,
    const float* wz, const float* uz, const float* bz,
    const float* wr, const float* ur, const float* br,
    const float* wn, const float* un, const float* bn,
    float* out, float* mid, float* blocked, int n_tiles, int n_layers, int split,
    int hidden, void* stream) {
  if (n_tiles <= 0 || split <= 0 || split >= n_layers) return int(cudaErrorInvalidValue);
  const Weights w = make_weights(msg_w, msg_b, wz, uz, bz, wr, ur, br, wn, un, bn);
  const Readout ro = {};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 16: return int(launch<16, false, true>(h0, adj, w, ro, out, n_tiles, n_layers, st, mid, split));
    case 32: return int(launch<32, false, true>(h0, adj, w, ro, out, n_tiles, n_layers, st, mid, split));
    case 64: return int(launch64<false, true>(h0, adj, w, ro, out, n_tiles, n_layers, st, mid, split));
    case 128: return int(launch128<false, true>(h0, adj, w, ro, blocked, out, n_tiles, n_layers, st, mid, split));
    default: return int(cudaErrorInvalidValue);
  }
}

// K2: g_nodes (P, T, D) = the gated readout of K1's h; `blocked` as K1's,
// of h128c::distinct_blocks(n_layers, true) blocks.  Returns a cudaError_t.
extern "C" int fused_ggnn_readout_fwd(
    const float* h0, const float* adj, const float* msg_w, const float* msg_b,
    const float* wz, const float* uz, const float* bz,
    const float* wr, const float* ur, const float* br,
    const float* wn, const float* un, const float* bn,
    const float* mask, const float* wi, const float* bi,
    const float* wj, const float* bj,
    float* out, float* blocked, int n_tiles, int n_layers, int hidden, int out_dim,
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
    case 128: return int(launch128<true>(h0, adj, w, ro, blocked, out, n_tiles, n_layers, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// The clusters of the H = 128 forward (K2's instance: two CTAs of 512
// threads and h128c::Plan's shared memory each) that the device holds at
// once (cudaOccupancyMaxActiveClusters) into *clusters.  Returns a
// cudaError_t.
extern "C" int fused_ggnn128_clusters(int* clusters) {
  constexpr size_t bytes = h128c::Plan::BYTES;
  static bool opted_in[MAX_DEVICES] = {};
  cudaError_t err = opt_in_smem(fused_ggnn_kernel128<true, false>, bytes, opted_in);
  if (err != cudaSuccess) return int(err);
  const ClusterLaunch launch(1, bytes, nullptr);
  return int(cudaOccupancyMaxActiveClusters(clusters, fused_ggnn_kernel128<true, false>,
                                            &launch.cfg));
}
