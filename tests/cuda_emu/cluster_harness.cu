// A test harness for the CPU stand-in's thread-block clusters
// (tests/cuda_emu/cuda_runtime.h), on which the H = 128 forward
// (fused_ggnn128_fwd.cuh) runs: clusters of two CTAs launched together by
// cudaLaunchKernelEx, each with a shared memory of its own, reading the
// peer's through cluster_map and meeting at the cluster barrier
// (cluster_arrive, cluster_wait).  tests/test_torch_cluster_emu.py holds
// a peer read, the barrier's ordering over rounds that reuse two buffers
// (as the forward's hw_e), the poison a CTA's shared memory takes when the
// CTA leaves, and a grid that the clusters do not divide, refused.
// Built only by tests/cuda_emu/emulate.py, against the CPU stand-in.

#include <chrono>
#include <cmath>
#include <thread>

#include "fused_ggnn_common.cuh"

namespace {

using namespace ggnn;

constexpr int N = 256;       // words of a CTA's buffer
constexpr int ROUNDS = 8;    // rounds of the peer kernel
constexpr int CTA_THREADS = 64;

// Round r: each CTA writes r 1e5 + rank 1e4 + i into its buffer r % 2, the
// cluster meets, then each reads the peer's buffer r % 2 into out (block,
// r, i).  A buffer is written again two rounds later, after the barrier
// of the round between: the peer's reads of it are done by then.
__global__ void peer_kernel(float* out) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const unsigned rank = cluster_rank();
  const float* peer = cluster_map(smem, rank ^ 1u);
  for (int r = 0; r < ROUNDS; ++r) {
    float* mine = smem + (r & 1) * N;
    for (int i = tid; i < N; i += CTA_THREADS) mine[i] = float(r * 100000 + rank * 10000 + i);
    cluster_arrive();
    cluster_wait();
    for (int i = tid; i < N; i += CTA_THREADS)
      out[(size_t(blockIdx.x) * ROUNDS + r) * N + i] = peer[(r & 1) * N + i];
  }
  // no CTA leaves while its peer may read its shared memory
  cluster_arrive();
  cluster_wait();
}

// Rank 0 writes its first word and leaves after the cluster barrier; rank
// 1's thread 0 reads that word (1 at first) until it turns NaN, the
// stand-in's poison of a CTA that has left, or 20 s pass: out[0] the first
// read, out[1] the last.
__global__ void leave_kernel(float* out) {
  extern __shared__ float smem[];
  const unsigned rank = cluster_rank();
  if (threadIdx.x == 0) smem[0] = 1.0f;
  cluster_arrive();
  cluster_wait();
  if (rank == 0 || threadIdx.x != 0) return;
  const volatile float* peer = cluster_map(smem, 0u);
  out[0] = peer[0];
  const auto end = std::chrono::steady_clock::now() + std::chrono::seconds(20);
  float v = peer[0];
  while (!std::isnan(v) && std::chrono::steady_clock::now() < end) {
    std::this_thread::yield();
    v = peer[0];
  }
  out[1] = v;
}

cudaError_t launch(void (*kernel)(float*), int grid, float* out) {
  cudaLaunchAttribute attr[1] = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(grid), 1, 1);
  cfg.blockDim = dim3(CTA_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 2 * N * 4;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, out);
}

}  // namespace

// peer_kernel over `clusters` clusters of two: out (2 clusters, ROUNDS, N).
extern "C" int cluster_peer(float* out, int clusters) {
  return int(launch(peer_kernel, 2 * clusters, out));
}

// leave_kernel on one cluster: out (2).
extern "C" int cluster_leave(float* out) { return int(launch(leave_kernel, 2, out)); }

// The words of the last cluster's CTA `rank` shared memory, as the stand-in
// holds it after the launch, into out (2 N).
extern "C" int cluster_smem(float* out, int rank) {
  const std::vector<float>& s = emu::cluster.ctas.at(size_t(rank))->smem;
  for (int i = 0; i < 2 * N; ++i) out[i] = s[size_t(i)];
  return 0;
}

// A launch of three CTAs in clusters of two; returns its cudaError_t.
extern "C" int cluster_odd_grid(float* out) { return int(launch(peer_kernel, 3, out)); }
