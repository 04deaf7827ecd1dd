// A CPU stand-in for the part of the CUDA runtime and device language that
// the kernels of gcnbmp_tpu_torch/ops/csrc/ (fused_ggnn.cu,
// fused_ggnn_bwd.cu, fused_mpnn.cu, set2set.cu) use, so that g++ can build
// their C entry points and the tests can run them on the CPU
// (tests/test_torch_bwd_emulated.py, tests/test_torch_mpnn_emulated.py,
// tests/test_torch_fwd_emulated.py).
// Each CUDA thread of a block is a std::thread; __syncthreads, __syncwarp,
// named barriers and the warp collectives are std::barriers.  Blocks run
// one after another, or with a cluster launch (cudaLaunchKernelEx with a
// cluster dimension) the CTAs of one cluster together, each with a shared
// memory of its own, and the clusters one after another.  Shared memory is
// filled with NaN before each block, so a read of an entry no thread wrote
// shows in the results, and again when the block's last thread returns, so
// that a read of a peer's shared memory after the peer has left shows too.
// The device has EMU_SMS multiprocessors, each holding one block.
// emulate.py rewrites `extern __shared__` and `<<<...>>>` launches into
// calls of this header before compiling.  The PTX wrappers of
// fused_ggnn_common.cuh (named barriers, mbarriers, bulk copies, the
// cluster's rank, address mapping and barrier) and of fused_ggnn64.cuh (the
// warp's m16n8k8 TF32 product and its ldmatrix loads) are defined here for
// the CPU.
#pragma once

#include <algorithm>
#include <array>
#include <atomic>
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <optional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)

using std::max;
using std::min;

constexpr int EMU_SMS = 3;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
// the launch configuration of cudaLaunchKernelEx, its cluster dimension
// the only attribute the stand-in reads
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
union cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = EMU_SMS;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}

struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// shared-memory atomics: the threads of a block are threads here too
template <class T> inline T atomicAdd(T* p, T v) {
  return std::atomic_ref<T>(*p).fetch_add(v);
}
template <class T> inline T atomicOr(T* p, T v) {
  return std::atomic_ref<T>(*p).fetch_or(v);
}
// cp.async through CUDA's pipeline primitives, synchronous here: the copy
// is done when the call returns, so commit and wait have nothing to do.
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size,
                                    size_t = 0) {
  std::memcpy(dst, src, size);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}

// the built-in variables (variables, not macros: a launch configuration
// has members of the same names)
struct EmuDim { unsigned x = 0, y = 0, z = 0; };
inline thread_local EmuDim threadIdx, blockIdx;
inline EmuDim blockDim, gridDim;
namespace emu {
// mbarriers of the running blocks, by address: the phase parity, arrivals
// still expected in this phase and bytes still to land
struct Mbar { unsigned count = 0, pending = 0, phase = 0; long long tx = 0; };
// what one running block owns: its shared memory, its barriers and the
// warps' exchange slots
struct Cta {
  std::vector<float> smem;
  std::unique_ptr<std::barrier<>> block_barrier;
  std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
  std::vector<uint64_t> lanes;  // one exchange slot per thread
  // the warp products' fragments (a0..a3, b0, b1), one slot per thread in
  // each of two sets used in turns, so one barrier per product suffices
  std::vector<std::array<float, 6>> frags[2];
  // the row addresses of the warps' ldmatrix loads, likewise
  std::vector<const float*> ldsm_rows[2];
  // named barriers, made at first use with the thread count their first
  // caller gives
  std::mutex named_mu;
  std::unique_ptr<std::barrier<>> named[16];
  std::atomic<int> running{0};  // threads not yet returned
  unsigned rank = 0;            // in its cluster
};
// the CTAs of the running cluster and its barrier
struct Cluster {
  std::vector<std::unique_ptr<Cta>> ctas;
  std::unique_ptr<std::barrier<>> barrier;
};
inline Cluster cluster;
inline thread_local Cta* cta = nullptr;
inline thread_local float* smem = nullptr;
inline thread_local unsigned frag_set = 0;
inline thread_local unsigned ldsm_set = 0;
inline thread_local std::optional<std::barrier<>::arrival_token> cluster_token;
inline std::mutex mbar_mu;
inline std::condition_variable mbar_cv;
inline std::map<const void*, Mbar> mbars;

inline void mbar_step(Mbar& m) {  // under mbar_mu
  if (m.pending == 0 && m.tx == 0) {
    m.phase ^= 1u;
    m.pending = m.count;
    mbar_cv.notify_all();
  }
}

// every lane of the warp posts `bits` and reads lane `src`'s
inline uint64_t exchange(uint64_t bits, int src) {
  const int w = threadIdx.x / 32;
  cta->lanes[threadIdx.x] = bits;
  cta->warp_barriers[w]->arrive_and_wait();
  const uint64_t got = cta->lanes[w * 32 + (src & 31)];
  cta->warp_barriers[w]->arrive_and_wait();
  return got;
}
}  // namespace emu

inline void __syncthreads() { emu::cta->block_barrier->arrive_and_wait(); }

inline void __syncwarp(unsigned = 0xffffffffu) {
  emu::cta->warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}

inline unsigned __ballot_sync(unsigned, int pred) {
  const int w = threadIdx.x / 32;
  emu::cta->lanes[threadIdx.x] = pred ? 1 : 0;
  emu::cta->warp_barriers[w]->arrive_and_wait();
  unsigned r = 0;
  for (int l = 0; l < 32; ++l)
    if (emu::cta->lanes[w * 32 + l]) r |= 1u << l;
  emu::cta->warp_barriers[w]->arrive_and_wait();
  return r;
}

template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) <= 8, "shuffle of a scalar");
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  bits = emu::exchange(bits, src);
  T r;
  std::memcpy(&r, &bits, sizeof(T));
  return r;
}

template <class T>
inline T __shfl_up_sync(unsigned mask, T v, unsigned off) {
  const int lane = threadIdx.x % 32;
  return __shfl_sync(mask, v, lane >= int(off) ? lane - int(off) : lane);
}

template <class T>
inline T __shfl_xor_sync(unsigned mask, T v, int lane_mask) {
  return __shfl_sync(mask, v, (threadIdx.x % 32) ^ lane_mask);
}

// the bits of a float as an unsigned int, and back
inline unsigned __float_as_uint(float v) {
  unsigned u;
  std::memcpy(&u, &v, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float v;
  std::memcpy(&v, &u, 4);
  return v;
}

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d += a b, with the
// PTX fragment layouts: lane (g, q) = (lane / 4, lane % 4) holds A's rows
// g, g + 8 at depths q, q + 4 (a0: g q, a1: g + 8 q, a2: g q + 4, a3:
// g + 8 q + 4), B's depths q, q + 4 at column g (b0, b1) and D's rows g,
// g + 8 at columns 2q, 2q + 1 (d0 d1 d2 d3).  Every lane posts its
// fragments, the warp meets at its barrier, and each lane sums its four
// outputs over the depth in f32 from the posted fragments (the products
// of TF32 values are exact in f32).
inline void mma_tf32(float* d, const float* a, const float* b) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  auto& set = emu::cta->frags[emu::frag_set];
  emu::frag_set ^= 1u;
  set[t] = {a[0], a[1], a[2], a[3], b[0], b[1]};
  emu::cta->warp_barriers[w]->arrive_and_wait();
  const int g = lane / 4, q = lane % 4;
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i >> 1), c = 2 * q + (i & 1);
    float s = d[i];
    for (int k = 0; k < 8; ++k) {
      const float av = set[w * 32 + (r % 8) * 4 + k % 4][(r / 8) + 2 * (k / 4)];
      const float bv = set[w * 32 + c * 4 + k % 4][4 + k / 4];
      s += av * bv;
    }
    d[i] = s;
  }
}

// ldmatrix.sync.aligned.m8n8.x4.shared.b16 of 32-bit words: lane 8j + r
// posts the address of row r of block j (four words); lane (g, q) =
// (lane / 4, lane % 4) reads word q of row g of each block j into r[j].
inline void ldsm_x4(float (&r)[4], const float* p) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  auto& rows = emu::cta->ldsm_rows[emu::ldsm_set];
  emu::ldsm_set ^= 1u;
  rows[t] = p;
  emu::cta->warp_barriers[w]->arrive_and_wait();
  for (int j = 0; j < 4; ++j) r[j] = rows[w * 32 + 8 * j + lane / 4][lane % 4];
}

// bar.sync id, threads
inline void named_sync(int id, int threads) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> g(emu::cta->named_mu);
    auto& nb = emu::cta->named[id];
    if (!nb) nb = std::make_unique<std::barrier<>>(threads);
    b = nb.get();
  }
  b->arrive_and_wait();
}

// mbarrier init, arrive with an expected byte count, and wait on a phase
// parity; a bulk copy is a memcpy that then completes its bytes.
inline void mbar_init(unsigned long long* bar, unsigned count) {
  std::lock_guard<std::mutex> g(emu::mbar_mu);
  emu::mbars[bar] = emu::Mbar{count, count, 0, 0};
}
inline void mbar_fence_init() {}
inline void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  std::lock_guard<std::mutex> g(emu::mbar_mu);
  emu::Mbar& m = emu::mbars.at(bar);
  m.tx += bytes;
  --m.pending;
  emu::mbar_step(m);
}
inline void mbar_wait(unsigned long long* bar, unsigned parity) {
  std::unique_lock<std::mutex> g(emu::mbar_mu);
  emu::mbar_cv.wait(g, [&] { return emu::mbars.at(bar).phase != parity; });
}
inline void bulk_copy(void* dst, const void* src, unsigned bytes, unsigned long long* bar) {
  std::memcpy(dst, src, bytes);
  std::lock_guard<std::mutex> g(emu::mbar_mu);
  emu::Mbar& m = emu::mbars.at(bar);
  m.tx -= bytes;
  emu::mbar_step(m);
}
inline void fence_proxy_async() {}
inline void mbar_arrive(unsigned long long* bar) {
  std::lock_guard<std::mutex> g(emu::mbar_mu);
  emu::Mbar& m = emu::mbars.at(bar);
  --m.pending;
  emu::mbar_step(m);
}

// the cluster: the CTA's rank, an address of its shared memory in the CTA
// `rank`'s, and the cluster barrier (std::barrier's arrive and wait)
inline unsigned cluster_rank() { return emu::cta->rank; }
template <class T>
inline T* cluster_map(T* p, unsigned rank) {
  const char* here = reinterpret_cast<const char*>(emu::cta->smem.data());
  char* there = reinterpret_cast<char*>(emu::cluster.ctas.at(rank)->smem.data());
  return reinterpret_cast<T*>(there + (reinterpret_cast<const char*>(p) - here));
}
inline void cluster_arrive() { emu::cluster_token = emu::cluster.barrier->arrive(); }
inline void cluster_wait() {
  emu::cluster.barrier->wait(std::move(*emu::cluster_token));
  emu::cluster_token.reset();
}

// The blocks [first, first + size) of a launch of `grid` blocks run
// together as one cluster, each block's threads std::threads.
template <class K, class... A>
void emu_run_cluster(K kernel, int first, int size, int threads, size_t smem_bytes,
                     A... args) {
  emu::Cluster& c = emu::cluster;
  c.ctas.clear();
  c.barrier = std::make_unique<std::barrier<>>(size * threads);
  {
    std::lock_guard<std::mutex> g(emu::mbar_mu);
    emu::mbars.clear();
  }
  for (int r = 0; r < size; ++r) {
    auto cta = std::make_unique<emu::Cta>();
    cta->smem.assign(smem_bytes / 4 + 4, std::nanf(""));
    cta->block_barrier = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < (threads + 31) / 32; ++w)
      cta->warp_barriers.push_back(std::make_unique<std::barrier<>>(32));
    cta->lanes.assign(threads, 0);
    for (auto& f : cta->frags) f.assign(threads, {});
    for (auto& rows : cta->ldsm_rows) rows.assign(threads, nullptr);
    cta->running = threads;
    cta->rank = unsigned(r);
    c.ctas.push_back(std::move(cta));
  }
  std::vector<std::thread> pool;
  pool.reserve(size_t(size) * threads);
  for (int r = 0; r < size; ++r)
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([=]() {
        emu::Cta* me = emu::cluster.ctas[r].get();
        emu::cta = me;
        emu::smem = me->smem.data();
        emu::frag_set = emu::ldsm_set = 0;
        blockIdx = {unsigned(first + r), 0, 0};
        threadIdx = {unsigned(t), 0, 0};
        kernel(args...);
        // the block's last thread to return poisons its shared memory
        if (me->running.fetch_sub(1) == 1)
          std::fill(me->smem.begin(), me->smem.end(), std::nanf(""));
      });
  for (auto& th : pool) th.join();
}

// kernel<<<grid, threads, smem_bytes, stream>>>(args...): blocks one at a time
template <class K, class... A>
void emu_launch(K kernel, int grid, int threads, size_t smem_bytes,
                cudaStream_t, A... args) {
  blockDim = {unsigned(threads), 1, 1};
  gridDim = {unsigned(grid), 1, 1};
  for (int b = 0; b < grid; ++b) emu_run_cluster(kernel, b, 1, threads, smem_bytes, args...);
}

// cudaLaunchKernelEx: clusters of the attribute's x dimension (1 without
// it), one cluster at a time; a grid that clusters do not divide is refused
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...),
                               A&&... args) {
  int size = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      size = int(cfg->attrs[i].val.clusterDim.x);
  const int grid = int(cfg->gridDim.x), threads = int(cfg->blockDim.x);
  if (size < 1 || grid % size != 0) return cudaErrorInvalidValue;
  blockDim = {unsigned(threads), 1, 1};
  gridDim = {unsigned(grid), 1, 1};
  for (int b = 0; b < grid; b += size)
    emu_run_cluster(kernel, b, size, threads, cfg->dynamicSmemBytes, P(args)...);
  return cudaSuccess;
}

// clusters the stand-in's device holds at once: one block per
// multiprocessor
template <class K>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, K, const cudaLaunchConfig_t* cfg) {
  int size = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      size = int(cfg->attrs[i].val.clusterDim.x);
  *n = EMU_SMS / size;
  return cudaSuccess;
}
