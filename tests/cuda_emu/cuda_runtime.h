// A CPU stand-in for the part of the CUDA runtime and device language that
// gcnbmp_tpu_torch/ops/csrc/fused_ggnn_bwd.cu uses, so that g++ can build
// the backward kernels' C entry points and the tests can run them on the
// CPU (tests/test_torch_bwd_emulated.py).  Each CUDA thread of a block is
// a std::thread; __syncthreads and the warp collectives are std::barriers.
// Blocks run one after another.  Shared memory is filled with NaN before
// each block, so a read of an entry no thread wrote shows in the results.
// The test rewrites `extern __shared__` and `<<<...>>>` launches into calls
// of this header before compiling.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }

struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }

struct EmuDim { unsigned x = 0, y = 0, z = 0; };
namespace emu {
inline thread_local EmuDim thread_idx, block_idx;
inline EmuDim block_dim;
inline std::vector<float> smem_store;
inline float* smem = nullptr;
inline std::unique_ptr<std::barrier<>> block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
inline std::vector<uint64_t> lanes;  // one exchange slot per thread

// every lane of the warp posts `bits` and reads lane `src`'s
inline uint64_t exchange(uint64_t bits, int src) {
  const int w = thread_idx.x / 32;
  lanes[thread_idx.x] = bits;
  warp_barriers[w]->arrive_and_wait();
  const uint64_t got = lanes[w * 32 + (src & 31)];
  warp_barriers[w]->arrive_and_wait();
  return got;
}
}  // namespace emu

#define threadIdx (emu::thread_idx)
#define blockIdx (emu::block_idx)
#define blockDim (emu::block_dim)

inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }

inline unsigned __ballot_sync(unsigned, int pred) {
  const int w = threadIdx.x / 32;
  emu::lanes[threadIdx.x] = pred ? 1 : 0;
  emu::warp_barriers[w]->arrive_and_wait();
  unsigned r = 0;
  for (int l = 0; l < 32; ++l)
    if (emu::lanes[w * 32 + l]) r |= 1u << l;
  emu::warp_barriers[w]->arrive_and_wait();
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

// kernel<<<grid, threads, smem_bytes, stream>>>(args...)
template <class K, class... A>
void emu_launch(K kernel, int grid, int threads, size_t smem_bytes,
                cudaStream_t, A... args) {
  emu::block_dim = {unsigned(threads), 1, 1};
  emu::smem_store.assign(smem_bytes / 4 + 4, 0.0f);
  emu::smem = emu::smem_store.data();
  for (int b = 0; b < grid; ++b) {
    std::fill(emu::smem_store.begin(), emu::smem_store.end(), std::nanf(""));
    emu::block_barrier = std::make_unique<std::barrier<>>(threads);
    emu::warp_barriers.clear();
    for (int w = 0; w < (threads + 31) / 32; ++w)
      emu::warp_barriers.push_back(std::make_unique<std::barrier<>>(32));
    emu::lanes.assign(threads, 0);
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([=]() {
        emu::block_idx = {unsigned(b), 0, 0};
        emu::thread_idx = {unsigned(t), 0, 0};
        kernel(args...);
      });
    for (auto& th : pool) th.join();
  }
}
