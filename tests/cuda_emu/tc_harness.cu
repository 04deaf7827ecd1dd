// A test harness for the 3xTF32 tensor-core products of fused_ggnn64.cuh
// (h64::Tc): one CTA loads two (64, 64) operands a and b from global memory
// into shared memory in the Tc layout (b also through the weight panels,
// as the reverse body stages its weights), takes the three products the
// reverse body uses and writes them back row-major, so that
// tests/test_torch_bwd_emulated.py can hold them against float64 products.
// Built only by tests/cuda_emu/emulate.py, against the CPU stand-in.

#include "fused_ggnn64.cuh"

namespace {

using namespace ggnn;
using namespace ggnn::h64;

// shared-memory plan in words: a, b (Tc layout), two panels
constexpr int A = 0, B = A + H * H, PANELS = B + H * H, WORDS = PANELS + 2 * PANEL;

__global__ void tc_kernel(const float* a, const float* b, float* xw, float* xwt,
                          float* atb) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  for (int i = tid; i < H * H; i += THREADS) {
    smem[A + Tc::at(i / H, i % H)] = a[i];
    smem[B + Tc::at(i / H, i % H)] = b[i];
  }
  Panels p;
  panels_start<Tc>(p, smem + PANELS, b, tid);
  const float* w = panels_next<Tc>(p, b, nullptr, tid);  // synchronises
  const Tc::Own o(tid);
  float acc[RPH] = {};
  Tc::product(smem + A, w, o, acc);  // a b
#pragma unroll
  for (int k = 0; k < RPH; ++k) xw[o.row(k) * H + o.col(k)] = acc[k];
#pragma unroll
  for (int k = 0; k < RPH; ++k) acc[k] = 0.0f;
  tc_xwt(smem + A, w, o, acc);  // a b^T
#pragma unroll
  for (int k = 0; k < RPH; ++k) xwt[o.row(k) * H + o.col(k)] = acc[k];
  // a^T b over 64 rows, by warps 0-7
  const GradPass<1, 0> gp = {{smem + A}, {smem + B}, {atb}, {nullptr}, {nullptr}, {nullptr}};
  tc_grad_pass<1, 0, 0>(gp, H, false, false, tid);
}

}  // namespace

// The products a b, a b^T and a^T b of two (64, 64) row-major operands,
// each into a (64, 64) row-major output.  Returns a cudaError_t.
extern "C" int tc_products(const float* a, const float* b, float* xw, float* xwt,
                           float* atb) {
  tc_kernel<<<1, THREADS, size_t(WORDS) * 4, nullptr>>>(a, b, xw, xwt, atb);
  return int(cudaGetLastError());
}
