// A test harness for the 3xTF32 tensor-core products of fused_ggnn64.cuh
// (h64::Tc): one CTA loads two (64, 64) operands a and b from global
// memory into shared memory in the Tc layout (b also through the weight
// panels, as the bodies stage their weights, and [a; b] as a tile of 128
// rows with its TF32 parts beside it, as the forward keeps h), takes the
// three products the reverse body uses, the forward's product over the
// tile from the operand split at load and from its kept parts, and a b
// over 64 rows with the correction terms apart (tc_mma's SEP, the
// forward's form), and writes them back row-major, so that
// tests/test_torch_bwd_emulated64.py can hold them against float64
// products and the tile products against each other and against the
// SEP product, bit for bit.
// Built only by tests/cuda_emu/emulate.py, against the CPU stand-in.

#include "fused_ggnn64.cuh"

namespace {

using namespace ggnn;
using namespace ggnn::h64;

// shared-memory plan in words: a, b (Tc layout; together the tile [a; b]),
// two panels, the tile's TF32 parts (2 TH)
constexpr int A = 0, B = A + H * H, PANELS = B + H * H, XS = PANELS + 2 * PANEL;
constexpr int WORDS = XS + 2 * TH;

// the tile product's entries (both halves) into a (128, 64) row-major output
__device__ void store_tile(float* out, const Tc::Own& o, const float (&acc)[2 * RPH]) {
  for (int j = 0; j < 2 * RPH; ++j)
    out[((j / RPH) * HALF + o.row(j % RPH)) * H + o.col(j % RPH)] = acc[j];
}

__global__ void tc_kernel(const float* a, const float* b, float* xw, float* xwt,
                          float* atb, float* tile_tc, float* tile_split, float* xw_sep) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  for (int i = tid; i < H * H; i += THREADS) {
    smem[A + Tc::at(i / H, i % H)] = a[i];
    smem[B + Tc::at(i / H, i % H)] = b[i];
    split_store(smem + XS, Tc::at(i / H, i % H), a[i]);
    split_store(smem + XS, Tc::at(HALF + i / H, i % H), b[i]);
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
  // [a; b] b over the tile, [a; b] split at load and from its kept parts
  float tacc[2 * RPH] = {};
  Tc::product_tile(smem + A, w, o, tacc);
  store_tile(tile_tc, o, tacc);
#pragma unroll
  for (int j = 0; j < 2 * RPH; ++j) tacc[j] = 0.0f;
  tc_mma_split_a(smem + XS, w, o.R, o.C, o.g, o.q, tacc);
  store_tile(tile_split, o, tacc);
  // a b with SEP, over the rows the tile's first half holds
#pragma unroll
  for (int k = 0; k < RPH; ++k) acc[k] = 0.0f;
  tc_mma<false, false, 1, 2, 16, H, true>(smem + A, w, H, o.R, o.C, o.g, o.q, acc);
#pragma unroll
  for (int k = 0; k < RPH; ++k) xw_sep[o.row(k) * H + o.col(k)] = acc[k];
  // a^T b over 64 rows, by warps 0-7
  const GradPass<1, 0> gp = {{smem + A}, {smem + B}, {atb}, {nullptr}, {nullptr}, {nullptr}};
  tc_grad_pass<1, 0, 0>(gp, H, false, false, tid);
}

}  // namespace

// The products a b, a b^T and a^T b of two (64, 64) row-major operands,
// each into a (64, 64) row-major output, [a; b] b (128, 64) with [a; b]
// split at load (tile_tc) and from its kept TF32 parts (tile_split), and
// a b with SEP (xw_sep, (64, 64)).  Returns a cudaError_t.
extern "C" int tc_products(const float* a, const float* b, float* xw, float* xwt,
                           float* atb, float* tile_tc, float* tile_split, float* xw_sep) {
  tc_kernel<<<1, THREADS, size_t(WORDS) * 4, nullptr>>>(a, b, xw, xwt, atb, tile_tc,
                                                         tile_split, xw_sep);
  return int(cudaGetLastError());
}
