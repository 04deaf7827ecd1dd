// The one-CTA plan of the GGNN bodies at H = 128, which the reverse body
// (fused_ggnn128_bwd.cuh: K1b, K3, K2b at that width) takes, and the
// pieces the forward (fused_ggnn128_fwd.cuh) shares with it: the Tc layout
// of 128-word rows, the weights' (64, 64) blocks and their order in a
// layer.
//
// Why H = 128 has plans of its own: the H = 64 bodies (fused_ggnn64.cuh)
// keep h, m, hw_e and more T x H buffers beside two (64, 64) weight
// panels.  At H = 128 one T x H buffer is 64 KB, so h, m and one hw_e take
// 192 KB and the panels and row lists bring that to about 239 KB, against
// 227 KB per CTA.  So one CTA per tile holds (Plan):
// - h and m at T x H (64 KB each); one work buffer of T x 64 words
//   (32 KB), a column half of hw_e in the message step and r*s of a row
//   half (64 x H) in the GRU;
// - the two staged (64, 64) weight panels of the H = 64 body
//   (h64::Panels), through which the weights stream from L2 one block
//   (kb, cb) of a (., 128) matrix at a time: rows 64 kb.., columns 64 cb..
//   (blk).  Every product is a sum of products by such blocks;
// - the biases and the row lists: 214,016 bytes.
// A layer's 88 blocks (block()): the message step's 16, one edge type and
// one column half at a time (hw_e[:, c] = h W_e[:, c] + b_e[c], then m[:, c]
// (+)= A_e hw_e[:, c], each entry of m adding the same terms in the same
// order, ascending column of A_flat, as at the narrower widths), then the
// GRU's 36 for each of the tile's row halves (its gates are row-local, and
// r*s of the whole tile does not fit): r by column halves into r*s, z and
// n by column halves, 12 blocks a gate: Wz, Wr, Wn's four and U's two of
// each column half.  The readout's 12 follow the layers.  Every dense
// product runs on the tensor cores in 3xTF32 (h64::tc_mma), the T x H
// buffers in the Tc layout with rows of 128 words (the swizzle of a row is
// that of a 64-word row, since 128 words are a multiple of the 32 banks).
//
// The forward ran on this plan until it took a cluster of two CTAs per
// tile (fused_ggnn128_fwd.cuh), which gives the same bits: the reverse
// body's F (fused_ggnn_bwd.cu) still runs the forward on it, each entry's
// terms in that body's order.

#pragma once

#include "fused_ggnn64.cuh"

namespace ggnn {
namespace h128 {

using h64::Idx;
using h64::Panels;
using h64::Tc;
using h64::swz;

constexpr int H = 128;
constexpr int HB = h64::H;           // 64: a weight block's side, a column half
constexpr int TH = TILE * H;
constexpr int HALF = TILE / 2;       // rows of a GRU half
constexpr int RPH = h64::RPH;        // 8 outputs a thread of a (64, 64) product
constexpr int MSG_BLOCKS = NE * 4;   // a layer's message blocks: four per W_e
constexpr int GRU_BLOCKS = 36;       // a GRU half's: twelve per gate
constexpr int LAYER_BLOCKS = MSG_BLOCKS + 2 * GRU_BLOCKS;
constexpr int READOUT_BLOCKS = 12;   // Wi's four and Wj's two per column half

// entry (row, col) of a T x H buffer in the Tc layout
__device__ __forceinline__ int at(int row, int col) { return row * H + (col ^ swz(row)); }

// the Tc layout of a buffer of H-word rows, for h64's steps
struct Wide {
  __device__ static int at(int row, int col) { return h128::at(row, col); }
};

// entry k of o's block of a (64, 64) output placed at rows hf HALF..,
// columns c HB.. of a buffer of H-word rows
__device__ __forceinline__ int own_at(const Tc::Own& o, int k, int hf, int c) {
  const int row = hf * HALF + o.row(k);
  return row * H + c * HB + (o.col(k) ^ swz(row));
}

// block (kb, cb) of a matrix of H-word rows
__device__ __forceinline__ const float* blk(const float* w, int kb, int cb) {
  return w + kb * HB * H + cb * HB;
}

// Block i of the kernel's sequence: per layer l the message blocks (i = 4e
// + 2c + kb: W_e's (kb, c)), then each GRU half's, gate by gate (r, z, n)
// and column half by column half c; for r and z the blocks W(0, c), W(1, c)
// (the h rows), U(0, c), U(1, c), W(2, c), W(3, c) (the m rows), for n
// W(0..3, c), then U(0, c), U(1, c); after the layers the readout's Wi(0..3,
// c), Wj(0, c), Wj(1, c) per column half.
__device__ __forceinline__ const float* block(const Weights& w, const Readout& ro,
                                              int n_layers, int i) {
  const int l = i / LAYER_BLOCKS;
  if (l >= n_layers) {
    const int j = i - n_layers * LAYER_BLOCKS, c = j / 6, k = j % 6;
    return k < 4 ? blk(ro.wi, k, c) : blk(ro.wj, k - 4, c);
  }
  int j = i - l * LAYER_BLOCKS;
  if (j < MSG_BLOCKS)
    return blk(w.msg_w + size_t(l * NE + j / 4) * H * H, j % 2, (j / 2) % 2);
  j = (j - MSG_BLOCKS) % GRU_BLOCKS;
  const int gate = j / 12, c = (j / 6) % 2, k = j % 6;
  const float* W = gate == 0 ? w.wr : gate == 1 ? w.wz : w.wn;
  const float* U = gate == 0 ? w.ur : gate == 1 ? w.uz : w.un;
  if (gate == 2) return k < 4 ? blk(W, k, c) : blk(U, k - 4, c);
  return k < 2 ? blk(W, k, c) : k < 4 ? blk(U, k - 2, c) : blk(W, k - 2, c);
}

// acc[k] = b[o.col(k)]
__device__ __forceinline__ void fill_half(float (&acc)[RPH], const float* b, const Tc::Own& o) {
#pragma unroll
  for (int k = 0; k < RPH; ++k) acc[k] = b[o.col(k)];
}

// Shared-memory plan in 4-byte words.
struct Plan {
  static constexpr int HIN = 0;                          // T H: h
  static constexpr int MS = HIN + TH;                    // T H: m; h0 (readout)
  static constexpr int WORK = MS + TH;                   // T HB: hw_e[:, c]; r*s (HALF x H)
  static constexpr int PANELS = WORK + TILE * HB;        // 2 (64, 64) panels
  static constexpr int B_MSG = PANELS + 2 * h64::PANEL;  // 4 H: layer l's b_e
  static constexpr int BZ = B_MSG + NE * H;              // H each
  static constexpr int BR = BZ + H;
  static constexpr int BN = BR + H;
  static constexpr int BI = BN + H;                      // readout biases
  static constexpr int BJ = BI + H;
  static constexpr int NV = BJ + H;                      // T NBR_CAP row-list values
  static constexpr int NK = NV + TILE * NBR_CAP;         // T NBR_CAP row-list columns (16-bit)
  static constexpr int NC = NK + TILE * NBR_CAP / 2;     // T row nonzero counts
  static constexpr int WORDS = NC + TILE;
  static constexpr size_t BYTES = size_t(WORDS) * 4;
  static_assert(TILE * HB == HALF * H, "the work buffer holds r*s of a row half");
  static_assert(PANELS % 4 == 0 && WORK % 4 == 0, "16-byte aligned rows");
  // h 64 KB, m 64 KB, work 32 KB, panels 32 KB, biases 4.5 KB, row lists 12.5 KB
  static_assert(BYTES == 214016, "the plan's bytes");
  static_assert(BYTES <= 232448, "shared-memory plan exceeds 227 KB");
};

// The shared-memory buffers of a layer step.
struct Tile {
  const float* adj_t;
  float* h;            // T x H: the layer's input, updated in place
  float* m;            // T x H
  float* work;         // T x HB: hw_e[:, c]; HALF x H: r*s
  float* bmsg;         // 4 H: layer l's message biases
  const float* bz; const float* br; const float* bn;
  const Idx* nk; const float* nv; const int* nc;
};

}  // namespace h128
}  // namespace ggnn
