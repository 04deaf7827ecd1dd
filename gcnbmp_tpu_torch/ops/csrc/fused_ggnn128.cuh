// The GGNN forward body at H = 128 (fused_ggnn.cu: K1, K1m, K2 at that
// width): the shared-memory plan, the order in which the weight blocks pass
// through the panels, the message step by column halves, the GRU by row
// halves and the readout by column halves.
//
// Why H = 128 has a design of its own: the H = 64 forward (fused_ggnn64.cuh)
// keeps h, m, hw_e and h's two TF32 parts, five T x H buffers, beside two
// (64, 64) weight panels.  At H = 128 one T x H buffer is 64 KB, so h, m and
// one hw_e take 192 KB and the panels and row lists bring that to about
// 239 KB, against 227 KB per CTA.  So at this width, one CTA per tile as at
// the narrower widths:
// - h and m are T x H (64 KB each); one work buffer of T x 64 words
//   (32 KB) holds a column half of hw_e in the message step, and r*s of a
//   row half (64 x H) in the GRU.  h is not kept split: the products split
//   their operands at load (h64::tc_mma).
// - The weights stream from L2 through the two staged (64, 64) panels of
//   the H = 64 body (h64::Panels), one block (kb, cb) of a (., 128) matrix
//   at a time: rows 64 kb.., columns 64 cb...  Every product is a sum of
//   products by such blocks.  The blocks pass in one fixed sequence per
//   kernel (block()), 88 a layer and 12 for the readout, and Seq::take
//   names each block it hands out and the one it loads behind it.
// - The message step takes one edge type and one column half c at a time:
//   hw_e[:, c] = h W_e[:, c] + b_e[c] over the tile (two blocks), then
//   m[:, c] (+)= A_e hw_e[:, c].  The aggregation separates by columns, so
//   each entry of m adds the same terms in the same order (ascending
//   column of A_flat) as at the narrower widths.
// - The GRU's n needs r*s over all H columns as the A operand of Un, and a
//   T x H r*s does not fit beside h, m and the panels.  Its gates are
//   row-local, so it runs on the tile's rows in two halves of 64, as the
//   H = 64 reverse body does: r by column halves into r*s (64 x H, the work
//   buffer), then z and n by column halves in registers (8 outputs a thread
//   of each (64, 64) product, 32 live at the end), then h' for the half's
//   rows in place.  The other half's rows are not read meanwhile.  36
//   blocks a half: 12 per gate, through Wz, Wr, Wn's four and U's two of
//   each column half.
// - The messages and the readout take each product over the whole tile
//   (16 outputs a thread; the two halves share each B fragment), as the
//   H = 64 forward does; the readout holds sigmoid's argument and h Wj + bj
//   of one column half at a time.
// - Every dense product runs on the tensor cores in 3xTF32 (h64::tc_mma:
//   about 2^-21 of each term dropped, lo*lo), the T x H buffers in the Tc
//   layout with rows of 128 words (the swizzle of a row is that of a
//   64-word row, since 128 words are a multiple of the 32 banks).  The
//   aggregation stays in f32.
// - Each product sums its correction terms (lo*hi, hi*lo) in an
//   accumulator of its own (tc_mma's SEP): the tensor cores truncate each
//   mma's sum to its accumulator's magnitude, and with the three terms in
//   one accumulator K1 came to 0.876 of its error bound on a crowded batch
//   (rows with ~25 neighbours, so m and the gates' sums run large), 0.348
//   with SEP, at about 1% of its time (chip_tc64.py phase 7, NVIDIA H100
//   80GB HBM3 at 700 W).
// The plan comes to 214,016 bytes (Plan); 123-128 registers a thread, no
// spill.  Its redesign candidate, a cluster of two CTAs per tile that each
// own 64 rows and read the peer's hw_e rows through distributed shared
// memory, is in ROADMAP queue 2.

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

// The panels' walk through the kernel's sequence of n blocks.
struct Seq {
  const Weights& w;
  const Readout& ro;
  int n_layers, n, i;
  // the next block of the sequence, once every thread is done with the
  // block before it (h64::panels_next); the one after it starts loading
  __device__ const float* take(Panels& p, int tid) {
    const float* cur = block(w, ro, n_layers, i);
    const float* next = i + 1 < n ? block(w, ro, n_layers, i + 1) : nullptr;
    ++i;
    return h64::panels_next<Tc, H>(p, cur, next, tid);
  }
};

// acc += x[:, kb HB..] w over the tile, o's block of each half (half hf's
// entry k at acc[RPH hf + k]); one B fragment feeds both halves
__device__ __forceinline__ void product_tile(const float* x, int kb, const float* w,
                                             const Tc::Own& o, float (&acc)[2 * RPH]) {
  h64::tc_mma<false, false, 2, 2, HALF, H, true>(x + kb * HB, w, HB, o.R, o.C, o.g, o.q,
                                                acc);
}

// acc += x[rows hf HALF.., kb HB..] w for o's block of half hf
__device__ __forceinline__ void product_half(const float* x, int hf, int kb, const float* w,
                                             const Tc::Own& o, float (&acc)[RPH]) {
  h64::tc_mma<false, false, 1, 2, 16, H, true>(x + hf * HALF * H + kb * HB, w, HB, o.R,
                                               o.C, o.g, o.q, acc);
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

// m = A_flat [h W_e + b_e]_e of layer l, one edge type and one column half
// at a time.  The caller synchronises before m is read.
__device__ __forceinline__ void messages(const Tile& t, Seq& seq, Panels& p, int tid) {
  const Tc::Own o(tid);
#pragma unroll 1
  for (int e = 0; e < NE; ++e) {
#pragma unroll 1
    for (int c = 0; c < 2; ++c) {
      // the biases, written at the layer's start, are read after a barrier
      const float* w0 = seq.take(p, tid);
      float acc[2 * RPH];
      h64::fill_cols(acc, t.bmsg + e * H + c * HB, o);
      product_tile(t.h, 0, w0, o, acc);
      product_tile(t.h, 1, seq.take(p, tid), o, acc);
#pragma unroll
      for (int j = 0; j < 2 * RPH; ++j) t.work[h64::tile_at(o, j)] = acc[j];
      __syncthreads();
      // m[:, c HB..] (+)= A_e hw_e[:, c]
      h64::aggregate_edge<Tc, Wide>(t.adj_t, e, t.work, t.m + c * HB, t.nk, t.nv,
                                    t.nc, tid);
    }
  }
}

// acc += h W(0, c) + h W(1, c) [+ s U(0, c) + s U(1, c)] + m W(2, c) +
// m W(3, c) for the rows of half hf, through the sequence's next six
// blocks (U's are handed out at layer 0 too, whose state is zero, and not
// used)
__device__ __forceinline__ void gate_xs(const Tile& t, int hf, bool zero_state, Seq& seq,
                                        Panels& p, const Tc::Own& o, float (&acc)[RPH],
                                        int tid) {
  product_half(t.h, hf, 0, seq.take(p, tid), o, acc);
  product_half(t.h, hf, 1, seq.take(p, tid), o, acc);
  const float* u0 = seq.take(p, tid);
  if (!zero_state) product_half(t.h, hf, 0, u0, o, acc);
  const float* u1 = seq.take(p, tid);
  if (!zero_state) product_half(t.h, hf, 1, u1, o, acc);
  product_half(t.m, hf, 0, seq.take(p, tid), o, acc);
  product_half(t.m, hf, 1, seq.take(p, tid), o, acc);
}

// acc += h Wn(0..1, c) + m Wn(2..3, c) [+ (r*s) Un(0..1, c)] for the rows
// of half hf (r*s: t.work, written before an earlier block's barrier)
__device__ __forceinline__ void gate_n(const Tile& t, int hf, bool zero_state, Seq& seq,
                                       Panels& p, const Tc::Own& o, float (&acc)[RPH],
                                       int tid) {
  product_half(t.h, hf, 0, seq.take(p, tid), o, acc);
  product_half(t.h, hf, 1, seq.take(p, tid), o, acc);
  product_half(t.m, hf, 0, seq.take(p, tid), o, acc);
  product_half(t.m, hf, 1, seq.take(p, tid), o, acc);
  const float* u0 = seq.take(p, tid);
  if (!zero_state) product_half(t.work, 0, 0, u0, o, acc);
  const float* u1 = seq.take(p, tid);
  if (!zero_state) product_half(t.work, 0, 1, u1, o, acc);
}

// The GRU on the rows of half hf, x = [h, m], state s = h (zero at layer
// 0), h updated in place for those rows:
//   r = sigmoid(x Wr + s Ur + br)            by column halves -> r*s (work)
//   z = sigmoid(x Wz + s Uz + bz)            in registers
//   n = tanh(x Wn + (r*s) Un + bn)           in registers
//   h' = z n + (1 - z) s
// The same terms in the same order as the H = 64 bodies' gates.
__device__ __forceinline__ void gru_half(const Tile& t, bool zero_state, int hf, Seq& seq,
                                         Panels& p, int tid) {
  const Tc::Own o(tid);
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    float r[RPH];
    fill_half(r, t.br + c * HB, o);
    gate_xs(t, hf, zero_state, seq, p, o, r, tid);
#pragma unroll
    for (int k = 0; k < RPH; ++k)
      t.work[own_at(o, k, 0, c)] =
          zero_state ? 0.0f : sigmoidf(r[k]) * t.h[own_at(o, k, hf, c)];
  }
  float z0[RPH], z1[RPH], n0[RPH], n1[RPH];
  fill_half(z0, t.bz, o);
  gate_xs(t, hf, zero_state, seq, p, o, z0, tid);
  fill_half(z1, t.bz + HB, o);
  gate_xs(t, hf, zero_state, seq, p, o, z1, tid);
  fill_half(n0, t.bn, o);
  gate_n(t, hf, zero_state, seq, p, o, n0, tid);
  fill_half(n1, t.bn + HB, o);
  gate_n(t, hf, zero_state, seq, p, o, n1, tid);
  // no thread reads these rows of h after the last block's barrier
#pragma unroll
  for (int k = 0; k < RPH; ++k) {
    const int i0 = own_at(o, k, hf, 0), i1 = own_at(o, k, hf, 1);
    const float za = sigmoidf(z0[k]), zb = sigmoidf(z1[k]);
    const float sa = zero_state ? 0.0f : t.h[i0], sb = zero_state ? 0.0f : t.h[i1];
    t.h[i0] = za * tanhf(n0[k]) + (1.0f - za) * sa;
    t.h[i1] = zb * tanhf(n1[k]) + (1.0f - zb) * sb;
  }
}

// One GGNN layer l on the tile, h updated in place.  Ends synchronised.
__device__ __forceinline__ void layer_forward(const Tile& t, const Weights& w, int l,
                                              Seq& seq, Panels& p, int tid) {
  // the previous layer's readers of the biases are past its last barrier
  for (int i = tid; i < NE * H; i += THREADS) t.bmsg[i] = w.msg_b[size_t(l) * NE * H + i];
  messages(t, seq, p, tid);
#pragma unroll 1
  for (int hf = 0; hf < 2; ++hf) gru_half(t, l == 0, hf, seq, p, tid);
  __syncthreads();
}

// g = sigmoid([h, h0] Wi + bi) * (h Wj + bj) * mask into out_t (T x D,
// D = H), by column halves over the tile (h0 in s_h0, Tc layout)
__device__ __forceinline__ void readout(const Tile& t, const float* s_h0, const float* s_bi,
                                        const float* s_bj, const float* mask_t, float* out_t,
                                        Seq& seq, Panels& p, int tid) {
  const Tc::Own o(tid);
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    float gi[2 * RPH], gj[2 * RPH];
    h64::fill_cols(gi, s_bi + c * HB, o);
    product_tile(t.h, 0, seq.take(p, tid), o, gi);
    product_tile(t.h, 1, seq.take(p, tid), o, gi);
    product_tile(s_h0, 0, seq.take(p, tid), o, gi);
    product_tile(s_h0, 1, seq.take(p, tid), o, gi);
    h64::fill_cols(gj, s_bj + c * HB, o);
    product_tile(t.h, 0, seq.take(p, tid), o, gj);
    product_tile(t.h, 1, seq.take(p, tid), o, gj);
#pragma unroll
    for (int j = 0; j < 2 * RPH; ++j) {
      const int row = (j / RPH) * HALF + o.row(j % RPH);
      out_t[row * H + c * HB + o.col(j % RPH)] = sigmoidf(gi[j]) * gj[j] * mask_t[row];
    }
  }
}

}  // namespace h128
}  // namespace ggnn
