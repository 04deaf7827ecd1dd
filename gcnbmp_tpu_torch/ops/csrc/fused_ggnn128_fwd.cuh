// The GGNN forward body at H = 128 (fused_ggnn.cu: K1, K1m, K2 at that
// width): a cluster of two CTAs per tile, the shared-memory plan of a CTA,
// the ring the weight blocks pass through, the message step with the
// aggregation reading the peer's rows, the GRU on the CTA's rows and the
// readout.
//
// Why a cluster: one CTA per tile (h128::Plan, which the reverse body's F
// still takes) holds h and m at T x H, 64 KB each, so it has room for
// neither h's TF32 parts nor r*s of the whole tile nor a third weight
// stage: it split h at every load, ran the GRU by row halves (36 weight
// blocks each, so 72 of a layer's 88 fed 64 rows) and met at a CTA-wide
// barrier for every block.  The GRU and the readout are row-local, and only
// the aggregation m = A_flat hw reads other rows.  So here CTA rank r of a
// cluster of two owns rows 64 r .. 64 r + 63 of the tile: their h, h's two
// TF32 parts, m and row lists, and writes their outputs.  hw_e of its rows
// goes to its work buffer, and the aggregation reads the peer's rows of
// hw_e there through distributed shared memory (cluster_map).
//
// The plan of a CTA (Plan), in bytes: h 32,768; h's TF32 parts 65,536,
// written once by the thread that writes h (split_store); m 32,768; the
// work buffer 32,768, which holds hw_e[rows, c] of a column half in two
// buffers of 64 x 64 used in turns (so that the peer reads one while the
// next is written: one cluster barrier per (e, c)), then r*s of the CTA's
// 64 rows; three weight stages of 16,384; the biases 4,608; the row lists
// of 64 rows 6,400; six mbarriers: 224,048 of the 232,448 a CTA may have.
//
// The weights stream from L2 by (64, 64) blocks (rows 64 kb.., columns
// 64 cb.. of a (., 128) matrix), 52 a layer (16 for the messages, 12 per
// gate r, z, n) and 12 for the readout, in one sequence per kernel
// (block()), through three stages in a ring on mbarriers (Ring), each by
// one bulk copy (cp.async.bulk, 16 KB) from a blocked copy of the weights
// in the staged layout that a kernel of its own (block_weights128 in
// fused_ggnn.cu) makes before the body: h64::Tc's XOR of 4-word groups, so
// that the lanes of a B fragment fall on 32 distinct banks.  With each
// block copied row by row from the weights as they lie (64 bulk copies of
// 256 bytes into rows padded to 72 words) the waits for the blocks took
// 61% of the body's cycles, and K2 9.70 ms against the one-CTA body's 5.24
// at P = 387 (chip_tc64.py phase 9).  No CTA-wide barrier is taken for a
// block: the barriers left are those of the data (hw_e before the
// aggregation, m before the gates, r*s before Un, the products of h before
// h', h' before the next layer).
//
// Every dense product runs on the tensor cores in 3xTF32 with the
// correction terms in an accumulator of their own (SEP), each (64, 64)
// output 8 entries a thread (h64::Tc::Own), and the products whose A
// operand is h read its kept TF32 parts.  Each entry takes the terms of the
// one-CTA body (65f988f .. fcbbe1d) in its order: the same split, the same
// 8-deep steps in the same order, the aggregation in ascending column of
// A_flat, so K1, K1m and K2 give that body's bits (chip_tc64.py phase 9),
// and K1m's h_mid is the reverse body's F's input of layer split.

#pragma once

#include "fused_ggnn128.cuh"

namespace ggnn {
namespace h128c {

using h64::Idx;
using h64::Tc;
using h64::swz;
using h128::H;
using h128::HB;
#ifdef __CUDACC__
using h64::ldsm_x4;
using h64::mma_tf32;
#endif

constexpr int CLUSTER = 2;             // CTAs a tile
constexpr int ROWS = TILE / CLUSTER;   // 64 rows a CTA
constexpr int RH = ROWS * H;           // words of a ROWS x H buffer
constexpr int RPH = h64::RPH;          // 8 outputs a thread of a (64, 64) product
constexpr int STAGE = h64::PANEL;      // words of a stage: a (64, 64) block
constexpr int STAGES = 3;
using h128::MSG_BLOCKS;
using h128::GRU_BLOCKS;
using h128::READOUT_BLOCKS;
// a layer's blocks: the GRU on the CTA's rows takes each of its 36 once
constexpr int LAYER_BLOCKS = MSG_BLOCKS + GRU_BLOCKS;

// Shared-memory plan of a CTA in 4-byte words.
struct Plan {
  static constexpr int HIN = 0;                          // RH: h of the CTA's rows
  static constexpr int HS = HIN + RH;                    // 2 RH: h's TF32 parts
  static constexpr int MS = HS + 2 * RH;                 // RH: m; h0 (readout)
  static constexpr int WORK = MS + RH;                   // RH: 2 hw_e[rows, c]; r*s
  static constexpr int STAGE0 = WORK + RH;               // 3 STAGE: the weight ring
  static constexpr int B_MSG = STAGE0 + 3 * STAGE;       // 4 H: layer l's b_e
  static constexpr int BZ = B_MSG + NE * H;              // H each
  static constexpr int BR = BZ + H;
  static constexpr int BN = BR + H;
  static constexpr int BI = BN + H;                      // readout biases
  static constexpr int BJ = BI + H;
  static constexpr int NV = BJ + H;                      // ROWS NBR_CAP row-list values
  static constexpr int NK = NV + ROWS * NBR_CAP;         // ROWS NBR_CAP columns (16-bit)
  static constexpr int NC = NK + ROWS * NBR_CAP / 2;     // ROWS row nonzero counts
  static constexpr int BARS = NC + ROWS;                 // 3 full, 3 empty mbarriers
  static constexpr int WORDS = BARS + 2 * 3 * 2;
  static constexpr size_t BYTES = size_t(WORDS) * 4;
  static_assert(2 * ROWS * HB == RH, "the work buffer holds two hw_e halves or r*s");
  static_assert(STAGE0 % 4 == 0 && HS % 4 == 0 && WORK % 4 == 0, "16-byte aligned rows");
  static_assert(BARS % 2 == 0, "8-byte aligned mbarriers");
  static_assert(STAGES <= 3, "the ring's stages and mbarriers in the plan");
  // h 32 KB, h's parts 64 KB, m 32 KB, work 32 KB, stages 48 KB, biases
  // 4.5 KB, row lists 6.25 KB, mbarriers
  static_assert(BYTES == 224048, "the plan's bytes");
  static_assert(BYTES <= 232448, "shared-memory plan exceeds 227 KB");
};

// Block i of the kernel's sequence: per layer l the message blocks, then
// one GRU half's of the one-CTA sequence (h128::block: the message blocks
// (i = 4e + 2c + kb: W_e's (kb, c)), then gate by gate (r, z, n) and column
// half by column half), the CTA's rows taking each once; after the layers
// the readout's.
__device__ __forceinline__ const float* block(const Weights& w, const Readout& ro,
                                              int n_layers, int i) {
  const int l = min(i / LAYER_BLOCKS, n_layers);
  return h128::block(w, ro, n_layers, i + l * (h128::LAYER_BLOCKS - LAYER_BLOCKS));
}

// The blocked copy of the weights (block_weights128 in fused_ggnn.cu makes
// it before every launch, into the caller's scratch: ops/fused_ggnn.py's
// _blocked128): each distinct block of the sequence once, in the
// staged layout (h64::Tc::panel_at: rows of 64 words, their 4-word groups
// XORed by the row), so that one bulk copy of 16 KB stages a block.  Its
// blocks: every layer's 16 message blocks, then the GRU's 36 (each layer
// takes each of them once, in the same order), then the readout's 12.
__host__ __device__ constexpr int distinct_blocks(int n_layers, bool readout) {
  return n_layers * MSG_BLOCKS + GRU_BLOCKS + (readout ? READOUT_BLOCKS : 0);
}

// the blocked copy's index of block i of the sequence
__device__ __forceinline__ int blocked_index(int n_layers, int i) {
  const int l = i / LAYER_BLOCKS, j = i - l * LAYER_BLOCKS;
  const int nm = n_layers * MSG_BLOCKS;
  if (l >= n_layers) return nm + GRU_BLOCKS + (i - n_layers * LAYER_BLOCKS);
  return j < MSG_BLOCKS ? l * MSG_BLOCKS + j : nm + (j - MSG_BLOCKS);
}

// the first block of the sequence that the blocked copy's block b holds
__device__ __forceinline__ int first_use(int n_layers, int b) {
  const int nm = n_layers * MSG_BLOCKS;
  if (b < nm) return (b / MSG_BLOCKS) * LAYER_BLOCKS + b % MSG_BLOCKS;
  if (b < nm + GRU_BLOCKS) return MSG_BLOCKS + (b - nm);
  return n_layers * LAYER_BLOCKS + (b - nm - GRU_BLOCKS);
}

// The weight blocks' ring: block j of the sequence of n sits in stage
// j % STAGES, its full mbarrier's phase j / STAGES.  Thread 0 issues the
// bulk copy of block j + STAGES - 1 at its take of block j, once every warp
// has released the stage's previous block (the stage's `empty` mbarrier,
// one arrival per warp).  Every thread takes the blocks in order and
// releases each (its warp's arrival on `empty`) once its product is done,
// with no CTA or cluster barrier between a take and its release.  (Two
// stages with a CTA barrier a block, as the one-CTA body's panels, ran
// 1.5-2.3% slower, and the warp that releases a stage last issuing its
// next copy, by a count in shared memory, 2.3% slower at P = 387:
// chip_tc64.py phase 9.)
struct Ring {
  float* stages;
  unsigned long long* full;    // STAGES, one arrival (thread 0's) and the bytes
  unsigned long long* empty;   // STAGES, one arrival per warp
  const float* blocked;        // the blocked copy of the weights
  const Weights& w;
  const Readout& ro;
  int n_layers, n, j;          // the sequence's length, the next block taken

  // thread 0: block k into its stage, one bulk copy on its full mbarrier
  __device__ void load(int k) {
    unsigned long long* f = full + k % STAGES;
    mbar_expect_tx(f, STAGE * 4);
    fence_proxy_async();
    bulk_copy(stages + (k % STAGES) * STAGE,
              blocked + size_t(blocked_index(n_layers, k)) * STAGE, STAGE * 4, f);
  }

  // the first blocks on their way; after the mbarriers' initialisation
  // and a CTA barrier
  __device__ void start(int tid) {
    if (tid == 0)
      for (int k = 0; k < STAGES - 1 && k < n; ++k) load(k);
  }

  // block j, landed; thread 0 first issues the block STAGES - 1 ahead
  __device__ const float* take(int tid) {
    const int k = j + STAGES - 1;
    if (tid == 0 && k < n) {
      // the stage's last block, k - STAGES, released by every warp
      if (k >= STAGES) mbar_wait(empty + k % STAGES, (k / STAGES - 1) & 1);
      load(k);
    }
    mbar_wait(full + j % STAGES, (j / STAGES) & 1);
    float* b = stages + (j % STAGES) * STAGE;
#ifndef __CUDACC__
    // the CPU stand-in: the stage holds the weight block the sequence names
    if ((tid & 31) == 0) {
      const float* s = block(w, ro, n_layers, j);
      for (int i = 0; i < STAGE; ++i)
        if (b[Tc::panel_at(i / HB, i % HB)] != s[(i / HB) * H + i % HB]) __builtin_trap();
    }
#endif
    ++j;
    return b;
  }

  // the warp is done with the block it took last
  __device__ void release(int tid) {
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty + (j - 1) % STAGES);
  }
};

// acc += x[:, kb HB..] w for o's block of the CTA's rows: x a ROWS x H
// buffer in the Tc layout, split where it is loaded, w a staged block
// (h64::tc_mma with its SEP)
__device__ __forceinline__ void product(const float* x, int kb, const float* w,
                                        const Tc::Own& o, float (&acc)[RPH]) {
  h64::tc_mma<false, false, 1, 2, 16, H, true, HB>(x + kb * HB, w, HB, o.R, o.C, o.g, o.q,
                                                   acc);
}

// product's terms in its order (the same bits), x given by its TF32 parts
// (hi at xs, lo at xs + RH): each A fragment two ldmatrix and no split
__device__ __forceinline__ void product_kept(const float* xs, int kb, const float* w,
                                             const Tc::Own& o, float (&acc)[RPH]) {
  float cor[RPH];
#pragma unroll
  for (int i = 0; i < RPH; ++i) cor[i] = 0.0f;
  const int lr = (4 * o.g + o.q) & 7, lj = (4 * o.g + o.q) >> 3, slr = swz(lr);
  const float* arow = xs + (o.R + lr + 8 * (lj & 1)) * H + kb * HB;
  const int sq0 = swz(o.q), sq1 = swz(o.q + 4);
#pragma unroll 2
  for (int k0 = 0; k0 < HB; k0 += 8) {
    float ah[4], al[4];
    const float* a = arow + ((k0 + 4 * (lj >> 1)) ^ slr);
    ldsm_x4(ah, a);
    ldsm_x4(al, a + RH);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      float bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        h64::split_tf32(w[(k0 + o.q + 4 * i) * HB + ((o.C + 8 * nj + o.g) ^ (i ? sq1 : sq0))],
                        bh[i], bl[i]);
      float* d = acc + 4 * nj;
      float* e = cor + 4 * nj;
      mma_tf32(e, al, bh);
      mma_tf32(e, ah, bl);
      mma_tf32(d, ah, bh);
    }
  }
#pragma unroll
  for (int i = 0; i < RPH; ++i) acc[i] += cor[i];
}

// h's TF32 parts, as the body keeps them: hs[i] = hi, hs[RH + i] = lo
__device__ __forceinline__ void split_store(float* hs, int i, float v) {
  h64::split_tf32(v, hs[i], hs[RH + i]);
}

// The shared-memory buffers of a CTA, each of its rows.
struct Bufs {
  const float* adj_t;  // the CTA's rows of the tile's adjacency
  float* h;            // ROWS x H: the layer's input, updated in place
  float* hs;           // 2 ROWS x H: h's TF32 parts
  float* m;            // ROWS x H
  float* work;         // 2 ROWS x HB: hw_e[rows, c] by turns; ROWS x H: r*s
  const float* peer;   // the peer's work buffer (distributed shared memory)
  int rank;            // rank in the cluster: rows 64 rank ..
  float* bmsg;         // 4 H: layer l's message biases
  const float* bz; const float* br; const float* bn;
  const Idx* nk; const float* nv; const int* nc;
};

// acc += h[:, kb HB..] w, h from its kept parts (splitting h where it is
// loaded instead ran 9.2-11.6% slower: chip_tc64.py phase 9)
__device__ __forceinline__ void product_h(const Bufs& t, int kb, const float* w,
                                          const Tc::Own& o, float (&acc)[RPH]) {
  product_kept(t.hs, kb, w, o, acc);
}

// acc += x[:, kb HB..] (the ring's next block), released once read; a
// state block at layer 0 (`skip`) is taken and released unread
template <class F>
__device__ __forceinline__ void with_block(Ring& ring, bool skip, F f, int tid) {
  const float* wb = ring.take(tid);
  if (!skip) f(wb);
  ring.release(tid);
}

// m[rows, c HB..] (+)= A_e[rows, :] hw_e[:, c] for edge type e: one warp
// per row, lane c owns columns c and c + 32 of the half.  hw_e's rows
// 0..63 lie in rank 0's buffer `buf`, rows 64..127 in rank 1's.  The row
// lists (or a crowded row's dense columns) in ascending order, m starting
// at zero for e = 0 and carrying on for e > 0: each row sums its terms in
// ascending column order of A_flat, as h64::aggregate_edge does.
__device__ __forceinline__ void aggregate(const Bufs& t, int e, int c, int buf, int tid) {
  const int lane = tid & 31;
  const int lo = e * TILE;
  const float* own = t.work + buf * ROWS * HB;
  const float* other = t.peer + buf * ROWS * HB;
  const float* half[2] = {t.rank == 0 ? own : other, t.rank == 0 ? other : own};
  float* m = t.m + c * HB;
  for (int i = tid >> 5; i < ROWS; i += WARPS) {
    float a0 = e == 0 ? 0.0f : m[h128::at(i, lane)];
    float a1 = e == 0 ? 0.0f : m[h128::at(i, lane + 32)];
    const int cnt = t.nc[i];
    if (cnt > NBR_CAP) {
      const float* arow = t.adj_t + size_t(i) * ROW_LEN + lo;
      float av[TILE / 32];
#pragma unroll
      for (int q = 0; q < TILE / 32; ++q) av[q] = __ldg(arow + q * 32 + lane);
#pragma unroll
      for (int q = 0; q < TILE / 32; ++q) {
        const float a = av[q];
        unsigned nz = __ballot_sync(0xffffffffu, a != 0.0f);
        const float* hw = half[q >> 1];
        while (nz) {
          const int b = __ffs(nz) - 1;
          nz &= nz - 1;
          const float v = __shfl_sync(0xffffffffu, a, b);
          const int k = (q & 1) * 32 + b;
          a0 = fmaf(v, hw[Tc::at(k, lane)], a0);
          a1 = fmaf(v, hw[Tc::at(k, lane + 32)], a1);
        }
      }
    } else {
      for (int n = 0; n < cnt; ++n) {
        const int k = int(t.nk[i * NBR_CAP + n]) - lo;
        if (k < 0 || k >= TILE) continue;
        const float v = t.nv[i * NBR_CAP + n];
        const float* hw = k < ROWS ? half[0] : half[1];
        a0 = fmaf(v, hw[Tc::at(k & (ROWS - 1), lane)], a0);
        a1 = fmaf(v, hw[Tc::at(k & (ROWS - 1), lane + 32)], a1);
      }
    }
    m[h128::at(i, lane)] = a0;
    m[h128::at(i, lane + 32)] = a1;
  }
}

// m = A_flat [h W_e + b_e]_e of layer l for the CTA's rows, one edge type
// and one column half at a time: hw_e[rows, c] = h W_e[:, c] + b_e[c] into
// work buffer c, a cluster barrier (both CTAs' rows written; the peer is
// done with the buffer's previous use, two steps back), then the
// aggregation.  Ends with m complete (a CTA barrier) and this CTA's arrival
// on the cluster barrier that says it reads the peer's buffers no more:
// the caller waits on it before the work buffer is written again.
__device__ __forceinline__ void messages(const Bufs& t, Ring& ring, int tid) {
  const Tc::Own o(tid);
#pragma unroll 1
  for (int ec = 0; ec < 2 * NE; ++ec) {
    const int e = ec >> 1, c = ec & 1;
    float acc[RPH];
    // the biases, written before a barrier
    h128::fill_half(acc, t.bmsg + e * H + c * HB, o);
#pragma unroll 1
    for (int kb = 0; kb < 2; ++kb)
      with_block(ring, false, [&](const float* wb) { product_h(t, kb, wb, o, acc); }, tid);
    float* hw = t.work + c * ROWS * HB;
#pragma unroll
    for (int k = 0; k < RPH; ++k) hw[o.at(k)] = acc[k];
    cluster_arrive();
    cluster_wait();
    aggregate(t, e, c, c, tid);
  }
  __syncthreads();
  cluster_arrive();
}

// acc += h W(0, c) + h W(1, c) [+ s U(0, c) + s U(1, c)] + m W(2, c) +
// m W(3, c), through the ring's next six blocks (U's at layer 0 too, whose
// state is zero, and not read)
__device__ __forceinline__ void gate_xs(const Bufs& t, bool zero_state, Ring& ring,
                                        const Tc::Own& o, float (&acc)[RPH], int tid) {
#pragma unroll 1
  for (int k = 0; k < 6; ++k)
    with_block(ring, zero_state && (k == 2 || k == 3), [&](const float* wb) {
      if (k < 4)
        product_h(t, k & 1, wb, o, acc);
      else
        product(t.m, k & 1, wb, o, acc);
    }, tid);
}

// acc += h Wn(0..1, c) + m Wn(2..3, c) [+ (r*s) Un(0..1, c)]; r*s (the work
// buffer) is complete after a CTA barrier before Un's first block is read
__device__ __forceinline__ void gate_n(const Bufs& t, bool zero_state, bool first, Ring& ring,
                                       const Tc::Own& o, float (&acc)[RPH], int tid) {
#pragma unroll 1
  for (int k = 0; k < 6; ++k) {
    if (first && k == 4) __syncthreads();
    with_block(ring, zero_state && k >= 4, [&](const float* wb) {
      if (k < 2)
        product_h(t, k & 1, wb, o, acc);
      else
        product(k < 4 ? t.m : t.work, k & 1, wb, o, acc);
    }, tid);
  }
}

// One GGNN layer l on the CTA's rows, x = [h, m], state s = h (zero at
// layer 0):
//   r = sigmoid(x Wr + s Ur + br)            by column halves -> r*s (work)
//   z = sigmoid(x Wz + s Uz + bz)            in registers
//   n = tanh(x Wn + (r*s) Un + bn)           in registers
//   h' = z n + (1 - z) s                     with its TF32 parts
// The same terms in the same order as the one-CTA body's gru_half.  Ends
// synchronised, with layer l + 1's message biases (`next_b`) in place.
__device__ __forceinline__ void layer_forward(const Bufs& t, bool zero_state,
                                              const float* next_b, Ring& ring, int tid) {
  const Tc::Own o(tid);
  messages(t, ring, tid);
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    float r[RPH];
    h128::fill_half(r, t.br + c * HB, o);
    gate_xs(t, zero_state, ring, o, r, tid);
    if (c == 0) cluster_wait();  // the peer reads this CTA's hw_e no more
#pragma unroll
    for (int k = 0; k < RPH; ++k) {
      const int i = h128::own_at(o, k, 0, c);
      t.work[i] = zero_state ? 0.0f : sigmoidf(r[k]) * t.h[i];
    }
  }
  float z0[RPH], z1[RPH], n0[RPH], n1[RPH];
  h128::fill_half(z0, t.bz, o);
  gate_xs(t, zero_state, ring, o, z0, tid);
  h128::fill_half(z1, t.bz + HB, o);
  gate_xs(t, zero_state, ring, o, z1, tid);
  h128::fill_half(n0, t.bn, o);
  gate_n(t, zero_state, true, ring, o, n0, tid);
  h128::fill_half(n1, t.bn + HB, o);
  gate_n(t, zero_state, false, ring, o, n1, tid);
  __syncthreads();  // every product that reads h is done
#pragma unroll
  for (int k = 0; k < RPH; ++k) {
    const int i0 = h128::own_at(o, k, 0, 0), i1 = h128::own_at(o, k, 0, 1);
    const float za = sigmoidf(z0[k]), zb = sigmoidf(z1[k]);
    const float sa = zero_state ? 0.0f : t.h[i0], sb = zero_state ? 0.0f : t.h[i1];
    const float va = za * tanhf(n0[k]) + (1.0f - za) * sa;
    const float vb = zb * tanhf(n1[k]) + (1.0f - zb) * sb;
    t.h[i0] = va;
    t.h[i1] = vb;
    split_store(t.hs, i0, va);
    split_store(t.hs, i1, vb);
  }
  if (next_b != nullptr)
    for (int i = tid; i < NE * H; i += THREADS) t.bmsg[i] = next_b[i];
  __syncthreads();
}

// g = sigmoid([h, h0] Wi + bi) * (h Wj + bj) * mask into out_t (the CTA's
// rows, D = H), by column halves (h0 in s_h0, Tc layout)
__device__ __forceinline__ void readout(const Bufs& t, const float* s_h0, const float* s_bi,
                                        const float* s_bj, const float* mask_t, float* out_t,
                                        Ring& ring, int tid) {
  const Tc::Own o(tid);
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    float gi[RPH], gj[RPH];
    h128::fill_half(gi, s_bi + c * HB, o);
#pragma unroll 1
    for (int k = 0; k < 4; ++k)
      with_block(ring, false, [&](const float* wb) {
        if (k < 2)
          product_h(t, k, wb, o, gi);
        else
          product(s_h0, k & 1, wb, o, gi);
      }, tid);
    h128::fill_half(gj, s_bj + c * HB, o);
#pragma unroll 1
    for (int kb = 0; kb < 2; ++kb)
      with_block(ring, false, [&](const float* wb) { product_h(t, kb, wb, o, gj); }, tid);
#pragma unroll
    for (int k = 0; k < RPH; ++k) {
      const int row = o.row(k);
      out_t[row * H + c * HB + o.col(k)] = sigmoidf(gi[k]) * gj[k] * mask_t[row];
    }
  }
}

}  // namespace h128c
}  // namespace ggnn
