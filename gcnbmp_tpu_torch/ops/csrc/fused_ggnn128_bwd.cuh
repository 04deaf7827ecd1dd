// The GGNN reverse body at H = 128 (fused_ggnn_bwd.cu: K1b, K3, K2b at
// that width): the shared-memory plan, what lives in global memory
// instead, the two launches of every form, the order in which the weight
// blocks pass through the panels, the products against transposed weight
// blocks and the weight gradients by (64, 64) blocks.
//
// Why H = 128 has a reverse plan of its own: the H = 64 reverse
// (h64::Plan<true>) keeps five T x H buffers (h; m, then dm; dh; two of
// work).  At H = 128 one T x H buffer is 64 KB, so those five take 320 KB
// against 227 KB per CTA.  So at this width, one CTA per tile as in the
// H = 128 forward, on the forward's own plan (h128::Plan: h and m at
// T x H, a T x 64 work buffer, the two staged (64, 64) weight panels, the
// biases and the row lists) plus the column lists of the transposed
// aggregation, the tile's global pointers and an mbarrier: 228,992 bytes
// (RPlan).
//
// Two launches in every form (MODE): F runs the forward over the range
// [lo, hi) (messages_looped, gru_half_looped: the forward body's terms in
// its order) and keeps what the reverse reads, then seeds dh (dh_top; K2b's
// F runs the readout's backward); R runs the reverse alone.  F stores, for
// each layer of the range, its input h in hs (P, hi - lo, T, H) and its m
// after the aggregation and its gates r, z and n in acts (P, hi - lo, 4,
// T, H; Act): 256 KB a layer a tile, 811 MB at L = 8, P = 387.  m is a
// copy of the shared buffer (the Tc layout); r, z and n are written, and
// read in R, by the thread that owns each entry in the GRU's (64, 64)
// products (own_at).  So R runs no message product, no aggregation and no
// gate product: 88 staged blocks a reversed layer (REV_BLOCKS), against the
// 176 of a reverse that rebuilt the forward in every layer, and the same
// bits, since the stored values are the ones the rebuild computed.
// What the plan has no room for:
// - dh lives in global memory, in the kernel's output dh_bot (row-major,
//   64 KB a tile; L2 holds it): every entry belongs to one thread for the
//   whole body (the thread that owns it in a (64, 64) product of Tc::Own
//   over the tile's row halves and column halves), which reads, adds to
//   and writes it in place, so dh needs no barrier and ends where the
//   caller reads it.  Each step loads its global values before its first
//   store, so the loads go out together.
// - The GRU's reverse runs on the tile's rows in two halves of 64, as the
//   H = 64 reverse does, and needs three 64 x H buffers beside h and m
//   (r*s, then dr'; dz'; dn').  It borrows the other half's rows of h (dn')
//   and of m (dz'), so R reloads them: the second half's from hs and acts
//   before it runs, the first half's after; the first half's dm goes to
//   global memory meanwhile (Scratch::PARK).
// - R's reloads (Reloads) are bulk copies (cp.async.bulk) on one
//   mbarrier, which thread 0 issues as soon as every reader of the buffer
//   is past a barrier: the next layer's m once the last column gather is
//   done, its h once the last weight-gradient block is, so they land
//   while the layer's last products run.
// - The global scratch of a tile (the parked dm, K2b's doj and the
//   readout's direct dh0 term) lies in the first NE H H words of its row of
//   gradient partials: the message gradients of the range's first layer
//   lo, which R writes last (the message backward of layer lo), after the
//   last use of that scratch.  The partial buffer stays as at the narrower
//   widths (_bwd_buffers).
// - The readout's backward (K2b's F) runs by column halves of D, its
//   recompute by row halves too: the gate, d(pre-gate) and d(h Wj + bj) of
//   a column half (T x 64) through the work buffer, one at a time.  The
//   direct term of dh0, dpi Wi[H:]^T, is added to dh in R once layer 0's
//   GRU reverse has consumed it.
// - The message backward takes one edge type and one column half at a
//   time: dhw_e[:, c] = A_e^T dm[:, c] into the work buffer, then dW_e's
//   column half and dh += dhw_e[:, c] W_e[:, c]^T.
// Every dense product runs on the tensor cores in 3xTF32 (h64::tc_mma):
// F's as in the forward (the correction terms in accumulators of their
// own, SEP), the products against transposed weight blocks (xwt) and the
// weight gradients (grad_block) with the three terms in one accumulator,
// as in the H = 64 reverse body.  Each product runs in a loop over its
// blocks (one instance of it, not one a block), and the tile's global
// pointers sit in shared memory (Globals): a body holding both the
// forward's steps and the reverse's fitted 128 registers only so, with its
// depth loops not unrolled.  With R apart from F, the depth loops unroll
// twice in both (FWD_UNROLL, REV_UNROLL: 112 and 114 registers in F, 121
// in R, no spill, nvcc -Xptxas -v for sm_90a); K2b is 3.0% slower with F's
// loop not unrolled, 3.8% with R's (chip_tc64.py phase 8, in turns).  SEP
// in the reverse's products also fits (128 and 127 registers) and brings
// the crowded K1b from 0.393 to 0.176 of its gradient bound, but K2b and
// K1b are 0.8-1.7% slower with it, so it is not kept, and the body gives
// the bits of a reverse that rebuilds the forward.  With thread loops in
// place of the bulk reloads K2b is 5.5% slower.  The weight gradients are
// taken by (64, 64) blocks, two at a time (one on each half of the CTA);
// every output belongs to one thread, which sums its rows in the same order
// in every run, and the tile's rows are summed over P in tile order
// (sum_tiles_kernel), so a run repeats bit for bit.

#pragma once

#include "fused_ggnn128.cuh"

namespace ggnn {
namespace h128 {

constexpr int RO_BWD_BLOCKS = 36;   // the readout's backward: eighteen per column half
constexpr int GRU_REV_BLOCKS = 4 + 20 + 12;  // a GRU half's reverse: 36
constexpr int REV_BLOCKS = MSG_BLOCKS + 2 * GRU_REV_BLOCKS;  // a layer's reverse: 88

// tc_mma's depth-loop unrolling in F's products (the forward's, product_half1)
// and in the products of the reverse and of the readout's backward (xwt,
// grad_block), and SEP in the latter (the note above says what was kept)
constexpr int FWD_UNROLL = 2;
constexpr int REV_UNROLL = 2;
constexpr bool REV_SEP = false;

// The launches of the reverse body (MODE): 0, F of K1b and of each half of
// K3: the forward over [lo, hi), storing each layer's input in hs and its
// m, r, z and n in acts, then dh = dh_top; 1, K2b's F: the same forward
// over [0, L), then the readout's backward, which seeds dh; 2, R: the
// reverse from hs, acts and dh, for every form.
constexpr int R_MODE = 2;

// Shared-memory plan of the reverse in 4-byte words: the forward's, then
// the column lists, the tile's global pointers and R's mbarrier.
struct RPlan {
  static constexpr int HIN = Plan::HIN;      // T H: h
  static constexpr int MS = Plan::MS;        // T H: m, then dm; h0 (readout)
  static constexpr int WORK = Plan::WORK;    // T HB: hw_e[:, c]; r*s then dr'; dhw_e[:, c]
  static constexpr int PANELS = Plan::PANELS;
  static constexpr int B_MSG = Plan::B_MSG;
  static constexpr int BZ = Plan::BZ, BR = Plan::BR, BN = Plan::BN;
  static constexpr int BI = Plan::BI, BJ = Plan::BJ;
  static constexpr int NV = Plan::NV, NK = Plan::NK, NC = Plan::NC;
  static constexpr int CS = Plan::WORDS;             // 4T + 1 column starts
  static constexpr int CR = CS + ROW_LEN + 4;        // T NBR_CAP column-list rows (16-bit)
  static constexpr int CV = CR + TILE * NBR_CAP / 2; // T NBR_CAP column-list values
  static constexpr int OV = CV + TILE * NBR_CAP;     // T crowded rows
  static constexpr int OVN = OV + TILE;              // their count
  static constexpr int PTRS = OVN + 4;               // 11 global pointers (Globals)
  static constexpr int BAR = PTRS + 22;              // R's reload mbarrier (Reloads)
  static constexpr int WORDS = BAR + 2;
  static constexpr size_t BYTES = size_t(WORDS) * 4;
  static_assert(TILE * HB >= COLUMN_MASK_WORDS, "row masks fit in WORK");
  static_assert(PTRS % 2 == 0, "8-byte aligned pointers and mbarrier");
  // the forward's 214,016 bytes, column lists 14.5 KB, pointers, mbarrier
  static_assert(BYTES == 228992, "the plan's bytes");
  static_assert(BYTES <= 232448, "shared-memory plan exceeds 227 KB");
};

// A tile's scratch in global memory, in words from the start of its row of
// gradient partials (the message gradients of the range's first layer).
struct Scratch {
  static constexpr int DIRECT = 0;               // T H: K2b's dpi Wi[H:]^T (row-major)
  static constexpr int PARK = DIRECT + TH;       // HALF H: the first GRU half's dm
  static constexpr int DOJ = PARK + HALF * H;    // T HB: K2b's doj
  static constexpr int WORDS = DOJ + TILE * HB;
  static_assert(WORDS <= NE * H * H, "scratch inside a layer's message gradients");
};

// A layer's stored activations in acts (F writes them, R reads them), each
// T x H in the Tc layout: m after the aggregation (a copy of the shared
// buffer), and the gates r, z and n, each entry written and read by the
// thread that owns it in the GRU's (64, 64) products (own_at).
enum Act { ACT_M = 0, ACT_R = 1, ACT_Z = 2, ACT_N = 3, ACTS = 4 };

// Block i of MODE's sequence over layers [lo, hi).  F (modes 0 and 1): the
// forward over the range (block()'s blocks of those layers), then the
// readout's backward (mode 1), per column half c: Wi(0..3, c), Wj(0..1, c)
// (the recompute) for each row half, Wi(0..1, c) (dh), Wi(2..3, c) (dh0),
// Wj(0..1, c) (dh).  R (mode 2), per layer l = hi - 1 .. lo: per GRU half
// Un(kb, cb) (drs), then per output column half kb Uz(kb, cb), Ur(kb, cb)
// (ds), Wz, Wr, Wn(kb, cb) (dh_in), then per kb Wz, Wr, Wn(2 + kb, cb) (dm),
// cb = 0, 1 each; last the message backward's W_e(kb, c), by e, c, kb.
// nullptr past the sequence's end.  PHASE (0: the forward, 1: the readout's
// backward) is the phase of the take that asks: i lies in it or, for the
// block loaded behind, in a later one, so the readout's takes skip the
// forward's arithmetic.
template <int MODE, int PHASE>
__device__ __forceinline__ const float* rev_block(const Weights& w, const Readout& ro,
                                                  int lo, int hi, int i) {
  if constexpr (MODE != R_MODE) {
    const int nf = (hi - lo) * LAYER_BLOCKS;
    if (PHASE == 0 && i < nf) return block(w, ro, hi, lo * LAYER_BLOCKS + i);
    if (MODE == 0 || i >= nf + RO_BWD_BLOCKS) return nullptr;
    const int r = i - nf, c = r / 18, j = r % 18, k = j < 12 ? j % 6 : j - 12;
    return k < 4 ? blk(ro.wi, k, c) : blk(ro.wj, k - 4, c);
  } else {
    const int l = hi - 1 - i / REV_BLOCKS;
    if (l < lo) return nullptr;
    int j = i % REV_BLOCKS;
    if (j >= 2 * GRU_REV_BLOCKS) {
      j -= 2 * GRU_REV_BLOCKS;
      return blk(w.msg_w + size_t(l * NE + j / 4) * H * H, j % 2, (j / 2) % 2);
    }
    j %= GRU_REV_BLOCKS;
    if (j < 4) return blk(w.un, j / 2, j % 2);
    j -= 4;
    if (j < 20) {
      const int kb = j / 10, k = j % 10;
      const float* m = k < 2 ? w.uz : k < 4 ? w.ur : k < 6 ? w.wz : k < 8 ? w.wr : w.wn;
      return blk(m, kb, k % 2);
    }
    j -= 20;
    const int kb = j / 6, k = j % 6;
    return blk(k < 2 ? w.wz : k < 4 ? w.wr : w.wn, 2 + kb, k % 2);
  }
}

// The panels' walk through MODE's sequence, for the takes of one phase:
// block p.j next (the panels count the blocks handed out).
template <int MODE, int PHASE>
struct RSeq {
  const Weights& w;
  const Readout& ro;
  int lo, hi;
  __device__ const float* take(Panels& p, int tid) {
    return h64::panels_next<Tc, H>(p, rev_block<MODE, PHASE>(w, ro, lo, hi, p.j),
                                   rev_block<MODE, PHASE>(w, ro, lo, hi, p.j + 1), tid);
  }
};

// The tile's rows of the global buffers, kept in shared memory
// (RPlan::PTRS) and read where used, so that no register holds them across
// the body: the adjacency, hs (the range's layer inputs), dh (dh_bot), the
// row of gradient partials (its head the scratch) and its message-bias,
// GRU and readout parts, the range's input (h0 or h_mid), the upstream
// gradient (dh_top, or K2b's dg), K2b's mask and acts (the range's stored
// activations).
struct Globals {
  float* const* ptrs;
  __device__ const float* adj() const { return ptrs[0]; }
  __device__ float* hs(int i) const { return ptrs[1] + size_t(i) * TH; }
  __device__ float* dh() const { return ptrs[2]; }
  __device__ float* part() const { return ptrs[3]; }
  __device__ float* msg_b() const { return ptrs[4]; }
  __device__ float* gru() const { return ptrs[5]; }
  __device__ float* ro() const { return ptrs[6]; }
  __device__ const float* hin() const { return ptrs[7]; }
  __device__ const float* dout() const { return ptrs[8]; }
  __device__ const float* mask() const { return ptrs[9]; }
  // activation a of the range's i-th layer (Act)
  __device__ float* act(int i, int a) const { return ptrs[10] + (size_t(i) * ACTS + a) * TH; }
};

// R's reloads of h and m into shared memory: bulk copies (cp.async.bulk)
// that thread 0 issues once every reader of the buffer is past a barrier,
// completing on one mbarrier (RPlan::BAR) that the CTA waits on before the
// buffer is next read.  Its phases, per reversed layer j = hi - 1 - l: the
// layer's h and m (3 j), the second GRU half's rows of them (3 j + 1), the
// first half's rows of h (3 j + 2); each phase is waited on by every thread
// before the next one's copies are issued.
struct Reloads {
  unsigned long long* bar;
  // thread 0: arrive on the phase, which completes once `words` have landed
  __device__ void expect(int words, int tid) const {
    if (tid == 0) mbar_expect_tx(bar, unsigned(words) * 4);
  }
  // dst[0, words) = src[0, words), 16-byte aligned, on the current phase
  __device__ void copy(float* dst, const float* src, int words, int tid) const {
    if (tid == 0) {
      fence_proxy_async();
      bulk_copy(dst, src, unsigned(words) * 4, bar);
    }
  }
  __device__ void wait(int phase) const { mbar_wait(bar, unsigned(phase) & 1u); }
};

// acc += x w^T for o's block of the 64 rows at x (rows of LD words, the
// depth a column half of them), w a panel: the product against a
// transposed weight block
template <int LD>
__device__ __forceinline__ void xwt(const float* x, const float* w, const Tc::Own& o,
                                    float (&acc)[RPH]) {
  h64::tc_mma<false, true, 1, 2, 16, LD, REV_SEP, HB, REV_UNROLL>(x, w, HB, o.R, o.C, o.g, o.q,
                                                                 acc);
}

// acc += x[rows hf HALF.., kb HB..] w for o's block of half hf: product_half
// (with its SEP, the same terms in the same order, the same bits), the depth
// loop unrolled FWD_UNROLL times
__device__ __forceinline__ void product_half1(const float* x, int hf, int kb, const float* w,
                                              const Tc::Own& o, float (&acc)[RPH]) {
  h64::tc_mma<false, false, 1, 2, 16, H, true, HB, FWD_UNROLL>(x + hf * HALF * H + kb * HB, w,
                                                              HB, o.R, o.C, o.g, o.q, acc);
}

// out[row, col] (+)= (x w^T)[row, col] over the tile, out a column half of
// a row-major T x H buffer in global memory (dh, dh0's direct term), x
// (T x HB, the work buffer) by row halves; each entry read and written by
// the thread that owns it (Tc::Own over the row halves)
__device__ __forceinline__ void xwt_tile_global(const float* x, const float* w, float* out,
                                                bool accumulate) {
  const Tc::Own o(h64::fresh_tid());
#pragma unroll 1
  for (int hf = 0; hf < 2; ++hf) {
    float acc[RPH];
#pragma unroll
    for (int k = 0; k < RPH; ++k)
      acc[k] = accumulate ? out[(hf * HALF + o.row(k)) * H + o.col(k)] : 0.0f;
    xwt<HB>(x + hf * HALF * HB, w, o, acc);
#pragma unroll
    for (int k = 0; k < RPH; ++k) out[(hf * HALF + o.row(k)) * H + o.col(k)] = acc[k];
  }
}

// out (+)= a^T b for one (64, 64) block of a weight gradient over `rows`
// rows, by the 8 warps of one half of the CTA (warp v of the half owns the
// 32 x 16 block at rows 32 (v / 4), columns 16 (v % 4)): a and b column
// blocks of Tc-layout buffers of LDA- and LDB-word rows, out a block of an
// (., H) gradient in global memory; out2, where set, takes the same product
// (zeros without add2).  Each output belongs to one thread and sums the
// rows in the same order in every call.
template <int LDA, int LDB>
__device__ __forceinline__ void grad_block(const float* a, const float* b, float* out,
                                           float* out2, int rows, bool accumulate,
                                           bool add2) {
  const int tid = h64::fresh_tid(), v = (tid >> 5) & 7, lane = tid & 31;
  const int R = 32 * (v >> 2), C = 16 * (v & 3), g = lane >> 2, q = lane & 3;
  float acc[16] = {};
  h64::tc_mma<true, false, 2, 2, 16, LDA, REV_SEP, LDB, REV_UNROLL>(a, b, rows, R, C, g, q,
                                                                   acc);
  // by pairs of adjacent columns, pair j holding acc[2j], acc[2j + 1]
  int f[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    f[j] = (R + 16 * (j >> 2) + g + 8 * (j & 1)) * H + C + 8 * ((j >> 1) & 1) + 2 * q;
  h64::store_pairs(out, f, acc, accumulate, true);
  if (out2 != nullptr) h64::store_pairs(out2, f, acc, accumulate, add2);
}

// NP products a_p^T b_p (H x H each, from rows x H buffers in the Tc
// layout) into out_p (and out2_p, where set)
template <int NP>
struct GradPass128 {
  const float* a[NP];
  const float* b[NP];
  float* out[NP];
  float* out2[NP];
};

// out_p (+)= a_p^T b_p over `rows` rows for p < NP, by (64, 64) blocks
// (ia, cb), two at a time: block 4 p + 2 ia + cb on the half tid / 256
template <int NP>
__device__ __forceinline__ void grad_pass128(const GradPass128<NP>& gp, int rows,
                                             bool accumulate, bool add2, int tid) {
#pragma unroll 1
  for (int jb = tid >> 8; jb < 4 * NP; jb += 2) {
    const int p = jb >> 2, ia = (jb >> 1) & 1, cb = jb & 1;
    const int off = ia * HB * H + cb * HB;
    float* out2 = h64::pick(gp.out2, p);
    grad_block<H, H>(h64::pick(gp.a, p) + ia * HB, h64::pick(gp.b, p) + cb * HB,
                     h64::pick(gp.out, p) + off, out2 == nullptr ? nullptr : out2 + off,
                     rows, accumulate, add2);
  }
}

// out_q[c] (+)= the sum over `rows` rows of column c of s_q (a Tc-layout
// buffer of LD-word rows) for c < COLS, q < NS: thread j < NS COLS owns
// column j % COLS of s_{j / COLS} and sums its rows in order
template <int NS, int COLS, int LD>
__device__ __forceinline__ void col_sums(const float* const (&s)[NS], float* const (&out)[NS],
                                         int rows, bool accumulate, int tid) {
  static_assert(NS * COLS <= THREADS, "a thread a column");
  if (tid >= NS * COLS) return;
  const int c = tid % COLS;
  const float* x = h64::pick(s, tid / COLS);
  float acc = 0.0f;
#pragma unroll 4
  for (int i = 0; i < rows; ++i) acc += x[i * LD + (c ^ swz(i))];
  float* o = h64::pick(out, tid / COLS) + c;
  *o = accumulate ? *o + acc : acc;
}

// ---------------------------------------------------------------------------
// F's forward steps, each product in a loop over its blocks (one instance
// of the product where the forward body writes one a block: K2b's F holds
// the readout's backward too, and fits its registers only so), the same
// terms in the same order as the forward body's

// acc[hf] += x[:, kb HB..] w over the tile by row halves: product_tile's
// terms in its order (the same bits), with half its accumulators live
__device__ __forceinline__ void product_halves(const float* x, int kb, const float* w,
                                               const Tc::Own& o, float (&acc)[2][RPH]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) product_half1(x, hf, kb, w, o, acc[hf]);
}

// m = A_flat [h W_e + b_e]_e of layer l, as h128::messages takes it.  The
// caller synchronises before m is read.
template <class S>
__device__ __forceinline__ void messages_looped(const Tile& t, const Globals& g, S& seq,
                                                Panels& p, int tid) {
  const Tc::Own o(h64::fresh_tid());
#pragma unroll 1
  for (int ec = 0; ec < 2 * NE; ++ec) {
    const int e = ec >> 1, c = ec & 1;
    float acc[2][RPH];
#pragma unroll 1
    for (int kb = 0; kb < 2; ++kb) {
      const float* wb = seq.take(p, tid);
      // the biases, written at the layer's start, are read after a barrier
      if (kb == 0) {
        fill_half(acc[0], t.bmsg + e * H + c * HB, o);
        fill_half(acc[1], t.bmsg + e * H + c * HB, o);
      }
      product_halves(t.h, kb, wb, o, acc);
    }
#pragma unroll
    for (int j = 0; j < 2 * RPH; ++j) t.work[h64::tile_at(o, j)] = acc[j / RPH][j % RPH];
    __syncthreads();
    h64::aggregate_edge<Tc, Wide>(g.adj(), e, t.work, t.m + c * HB, t.nk, t.nv, t.nc, tid);
  }
}

// acc += the six blocks of gate g (0: r, 1: z, 2: n) for the rows of half
// hf, through the sequence's next six blocks, as gate_xs (r, z: h, h, s = h
// by U, s, m, m) and gate_n (n: h, h, m, m, r*s by U, r*s) take them; the
// state's blocks are handed out at layer 0 too, and not used
template <class S>
__device__ __forceinline__ void gate_blocks(const Tile& t, int hf, bool zero_state, int g,
                                            S& seq, Panels& p, const Tc::Own& o,
                                            float (&acc)[RPH], int tid) {
#pragma unroll 1
  for (int k = 0; k < 6; ++k) {
    const float* wb = seq.take(p, tid);
    const bool state = g == 2 ? k >= 4 : k == 2 || k == 3;
    const float* x = g == 2 && k >= 4 ? t.work
                     : ((g == 2 ? k < 2 : k < 4) ? t.h : t.m) + hf * HALF * H;
    if (!(state && zero_state)) product_half1(x, 0, k & 1, wb, o, acc);
  }
}

// The GRU on the rows of half hf as gru_half computes it (r by column
// halves into r*s, z and n by column halves, then h' = z n + (1 - z) s in
// place), the gates' blocks through gate_blocks; r, z and n go to the
// layer's acts (T x H each, the entries of the thread that owns them), which
// R reads, and z and n are read back from there once the products that read
// the half's rows of h are done.
template <class S>
__device__ __forceinline__ void gru_half_looped(const Tile& t, bool zero_state, int hf,
                                                float* rg, float* zg, float* ng, S& seq,
                                                Panels& p, int tid) {
  const Tc::Own o(h64::fresh_tid());
#pragma unroll 1
  for (int gc = 0; gc < 6; ++gc) {  // r, z, n by column halves
    const int g = gc >> 1, c = gc & 1;
    float acc[RPH];
    fill_half(acc, (g == 0 ? t.br : g == 1 ? t.bz : t.bn) + c * HB, o);
    gate_blocks(t, hf, zero_state, g, seq, p, o, acc, tid);
#pragma unroll
    for (int k = 0; k < RPH; ++k) {
      const int ih = own_at(o, k, hf, c);
      if (g == 0) {
        const float r = sigmoidf(acc[k]);
        rg[ih] = r;
        t.work[own_at(o, k, 0, c)] = zero_state ? 0.0f : r * t.h[ih];
      } else if (g == 1) {
        zg[ih] = sigmoidf(acc[k]);
      } else {
        ng[ih] = tanhf(acc[k]);
      }
    }
  }
  // no thread reads these rows of h after the last block's barrier (z and
  // n read back one entry at a time: with the loads batched, nvcc fuses
  // this step's products another way and the forward's bits change,
  // chip_tc64.py phase 8)
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int k = 0; k < RPH; ++k) {
      const int ih = own_at(o, k, hf, c);
      const float z = zg[ih], s = zero_state ? 0.0f : t.h[ih];
      t.h[ih] = z * ng[ih] + (1.0f - z) * s;
    }
  }
}

}  // namespace h128
}  // namespace ggnn
