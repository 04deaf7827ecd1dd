// The GGNN kernels' layer steps at H = 64, shared by the forward body
// (fused_ggnn.cu: K1, K1m, K2) and the reverse body (fused_ggnn_bwd.cu:
// K1b, K3, K2b) at that width: the shared-memory plan, the weight panels,
// the message step one edge type at a time, the GRU gates (by halves of
// the tile in the reverse, over the tile in the forward), the readout's
// pre-activations and the products.
//
// Why H = 64 has a design of its own: GgnnPlan (fused_ggnn_common.cuh)
// keeps every weight, h, m and the 4T x H hw stack in shared memory.  At
// H = 64 that is 442 KB forward and 493 KB backward, against 227 KB per
// CTA; the weights alone (the GRU and one layer's messages, rows padded)
// take 226 KB.  So at this width:
// - The weights stay in global memory (L2) and pass through two staged
//   panels of one (64, 64) block each: while the CTA multiplies by block
//   j, cp.async brings block j + 1 into the other panel (panels_next).
//   Every product is split into products by (64, 64) blocks: the message
//   weight W_e, the GRU's Wz, Wr, Wn by their h and m halves, Uz, Ur, Un,
//   the readout's Wi by halves and Wj.
// - The message step takes one edge type at a time: hw_e = h W_e + b_e
//   (T x H) into one buffer, then m += A_e hw_e, each row's sum running on
//   in ascending column order across e, so m adds the same terms in the
//   same order as the 4T x H stack of the narrower widths.  The reverse
//   gathers dhw_e = A_e^T dm one edge type at a time the same way.
// - The reverse runs the GRU on the tile's rows in two halves of 64 (its
//   gates are row-local), so that its r*s, dz', dr', dn' take 64 rows each
//   (64 KB together) instead of 128.  The gates are taken one at a time,
//   z and r parked in shared memory, so one set of accumulators is live.
// - The reverse body keeps 8 outputs of a product a thread in registers (16
//   for a weight gradient): its message and readout products also go by
//   halves of the tile, and it fits 128 registers a thread without
//   spilling.  The forward body, which has registers to spare, takes every
//   product over the whole tile instead (layer_forward_tile): the two
//   halves share each staged panel, so its GRU stages 9 panels a layer,
//   not 18, and each B fragment feeds both halves.
// - Index lists are 16-bit (columns < 512, rows < 128).
// The plan comes to 211,712 bytes forward and 226,624 backward (Plan).
//
// Every dense product runs on the tensor cores in 3xTF32 (Tc).  Each
// operand is split into a TF32 high part and a TF32 remainder (split_tf32),
// and each 8-deep step of a product issues three m16n8k8 mma.sync (lo*hi,
// hi*lo, hi*hi; lo*lo is dropped) into f32 accumulators: about 2^-21 of
// each term, the f32 bounds the kernels are held to.  The forward sums the
// correction terms in accumulators of their own (tc_mma's SEP), the
// reverse, which has no registers for them, with hi*hi.  The T x H buffers and
// the panels are rows of H words whose 4-word column groups are XORed by
// the row (swz), so that every fragment load, in each orientation the
// bodies read (x W, x W^T, a^T b), puts the 32 lanes on 32 banks.  An
// operand read along its rows comes by ldmatrix, the others by single
// loads.  Ownership is the mma accumulator's: warp w of a (64, 64) product
// owns the 16 x 16 block at rows 16 (w / 4), columns 16 (w % 4) (over the
// tile: that block of each half), and lane (g, q) = (lane / 4, lane % 4)
// its rows g and g + 8, columns 2q, 2q + 1 of each 8-column half; an
// elementwise step works on those entries.
// Splitting a value where it is loaded takes five instructions, some twenty
// of the fifty an 8-deep step of a warp issues.  The forward splits h, the
// A operand of most of its products (the messages, five of the GRU's nine,
// two of the readout's three), once: the thread that writes an entry of h
// also writes its two TF32 parts (split_store, 64 KB the reverse's plan has
// no room for), and those products load both parts by ldmatrix
// (tc_mma_split_a).  Weight panels split once when staged (a float4 of hi,
// lo at the two depths of a B fragment) were tried, and ran slower than
// the split at load (chip_tc64.py, phase 5: the split pass sits between
// every panel's arrival and its barrier).

#pragma once

#include "fused_ggnn_common.cuh"

namespace ggnn {
namespace h64 {

constexpr int H = 64;
constexpr int TH = TILE * H;
constexpr int HALF = TILE / 2;        // rows of half the tile
constexpr int RS = THREADS / H;       // 8: stride of a column gather's rows
constexpr int RPH = HALF * H / THREADS;  // 8 outputs per thread over a half
constexpr int PANEL = H * H;          // words of one (64, 64) weight block
using Idx = unsigned short;           // row- and column-list indices

// ---------------------------------------------------------------------------
// the 3xTF32 tensor-core products (Tc)

// threadIdx.x read anew where it is called: what a caller computes from it
// is then computed there, and no register holds it across the body.
#ifdef __CUDACC__
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}
#else
inline int fresh_tid() { return threadIdx.x; }
#endif

// The XOR of row `row`'s 4-word column groups: the groups of rows 8j ..
// 8j + 7 are permuted so that both the lanes' rows g (fragment rows, 8 of
// them) and their rows q, q + 4 (fragment depths, 4 and 2 groups) fall on
// distinct banks.
__device__ __forceinline__ int swz(int row) {
  return (((row & 3) << 1) | ((row >> 2) & 1)) << 2;
}

// v rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// half an ulp of TF32 added to the magnitude's bits, then the 13 low bits
// cleared.  The same bits as cvt.rna.tf32.f32 for every finite v, in two
// integer instructions that an H100 issues faster than the conversion
// (chip_tc64.py times the body both ways).
__device__ __forceinline__ float tf32_rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}

#ifdef __CUDACC__
// d += a b for the warp's m16n8k8 fragments (TF32 in, f32 accumulators):
// a the (16, 8) A rows g, g + 8 at depths q, q + 4 (a0 a1 a2 a3), b the
// (8, 8) B depths q, q + 4 at column g, d the rows g, g + 8 at columns
// 2q, 2q + 1 (d0 d1 d2 d3), with (g, q) = (lane / 4, lane % 4).
__device__ __forceinline__ void mma_tf32(float* d, const float* a, const float* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

// ldmatrix.x4 of 32-bit words: four 8 x 4 blocks, lane 8j + r giving the
// address of row r of block j (16 bytes, aligned); r[j] of lane (g, q) is
// block j's word (g, q), the place of an m16n8k8 TF32 fragment's entry.
__device__ __forceinline__ void ldsm_x4(float (&r)[4], const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned x0, x1, x2, x3;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(x0), "=r"(x1), "=r"(x2), "=r"(x3) : "r"(s));
  r[0] = __uint_as_float(x0); r[1] = __uint_as_float(x1);
  r[2] = __uint_as_float(x2); r[3] = __uint_as_float(x3);
}
#endif

// v = hi + lo, each a TF32 value; v - hi is exact in f32.
__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - hi);
}

// acc += A B in 3xTF32 over the depth [0, depth) for the warp's block of
// NM x NN tiles (16 x 8) at rows R + MS mi, columns C + 8 nj, every
// operand a buffer of H-word rows in the Tc layout (A without TA: rows of
// LDA words, whose swizzle is the same for any multiple of 32): A[r][k] =
// a[k][r] if TA else a[r][k], B[k][c] = b[c][k] if TB else b[k][c].  acc holds tile
// (mi, nj)'s d0..d3 at 4 (mi NN + nj).  R and C are multiples of 16 and 8,
// so each lane's swizzle is one of four constants.  An operand read along
// its rows (A without TA, B with TB) comes by ldmatrix, four 8 x 4 blocks
// a load; the transposed ones by single loads.  With SEP the two
// correction products (lo*hi, hi*lo) go to an accumulator of their own,
// added to acc at the end: the tensor cores truncate each mma's sum to the
// magnitude of its accumulator, so acc then takes one truncation per
// 8-deep step instead of three.  The forward bodies (H = 64, 128) take
// every product with SEP; the reverse body without, since the 4 NM NN
// more registers make it spill (chip_tc64.py phase 4).
template <bool TA, bool TB, int NM, int NN, int MS = 16, int LDA = H, bool SEP = false>
__device__ __forceinline__ void tc_mma(const float* a, const float* b, int depth,
                                       int R, int C, int g, int q, float* acc) {
  static_assert(!TB || NN == 2, "ldmatrix brings two n-tiles of B");
  float cor[SEP ? 4 * NM * NN : 1];
#pragma unroll
  for (int i = 0; i < (SEP ? 4 * NM * NN : 1); ++i) cor[i] = 0.0f;
  const int sg = swz(g), sq0 = swz(q), sq1 = swz(q + 4);
  // ldmatrix: lane 8j + r gives row r of block j
  const int lr = (4 * g + q) & 7, lj = (4 * g + q) >> 3, slr = swz(lr);
#pragma unroll 2
  for (int k0 = 0; k0 < depth; k0 += 8) {
    float ah[NM][4], al[NM][4];
#pragma unroll
    for (int mi = 0; mi < NM; ++mi) {
      float v[4];
      if constexpr (TA) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = R + MS * mi + g + 8 * (i & 1);
          v[i] = a[(k0 + q + 4 * (i >> 1)) * H + (r ^ (i >> 1 ? sq1 : sq0))];
        }
      } else {  // blocks: rows +0 / +8 (j & 1), depths +0 / +4 (j >> 1)
        ldsm_x4(v, a + (R + MS * mi + lr + 8 * (lj & 1)) * LDA + ((k0 + 4 * (lj >> 1)) ^ slr));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], ah[mi][i], al[mi][i]);
    }
    float bt[4];  // with TB: blocks depths +0 / +4 (j & 1) of n-tiles j >> 1
    if constexpr (TB)
      ldsm_x4(bt, b + (C + lr + 8 * (lj >> 1)) * H + ((k0 + 4 * (lj & 1)) ^ slr));
#pragma unroll
    for (int nj = 0; nj < NN; ++nj) {
      float bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = C + 8 * nj + g;
        split_tf32(TB ? bt[2 * nj + i] : b[(k0 + q + 4 * i) * H + (c ^ (i ? sq1 : sq0))],
                   bh[i], bl[i]);
      }
#pragma unroll
      for (int mi = 0; mi < NM; ++mi) {
        float* d = acc + 4 * (mi * NN + nj);
        float* e = SEP ? cor + 4 * (mi * NN + nj) : d;
        mma_tf32(e, al[mi], bh);
        mma_tf32(e, ah[mi], bl);
        mma_tf32(d, ah[mi], bh);
      }
    }
  }
  if constexpr (SEP) {
#pragma unroll
    for (int i = 0; i < 4 * NM * NN; ++i) acc[i] += cor[i];
  }
}

struct Tc {
  __device__ static int at(int row, int col) { return row * H + (col ^ swz(row)); }
  __device__ static int panel_at(int row, int col) { return at(row, col); }
  // the panel loads' addresses, recomputed at each load (kept across the
  // reverse body, they cost it its last registers and spill)
  __device__ static int panel_tid(int) { return fresh_tid(); }
  // warp v of a product's 16 owns rows 16 (v / 4), columns 16 (v % 4) of
  // its (64, 64) output; entry k of lane (g, q) is d[k % 4] of n-tile k / 4
  struct Own {
    int R, C, g, q;
    __device__ Own(int v, int lane)
        : R(16 * (v >> 2)), C(16 * (v & 3)), g(lane >> 2), q(lane & 3) {}
    __device__ explicit Own(int tid) : Own(tid >> 5, tid & 31) {}
    __device__ int row(int k) const { return R + g + 8 * ((k >> 1) & 1); }
    __device__ int col(int k) const { return C + 8 * (k >> 2) + 2 * q + (k & 1); }
    // Tc::at(row(k), col(k)): rows g and g + 8 share one swizzle, and a
    // column's low bit lies outside it, so two bases and immediates
    __device__ int at(int k) const {
      return (R + g + 8 * ((k >> 1) & 1)) * H + ((C + 8 * (k >> 2) + 2 * q) ^ swz(g)) +
             (k & 1);
    }
  };
  // acc += x w over a half tile (x: 64 rows, w: a panel)
  __device__ static void product(const float* x, const float* w, const Own& o,
                                 float (&acc)[RPH]) {
    tc_mma<false, false, 1, 2>(x, w, H, o.R, o.C, o.g, o.q, acc);
  }
  // acc += x w over the tile (x: 128 rows), o's block of each half: half
  // hf's entry k at acc[RPH hf + k]; one B fragment feeds both halves (the
  // forward's product, with SEP)
  __device__ static void product_tile(const float* x, const float* w, const Own& o,
                                      float (&acc)[2 * RPH]) {
    tc_mma<false, false, 2, 2, HALF, H, true>(x, w, H, o.R, o.C, o.g, o.q, acc);
  }
};

// h's TF32 parts, as the forward keeps them: hs[i] = hi, hs[TH + i] = lo
// of h[i] (split_tf32), written by the thread that writes h[i]
__device__ __forceinline__ void split_store(float* hs, int i, float v) {
  split_tf32(v, hs[i], hs[TH + i]);
}

// acc += x w over the tile for the warp's 16 x 16 blocks at rows R and
// R + HALF, columns C, with x given by its TF32 parts (split_store), w a
// panel split at load: Tc::product_tile term for term (the same split
// values in the same mma order, the correction terms apart as with SEP, the
// same bits), each A fragment two ldmatrix and no split.
__device__ __forceinline__ void tc_mma_split_a(const float* xs, const float* b, int R,
                                               int C, int g, int q, float* acc) {
  float cor[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) cor[i] = 0.0f;
  const int sq0 = swz(q), sq1 = swz(q + 4);
  const int lr = (4 * g + q) & 7, lj = (4 * g + q) >> 3, slr = swz(lr);
  const float* arow = xs + (R + lr + 8 * (lj & 1)) * H;
#pragma unroll 2
  for (int k0 = 0; k0 < H; k0 += 8) {
    float ah[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* a = arow + mi * HALF * H + ((k0 + 4 * (lj >> 1)) ^ slr);
      ldsm_x4(ah[mi], a);
      ldsm_x4(al[mi], a + TH);
    }
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      float bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        split_tf32(b[(k0 + q + 4 * i) * H + ((C + 8 * nj + g) ^ (i ? sq1 : sq0))],
                   bh[i], bl[i]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float* d = acc + 4 * (2 * mi + nj);
        float* e = cor + 4 * (2 * mi + nj);
        mma_tf32(e, al[mi], bh);
        mma_tf32(e, ah[mi], bl);
        mma_tf32(d, ah[mi], bh);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] += cor[i];
}

// acc += x w^T for the rows of x at o's block (w a panel: the product
// against the transposed weight)
__device__ __forceinline__ void tc_xwt(const float* x, const float* w,
                                       const Tc::Own& o, float (&acc)[RPH]) {
  tc_mma<false, true, 1, 2>(x, w, H, o.R, o.C, o.g, o.q, acc);
}

// o[f[j]], o[f[j] + 1] (+)= v[2j], v[2j + 1] (zeros without `take`) for
// j < N / 2: every old value loaded before the first store, so the loads
// go out together (o could alias other outputs, as far as the compiler
// knows, which would order each load after the store before it).
template <int N>
__device__ __forceinline__ void store_pairs(float* o, const int (&f)[N / 2],
                                            const float (&v)[N], bool accumulate,
                                            bool take) {
  float2 old[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j)
    old[j] = accumulate ? *reinterpret_cast<const float2*>(o + f[j]) : float2{0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float x = take ? v[2 * j] : 0.0f, y = take ? v[2 * j + 1] : 0.0f;
    *reinterpret_cast<float2*>(o + f[j]) =
        accumulate ? float2{old[j].x + x, old[j].y + y} : float2{x, y};
  }
}

// ptrs[p] for a thread-dependent p < N, by selects (an index into the
// array would put it in local memory)
template <int N, class T>
__device__ __forceinline__ T pick(T const (&ptrs)[N], int p) {
  T r = ptrs[0];
#pragma unroll
  for (int i = 1; i < N; ++i) r = p == i ? ptrs[i] : r;
  return r;
}

// Weight gradients over `rows` rows (64 or 128, buffers in the Tc layout),
// as grad_pass of the narrower widths: out_p (H, H) (+)= a_p^T b_p for
// p < NP (out2_p, where set, takes the same product, or zeros without
// `add2`), s_out_q (H) (+)= column sums of s_q for q < NS.  A product
// takes 8 warps, warp v the 32 x 16 block at rows 32 (v / 4), columns 16
// (v % 4); threads [256 NP, 256 NP + NSUM) own columns of the sums.  Each
// output belongs to one thread and sums the rows in the same order in
// every call.
template <int NP, int NS, int NSUM>
__device__ __forceinline__ void tc_grad_pass(const GradPass<NP, NS>& gp, int rows,
                                             bool accumulate, bool add2, int tid) {
  constexpr int TPP = 256;  // threads of a product
  static_assert(NP * TPP + NSUM <= THREADS, "threads of a gradient pass");
  if (tid < NP * TPP) {
    const int p = tid / TPP, v = (tid % TPP) >> 5, lane = tid & 31;
    const int R = 32 * (v >> 2), C = 16 * (v & 3), g = lane >> 2, q = lane & 3;
    float acc[16] = {};
    tc_mma<true, false, 2, 2>(pick(gp.a, p), pick(gp.b, p), rows, R, C, g, q, acc);
    // by pairs of adjacent columns, pair j holding acc[2j], acc[2j + 1]
    int f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      f[j] = (R + 16 * (j >> 2) + g + 8 * (j & 1)) * H + C + 8 * ((j >> 1) & 1) + 2 * q;
    float* out2 = pick(gp.out2, p);
    store_pairs(pick(gp.out, p), f, acc, accumulate, true);
    if (out2 != nullptr) store_pairs(out2, f, acc, accumulate, add2);
  } else if constexpr (NS > 0) {
    if (tid >= NP * TPP + NSUM) return;
    constexpr int COLS = NS * H;
    constexpr int PER = (COLS + NSUM - 1) / NSUM;
    const int j = tid - NP * TPP;
    float acc[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) acc[q] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < rows; ++i)
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int f = j + q * NSUM;
        if (f < COLS) acc[q] += pick(gp.s, f / H)[Tc::at(i, f % H)];
      }
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int f = j + q * NSUM;
      if (f < COLS) {
        float* o = pick(gp.s_out, f / H) + f % H;
        *o = accumulate ? *o + acc[q] : acc[q];
      }
    }
  }
}

// Shared-memory plan in 4-byte words; BWD adds dh, a second T x H of work
// space and the column lists, the forward h's TF32 parts (HS).  WORK holds hw_e
// / dhw_e (T x H); the forward's r*s (T x H); in a GRU half of the reverse
// r*s, z and r, then r*s, dz', dr', dn' (z and r where dz' and dr' go), in
// K2b's seed the gate, d(pre-gate) and d(h Wj + bj) (T x H each); the
// column build's row masks.
template <bool BWD>
struct Plan {
  static constexpr int HIN = 0;                          // T H: h
  static constexpr int MS = HIN + TH;                    // T H: m, then dm; h0 (readout)
  static constexpr int DH = MS + TH;                     // T H: dh (BWD)
  static constexpr int WORK = DH + (BWD ? TH : 0);
  static constexpr int HS = WORK + (BWD ? 2 : 1) * TH;   // 2 T H: h's TF32 parts (forward)
  static constexpr int PANELS = HS + (BWD ? 0 : 2) * TH; // 2 PANEL
  static constexpr int B_MSG = PANELS + 2 * PANEL;       // 4 H: layer l's b_e
  static constexpr int BZ = B_MSG + NE * H;              // H each
  static constexpr int BR = BZ + H;
  static constexpr int BN = BR + H;
  static constexpr int BI = BN + H;                      // readout biases
  static constexpr int BJ = BI + H;
  static constexpr int NV = BJ + H;                      // T NBR_CAP row-list values
  static constexpr int NK = NV + TILE * NBR_CAP;         // T NBR_CAP row-list columns (16-bit)
  static constexpr int NC = NK + TILE * NBR_CAP / 2;     // T row nonzero counts
  static constexpr int CS = NC + TILE;                   // 4T + 1 column starts
  static constexpr int CR = CS + ROW_LEN + 4;            // T NBR_CAP column-list rows (16-bit)
  static constexpr int CV = CR + TILE * NBR_CAP / 2;     // T NBR_CAP column-list values
  static constexpr int OV = CV + TILE * NBR_CAP;         // T crowded rows
  static constexpr int OVN = OV + TILE;                  // their count
  static constexpr int PTRS = OVN + 4;                   // 4 global pointers (BWD)
  static constexpr int WORDS = BWD ? PTRS + 8 : CS;
  static constexpr size_t BYTES = size_t(WORDS) * 4;
  static_assert(PANELS % 4 == 0 && B_MSG % 4 == 0 && WORK % 4 == 0 && HS % 4 == 0,
                "16-byte aligned rows");
  static_assert(!BWD || 2 * TH >= COLUMN_MASK_WORDS, "row masks fit in WORK");
  static_assert(BYTES <= 232448, "shared-memory plan exceeds 227 KB");
};

// ---------------------------------------------------------------------------
// weight panels

// Two staged (64, 64) weight blocks; block j of a kernel's sequence sits in
// buf + (j & 1) PANEL, in P's panel layout.  Each call of panels_next names
// the block it hands out and the one to load behind it, so the sequence is
// written out where the blocks are used.
struct Panels {
  float* buf;
  int j;
#ifndef __CUDACC__
  const float* src[2];  // the CPU stand-in checks the names against the loads
#endif
};

// One (64, 64) block (rows of 64 contiguous floats LD apart, 16-byte
// aligned) into a panel, by cp.async: 1,024 16-byte copies, 2 a thread.
template <class P, int LD = H>
__device__ __forceinline__ void panel_load(const float* __restrict__ src,
                                           float* dst, int tid) {
  static_assert(H * H / 4 == 2 * THREADS, "two copies a thread");
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = P::panel_tid(tid) + s * THREADS;
    const int row = q / (H / 4), c = (q % (H / 4)) * 4;
    __pipeline_memcpy_async(dst + P::panel_at(row, c), src + row * LD + c, 16);
  }
}

template <class P, int LD = H>
__device__ __forceinline__ void panels_start(Panels& p, float* buf,
                                             const float* first, int tid) {
  p.buf = buf;
  p.j = 0;
#ifndef __CUDACC__
  p.src[0] = first;
  p.src[1] = nullptr;
#endif
  panel_load<P, LD>(first, buf, tid);
  __pipeline_commit();
}

// Wait for block j (loaded from `cur`) and synchronise the CTA: every
// thread is then done with block j - 1 and with whatever it wrote before
// the call.  Then start loading `next` (nullptr: nothing) into block j - 1's
// panel, and return block j.  LD: the row stride of the blocks' matrices.
template <class P, int LD = H>
__device__ __forceinline__ const float* panels_next(Panels& p, const float* cur,
                                                    const float* next, int tid) {
  __pipeline_wait_prior(0);
  __syncthreads();
  float* here = p.buf + (p.j & 1) * PANEL;
#ifndef __CUDACC__
  if (p.src[p.j & 1] != cur) __builtin_trap();
  p.src[(p.j + 1) & 1] = next;
#endif
  if (next != nullptr) panel_load<P, LD>(next, p.buf + ((p.j + 1) & 1) * PANEL, tid);
  __pipeline_commit();
  ++p.j;
  return here;
}

__device__ __forceinline__ const float* msg_panel(const Weights& w, int l, int e) {
  return w.msg_w + size_t(l * NE + e) * H * H;
}

// ---------------------------------------------------------------------------
// the layer's steps

// m (+)= A_e hw_e (s_hw: hw_e, T x H) for edge type e: one warp per row,
// lane c owns columns c and c + 32.  The row-list entries of e's columns
// [eT, eT + T), or a crowded row's dense columns there, in ascending
// order; m starts at zero for e = 0 and carries on for e > 0, so each row
// sums its terms in ascending column order of A_flat.  m is in PM's layout
// (P's unless given: the H = 128 body's m is a column half of a wider
// buffer).
template <class P, class PM = P>
__device__ __forceinline__ void aggregate_edge(const float* adj_t, int e,
                                               const float* s_hw, float* s_m,
                                               const Idx* s_nk, const float* s_nv,
                                               const int* s_nc, int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lo = e * TILE;
  for (int i = warp; i < TILE; i += WARPS) {
    float a0 = e == 0 ? 0.0f : s_m[PM::at(i, lane)];
    float a1 = e == 0 ? 0.0f : s_m[PM::at(i, lane + 32)];
    const int cnt = s_nc[i];
    if (cnt > NBR_CAP) {
      const float* arow = adj_t + size_t(i) * ROW_LEN + lo;
      float av[TILE / 32];
#pragma unroll
      for (int q = 0; q < TILE / 32; ++q) av[q] = __ldg(arow + q * 32 + lane);
#pragma unroll
      for (int q = 0; q < TILE / 32; ++q) {
        const float a = av[q];
        unsigned nz = __ballot_sync(0xffffffffu, a != 0.0f);
        while (nz) {
          const int b = __ffs(nz) - 1;
          nz &= nz - 1;
          const float v = __shfl_sync(0xffffffffu, a, b);
          const int k = q * 32 + b;
          a0 = fmaf(v, s_hw[P::at(k, lane)], a0);
          a1 = fmaf(v, s_hw[P::at(k, lane + 32)], a1);
        }
      }
    } else {
      for (int n = 0; n < cnt; ++n) {
        const int k = int(s_nk[i * NBR_CAP + n]) - lo;
        if (k < 0 || k >= TILE) continue;
        const float v = s_nv[i * NBR_CAP + n];
        a0 = fmaf(v, s_hw[P::at(k, lane)], a0);
        a1 = fmaf(v, s_hw[P::at(k, lane + 32)], a1);
      }
    }
    s_m[PM::at(i, lane)] = a0;
    s_m[PM::at(i, lane + 32)] = a1;
  }
}

// dhw_e (T x H) = A_e^T dm for edge type e: thread owns column c of the
// rows k of dhw_e, column eT + k of A_flat: its column list in ascending
// row order, then the crowded rows in ascending order, as column_gather.
template <class P>
__device__ __forceinline__ void column_gather_edge(const float* adj_t, int e,
                                                   const float* s_dm,
                                                   const int* s_cs, const Idx* s_cr,
                                                   const float* s_cv, const int* s_ov,
                                                   int n_ov, float* s_dhw, int tid) {
  const int c = tid % H;
  for (int k = tid / H; k < TILE; k += RS) {
    const int kk = e * TILE + k;
    float acc = 0.0f;
    const int end = s_cs[kk + 1];
    for (int q = s_cs[kk]; q < end; ++q)
      acc = fmaf(s_cv[q], s_dm[P::at(int(s_cr[q]), c)], acc);
    for (int o = 0; o < n_ov; ++o) {
      const int i = s_ov[o];
      const float a = __ldg(adj_t + size_t(i) * ROW_LEN + kk);
      if (a != 0.0f) acc = fmaf(a, s_dm[P::at(i, c)], acc);
    }
    s_dhw[P::at(k, c)] = acc;
  }
}

// The shared-memory buffers of a layer step.
struct Tile {
  const float* adj_t;
  float* h;            // T x H: the layer's input, updated in place forward
  float* m;            // T x H
  float* work;         // hw_e; r*s at the head of the GRU halves
  float* bmsg;         // 4 H: layer l's message biases
  const float* bz; const float* br; const float* bn;
  const Idx* nk; const float* nv; const int* nc;
  float* hs;           // forward: h's TF32 parts (split_store), 2 T x H
};

// m = A_flat [h W_e + b_e]_e, one edge type at a time (panels W_0..W_3 of
// layer l, then `next`); hw_e by halves of the tile (8 outputs a thread).
// The caller synchronises before m is read.
template <class P>
__device__ __forceinline__ void messages(const Tile& t, const Weights& w, int l,
                                         Panels& p, const float* next, int tid) {
  const typename P::Own o(tid);
#pragma unroll 1
  for (int e = 0; e < NE; ++e) {
    const float* we = panels_next<P>(
        p, msg_panel(w, l, e), e + 1 < NE ? msg_panel(w, l, e + 1) : next, tid);
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float acc[RPH];
#pragma unroll
      for (int k = 0; k < RPH; ++k) acc[k] = t.bmsg[e * H + o.col(k)];
      P::product(t.h + hf * HALF * H, we, o, acc);
      float* hw = t.work + hf * HALF * H;
#pragma unroll
      for (int k = 0; k < RPH; ++k) hw[o.at(k)] = acc[k];
    }
    __syncthreads();
    aggregate_edge<P>(t.adj_t, e, t.work, t.m, t.nk, t.nv, t.nc, tid);
  }
}

// The GRU gates of the rows [hf HALF, hf HALF + HALF), x = [h, m], state
// s = h (zero at layer 0, `zero_state`), for the thread's 8 entries:
//   z = sigmoid(x Wz + s Uz + bz), r = sigmoid(x Wr + s Ur + br),
//   n = tanh(x Wn + (r*s) Un + bn),
// through the panels Wz[:H], Uz, Wz[H:], Wr[:H], Ur, Wr[H:], Wn[:H],
// Wn[H:], Un, then `next` (the state's blocks are loaded at layer 0 too,
// and not used).  One gate at a time, so that one set of accumulators is
// live: z goes to t.work + HALF H, r*s to t.work, r to t.work + 2 HALF H
// when `keep_r` (the reverse's), each (HALF x H) entry by the thread that
// owns it; n stays in registers.
template <class P>
__device__ __forceinline__ void gates(const Tile& t, const Weights& w, bool zero_state,
                                      int hf, bool keep_r, Panels& p,
                                      const float* next, float (&n)[RPH], int tid) {
  const typename P::Own o(tid);
  const float* h = t.h + hf * HALF * H;
  const float* m = t.m + hf * HALF * H;
  float* s_rs = t.work;
  float* s_z = t.work + HALF * H;
  float* s_r = t.work + 2 * HALF * H;
  const float* wz1 = w.wz + H * H;
  const float* wr1 = w.wr + H * H;
  const float* wn1 = w.wn + H * H;
  {
    float z[RPH];
#pragma unroll
    for (int k = 0; k < RPH; ++k) z[k] = t.bz[o.col(k)];
    P::product(h, panels_next<P>(p, w.wz, w.uz, tid), o, z);
    const float* uz = panels_next<P>(p, w.uz, wz1, tid);
    if (!zero_state) P::product(h, uz, o, z);
    P::product(m, panels_next<P>(p, wz1, w.wr, tid), o, z);
#pragma unroll
    for (int k = 0; k < RPH; ++k) s_z[o.at(k)] = sigmoidf(z[k]);
  }
  {
    float r[RPH];
#pragma unroll
    for (int k = 0; k < RPH; ++k) r[k] = t.br[o.col(k)];
    P::product(h, panels_next<P>(p, w.wr, w.ur, tid), o, r);
    const float* ur = panels_next<P>(p, w.ur, wr1, tid);
    if (!zero_state) P::product(h, ur, o, r);
    P::product(m, panels_next<P>(p, wr1, w.wn, tid), o, r);
#pragma unroll
    for (int k = 0; k < RPH; ++k) {
      const int i = o.at(k);
      const float rk = sigmoidf(r[k]);
      s_rs[i] = zero_state ? 0.0f : rk * h[i];
      if (keep_r) s_r[i] = rk;
    }
  }
#pragma unroll
  for (int k = 0; k < RPH; ++k) n[k] = t.bn[o.col(k)];
  P::product(h, panels_next<P>(p, w.wn, wn1, tid), o, n);
  P::product(m, panels_next<P>(p, wn1, w.un, tid), o, n);
  const float* un = panels_next<P>(p, w.un, next, tid);  // r*s visible after its sync
  if (!zero_state) P::product(s_rs, un, o, n);
#pragma unroll
  for (int k = 0; k < RPH; ++k) n[k] = tanhf(n[k]);
}

// One GGNN layer l on the tile, h updated in place: the message step, then
// each GRU half, h' = z n + (1 - z) s.  Ends synchronised; `next` is the
// block after the layer's last.
template <class P>
__device__ __forceinline__ void layer_forward(const Tile& t, const Weights& w, int l,
                                              Panels& p, const float* next, int tid) {
  const typename P::Own o(tid);
  const bool zero_state = (l == 0);
  // the previous layer's readers of the biases are past its last barrier
  for (int i = tid; i < NE * H; i += THREADS) t.bmsg[i] = w.msg_b[size_t(l) * NE * H + i];
  messages<P>(t, w, l, p, w.wz, tid);
#pragma unroll 1
  for (int hf = 0; hf < 2; ++hf) {
    float n[RPH];
    gates<P>(t, w, zero_state, hf, false, p, hf == 0 ? w.wz : next, n, tid);
    // no thread reads this half's h after the last panel's barrier
    float* h = t.h + hf * HALF * H;
    const float* s_z = t.work + HALF * H;
#pragma unroll
    for (int k = 0; k < RPH; ++k) {
      const int i = o.at(k);
      const float z = s_z[i];
      const float s = zero_state ? 0.0f : h[i];
      h[i] = z * n[k] + (1.0f - z) * s;
    }
  }
  __syncthreads();
}

// The readout's gate sigmoid([h, h0] Wi + bi) (D = H) into s_gate (T x D),
// through the panels Wi[:H], Wi[H:], then Wj (the caller's next panel):
// the pre-activation by halves of the tile, carried in s_gate between the
// two panels by the thread that owns each entry.
template <class P>
__device__ __forceinline__ void readout_gate(const float* s_h, const float* s_h0,
                                             const Readout& ro, const float* s_bi,
                                             float* s_gate, Panels& p, int tid) {
  const typename P::Own o(tid);
  const float* wi0 = panels_next<P>(p, ro.wi, ro.wi + H * H, tid);
#pragma unroll 1
  for (int hf = 0; hf < 2; ++hf) {
    float acc[RPH];
#pragma unroll
    for (int k = 0; k < RPH; ++k) acc[k] = s_bi[o.col(k)];
    P::product(s_h + hf * HALF * H, wi0, o, acc);
    float* g = s_gate + hf * HALF * H;
#pragma unroll
    for (int k = 0; k < RPH; ++k) g[o.at(k)] = acc[k];
  }
  const float* wi1 = panels_next<P>(p, ro.wi + H * H, ro.wj, tid);
#pragma unroll 1
  for (int hf = 0; hf < 2; ++hf) {
    float* g = s_gate + hf * HALF * H;
    float acc[RPH];
#pragma unroll
    for (int k = 0; k < RPH; ++k) acc[k] = g[o.at(k)];
    P::product(s_h0 + hf * HALF * H, wi1, o, acc);
#pragma unroll
    for (int k = 0; k < RPH; ++k) g[o.at(k)] = sigmoidf(acc[k]);
  }
}

// ---------------------------------------------------------------------------
// the forward body's layer step: every product over the whole tile, the two
// halves sharing each staged panel and each B fragment, and the products
// whose A operand is h reading it split (t.hs), as the thread that writes
// an entry of h keeps it.  The forward keeps z and n in registers, 16
// entries a thread each, where the reverse has no registers to spare and
// takes the halves one at a time.

// acc[RPH hf + k] = b[o.col(k)] for both halves
__device__ __forceinline__ void fill_cols(float (&acc)[2 * RPH], const float* b,
                                          const Tc::Own& o) {
#pragma unroll
  for (int j = 0; j < 2 * RPH; ++j) acc[j] = b[o.col(j % RPH)];
}

// the entry of acc[j] in a T x H buffer of the Tc layout
__device__ __forceinline__ int tile_at(const Tc::Own& o, int j) {
  return (j / RPH) * HALF * H + o.at(j % RPH);
}

// acc += h w over the tile, h from its TF32 parts
__device__ __forceinline__ void product_h(const Tile& t, const float* w, const Tc::Own& o,
                                          float (&acc)[2 * RPH]) {
  tc_mma_split_a(t.hs, w, o.R, o.C, o.g, o.q, acc);
}

// m = A_flat [h W_e + b_e]_e, one edge type at a time (panels W_0..W_3 of
// layer l, then `next`): hw_e over the tile into t.work, then the
// aggregation.  The caller synchronises before m is read.
__device__ __forceinline__ void messages_tile(const Tile& t, const Weights& w, int l,
                                              Panels& p, const float* next, int tid) {
  const Tc::Own o(tid);
#pragma unroll 1
  for (int e = 0; e < NE; ++e) {
    const float* we = panels_next<Tc>(
        p, msg_panel(w, l, e), e + 1 < NE ? msg_panel(w, l, e + 1) : next, tid);
    float acc[2 * RPH];
    fill_cols(acc, t.bmsg + e * H, o);
    product_h(t, we, o, acc);
#pragma unroll
    for (int j = 0; j < 2 * RPH; ++j) t.work[tile_at(o, j)] = acc[j];
    __syncthreads();
    aggregate_edge<Tc>(t.adj_t, e, t.work, t.m, t.nk, t.nv, t.nc, tid);
  }
}

// The GRU gates of the tile, x = [h, m], state s = h (zero at layer 0,
// `zero_state`), for the thread's 16 entries, through the panels Wz[:H],
// Uz, Wz[H:], Wr[:H], Ur, Wr[H:], Wn[:H], Wn[H:], Un, then `next`: z and n
// in registers, r*s into t.work (T x H), the A operand of the last product.
// The same terms in the same order as `gates`, entry for entry.
__device__ __forceinline__ void gates_tile(const Tile& t, const Weights& w, bool zero_state,
                                           Panels& p, const float* next,
                                           float (&z)[2 * RPH], float (&n)[2 * RPH],
                                           int tid) {
  const Tc::Own o(tid);
  const float* wz1 = w.wz + H * H;
  const float* wr1 = w.wr + H * H;
  const float* wn1 = w.wn + H * H;
  fill_cols(z, t.bz, o);
  product_h(t, panels_next<Tc>(p, w.wz, w.uz, tid), o, z);
  const float* uz = panels_next<Tc>(p, w.uz, wz1, tid);
  if (!zero_state) product_h(t, uz, o, z);
  Tc::product_tile(t.m, panels_next<Tc>(p, wz1, w.wr, tid), o, z);
#pragma unroll
  for (int j = 0; j < 2 * RPH; ++j) z[j] = sigmoidf(z[j]);
  {
    float r[2 * RPH];
    fill_cols(r, t.br, o);
    product_h(t, panels_next<Tc>(p, w.wr, w.ur, tid), o, r);
    const float* ur = panels_next<Tc>(p, w.ur, wr1, tid);
    if (!zero_state) product_h(t, ur, o, r);
    Tc::product_tile(t.m, panels_next<Tc>(p, wr1, w.wn, tid), o, r);
#pragma unroll
    for (int j = 0; j < 2 * RPH; ++j) {
      const int i = tile_at(o, j);
      t.work[i] = zero_state ? 0.0f : sigmoidf(r[j]) * t.h[i];
    }
  }
  fill_cols(n, t.bn, o);
  product_h(t, panels_next<Tc>(p, w.wn, wn1, tid), o, n);
  Tc::product_tile(t.m, panels_next<Tc>(p, wn1, w.un, tid), o, n);
  const float* un = panels_next<Tc>(p, w.un, next, tid);  // r*s visible after its sync
  if (!zero_state) Tc::product_tile(t.work, un, o, n);
#pragma unroll
  for (int j = 0; j < 2 * RPH; ++j) n[j] = tanhf(n[j]);
}

// One GGNN layer l on the tile, h (and its TF32 parts) updated in place:
// the message step, the gates, h' = z n + (1 - z) s.  Ends synchronised;
// `next` is the block after the layer's last.
__device__ __forceinline__ void layer_forward_tile(const Tile& t, const Weights& w, int l,
                                                   Panels& p, const float* next, int tid) {
  const Tc::Own o(tid);
  const bool zero_state = (l == 0);
  // the previous layer's readers of the biases are past its last barrier
  for (int i = tid; i < NE * H; i += THREADS) t.bmsg[i] = w.msg_b[size_t(l) * NE * H + i];
  messages_tile(t, w, l, p, w.wz, tid);
  float z[2 * RPH], n[2 * RPH];
  gates_tile(t, w, zero_state, p, next, z, n, tid);
  // no thread reads h after the last panel's barrier
#pragma unroll
  for (int j = 0; j < 2 * RPH; ++j) {
    const int i = tile_at(o, j);
    const float v = z[j] * n[j] + (1.0f - z[j]) * (zero_state ? 0.0f : t.h[i]);
    t.h[i] = v;
    split_store(t.hs, i, v);
  }
  __syncthreads();
}

// True when every weight block the panels load is 16-byte aligned (cp.async).
inline bool panels_aligned(const Weights& w, const Readout* ro) {
  const void* ptrs[] = {w.msg_w, w.wz, w.uz, w.wr, w.ur, w.wn, w.un,
                        ro ? ro->wi : nullptr, ro ? ro->wj : nullptr};
  for (const void* q : ptrs)
    if (reinterpret_cast<size_t>(q) % 16 != 0) return false;
  return true;
}

}  // namespace h64
}  // namespace ggnn
