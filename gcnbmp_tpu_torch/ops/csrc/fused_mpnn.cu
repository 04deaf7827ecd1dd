// Fused multi-layer MPNN (EdgeNet message + GRU) forward and backward over
// packed 128-atom tiles, for Hopper (sm_90a).  Built by
// gcnbmp_tpu_torch/ops/build.py with nvcc into a shared library with a
// plain C interface, loaded with ctypes.
//
// Replaces the TPU kernels of gcnbmp_tpu/ops/fused_mpnn.py:
//   fused_mpnn_fwd  <- _fused_mpnn_fwd / _fwd_kernel (K5)
//   fused_mpnn_bwd  <- _fused_mpnn_bwd / _bwd_kernel (K5b)
//
// Per layer l, on one tile of T=128 atoms (h: (T, C)), with layer l's own
// weights (wt_e = (M_e - M0)^T, m0t = M0^T, a GRU per layer):
//   hm_e = h wt_e                                 e = 0..3
//   out_i = sum_{e,j} A[i, eT+j] hm_e[j]          (flat (T, 4T) adjacency)
//   in_j  = sum_{e,i} A[i, eT+j] hm_e[i]          (its transposed blocks)
//   bg    = (Mmol h) m0t                          Mmol: real slots of one molecule
//   x     = [out + bg, in + bg]
//   z = sigmoid(x Wz + s Uz + bz), r = sigmoid(x Wr + s Ur + br),
//   n = tanh(x Wn + (r*s) Un + bn), h' = z n + (1-z) s
// with s = 0 at layer 0 and, for untied weights (carry = 0), at every
// layer; tied weights carry s = h.
// The backward recomputes the forward keeping each layer's input h, then
// reverses the layers (fused_mpnn.py:158-216): the GRU's adjoint as in
// fused_ggnn_bwd.cu with dx = [dout, din], then, Mmol being symmetric,
//   dbg = dout + din, gdbg = Mmol dbg, dm0t = h^T gdbg, dh += gdbg m0t^T
//   dhm_e = (A_flat^T dout)_e + A_e din,  dwt_e = h^T dhm_e,
//   dh += sum_e dhm_e wt_e^T  (+ the state's gradient when carried)
// and the U gradients get no term where the state is zero.
//
// What bounds it on this card, and what the design does about it:
// - One CTA owns one tile and loops over all L layers (the TPU kernel's
//   block of tiles per grid step becomes the grid).  Nothing carries
//   between CTAs; the backward writes each tile's weight gradients as one
//   row of a (P, n_grad) partial buffer, summed over P in tile order by a
//   second kernel: deterministic, no atomic sums (~460 KB per tile at
//   L=8, C=32).
// - Shared memory.  Unlike GGNN every layer has its own weights (57 KB
//   at C=32), so they are loaded one layer at a time.  h, the hm stack
//   (4T x C), the two halves of x, the adjacency's row lists (a ballot
//   scan before the first layer, NBR_CAP slots per row), its column
//   lists (for the in direction, which reads A by columns) and the
//   molecule groups come to ~209 KB at C=32 (forward) and ~225 KB with dh
//   (backward), the weights' rows padded to C + 4 words and the lists'
//   indices 16-bit in both: one CTA of 512 threads per SM.  Layer inputs for the
//   backward go to a global scratch (P, L, T, C).  The hm buffer is reused
//   for r*s and the gate adjoints, then the background's sums, then dhm.
// - The adjacency (256 KB per tile, ~0.4% dense) is read from global
//   memory once per pass; rows with more than NBR_CAP nonzeros rescan
//   their dense row, and are read by column from global memory, at every
//   layer, so any input (an asymmetric one too) is exact.  The column
//   lists are built by counting (count_columns in fused_ggnn_common.cuh).
// - Mmol is never formed: the tile's real slots are grouped by molecule id
//   once per pass (each row's group, each group's members in row order),
//   and Mmol x is a sum over the row's group: the 64 KB per tile of the
//   TPU kernel's molecule matrix is not read.  Each molecule's sum is
//   taken once and copied to the molecule's rows.
// - Shared-memory bandwidth bounds the small dense products at C <= 32
//   (plain f32 FMAs: no TF32, no tensor cores): shared memory serves one
//   wavefront per clock where the f32 pipes take four warp FMAs.  Every
//   product is register-blocked as the GGNN reverse body's
//   (fused_ggnn_bwd.cu; helpers in fused_ggnn_common.cuh):
//   * the forward layer (hm_e for all e with bg, the gates) per chunk of
//     four reduction steps, one copy (forward_layer) that K5 runs and K5b
//     runs to recompute, so K5's h and every layer input K5b keeps come
//     from the same code;
//   * the weight gradients in three grad_pass passes per layer: the GRU's
//     six W products, dUn and the three bias sums; dUz, dUr and dm0t
//     (beside gdbg m0t^T on the other half of the CTA); the four dwt
//     (beside the message dh);
//   * drs, [dout, din] with the state's dsu, gdbg m0t^T and the message
//     dh against the weights' rows padded to C + 4 words, four reduction
//     steps per 16-byte load.
//   Every output belongs to one thread and sums in a fixed order, so a run
//   repeats bit for bit.
// Later work: tensor cores for the dense products, several tiles' weight
// loads shared by a cluster, fewer passes over the partial buffer.

#include "fused_ggnn_common.cuh"

namespace {

using namespace ggnn;

struct MpnnWeights {
  const float* wt;   // (L, 4, C, C)
  const float* m0t;  // (L, C, C)
  const float* wz; const float* uz; const float* bz;  // (L, 2C, C) (L, C, C) (L, C)
  const float* wr; const float* ur; const float* br;
  const float* wn; const float* un; const float* bn;
};

// Shared-memory plan, in 4-byte words, of both kernels.  The weights'
// rows are padded to CP = C + 4 words (the backward's products against
// transposed weights read them by rows: the lanes' rows of one 16-byte
// chunk then fall in distinct banks), and the row lists' columns and the
// column lists' rows are 16-bit indices, which makes room for the
// padding.  The backward (BWD) adds dh.
template <int C, bool BWD>
struct MpnnPlan {
  static constexpr int CP = C + 4;                    // weight row stride
  static constexpr int IDX = TILE * NBR_CAP / 2;      // words of one 16-bit index list
  static constexpr int TC = TILE * C;
  static constexpr int WT = 0;                        // 4 C rows (layer l)
  static constexpr int M0T = WT + NE * C * CP;        // C rows
  static constexpr int WZ = M0T + C * CP;             // 2C rows each
  static constexpr int WR = WZ + 2 * C * CP;
  static constexpr int WN = WR + 2 * C * CP;
  static constexpr int UZ = WN + 2 * C * CP;          // C rows each
  static constexpr int UR = UZ + C * CP;
  static constexpr int UN = UR + C * CP;
  static constexpr int BZ = UN + C * CP;              // C each
  static constexpr int BR = BZ + C;
  static constexpr int BN = BR + C;
  static constexpr int HS = BN + C;                   // T C: h (the layer input)
  static constexpr int DH = HS + TC;                  // T C: dh, then dout (backward)
  static constexpr int HM = DH + (BWD ? TC : 0);      // 4T C: hm | rs dz' dr' dn' | gdbg . . dbg | dhm
  static constexpr int XO = HM + NE * TC;             // T C: out + bg; dh's partial sum
  static constexpr int XI = XO + TC;                  // T C: in + bg; din; the column build's row masks
  static constexpr int NV = XI + TC;                  // T NBR_CAP row-list values
  static constexpr int NK = NV + TILE * NBR_CAP;      // T NBR_CAP row-list columns (16-bit)
  static constexpr int NC = NK + IDX;                 // T row nonzero counts (int)
  static constexpr int CS = NC + TILE;                // 4T+1 column starts (int)
  static constexpr int CR = CS + ROW_LEN + 1;         // T NBR_CAP column-list rows (16-bit)
  static constexpr int CV = CR + IDX;                 // T NBR_CAP column-list values
  static constexpr int OV = CV + TILE * NBR_CAP;      // T overflow rows (int)
  static constexpr int OVN = OV + TILE;               // 1 overflow row count (int)
  static constexpr int GRP = OVN + 1;                 // T row -> its group's first row, or -1 (int)
  static constexpr int GST = GRP + TILE;              // T group (by first row) -> start in GMEM (int)
  static constexpr int GSZ = GST + TILE;              // T group (by first row) -> size (int)
  static constexpr int GMEM = GSZ + TILE;             // T members, by group, rows ascending (int)
  static constexpr int WORDS = GMEM + TILE;
  static constexpr size_t BYTES = size_t(WORDS) * 4;
  static_assert(CP % 4 == 0 && M0T % 4 == 0 && WZ % 4 == 0 && UZ % 4 == 0 &&
                HS % 4 == 0 && DH % 4 == 0 && HM % 4 == 0 && XO % 4 == 0 &&
                XI % 4 == 0, "16-byte aligned rows for float4 loads");
  static_assert(TC >= COLUMN_MASK_WORDS, "row masks fit in XI");
};

// Offsets in one tile's row of gradient partials: dwt (L,4,C,C), dm0t
// (L,C,C), then the GRU stacks wz (L,2C,C) uz (L,C,C) bz (L,C), wr ur br,
// wn un bn.  ops/fused_mpnn.py splits the summed row in the same order.
template <int C>
struct MpnnGradLayout {
  static constexpr size_t CC = size_t(C) * C;
  __host__ __device__ static size_t wt(int l, int e) { return (size_t(l) * NE + e) * CC; }
  __host__ __device__ static size_t m0t(int L, int l) { return size_t(L) * NE * CC + l * CC; }
  __host__ __device__ static size_t gru0(int L) { return size_t(L) * (NE + 1) * CC; }
  // one gate's (w, u, b) block over all layers
  __host__ __device__ static size_t gate(int L) { return size_t(L) * (3 * CC + C); }
  __host__ __device__ static size_t w(int L, int l, int g) { return gru0(L) + g * gate(L) + l * 2 * CC; }
  __host__ __device__ static size_t u(int L, int l, int g) { return gru0(L) + g * gate(L) + L * 2 * CC + l * CC; }
  __host__ __device__ static size_t b(int L, int l, int g) { return gru0(L) + g * gate(L) + L * 3 * CC + l * C; }
  __host__ __device__ static size_t words(int L) { return gru0(L) + 3 * gate(L); }
};

struct Tile {
  float* wt; float* m0t; GruSmem g;
  float* h; float* dh; float* hm; float* xo; float* xi;
  float* nv; unsigned short* nk; int* nc;
  int* cs; unsigned short* cr; float* cv; int* ov; int* ovn;
  int* grp; int* gst; int* gsz; int* gmem;
};

__device__ __forceinline__ int* as_ints(float* p) {
  return reinterpret_cast<int*>(p);
}

template <int C, bool BWD>
__device__ __forceinline__ Tile make_tile(float* smem) {
  using S = MpnnPlan<C, BWD>;
  using Idx = unsigned short;
  Tile s;
  s.wt = smem + S::WT; s.m0t = smem + S::M0T;
  s.g = {smem + S::WZ, smem + S::WR, smem + S::WN,
         smem + S::UZ, smem + S::UR, smem + S::UN,
         smem + S::BZ, smem + S::BR, smem + S::BN};
  s.h = smem + S::HS; s.dh = smem + S::DH; s.hm = smem + S::HM;
  s.xo = smem + S::XO; s.xi = smem + S::XI;
  s.nv = smem + S::NV; s.nk = reinterpret_cast<Idx*>(smem + S::NK);
  s.nc = as_ints(smem + S::NC);
  s.cs = as_ints(smem + S::CS); s.cr = reinterpret_cast<Idx*>(smem + S::CR);
  s.cv = smem + S::CV;
  s.ov = as_ints(smem + S::OV); s.ovn = as_ints(smem + S::OVN);
  s.grp = as_ints(smem + S::GRP); s.gst = as_ints(smem + S::GST);
  s.gsz = as_ints(smem + S::GSZ); s.gmem = as_ints(smem + S::GMEM);
  return s;
}

// Molecule groups of the tile's real slots (node_mask > 0), from the
// molecule ids alone (no assumption that a molecule's slots are
// contiguous): grp[i] = the first real row of row i's molecule, or -1 for
// a pad row; for each such first row g, its members in ascending row order
// at gmem[gst[g] .. gst[g] + gsz[g]).
__device__ __forceinline__ void build_groups(const int* mol_t, const float* mask_t,
                                             const Tile& s, int tid) {
  if (tid < TILE) {
    int g = -1;
    if (__ldg(mask_t + tid) > 0.0f) {
      const int mi = __ldg(mol_t + tid);
      for (int j = 0; j <= tid; ++j)
        if (__ldg(mask_t + j) > 0.0f && __ldg(mol_t + j) == mi) { g = j; break; }
    }
    s.grp[tid] = g;
  }
  __syncthreads();
  if (tid < TILE && s.grp[tid] == tid) {
    int size = 0, start = 0;
    for (int j = 0; j < TILE; ++j) {
      const int gj = s.grp[j];
      size += (gj == tid);
      start += (gj >= 0 && gj < tid);
    }
    s.gsz[tid] = size;
    s.gst[tid] = start;
  }
  __syncthreads();
  if (tid < TILE && s.grp[tid] >= 0) {
    const int g = s.grp[tid];
    int rank = 0;
    for (int j = 0; j < tid; ++j) rank += (s.grp[j] == g);
    s.gmem[s.gst[g] + rank] = tid;
  }
  __syncthreads();
}

// (Mmol x)[i, c]: the sum of x[j, c] over the real rows j of row i's
// molecule; 0 on a pad row.
template <int C>
__device__ __forceinline__ float group_sum(const float* x, int i, int c,
                                           const Tile& s) {
  const int g = s.grp[i];
  float acc = 0.0f;
  if (g >= 0) {
    const int* mem = s.gmem + s.gst[g];
    const int cnt = s.gsz[g];
    for (int k = 0; k < cnt; ++k) acc += x[mem[k] * C + c];
  }
  return acc;
}

// Layer l's message weights wt and m0t, and its GRU's weights, into the
// tile's shared memory (rows padded to C + 4); ASYNC: by cp.async
// (to_shared).
template <int C, bool ASYNC = false>
__device__ __forceinline__ void load_messages(const MpnnWeights& w, int l,
                                              const Tile& s, int tid) {
  constexpr int CC = C * C;
  load_padded<C, ASYNC>(w.wt + size_t(l) * NE * CC, s.wt, NE * C, tid);
  load_padded<C, ASYNC>(w.m0t + size_t(l) * CC, s.m0t, C, tid);
}

template <int C, bool ASYNC = false>
__device__ __forceinline__ void load_gru(const MpnnWeights& w, int l,
                                         const Tile& s, int tid) {
  constexpr int CC = C * C;
  load_padded<C, ASYNC>(w.wz + size_t(l) * 2 * CC, s.g.wz, 2 * C, tid);
  load_padded<C, ASYNC>(w.wr + size_t(l) * 2 * CC, s.g.wr, 2 * C, tid);
  load_padded<C, ASYNC>(w.wn + size_t(l) * 2 * CC, s.g.wn, 2 * C, tid);
  load_padded<C, ASYNC>(w.uz + size_t(l) * CC, s.g.uz, C, tid);
  load_padded<C, ASYNC>(w.ur + size_t(l) * CC, s.g.ur, C, tid);
  load_padded<C, ASYNC>(w.un + size_t(l) * CC, s.g.un, C, tid);
  copy_in<ASYNC>(s.g.bz, w.bz + size_t(l) * C, C, tid);
  copy_in<ASYNC>(s.g.br, w.br + size_t(l) * C, C, tid);
  copy_in<ASYNC>(s.g.bn, w.bn + size_t(l) * C, C, tid);
}

template <int C>
__device__ __forceinline__ void load_layer_padded(const MpnnWeights& w, int l,
                                                  const Tile& s, int tid) {
  load_messages<C>(w, l, s, tid);
  load_gru<C>(w, l, s, tid);
}

// out[i, c] = (Mmol x)[i, c] for every row i (out != x): the threads of a
// molecule's first row walk its members once, the other rows copy that
// sum (0 on a pad row), so no thread walks a molecule per row it owns.
// The sums are group_sum's, in the same order.  Synchronises once; the
// caller synchronises before out is read.
template <int C>
__device__ __forceinline__ void group_sums(const float* x, float* out,
                                           const Tile& s, int tid) {
  using R = Rows<C>;
  const int col = tid % C;
  const int row0 = tid / C;
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) {
    const int i = row0 + k * R::RS;
    if (s.grp[i] == i) out[i * C + col] = group_sum<C>(x, i, col, s);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) {
    const int i = row0 + k * R::RS;
    const int g = s.grp[i];
    if (g != i) out[i * C + col] = g >= 0 ? out[g * C + col] : 0.0f;
  }
}

// The adjacency's row lists (scan_rows) and column lists (count_columns,
// its row masks in xi, which the first layer's molecule sums overwrite),
// once per call.  Synchronises before it returns.
__device__ __forceinline__ void build_lists(const float* adj_t, const Tile& s,
                                            int tid) {
  scan_rows(adj_t, s.nk, s.nv, s.nc, tid);
  __syncthreads();
  count_columns(s.nk, s.nv, s.nc, s.cs, s.cr, s.cv, s.ov, s.ovn,
                reinterpret_cast<unsigned*>(s.xi), tid);
}

// x = [out + bg, in + bg] of one layer for the tile's h, with the layer's
// weights in shared memory, into s.xo and s.xi.  The dense products are
// register-blocked: bg = (Mmol h) m0t and hm_e = h wt_e for all four e at
// once, per chunk of four d the five weights' entries of rows d at the
// thread's column and one 16-byte load (a warp-wide broadcast) of each of
// its h and Mmol h rows.  The out direction gathers through the row
// lists, the in direction through the column lists (build_lists).
template <int C, class Loads>
__device__ void mpnn_x(const float* adj_t, const Tile& s, int tid,
                       const Loads& loads) {
  using R = Rows<C>;
  constexpr int CP = C + 4;
  const int col = tid % C;
  const int row0 = tid / C;
  // Mmol h into xi (scratch), then bg = (Mmol h) m0t and hm_e = h wt_e
  group_sums<C>(s.h, s.xi, s, tid);
  __syncthreads();
  float hm[NE][R::RPT] = {}, bg[R::RPT] = {};
#pragma unroll 1
  for (int d0 = 0; d0 < C; d0 += 4) {
    float wv[NE][4], mv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int e = 0; e < NE; ++e) wv[e][q] = s.wt[(e * C + d0 + q) * CP + col];
      mv[q] = s.m0t[(d0 + q) * CP + col];
    }
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      float hv[4], gv[4];
      ldv<4>(s.h + (row0 + k * R::RS) * C + d0, hv);
      ldv<4>(s.xi + (row0 + k * R::RS) * C + d0, gv);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int e = 0; e < NE; ++e) hm[e][k] = fmaf(hv[q], wv[e][q], hm[e][k]);
        bg[k] = fmaf(gv[q], mv[q], bg[k]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < NE; ++e)
#pragma unroll
    for (int k = 0; k < R::RPT; ++k)
      s.hm[(e * TILE + row0 + k * R::RS) * C + col] = hm[e][k];
  __syncthreads();
  loads.after_products();
  // out = A_flat hm through the row lists
  aggregate<C>(adj_t, s.hm, s.xo, s.nk, s.nv, s.nc, tid);
  __syncthreads();
  // in_j = sum_e (A_e^T hm_e)[j] through the column lists (crowded rows
  // from global memory); both halves get bg
  const int n_ov = *s.ovn;
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) {
    const int j = row0 + k * R::RS;
    float acc = 0.0f;
    for (int e = 0; e < NE; ++e) {
      const int kc = e * TILE + j;
      const float* hm_e = s.hm + e * TILE * C;
      const int end = s.cs[kc + 1];
      for (int p = s.cs[kc]; p < end; ++p)
        acc = fmaf(s.cv[p], hm_e[s.cr[p] * C + col], acc);
      for (int o = 0; o < n_ov; ++o) {
        const int i = s.ov[o];
        const float a = __ldg(adj_t + size_t(i) * ROW_LEN + kc);
        if (a != 0.0f) acc = fmaf(a, hm_e[i * C + col], acc);
      }
    }
    s.xi[j * C + col] = acc + bg[k];
    s.xo[j * C + col] += bg[k];
  }
  __syncthreads();
}

// acc[k] += sum_d x[i_k, d] w[d, col] for the thread's rows i_k (w rows
// padded to C + 4), blocked as gate_inputs: the state's Uz and Ur
// products, and (r*s) Un.
template <int C, int NW>
__device__ __forceinline__ void add_xw(const float* x, const float* const (&w)[NW],
                                       int col, int row0,
                                       float (&acc)[NW][Rows<C>::RPT]) {
  using R = Rows<C>;
  constexpr int CP = C + 4;
#pragma unroll 1
  for (int d0 = 0; d0 < C; d0 += 4) {
    float wv[NW][4];
#pragma unroll
    for (int p = 0; p < NW; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[p][q] = w[p][(d0 + q) * CP + col];
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      float xv[4];
      ldv<4>(x + (row0 + k * R::RS) * C + d0, xv);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < NW; ++p) acc[p][k] = fmaf(xv[q], wv[p][q], acc[p][k]);
    }
  }
}

// The GRU gates for x = [xo, xi] and state s = h (or 0 when
// `zero_state`), as ggnn_gates does for GGNN: returns z, r, n in
// registers, r*s in s_rs; synchronises once.  Register-blocked: the input
// products through gate_inputs (x against the top and bottom halves of
// W), the state's through add_xw.
template <int C>
__device__ __forceinline__ void mpnn_gru(bool zero_state, const Tile& s,
                                         float* s_rs, float (&z)[Rows<C>::RPT],
                                         float (&r)[Rows<C>::RPT],
                                         float (&n)[Rows<C>::RPT], int tid) {
  using R = Rows<C>;
  const GruSmem& g = s.g;
  const int col = tid % C;
  const int row0 = tid / C;
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) {
    z[k] = g.bz[col]; r[k] = g.br[col]; n[k] = g.bn[col];
  }
  gate_inputs<C, false>(s.xo, g, 0, col, row0, z, r, n);
  gate_inputs<C, false>(s.xi, g, C, col, row0, z, r, n);
  if (!zero_state) {
    float zr[2][R::RPT] = {};
    add_xw<C, 2>(s.h, {g.uz, g.ur}, col, row0, zr);
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) { z[k] += zr[0][k]; r[k] += zr[1][k]; }
  }
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) {
    const int i = row0 + k * R::RS;
    z[k] = sigmoidf(z[k]);
    r[k] = sigmoidf(r[k]);
    s_rs[i * C + col] = zero_state ? 0.0f : r[k] * s.h[i * C + col];
  }
  __syncthreads();
  if (!zero_state) {
    float un[1][R::RPT] = {};
    add_xw<C, 1>(s_rs, {g.un}, col, row0, un);
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) n[k] += un[0][k];
  }
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) n[k] = tanhf(n[k]);
}

// What a forward layer does about the weights at two points: once its
// products have read wt and m0t, and before its gates read the GRU's.
// K5b loads each layer's weights whole before the layer (its reverse
// reads them after): nothing to do.
struct NoLoads {
  __device__ void after_products() const {}
  __device__ void before_gates() const {}
};

// K5: layer l + 1's wt and m0t load (cp.async) once layer l's products
// have read theirs, and arrive while it aggregates and gates; its GRU
// weights load once layer l's gates are done (after forward_layer),
// while layer l + 1 computes its x.  Each layer waits for a part just
// before it reads it, with the part loaded after it still in flight.
template <int C>
struct NextLayerLoads {
  const MpnnWeights& w;
  const Tile& s;
  int next, n_layers, tid;
  __device__ void after_products() const {
    if (next < n_layers) load_messages<C, true>(w, next, s, tid);
    __pipeline_commit();
  }
  __device__ void before_gates() const {
    __pipeline_wait_prior(1);  // this layer's GRU weights
    __syncthreads();
  }
};

// One forward layer in place on s.h: K5's layers, and the recompute of
// K5b's forward, are this one copy.
template <int C, class Loads>
__device__ __forceinline__ void forward_layer(bool zero_state,
                                              const float* adj_t, const Tile& s,
                                              int tid, const Loads& loads) {
  using R = Rows<C>;
  const int col = tid % C;
  const int row0 = tid / C;
  mpnn_x<C>(adj_t, s, tid, loads);
  loads.before_gates();
  float z[R::RPT], r[R::RPT], n[R::RPT];
  mpnn_gru<C>(zero_state, s, s.hm, z, r, n, tid);
  // each thread rewrites only its own elements of h
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) {
    const int i = row0 + k * R::RS;
    const float sv = zero_state ? 0.0f : s.h[i * C + col];
    s.h[i * C + col] = z[k] * n[k] + (1.0f - z[k]) * sv;
  }
  __syncthreads();
}

// One CTA per SM (the shared-memory plan), so up to 128 registers a thread.
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
fused_mpnn_kernel(const float* __restrict__ h0, const float* __restrict__ adj,
                  const int* __restrict__ mol, const float* __restrict__ mask,
                  MpnnWeights w, float* __restrict__ out, int n_layers,
                  int carry) {
  extern __shared__ float smem[];
  const Tile s = make_tile<C, false>(smem);
  constexpr int TC = TILE * C;
  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;
  const float* adj_t = adj + tile * TILE * ROW_LEN;
  for (int i = tid; i < TC; i += THREADS) s.h[i] = h0[tile * TC + i];
  build_groups(mol + tile * TILE, mask + tile * TILE, s, tid);
  build_lists(adj_t, s, tid);
  load_layer_padded<C>(w, 0, s, tid);
  for (int l = 0; l < n_layers; ++l) {
    __pipeline_wait_prior(1);  // layer l's wt and m0t
    __syncthreads();
    forward_layer<C>(l == 0 || !carry, adj_t, s, tid,
                     NextLayerLoads<C>{w, s, l + 1, n_layers, tid});
    if (l + 1 < n_layers) load_gru<C, true>(w, l + 1, s, tid);
    __pipeline_commit();
  }
  for (int i = tid; i < TC; i += THREADS) out[tile * TC + i] = s.h[i];
}

// dhm_e[i] += sum_j A[i, eT+j] din[j] for every e: one warp per row i,
// lane c < C owns column c; rows within NBR_CAP go through their lists,
// the others rescan their dense row.
template <int C>
__device__ __forceinline__ void row_scatter(const float* adj_t,
                                            const float* s_din, float* s_dhm,
                                            const Tile& s, int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = warp; i < TILE; i += WARPS) {
    const int cnt = s.nc[i];
    if (cnt > NBR_CAP) {
      const float* arow = adj_t + size_t(i) * ROW_LEN;
      float av[ROW_LEN / 32];
#pragma unroll
      for (int q = 0; q < ROW_LEN / 32; ++q) av[q] = __ldg(arow + q * 32 + lane);
#pragma unroll
      for (int q = 0; q < ROW_LEN / 32; ++q) {
        const float a = av[q];
        unsigned nz = __ballot_sync(0xffffffffu, a != 0.0f);
        while (nz) {
          const int b = __ffs(nz) - 1;
          nz &= nz - 1;
          const float v = __shfl_sync(0xffffffffu, a, b);
          const int kcol = q * 32 + b;
          if (lane < C)
            s_dhm[((kcol / TILE) * TILE + i) * C + lane] +=
                v * s_din[(kcol % TILE) * C + lane];
        }
      }
    } else {
      for (int p = 0; p < cnt; ++p) {
        const int kcol = s.nk[i * NBR_CAP + p];
        const float v = s.nv[i * NBR_CAP + p];
        if (lane < C)
          s_dhm[((kcol / TILE) * TILE + i) * C + lane] +=
              v * s_din[(kcol % TILE) * C + lane];
      }
    }
  }
}

// One CTA per SM (the shared-memory plan), so up to 128 registers a thread.
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
fused_mpnn_bwd_kernel(const float* __restrict__ h0, const float* __restrict__ adj,
                      const int* __restrict__ mol, const float* __restrict__ mask,
                      MpnnWeights w, const float* __restrict__ dout,
                      float* dh0, float* partial, float* hs, int n_layers,
                      int carry, int n_grad) {
  using R = Rows<C>;
  using G = MpnnGradLayout<C>;
  constexpr int HALF = THREADS / 2;
  using RH = RowSet<C, HALF>;  // the row products of half the CTA
  constexpr int TC = TILE * C;
  constexpr int CC = C * C;
  constexpr int CP = C + 4;
  extern __shared__ float smem[];
  const Tile s = make_tile<C, true>(smem);
  const int tid = threadIdx.x;
  const int col = tid % C;
  const int row0 = tid / C;
  // the half-CTA row products: threads [HALF, THREADS)
  const int hcol = (tid - HALF) % C;
  const int hrow0 = (tid - HALF) / C;
  const size_t tile = blockIdx.x;
  const float* adj_t = adj + tile * TILE * ROW_LEN;
  float* hs_t = hs + tile * size_t(n_layers) * TC;
  float* part = partial + tile * size_t(n_grad);
  const int L = n_layers;

  // 1. forward, keeping each layer's input in hs
  for (int i = tid; i < TC; i += THREADS) s.h[i] = h0[tile * TC + i];
  build_groups(mol + tile * TILE, mask + tile * TILE, s, tid);
  build_lists(adj_t, s, tid);
  for (int l = 0; l < L; ++l) {
    const bool zero_state = l == 0 || !carry;
    load_layer_padded<C>(w, l, s, tid);
    for (int i = tid; i < TC; i += THREADS) hs_t[size_t(l) * TC + i] = s.h[i];
    __syncthreads();
    forward_layer<C>(zero_state, adj_t, s, tid, NoLoads{});
  }
  const int n_ov = *s.ovn;

  // 2. dh at the top of the stack
  for (int i = tid; i < TC; i += THREADS) s.dh[i] = dout[tile * TC + i];
  __syncthreads();

  // 3. reverse the layers
  float* s_rs = s.hm;
  float* s_dz = s.hm + TC;
  float* s_dr = s.hm + 2 * TC;
  float* s_dn = s.hm + 3 * TC;
  for (int l = L - 1; l >= 0; --l) {
    const bool zero_state = (l == 0) || !carry;
    load_layer_padded<C>(w, l, s, tid);
    for (int i = tid; i < TC; i += THREADS) s.h[i] = hs_t[size_t(l) * TC + i];
    __syncthreads();
    mpnn_x<C>(adj_t, s, tid, NoLoads{});
    float z[R::RPT], r[R::RPT], n[R::RPT];
    mpnn_gru<C>(zero_state, s, s_rs, z, r, n, tid);

    // the GRU's adjoint (dh read by its owner only)
    float ds[R::RPT];
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      const float sv = zero_state ? 0.0f : s.h[i * C + col];
      const float dhv = s.dh[i * C + col];
      const float dz = dhv * (n[k] - sv);
      const float dn = dhv * z[k];
      ds[k] = dhv * (1.0f - z[k]);
      s_dn[i * C + col] = dn * (1.0f - n[k] * n[k]);
      s_dz[i * C + col] = dz * z[k] * (1.0f - z[k]);
    }
    __syncthreads();
    {  // drs = dn' Un^T; ds (complete but for dsu) goes to dh's place
      float drs[R::RPT] = {};
      add_xwt<C, THREADS>(s_dn, s.g.un, col, row0, drs);
#pragma unroll
      for (int k = 0; k < R::RPT; ++k) {
        const int i = row0 + k * R::RS;
        const float sv = zero_state ? 0.0f : s.h[i * C + col];
        s.dh[i * C + col] = fmaf(drs[k], r[k], ds[k]);
        s_dr[i * C + col] = drs[k] * sv * r[k] * (1.0f - r[k]);
      }
    }
    __syncthreads();

    // layer l's GRU gradients: the input weights' six products, dUn and
    // the bias sums (dUn gets a zero operand where the state is zero)
    {
      float* gw = part + G::w(L, l, 0);
      float* gr = part + G::w(L, l, 1);
      float* gn = part + G::w(L, l, 2);
      const GradPass<7, 3> gp = {
          {s.xo, s.xi, s.xo, s.xi, s.xo, s.xi, zero_state ? nullptr : s_rs},
          {s_dz, s_dz, s_dr, s_dr, s_dn, s_dn, s_dn},
          {gw, gw + CC, gr, gr + CC, gn, gn + CC, part + G::u(L, l, 2)},
          {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr},
          {s_dz, s_dr, s_dn},
          {part + G::b(L, l, 0), part + G::b(L, l, 1), part + G::b(L, l, 2)}};
      grad_pass<C, 7, 3, 64>(gp, false, false, tid);
    }
    // [dout, din] = d{z,r,n}' W{z,r,n}^T, dsu = d{z,r}' U{z,r}^T
    float dxo[R::RPT] = {}, dxi[R::RPT] = {}, dsu[R::RPT] = {};
#pragma unroll 1
    for (int j0 = 0; j0 < C; j0 += 4) {
      dx_chunk<C, true>(s_dz, s.g.wz, s.g.uz, col, row0, j0, dxo, dxi, dsu);
      dx_chunk<C, true>(s_dr, s.g.wr, s.g.ur, col, row0, j0, dxo, dxi, dsu);
      dx_chunk<C, false>(s_dn, s.g.wn, nullptr, col, row0, j0, dxo, dxi, dsu);
    }
    __syncthreads();
    // x, r*s and dn' are dead: xo takes dh's partial sum (the state's
    // gradient where it is carried), dh dout, xi din, and the fourth
    // slot of hm dbg = dout + din
    float* s_part = s.xo;
    float* s_gdbg = s.hm;
    float* s_dbg = s.hm + 3 * TC;
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      s_part[i * C + col] = zero_state ? 0.0f : s.dh[i * C + col] + dsu[k];
      s.dh[i * C + col] = dxo[k];
      s.xi[i * C + col] = dxi[k];
      s_dbg[i * C + col] = dxo[k] + dxi[k];
    }
    __syncthreads();
    // the background, bg = (Mmol h) m0t with Mmol symmetric: gdbg = Mmol
    // dbg, dm0t = h^T gdbg, dh += gdbg m0t^T
    group_sums<C>(s_dbg, s_gdbg, s, tid);
    __syncthreads();
    {  // threads [0, 192): dUz, dUr (zero where the state is zero), dm0t
      const float* state = zero_state ? nullptr : s.h;
      const GradPass<3, 0> gp = {
          {state, state, s.h}, {s_dz, s_dr, s_gdbg},
          {part + G::u(L, l, 0), part + G::u(L, l, 1), part + G::m0t(L, l)},
          {nullptr, nullptr, nullptr}};
      grad_pass<C, 3, 0, 0>(gp, false, false, tid);
    }
    if (tid >= HALF) {
      float acc[RH::RPT];
#pragma unroll
      for (int k = 0; k < RH::RPT; ++k) acc[k] = s_part[(hrow0 + k * RH::RS) * C + hcol];
      add_xwt<C, HALF>(s_gdbg, s.m0t, hcol, hrow0, acc);
#pragma unroll
      for (int k = 0; k < RH::RPT; ++k) s_part[(hrow0 + k * RH::RS) * C + hcol] = acc[k];
    }
    __syncthreads();

    // the messages: dhm = A_flat^T dout (out) + A_e din (in), then dwt_e =
    // h^T dhm_e (threads [0, 256)) beside dh = part + sum_e dhm_e wt_e^T
    // (threads [256, 512))
    column_gather<C>(adj_t, s.dh, s.cs, s.cr, s.cv, s.ov, n_ov, s.hm, tid);
    __syncthreads();
    row_scatter<C>(adj_t, s.xi, s.hm, s, tid);
    __syncthreads();
    {
      const GradPass<NE, 0> gp = {
          {s.h, s.h, s.h, s.h},
          {s.hm, s.hm + TC, s.hm + 2 * TC, s.hm + 3 * TC},
          {part + G::wt(l, 0), part + G::wt(l, 1), part + G::wt(l, 2),
           part + G::wt(l, 3)},
          {nullptr, nullptr, nullptr, nullptr}};
      grad_pass<C, NE, 0, 0>(gp, false, false, tid);
    }
    if (tid >= HALF) {
      float acc[RH::RPT];
#pragma unroll
      for (int k = 0; k < RH::RPT; ++k) acc[k] = s_part[(hrow0 + k * RH::RS) * C + hcol];
      for (int e = 0; e < NE; ++e)
        add_xwt<C, HALF>(s.hm + e * TC, s.wt + e * C * CP, hcol, hrow0, acc);
#pragma unroll
      for (int k = 0; k < RH::RPT; ++k) s.dh[(hrow0 + k * RH::RS) * C + hcol] = acc[k];
    }
    __syncthreads();
  }

  // 4. dh0
  for (int i = tid; i < TC; i += THREADS) dh0[tile * TC + i] = s.dh[i];
}

template <int C>
cudaError_t launch_fwd(const float* h0, const float* adj, const int* mol,
                       const float* mask, const MpnnWeights& w, float* out,
                       int n_tiles, int n_layers, int carry, cudaStream_t stream) {
  constexpr size_t bytes = MpnnPlan<C, false>::BYTES;
  static_assert(bytes <= 232448, "shared-memory plan exceeds 227 KB");
  static bool opted_in[MAX_DEVICES] = {};
  cudaError_t err = opt_in_smem(fused_mpnn_kernel<C>, bytes, opted_in);
  if (err != cudaSuccess) return err;
  fused_mpnn_kernel<C><<<n_tiles, THREADS, bytes, stream>>>(
      h0, adj, mol, mask, w, out, n_layers, carry);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_bwd(const float* h0, const float* adj, const int* mol,
                       const float* mask, const MpnnWeights& w,
                       const float* dout, float* dh0, float* partial,
                       float* grads, float* hs, int n_tiles, int n_layers,
                       int carry, cudaStream_t stream) {
  constexpr size_t bytes = MpnnPlan<C, true>::BYTES;
  static_assert(bytes <= 232448, "shared-memory plan exceeds 227 KB");
  static bool opted_in[MAX_DEVICES] = {};
  cudaError_t err = opt_in_smem(fused_mpnn_bwd_kernel<C>, bytes, opted_in);
  if (err != cudaSuccess) return err;
  const int n_grad = int(MpnnGradLayout<C>::words(n_layers));
  fused_mpnn_bwd_kernel<C><<<n_tiles, THREADS, bytes, stream>>>(
      h0, adj, mol, mask, w, dout, dh0, partial, hs, n_layers, carry, n_grad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int SUM_THREADS = 256;
  sum_tiles_kernel<<<(n_grad + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0,
                     stream>>>(partial, grads, n_tiles, n_grad);
  return cudaGetLastError();
}

template <int C>
cudaError_t bwd_occupancy(int n_tiles, int* out) {
  constexpr size_t bytes = MpnnPlan<C, true>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mpnn_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fused_mpnn_bwd_kernel<C>, THREADS, bytes);
  out[1] = n_tiles;
  out[2] = WARPS;
  return err;
}

MpnnWeights make_mpnn_weights(const float* wt, const float* m0t,
                              const float* wz, const float* uz, const float* bz,
                              const float* wr, const float* ur, const float* br,
                              const float* wn, const float* un, const float* bn) {
  MpnnWeights w;
  w.wt = wt; w.m0t = m0t;
  w.wz = wz; w.uz = uz; w.bz = bz;
  w.wr = wr; w.ur = ur; w.br = br;
  w.wn = wn; w.un = un; w.bn = bn;
  return w;
}

}  // namespace

// K5: h (P, T, C) after n_layers MPNN layers.  mol (P, T) int32 and mask
// (P, T) f32 give the molecule groups; carry != 0 carries the GRU state
// across layers (tied weights).  Returns a cudaError_t.
extern "C" int fused_mpnn_fwd(
    const float* h0, const float* adj, const int* mol, const float* mask,
    const float* wt, const float* m0t,
    const float* wz, const float* uz, const float* bz,
    const float* wr, const float* ur, const float* br,
    const float* wn, const float* un, const float* bn,
    float* out, int n_tiles, int n_layers, int hidden, int carry, void* stream) {
  if (n_tiles <= 0 || n_layers <= 0) return int(cudaErrorInvalidValue);
  const MpnnWeights w = make_mpnn_weights(wt, m0t, wz, uz, bz, wr, ur, br, wn, un, bn);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 16: return int(launch_fwd<16>(h0, adj, mol, mask, w, out, n_tiles, n_layers, carry, st));
    case 32: return int(launch_fwd<32>(h0, adj, mol, mask, w, out, n_tiles, n_layers, carry, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// K5b: dh0 (P, T, C) and the summed weight gradients (grads, in the
// MpnnGradLayout order) of K5 for the upstream gradient dh_final.
// partial (P, n_grad) and hs (P, L, T, C) are scratch.  Returns a
// cudaError_t.
extern "C" int fused_mpnn_bwd(
    const float* h0, const float* adj, const int* mol, const float* mask,
    const float* wt, const float* m0t,
    const float* wz, const float* uz, const float* bz,
    const float* wr, const float* ur, const float* br,
    const float* wn, const float* un, const float* bn,
    const float* dh_final, float* dh0, float* partial, float* grads, float* hs,
    int n_tiles, int n_layers, int hidden, int carry, void* stream) {
  if (n_tiles <= 0 || n_layers <= 0) return int(cudaErrorInvalidValue);
  const MpnnWeights w = make_mpnn_weights(wt, m0t, wz, uz, bz, wr, ur, br, wn, un, bn);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 16: return int(launch_bwd<16>(h0, adj, mol, mask, w, dh_final, dh0, partial, grads, hs, n_tiles, n_layers, carry, st));
    case 32: return int(launch_bwd<32>(h0, adj, mol, mask, w, dh_final, dh0, partial, grads, hs, n_tiles, n_layers, carry, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// K5b's main kernel over n_tiles tiles: the CTAs an SM holds at its
// shared-memory plan, the CTAs it launches and the warps of each, in
// out[0..2].  Returns a cudaError_t.
extern "C" int fused_mpnn_bwd_occupancy(int n_tiles, int hidden, int* out) {
  switch (hidden) {
    case 16: return int(bwd_occupancy<16>(n_tiles, out));
    case 32: return int(bwd_occupancy<32>(n_tiles, out));
    default: return int(cudaErrorInvalidValue);
  }
}
