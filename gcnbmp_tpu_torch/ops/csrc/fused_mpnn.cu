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
// fused_ggnn_bwd.cu with dx = [dout, din], then
//   dbg = dout + din, dm0t = (Mmol h)^T dbg, dh += Mmol (dbg m0t^T)
//   dhm_e = (A_flat^T dout)_e + A_e din,  dwt_e = h^T dhm_e,
//   dh += sum_e dhm_e wt_e^T  (+ the state's gradient when carried)
// and the U gradients get no term where the state is zero.
//
// What bounds it on this card, and what the design does about it:
// - One CTA owns one tile and loops over all L layers (the TPU kernel's
//   block of tiles per grid step becomes the grid).  Nothing carries
//   between CTAs; the backward writes each tile's weight gradients as one
//   row of a (P, n_grad) partial buffer, summed over P in tile order by a
//   second kernel: deterministic, no atomics (~460 KB per tile at L=8,
//   C=32).
// - Shared memory.  Unlike GGNN every layer has its own weights (57 KB
//   at C=32), so they are loaded one layer at a time.  h, the hm stack
//   (4T x C), the two halves of x, the adjacency's row lists (layer 0's
//   ballot scan, NBR_CAP slots per row), its column lists (for the in
//   direction, which reads A by columns) and the molecule groups come to
//   ~210 KB at C=32 (forward) and ~226 KB with dh (backward): one CTA of
//   512 threads per SM.  Layer inputs for the backward go to a global
//   scratch (P, L, T, C).  The hm buffer is reused for r*s and the gate
//   adjoints, then the background's sums, then dhm.
// - The adjacency (256 KB per tile, ~0.4% dense) is read from global
//   memory once per pass; rows with more than NBR_CAP nonzeros rescan
//   their dense row, and are read by column from global memory, at every
//   layer, so any input (an asymmetric one too) is exact.
// - Mmol is never formed: the tile's real slots are grouped by molecule id
//   once per pass (each row's group, each group's members in row order),
//   and Mmol x is a sum over the row's group: the 64 KB per tile of the
//   TPU kernel's molecule matrix is not read.
// - The rest is small dense products at C <= 32 in plain f32 FMAs (no
//   TF32, no tensor cores), each thread owning one column of a strided set
//   of rows; products against transposed weights rotate the reduction
//   index by the column to keep a warp's lanes on distinct banks.
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

// Shared-memory plan, in 4-byte words; the backward adds dh.
template <int C, bool BWD>
struct MpnnPlan {
  static constexpr int TC = TILE * C;
  static constexpr int WT = 0;                        // 4 C C (layer l)
  static constexpr int M0T = WT + NE * C * C;         // C C
  static constexpr int WZ = M0T + C * C;              // 2C C each
  static constexpr int WR = WZ + 2 * C * C;
  static constexpr int WN = WR + 2 * C * C;
  static constexpr int UZ = WN + 2 * C * C;           // C C each
  static constexpr int UR = UZ + C * C;
  static constexpr int UN = UR + C * C;
  static constexpr int BZ = UN + C * C;               // C each
  static constexpr int BR = BZ + C;
  static constexpr int BN = BR + C;
  static constexpr int HS = BN + C;                   // T C: h (the layer input)
  static constexpr int DH = HS + TC;                  // T C: dh, then dout (backward)
  static constexpr int HM = DH + (BWD ? TC : 0);      // 4T C: hm | rs dz' dr' dn' | gs dbg dgs | dhm
  static constexpr int XO = HM + NE * TC;             // T C: out + bg
  static constexpr int XI = XO + TC;                  // T C: in + bg; din
  static constexpr int NV = XI + TC;                  // T NBR_CAP row-list values
  static constexpr int NK = NV + TILE * NBR_CAP;      // T NBR_CAP row-list columns (int)
  static constexpr int NC = NK + TILE * NBR_CAP;      // T row nonzero counts (int)
  static constexpr int CS = NC + TILE;                // 4T+1 column starts (int)
  static constexpr int CR = CS + ROW_LEN + 1;         // T NBR_CAP column-list rows (int)
  static constexpr int CV = CR + TILE * NBR_CAP;      // T NBR_CAP column-list values
  static constexpr int OV = CV + TILE * NBR_CAP;      // T overflow rows (int)
  static constexpr int OVN = OV + TILE;               // 1 overflow row count (int)
  static constexpr int GRP = OVN + 1;                 // T row -> its group's first row, or -1 (int)
  static constexpr int GST = GRP + TILE;              // T group (by first row) -> start in GMEM (int)
  static constexpr int GSZ = GST + TILE;              // T group (by first row) -> size (int)
  static constexpr int GMEM = GSZ + TILE;             // T members, by group, rows ascending (int)
  static constexpr int WORDS = GMEM + TILE;
  static constexpr size_t BYTES = size_t(WORDS) * 4;
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
  float* nv; int* nk; int* nc;
  int* cs; int* cr; float* cv; int* ov; int* ovn;
  int* grp; int* gst; int* gsz; int* gmem;
};

__device__ __forceinline__ int* as_ints(float* p) {
  return reinterpret_cast<int*>(p);
}

template <int C, bool BWD>
__device__ __forceinline__ Tile make_tile(float* smem) {
  using S = MpnnPlan<C, BWD>;
  Tile s;
  s.wt = smem + S::WT; s.m0t = smem + S::M0T;
  s.g = {smem + S::WZ, smem + S::WR, smem + S::WN,
         smem + S::UZ, smem + S::UR, smem + S::UN,
         smem + S::BZ, smem + S::BR, smem + S::BN};
  s.h = smem + S::HS; s.dh = smem + S::DH; s.hm = smem + S::HM;
  s.xo = smem + S::XO; s.xi = smem + S::XI;
  s.nv = smem + S::NV; s.nk = as_ints(smem + S::NK); s.nc = as_ints(smem + S::NC);
  s.cs = as_ints(smem + S::CS); s.cr = as_ints(smem + S::CR); s.cv = smem + S::CV;
  s.ov = as_ints(smem + S::OV); s.ovn = as_ints(smem + S::OVN);
  s.grp = as_ints(smem + S::GRP); s.gst = as_ints(smem + S::GST);
  s.gsz = as_ints(smem + S::GSZ); s.gmem = as_ints(smem + S::GMEM);
  return s;
}

__device__ __forceinline__ void copy_in(float* dst, const float* src, int n,
                                        int tid) {
  for (int i = tid; i < n; i += THREADS) dst[i] = __ldg(src + i);
}

template <int C>
__device__ __forceinline__ void load_layer(const MpnnWeights& w, int l,
                                           const Tile& s, int tid) {
  constexpr int CC = C * C;
  copy_in(s.wt, w.wt + size_t(l) * NE * CC, NE * CC, tid);
  copy_in(s.m0t, w.m0t + size_t(l) * CC, CC, tid);
  copy_in(s.g.wz, w.wz + size_t(l) * 2 * CC, 2 * CC, tid);
  copy_in(s.g.wr, w.wr + size_t(l) * 2 * CC, 2 * CC, tid);
  copy_in(s.g.wn, w.wn + size_t(l) * 2 * CC, 2 * CC, tid);
  copy_in(s.g.uz, w.uz + size_t(l) * CC, CC, tid);
  copy_in(s.g.ur, w.ur + size_t(l) * CC, CC, tid);
  copy_in(s.g.un, w.un + size_t(l) * CC, CC, tid);
  copy_in(s.g.bz, w.bz + size_t(l) * C, C, tid);
  copy_in(s.g.br, w.br + size_t(l) * C, C, tid);
  copy_in(s.g.bn, w.bn + size_t(l) * C, C, tid);
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

// x = [out + bg, in + bg] of one layer for the tile's h, with the layer's
// weights in shared memory, into s.xo and s.xi.  `scan` (the first layer
// of a pass) reads the adjacency rows and builds the row and column lists.
template <int C>
__device__ void layer_input(bool scan, const float* adj_t, const Tile& s,
                            int tid) {
  using R = Rows<C>;
  constexpr int CC = C * C;
  const int col = tid % C;
  const int row0 = tid / C;
  // Mmol h into s.xi (scratch), then bg = (Mmol h) m0t in registers
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) {
    const int i = row0 + k * R::RS;
    s.xi[i * C + col] = group_sum<C>(s.h, i, col, s);
  }
  __syncthreads();
  float bg[R::RPT];
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) bg[k] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < C; ++d) {
    const float wv = s.m0t[d * C + col];
#pragma unroll
    for (int k = 0; k < R::RPT; ++k)
      bg[k] = fmaf(s.xi[(row0 + k * R::RS) * C + d], wv, bg[k]);
  }
  // hm_e = h wt_e
  for (int e = 0; e < NE; ++e) {
    const float* we = s.wt + e * CC;
    float acc[R::RPT];
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < C; ++d) {
      const float wv = we[d * C + col];
#pragma unroll
      for (int k = 0; k < R::RPT; ++k)
        acc[k] = fmaf(s.h[(row0 + k * R::RS) * C + d], wv, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < R::RPT; ++k)
      s.hm[(e * TILE + row0 + k * R::RS) * C + col] = acc[k];
  }
  __syncthreads();
  // out = A_flat hm (row lists; built by the scan)
  aggregate<C>(scan, adj_t, s.hm, s.xo, s.nk, s.nv, s.nc, tid);
  __syncthreads();
  if (scan) build_columns(s.nk, s.nv, s.nc, s.cs, s.cr, s.cv, s.ov, s.ovn, tid);
  // in_j = sum_e (A_e^T hm_e)[j] (column lists, crowded rows from global
  // memory); both halves get bg
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

// The GRU gates for x = [xo, xi] and state s = h (or 0 when
// `zero_state`), as gru_gates does for GGNN: returns z, r, n in registers,
// r*s in s_rs; synchronises once.
template <int C>
__device__ __forceinline__ void mpnn_gates(bool zero_state, const Tile& s,
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
#pragma unroll 2
  for (int d = 0; d < C; ++d) {
    const float wzo = g.wz[d * C + col], wzi = g.wz[(C + d) * C + col];
    const float wro = g.wr[d * C + col], wri = g.wr[(C + d) * C + col];
    const float wno = g.wn[d * C + col], wni = g.wn[(C + d) * C + col];
    const float uz = zero_state ? 0.0f : g.uz[d * C + col];
    const float ur = zero_state ? 0.0f : g.ur[d * C + col];
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      const float xo = s.xo[i * C + d], xi = s.xi[i * C + d];
      z[k] = fmaf(xo, wzo, fmaf(xi, wzi, z[k]));
      r[k] = fmaf(xo, wro, fmaf(xi, wri, r[k]));
      n[k] = fmaf(xo, wno, fmaf(xi, wni, n[k]));
      if (!zero_state) {
        const float hv = s.h[i * C + d];
        z[k] = fmaf(hv, uz, z[k]);
        r[k] = fmaf(hv, ur, r[k]);
      }
    }
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
#pragma unroll 2
    for (int d = 0; d < C; ++d) {
      const float un = g.un[d * C + col];
#pragma unroll
      for (int k = 0; k < R::RPT; ++k)
        n[k] = fmaf(s_rs[(row0 + k * R::RS) * C + d], un, n[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) n[k] = tanhf(n[k]);
}

// One forward layer in place on s.h.
template <int C>
__device__ __forceinline__ void forward_layer(bool scan, bool zero_state,
                                              const float* adj_t, const Tile& s,
                                              int tid) {
  using R = Rows<C>;
  const int col = tid % C;
  const int row0 = tid / C;
  layer_input<C>(scan, adj_t, s, tid);
  float z[R::RPT], r[R::RPT], n[R::RPT];
  mpnn_gates<C>(zero_state, s, s.hm, z, r, n, tid);
  // each thread rewrites only its own elements of h
#pragma unroll
  for (int k = 0; k < R::RPT; ++k) {
    const int i = row0 + k * R::RS;
    const float sv = zero_state ? 0.0f : s.h[i * C + col];
    s.h[i * C + col] = z[k] * n[k] + (1.0f - z[k]) * sv;
  }
  __syncthreads();
}

template <int C>
__global__ void __launch_bounds__(THREADS)
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
  for (int l = 0; l < n_layers; ++l) {
    load_layer<C>(w, l, s, tid);
    __syncthreads();
    forward_layer<C>(l == 0, l == 0 || !carry, adj_t, s, tid);
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

template <int C>
__global__ void __launch_bounds__(THREADS)
fused_mpnn_bwd_kernel(const float* __restrict__ h0, const float* __restrict__ adj,
                      const int* __restrict__ mol, const float* __restrict__ mask,
                      MpnnWeights w, const float* __restrict__ dout,
                      float* dh0, float* partial, float* hs, int n_layers,
                      int carry, int n_grad) {
  using R = Rows<C>;
  using G = MpnnGradLayout<C>;
  constexpr int TC = TILE * C;
  constexpr int CC = C * C;
  extern __shared__ float smem[];
  const Tile s = make_tile<C, true>(smem);
  const int tid = threadIdx.x;
  const int col = tid % C;
  const int row0 = tid / C;
  const size_t tile = blockIdx.x;
  const float* adj_t = adj + tile * TILE * ROW_LEN;
  float* hs_t = hs + tile * size_t(n_layers) * TC;
  float* part = partial + tile * size_t(n_grad);
  const int L = n_layers;

  // 1. forward, keeping each layer's input in hs
  for (int i = tid; i < TC; i += THREADS) s.h[i] = h0[tile * TC + i];
  build_groups(mol + tile * TILE, mask + tile * TILE, s, tid);
  for (int l = 0; l < L; ++l) {
    load_layer<C>(w, l, s, tid);
    for (int i = tid; i < TC; i += THREADS) hs_t[size_t(l) * TC + i] = s.h[i];
    __syncthreads();
    forward_layer<C>(l == 0, l == 0 || !carry, adj_t, s, tid);
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
    load_layer<C>(w, l, s, tid);
    for (int i = tid; i < TC; i += THREADS) s.h[i] = hs_t[size_t(l) * TC + i];
    __syncthreads();
    layer_input<C>(false, adj_t, s, tid);
    float z[R::RPT], r[R::RPT], n[R::RPT];
    mpnn_gates<C>(zero_state, s, s_rs, z, r, n, tid);

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
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      float drs = 0.0f;
#pragma unroll 4
      for (int j = 0; j < C; ++j) {
        const int a = (j + col) & (C - 1);
        drs = fmaf(s_dn[i * C + a], s.g.un[col * C + a], drs);
      }
      const float sv = zero_state ? 0.0f : s.h[i * C + col];
      ds[k] = fmaf(drs, r[k], ds[k]);
      s_dr[i * C + col] = drs * sv * r[k] * (1.0f - r[k]);
    }
    __syncthreads();
    // dx = [dout, din]; dout replaces dh (now read by no one), din stays
    // in registers until x is no longer needed
    float din[R::RPT];
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      float dxo = 0.0f, dxi = 0.0f, dsu = 0.0f;
#pragma unroll 2
      for (int j = 0; j < C; ++j) {
        const int a = (j + col) & (C - 1);
        const float dzp = s_dz[i * C + a], drp = s_dr[i * C + a], dnp = s_dn[i * C + a];
        dxo = fmaf(dzp, s.g.wz[col * C + a], dxo);
        dxo = fmaf(drp, s.g.wr[col * C + a], dxo);
        dxo = fmaf(dnp, s.g.wn[col * C + a], dxo);
        dxi = fmaf(dzp, s.g.wz[(C + col) * C + a], dxi);
        dxi = fmaf(drp, s.g.wr[(C + col) * C + a], dxi);
        dxi = fmaf(dnp, s.g.wn[(C + col) * C + a], dxi);
        dsu = fmaf(dzp, s.g.uz[col * C + a], dsu);
        dsu = fmaf(drp, s.g.ur[col * C + a], dsu);
      }
      s.dh[i * C + col] = dxo;
      din[k] = dxi;
      ds[k] += dsu;
    }
    // layer l's GRU weight gradients
    const float* state = zero_state ? nullptr : s.h;
    grad_AtB<C, 2 * C>(s.xo, s.xi, s_dz, part + G::w(L, l, 0), false, tid);
    grad_AtB<C, 2 * C>(s.xo, s.xi, s_dr, part + G::w(L, l, 1), false, tid);
    grad_AtB<C, 2 * C>(s.xo, s.xi, s_dn, part + G::w(L, l, 2), false, tid);
    grad_AtB<C, C>(state, nullptr, s_dz, part + G::u(L, l, 0), false, tid);
    grad_AtB<C, C>(state, nullptr, s_dr, part + G::u(L, l, 1), false, tid);
    grad_AtB<C, C>(zero_state ? nullptr : s_rs, nullptr, s_dn, part + G::u(L, l, 2), false, tid);
    bias_sum<C>(s_dz, part + G::b(L, l, 0), false, tid);
    bias_sum<C>(s_dr, part + G::b(L, l, 1), false, tid);
    bias_sum<C>(s_dn, part + G::b(L, l, 2), false, tid);
    __syncthreads();

    // the background: dm0t = (Mmol h)^T dbg, dh += Mmol (dbg m0t^T)
    float* s_gs = s.hm;
    float* s_dbg = s.hm + TC;
    float* s_dgs = s.hm + 2 * TC;
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      s.xi[i * C + col] = din[k];
      s_gs[i * C + col] = group_sum<C>(s.h, i, col, s);
      s_dbg[i * C + col] = s.dh[i * C + col] + din[k];
    }
    __syncthreads();
    grad_AtB<C, C>(s_gs, nullptr, s_dbg, part + G::m0t(L, l), false, tid);
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      float acc = 0.0f;
#pragma unroll 4
      for (int j = 0; j < C; ++j) {
        const int a = (j + col) & (C - 1);
        acc = fmaf(s_dbg[i * C + a], s.m0t[col * C + a], acc);
      }
      s_dgs[i * C + col] = acc;
    }
    __syncthreads();
    float dhn[R::RPT];
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      dhn[k] = group_sum<C>(s_dgs, i, col, s) + (zero_state ? 0.0f : ds[k]);
    }
    __syncthreads();

    // the messages: dhm = A_flat^T dout (out) + A_e din (in)
    column_gather<C>(adj_t, s.dh, s.cs, s.cr, s.cv, s.ov, n_ov, s.hm, tid);
    __syncthreads();
    row_scatter<C>(adj_t, s.xi, s.hm, s, tid);
    __syncthreads();
    for (int e = 0; e < NE; ++e)
      grad_AtB<C, C>(s.h, nullptr, s.hm + e * TC, part + G::wt(l, e), false, tid);
#pragma unroll
    for (int k = 0; k < R::RPT; ++k) {
      const int i = row0 + k * R::RS;
      float acc = dhn[k];
      for (int e = 0; e < NE; ++e) {
        const float* dhm_e = s.hm + (e * TILE + i) * C;
        const float* we = s.wt + e * CC;
#pragma unroll 4
        for (int j = 0; j < C; ++j) {
          const int a = (j + col) & (C - 1);
          acc = fmaf(dhm_e[a], we[col * C + a], acc);
        }
      }
      s.dh[i * C + col] = acc;
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
