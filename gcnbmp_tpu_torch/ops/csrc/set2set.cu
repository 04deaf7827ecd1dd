// Fused Set2Set readout (all processing steps in one kernel), forward and
// backward, for Hopper (sm_90a).  Built by gcnbmp_tpu_torch/ops/build.py
// with nvcc into a shared library with a plain C interface, loaded with
// ctypes.
//
// Replaces the TPU kernels of gcnbmp_tpu/ops/set2set_kernel.py:
//   fused_set2set_fwd  <- _fused_set2set_fwd / _fwd_kernel (K4)
//   fused_set2set_bwd  <- _fused_set2set_bwd / _bwd_kernel (K4b) and its
//                         XLA epilogue (datoms), here inside the kernel
//
// Per molecule, over its (n_max, C) atom table and mask, S steps from
// c = hh = q* = 0 (flax OptimizedLSTMCell, gates i|f|g|o):
//   y = q* wx + hh wh + b; i, f, o = sigmoid, g = tanh
//   c = f c + i g; q = o tanh(c); hh = q
//   e = atoms.q, -1e9 where amask = 0; p = softmax over the n_max entries
//   r = sum_n (p amask)_n atoms_n; q* = [q, r]
// The backward recomputes the steps, keeping each step's gates, c, q, r
// and p, and takes the closed form of set2set_kernel.py:129-176 in
// reverse; datoms = sum_s (p amask)_s (x) dr_s + de_s (x) q_s is written
// here (the TPU version builds it outside only because its compiler
// crashed on the outer products).
//
// What bounds it on this card, and what the design does about it:
// - Each molecule is a chain of S small dependent steps over <= 128 x 32
//   values: latency, not bandwidth or FLOPs.  One warp owns a molecule
//   (lane c holds channel c of c, q and r; lane n holds atoms n, n+32, ..
//   of the softmax), so a step is warp shuffles and register math with no
//   block-wide barrier.  A CTA of 4 warps keeps wx, wh and b (48.5 KB at
//   C = 32) in shared memory and walks its molecules grid-stride, so the
//   weights are loaded once per CTA, not per molecule.
// - The molecule's atom rows are staged in shared memory with a padded
//   row stride (C + 1 words), so the energies' per-lane row reads and the
//   weighted sum's per-lane column reads are both free of bank conflicts.
// - Weight gradients: the warps stash each step's LSTM input and
//   pre-activation adjoint dy in shared memory; after each group of 4
//   molecules the whole CTA adds their outer products to its own
//   accumulators.  Each CTA writes one row of a (CTAs, n_grad) partial
//   buffer, summed in CTA order by a second kernel; the CTA count depends
//   on M alone, so a run repeats bit for bit, with no atomics.
// - Plain f32 arithmetic, expf/tanhf, as the JAX package's f32 math.

#include "fused_ggnn_common.cuh"

namespace {

using ggnn::MAX_DEVICES;
using ggnn::opt_in_smem;
using ggnn::sigmoidf;
using ggnn::sum_tiles_kernel;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_NPL = 4;         // atoms per lane: n_max <= 128
constexpr int MAX_ATOMS = 32 * MAX_NPL;
constexpr int MAX_STEPS = 4;
constexpr int MAX_CTAS = 264;      // two per SM of an H100; fixed for determinism
constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory words of the weights: wx (2C, 4C), wh (C, 4C), b (4C).
template <int C>
struct S2sWeights {
  static constexpr int G = 4 * C;
  static constexpr int WX = 0;
  static constexpr int WH = WX + 2 * C * G;
  static constexpr int B = WH + C * G;
  static constexpr int WORDS = B + G;
};

// One step's stash per warp, lane-indexed (P and DE atom-indexed).
struct Stash {
  static constexpr int GI = 0, GF = 32, GG = 64, GO = 96, CN = 128, Q = 160,
                       R = 192, P = 224, DE = P + MAX_ATOMS,
                       DR = DE + MAX_ATOMS, DY = DR + 32, WORDS = DY + 128;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

template <int C>
__device__ __forceinline__ void load_weights(float* s_w, const float* wx,
                                             const float* wh, const float* b) {
  using W = S2sWeights<C>;
  for (int i = threadIdx.x; i < 2 * C * W::G; i += THREADS) s_w[W::WX + i] = wx[i];
  for (int i = threadIdx.x; i < C * W::G; i += THREADS) s_w[W::WH + i] = wh[i];
  for (int i = threadIdx.x; i < W::G; i += THREADS) s_w[W::B + i] = b[i];
}

// Copy molecule `mol`'s atom rows into the warp's padded table, and its
// mask into registers (lane holds atoms lane + 32k) and, when s_am is
// given, into shared memory.
template <int C>
__device__ __forceinline__ void stage(const float* atoms, const float* amask,
                                      int mol, int n_max, float* s_atoms,
                                      float* s_am, float (&am)[MAX_NPL],
                                      int lane) {
  const float* src = atoms + size_t(mol) * n_max * C;
  for (int idx = lane; idx < n_max * C; idx += 32)
    s_atoms[(idx / C) * (C + 1) + idx % C] = src[idx];
#pragma unroll
  for (int k = 0; k < MAX_NPL; ++k) {
    const int n = lane + 32 * k;
    am[k] = n < n_max ? amask[size_t(mol) * n_max + n] : 0.0f;
    if (s_am != nullptr && n < n_max) s_am[n] = am[k];
  }
  __syncwarp();
}

// One LSTM step for channel `lane` (lanes >= C compute on column 0 and
// are discarded by the caller): gates from q* = [q, r] and hh = q, then
// c is updated in place.
template <int C>
__device__ __forceinline__ void lstm_step(const float* s_w, float q, float r,
                                          float& c, float& gi, float& gf,
                                          float& gg, float& go, int lane) {
  using W = S2sWeights<C>;
  constexpr int G = W::G;
  const int cl = lane < C ? lane : 0;
  const float* wx = s_w + W::WX;
  const float* wh = s_w + W::WH;
  float yi = s_w[W::B + cl], yf = s_w[W::B + C + cl];
  float yg = s_w[W::B + 2 * C + cl], yo = s_w[W::B + 3 * C + cl];
#pragma unroll 4
  for (int d = 0; d < C; ++d) {
    const float qd = __shfl_sync(FULL, q, d);
    const float rd = __shfl_sync(FULL, r, d);
    const float* wq = wx + d * G + cl;
    const float* wr = wx + (C + d) * G + cl;
    const float* whd = wh + d * G + cl;
    yi = fmaf(qd, wq[0], fmaf(rd, wr[0], fmaf(qd, whd[0], yi)));
    yf = fmaf(qd, wq[C], fmaf(rd, wr[C], fmaf(qd, whd[C], yf)));
    yg = fmaf(qd, wq[2 * C], fmaf(rd, wr[2 * C], fmaf(qd, whd[2 * C], yg)));
    yo = fmaf(qd, wq[3 * C], fmaf(rd, wr[3 * C], fmaf(qd, whd[3 * C], yo)));
  }
  gi = sigmoidf(yi);
  gf = sigmoidf(yf);
  gg = tanhf(yg);
  go = sigmoidf(yo);
  c = gf * c + gi * gg;
}

// p = softmax over the molecule's atoms of (atoms . v), -1e9 where the
// mask is 0; lane holds atoms lane + 32k.
template <int C>
__device__ __forceinline__ void attend(const float* s_atoms,
                                       const float (&am)[MAX_NPL], int n_max,
                                       float v, float (&p)[MAX_NPL]) {
  const int lane = threadIdx.x & 31;
  float e[MAX_NPL];
#pragma unroll
  for (int k = 0; k < MAX_NPL; ++k) e[k] = 0.0f;
  for (int d = 0; d < C; ++d) {
    const float vd = __shfl_sync(FULL, v, d);
#pragma unroll
    for (int k = 0; k < MAX_NPL; ++k) {
      const int n = lane + 32 * k;
      if (n < n_max) e[k] = fmaf(s_atoms[n * (C + 1) + d], vd, e[k]);
    }
  }
  float mx = -3.0e38f;  // below every energy, -1e9 included
#pragma unroll
  for (int k = 0; k < MAX_NPL; ++k) {
    if (lane + 32 * k < n_max) {
      e[k] = am[k] > 0.0f ? e[k] : NEG;
      mx = fmaxf(mx, e[k]);
    }
  }
  mx = warp_max(mx);
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < MAX_NPL; ++k) {
    e[k] = lane + 32 * k < n_max ? expf(e[k] - mx) : 0.0f;
    sum += e[k];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int k = 0; k < MAX_NPL; ++k) p[k] = e[k] / sum;
}

// sum_n w_n atoms[n, lane] (0 on lanes >= C); lane holds w of atoms
// lane + 32k.
template <int C>
__device__ __forceinline__ float weighted_sum(const float* s_atoms,
                                              const float (&wv)[MAX_NPL],
                                              int n_max) {
  const int lane = threadIdx.x & 31;
  const int cl = lane < C ? lane : 0;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < MAX_NPL; ++k) {
    if (32 * k < n_max) {
      const int lim = min(32, n_max - 32 * k);
      for (int j = 0; j < lim; ++j) {
        const float w = __shfl_sync(FULL, wv[k], j);
        acc = fmaf(w, s_atoms[(32 * k + j) * (C + 1) + cl], acc);
      }
    }
  }
  return lane < C ? acc : 0.0f;
}

// The S forward steps of one molecule; with `stash`, each step's values.
template <int C>
__device__ __forceinline__ void forward_steps(const float* s_w,
                                              const float* s_atoms,
                                              const float (&am)[MAX_NPL],
                                              int n_max, int steps,
                                              float* stash, float& q,
                                              float& r) {
  const int lane = threadIdx.x & 31;
  float c = 0.0f;
  q = 0.0f;
  r = 0.0f;
  for (int s = 0; s < steps; ++s) {
    float gi, gf, gg, go;
    lstm_step<C>(s_w, q, r, c, gi, gf, gg, go, lane);
    q = go * tanhf(c);
    if (lane >= C) { c = 0.0f; q = 0.0f; }
    float p[MAX_NPL], pa[MAX_NPL];
    attend<C>(s_atoms, am, n_max, q, p);
#pragma unroll
    for (int k = 0; k < MAX_NPL; ++k) pa[k] = p[k] * am[k];
    r = weighted_sum<C>(s_atoms, pa, n_max);
    if (stash != nullptr) {
      float* st = stash + s * Stash::WORDS;
      st[Stash::GI + lane] = gi; st[Stash::GF + lane] = gf;
      st[Stash::GG + lane] = gg; st[Stash::GO + lane] = go;
      st[Stash::CN + lane] = c; st[Stash::Q + lane] = q; st[Stash::R + lane] = r;
#pragma unroll
      for (int k = 0; k < MAX_NPL; ++k) st[Stash::P + lane + 32 * k] = p[k];
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS)
set2set_fwd_kernel(const float* __restrict__ atoms,
                   const float* __restrict__ amask,
                   const float* __restrict__ wx, const float* __restrict__ wh,
                   const float* __restrict__ b, float* __restrict__ out, int m,
                   int n_max, int steps) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  load_weights<C>(smem, wx, wh, b);
  __syncthreads();
  float* s_atoms = smem + S2sWeights<C>::WORDS + warp * n_max * (C + 1);
  for (int base = blockIdx.x * WARPS; base < m; base += gridDim.x * WARPS) {
    const int mol = base + warp;
    if (mol >= m) break;  // warp-uniform
    float am[MAX_NPL];
    stage<C>(atoms, amask, mol, n_max, s_atoms, nullptr, am, lane);
    float q, r;
    forward_steps<C>(smem, s_atoms, am, n_max, steps, nullptr, q, r);
    if (lane < C) {
      out[size_t(mol) * 2 * C + lane] = q;
      out[size_t(mol) * 2 * C + C + lane] = r;
    }
    __syncwarp();  // the table is rewritten for the next molecule
  }
}

// dq* = dy wx^T and dhh = dy wh^T for channel `lane`, adding gate
// `gate`'s part; the reduction index is rotated by the lane so a warp's
// weight reads fall on distinct banks.
template <int C>
__device__ __forceinline__ void dy_times_w(const float* s_w, float dy, int gate,
                                           float& dq, float& dr, float& dhh) {
  using W = S2sWeights<C>;
  constexpr int G = W::G;
  const int lane = threadIdx.x & 31;
  const int cl = lane < C ? lane : 0;
  const float* wq = s_w + W::WX + cl * G + gate * C;
  const float* wr = s_w + W::WX + (C + cl) * G + gate * C;
  const float* whr = s_w + W::WH + cl * G + gate * C;
#pragma unroll 4
  for (int j = 0; j < C; ++j) {
    const int a = (j + lane) & (C - 1);
    const float v = __shfl_sync(FULL, dy, a);
    dq = fmaf(v, wq[a], dq);
    dr = fmaf(v, wr[a], dr);
    dhh = fmaf(v, whr[a], dhh);
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS)
set2set_bwd_kernel(const float* __restrict__ atoms,
                   const float* __restrict__ amask,
                   const float* __restrict__ wx, const float* __restrict__ wh,
                   const float* __restrict__ b, const float* __restrict__ dg,
                   float* __restrict__ datoms, float* __restrict__ partial,
                   int m, int n_max, int steps) {
  using W = S2sWeights<C>;
  constexpr int G = W::G;
  constexpr int NW = W::WORDS;  // gradient words: dwx, dwh, db
  extern __shared__ float smem[];
  float* s_w = smem;
  float* s_acc = smem + NW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per_warp = n_max * (C + 1) + n_max + steps * Stash::WORDS;
  float* s_atoms = smem + 2 * NW + warp * per_warp;
  float* s_am = s_atoms + n_max * (C + 1);
  float* stash = s_am + n_max;
  load_weights<C>(s_w, wx, wh, b);
  for (int i = threadIdx.x; i < NW; i += THREADS) s_acc[i] = 0.0f;
  __syncthreads();

  for (int base = blockIdx.x * WARPS; base < m; base += gridDim.x * WARPS) {
    const int mol = base + warp;
    if (mol < m) {  // warp-uniform
      float am[MAX_NPL];
      stage<C>(atoms, amask, mol, n_max, s_atoms, s_am, am, lane);
      float q, r;
      forward_steps<C>(s_w, s_atoms, am, n_max, steps, stash, q, r);
      __syncwarp();
      float dq = lane < C ? dg[size_t(mol) * 2 * C + lane] : 0.0f;
      float dr = lane < C ? dg[size_t(mol) * 2 * C + C + lane] : 0.0f;
      float dc = 0.0f, dhh = 0.0f;
      for (int s = steps - 1; s >= 0; --s) {
        float* st = stash + s * Stash::WORDS;
        float p[MAX_NPL], da[MAX_NPL], de[MAX_NPL];
#pragma unroll
        for (int k = 0; k < MAX_NPL; ++k) {
          p[k] = st[Stash::P + lane + 32 * k];
          da[k] = 0.0f;
        }
        // r = sum_n (p amask)_n atoms_n  ->  dp_n = (atoms_n . dr) amask_n
        for (int d = 0; d < C; ++d) {
          const float v = __shfl_sync(FULL, dr, d);
#pragma unroll
          for (int k = 0; k < MAX_NPL; ++k) {
            const int n = lane + 32 * k;
            if (n < n_max) da[k] = fmaf(s_atoms[n * (C + 1) + d], v, da[k]);
          }
        }
        float ssum = 0.0f;
#pragma unroll
        for (int k = 0; k < MAX_NPL; ++k) {
          da[k] = p[k] * (da[k] * am[k]);  // p dp (0 beyond n_max: p = 0)
          ssum += da[k];
        }
        ssum = warp_sum(ssum);
#pragma unroll
        for (int k = 0; k < MAX_NPL; ++k) {
          de[k] = am[k] > 0.0f ? da[k] - p[k] * ssum : 0.0f;
          st[Stash::DE + lane + 32 * k] = de[k];
        }
        st[Stash::DR + lane] = dr;
        dq += weighted_sum<C>(s_atoms, de, n_max);
        // q = o tanh(c_new); q is also the next step's hidden
        const float gi = st[Stash::GI + lane], gf = st[Stash::GF + lane];
        const float gg = st[Stash::GG + lane], go = st[Stash::GO + lane];
        const float c_new = st[Stash::CN + lane];
        const float c_prev = s > 0 ? stash[(s - 1) * Stash::WORDS + Stash::CN + lane] : 0.0f;
        const float dq_t = dq + dhh;
        const float tc = tanhf(c_new);
        const float dc_new = dq_t * go * (1.0f - tc * tc) + dc;
        dc = dc_new * gf;
        const bool live = lane < C;
        const float dyi = live ? dc_new * gg * gi * (1.0f - gi) : 0.0f;
        const float dyf = live ? dc_new * c_prev * gf * (1.0f - gf) : 0.0f;
        const float dyg = live ? dc_new * gi * (1.0f - gg * gg) : 0.0f;
        const float dyo = live ? dq_t * tc * go * (1.0f - go) : 0.0f;
        if (live) {
          st[Stash::DY + lane] = dyi;
          st[Stash::DY + C + lane] = dyf;
          st[Stash::DY + 2 * C + lane] = dyg;
          st[Stash::DY + 3 * C + lane] = dyo;
        }
        float nq = 0.0f, nr = 0.0f, nh = 0.0f;
        dy_times_w<C>(s_w, dyi, 0, nq, nr, nh);
        dy_times_w<C>(s_w, dyf, 1, nq, nr, nh);
        dy_times_w<C>(s_w, dyg, 2, nq, nr, nh);
        dy_times_w<C>(s_w, dyo, 3, nq, nr, nh);
        dq = live ? nq : 0.0f;
        dr = live ? nr : 0.0f;
        dhh = live ? nh : 0.0f;
      }
      __syncwarp();
      // datoms[n, c] = sum_s (p amask)_s[n] dr_s[c] + de_s[n] q_s[c]
      if (lane < C) {
        float* dst = datoms + size_t(mol) * n_max * C;
        for (int n = 0; n < n_max; ++n) {
          float acc = 0.0f;
          for (int s = 0; s < steps; ++s) {
            const float* st = stash + s * Stash::WORDS;
            acc = fmaf(st[Stash::P + n] * s_am[n], st[Stash::DR + lane], acc);
            acc = fmaf(st[Stash::DE + n], st[Stash::Q + lane], acc);
          }
          dst[n * C + lane] = acc;
        }
      }
    }
    __syncthreads();
    // the CTA adds this group's outer products to its accumulators:
    // dwx += [q, r]_{s-1}^T dy_s, dwh += q_{s-1}^T dy_s, db += dy_s
    const int live_warps = min(WARPS, m - base);
    for (int idx = threadIdx.x; idx < NW; idx += THREADS) {
      float acc = 0.0f;
      for (int wi = 0; wi < live_warps; ++wi) {
        const float* wst = smem + 2 * NW + wi * per_warp + n_max * (C + 1) + n_max;
        for (int s = 0; s < steps; ++s) {
          const float* st = wst + s * Stash::WORDS;
          const float* prev = wst + (s > 0 ? s - 1 : 0) * Stash::WORDS;  // read when s > 0
          if (idx < W::WH) {                      // dwx[a, j]
            const int a = idx / G, j = idx % G;
            if (s > 0) {
              const float x = a < C ? prev[Stash::Q + a] : prev[Stash::R + a - C];
              acc = fmaf(x, st[Stash::DY + j], acc);
            }
          } else if (idx < W::B) {                // dwh[a, j]
            const int a = (idx - W::WH) / G, j = (idx - W::WH) % G;
            if (s > 0) acc = fmaf(prev[Stash::Q + a], st[Stash::DY + j], acc);
          } else {                                // db[j]
            acc += st[Stash::DY + idx - W::B];
          }
        }
      }
      s_acc[idx] += acc;
    }
    __syncthreads();  // the stashes are rewritten for the next group
  }
  for (int i = threadIdx.x; i < NW; i += THREADS)
    partial[size_t(blockIdx.x) * NW + i] = s_acc[i];
}

int bwd_ctas(int m) {
  const int blocks = (m + WARPS - 1) / WARPS;
  return blocks < MAX_CTAS ? blocks : MAX_CTAS;
}

template <int C>
size_t fwd_bytes(int n_max) {
  return size_t(S2sWeights<C>::WORDS + WARPS * n_max * (C + 1)) * 4;
}

template <int C>
size_t bwd_bytes(int n_max, int steps) {
  return size_t(2 * S2sWeights<C>::WORDS +
                WARPS * (n_max * (C + 1) + n_max + steps * Stash::WORDS)) * 4;
}

template <int C>
cudaError_t launch_fwd(const float* atoms, const float* amask, const float* wx,
                       const float* wh, const float* b, float* out, int m,
                       int n_max, int steps, cudaStream_t stream) {
  constexpr size_t max_bytes = size_t(S2sWeights<C>::WORDS + WARPS * MAX_ATOMS * (C + 1)) * 4;
  static_assert(max_bytes <= 232448, "shared-memory plan exceeds 227 KB");
  static bool opted_in[MAX_DEVICES] = {};
  cudaError_t err = opt_in_smem(set2set_fwd_kernel<C>, max_bytes, opted_in);
  if (err != cudaSuccess) return err;
  set2set_fwd_kernel<C><<<bwd_ctas(m), THREADS, fwd_bytes<C>(n_max), stream>>>(
      atoms, amask, wx, wh, b, out, m, n_max, steps);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_bwd(const float* atoms, const float* amask, const float* wx,
                       const float* wh, const float* b, const float* dg,
                       float* datoms, float* partial, float* grads, int m,
                       int n_max, int steps, cudaStream_t stream) {
  constexpr size_t max_bytes = size_t(2 * S2sWeights<C>::WORDS +
      WARPS * (MAX_ATOMS * (C + 1) + MAX_ATOMS + MAX_STEPS * Stash::WORDS)) * 4;
  static_assert(max_bytes <= 232448, "shared-memory plan exceeds 227 KB");
  static bool opted_in[MAX_DEVICES] = {};
  cudaError_t err = opt_in_smem(set2set_bwd_kernel<C>, max_bytes, opted_in);
  if (err != cudaSuccess) return err;
  const int ctas = bwd_ctas(m);
  set2set_bwd_kernel<C><<<ctas, THREADS, bwd_bytes<C>(n_max, steps), stream>>>(
      atoms, amask, wx, wh, b, dg, datoms, partial, m, n_max, steps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int NW = S2sWeights<C>::WORDS;
  sum_tiles_kernel<<<(NW + 255) / 256, 256, 0, stream>>>(partial, grads, ctas, NW);
  return cudaGetLastError();
}

bool valid(int m, int n_max, int steps) {
  return m > 0 && n_max > 0 && n_max <= MAX_ATOMS && steps > 0 &&
         steps <= MAX_STEPS;
}

}  // namespace

// The number of CTAs (rows of the partial buffer) of K4b for m molecules.
extern "C" int set2set_bwd_ctas(int m) { return bwd_ctas(m); }

// K4: q* (M, 2C) after `steps` Set2Set steps over atoms (M, n_max, C) with
// mask amask (M, n_max); wx (2C, 4C), wh (C, 4C), b (4C).  Returns a
// cudaError_t.
extern "C" int fused_set2set_fwd(const float* atoms, const float* amask,
                                 const float* wx, const float* wh,
                                 const float* b, float* out, int m, int n_max,
                                 int channels, int steps, void* stream) {
  if (!valid(m, n_max, steps)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 16: return int(launch_fwd<16>(atoms, amask, wx, wh, b, out, m, n_max, steps, st));
    case 32: return int(launch_fwd<32>(atoms, amask, wx, wh, b, out, m, n_max, steps, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// K4b: datoms (M, n_max, C) and the summed weight gradients grads = [dwx
// (2C, 4C), dwh (C, 4C), db (4C)] for the upstream gradient dg (M, 2C);
// partial (set2set_bwd_ctas(m), 12C^2 + 4C) is scratch.  Returns a
// cudaError_t.
extern "C" int fused_set2set_bwd(const float* atoms, const float* amask,
                                 const float* wx, const float* wh,
                                 const float* b, const float* dg,
                                 float* datoms, float* partial, float* grads,
                                 int m, int n_max, int channels, int steps,
                                 void* stream) {
  if (!valid(m, n_max, steps)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 16: return int(launch_bwd<16>(atoms, amask, wx, wh, b, dg, datoms, partial, grads, m, n_max, steps, st));
    case 32: return int(launch_bwd<32>(atoms, amask, wx, wh, b, dg, datoms, partial, grads, m, n_max, steps, st));
    default: return int(cudaErrorInvalidValue);
  }
}
