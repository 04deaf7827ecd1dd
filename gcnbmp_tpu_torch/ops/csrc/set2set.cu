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
//   values: latency and instruction count, not bandwidth or FLOPs (the
//   f32 work of M = 512 molecules is about 0.4 us of the card's FMA rate).
// - K4 gives each molecule a group of four warps (GROUP threads) that
//   synchronises on its own named barrier (bar.sync 1 + group, GROUP),
//   never on the CTA's, so no group waits for another.  A CTA holds up to
//   MAX_GROUPS groups, and the launch puts at most one CTA on each SM: at
//   small M every SM works (M = 512: 132 CTAs of 4 groups, 512 of them
//   with a molecule), at large M each SM keeps 16 warps in flight (its
//   registers allow no more) and the groups walk the molecules.  In a
//   step, thread j < 4C computes LSTM pre-activation j as q.W_q[:, j] +
//   r.W_r[:, j] + b_j, with W_q = wx[0:C] + wh folded once (the LSTM's
//   hidden is q: 2C terms, not 3C) and both columns held in registers;
//   the gates meet in shared memory; four threads per atom take the
//   energies by 16-byte reads; every warp takes the softmax of all the
//   atoms itself (no barrier); each warp sums its share of the atoms for
//   r, and threads c < C add the shares in a fixed order, so a run
//   repeats bit for bit.  The kernel is instantiated per atoms per lane
//   (NPL = ceil(n_max / 32)), so no loop runs over blocks of atoms the
//   table does not have.  Step 0 has q* = hh = 0, so its gates are b.
// - Weights and atoms by bulk copies (cp.async.bulk, completing on
//   mbarriers): one thread copies wx and wh (48 KB at C = 32) to shared
//   memory while step 0 runs (b, which step 0 needs, is a plain load);
//   each group's threads wait for them at their first step 1 and take
//   their columns into registers.  Each group's atom tables (unpadded,
//   (n_max, C)) land two molecules ahead in two buffers, so the next
//   molecule's copy runs under the current one's steps.
// - Not tensor cores: with at most 4 molecules per SM in flight, a step's
//   LSTM product has 4 rows against wgmma's 64.
// - K4b: one warp owns a molecule (lane c holds channel c of c, q and r;
//   lane n holds atoms n, n+32, .. of the softmax), so a step is warp
//   shuffles and register math.  A CTA keeps wx, wh and b in shared
//   memory; its CTA is sized at launch from n_max (16 warps at n_max =
//   24, C = 32: 200 KB, one CTA per SM), at most one CTA per SM.  The
//   molecule's atom rows are staged with a padded row stride (C + 1
//   words), so the energies' per-lane row reads and the weighted sum's
//   per-lane column reads are both free of bank conflicts.
// - K4b's weight gradients: its warps write each step's LSTM input x =
//   [q, r] of the step before (zero at the first) and pre-activation
//   adjoint dy to a global scratch of (M, S, 6C) rows; a second kernel
//   takes dwx = X^T DY (whose top C rows are dwh: the LSTM's hidden is q)
//   and db = sum DY as register-blocked products over fixed splits of
//   GRAD_ROWS rows, one row of partials per split, and a third sums the
//   partials in split order.  The splits depend on M alone, so a run
//   repeats bit for bit, with no atomics, whatever the grid.
// - Plain f32 arithmetic, expf/tanhf, as the JAX package's f32 math.

#include "fused_ggnn_common.cuh"

#ifdef __CUDACC__
// Hopper's named barriers, mbarriers and bulk copies, in PTX (the CPU
// stand-in of tests/cuda_emu defines the same functions).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// arrive, and expect `bytes` more to land before the phase completes
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// order this thread's generic-proxy accesses of shared memory before its
// later bulk copies into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// global -> shared, `bytes` a multiple of 16 at 16-byte-aligned addresses;
// completes its bytes on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}
#endif

namespace {

using ggnn::MAX_DEVICES;
using ggnn::opt_in_smem;
using ggnn::sigmoidf;
using ggnn::sum_tiles_kernel;

constexpr int MAX_NPL = 4;         // atoms per lane: n_max <= 128
constexpr int MAX_ATOMS = 32 * MAX_NPL;
constexpr int MAX_STEPS = 4;
constexpr int GROUP = 128;         // the forward's threads per molecule
constexpr int MAX_GROUPS = 4;      // the forward's molecules in flight per CTA
constexpr int EPT = 4;             // the forward's threads per atom's energy
constexpr int MAX_BWD_WARPS = 16;  // the backward's CTA
constexpr int GRAD_ROWS = 64;      // scratch rows per split of the weight gradients
constexpr int GRAD_THREADS = 512;  // one (C/8) x (C/8) block of dwx (2C, 4C) each
constexpr size_t SMEM_MAX = 232448;  // shared memory a CTA may opt into
constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

// K4b's shared-memory words of the weights: wx (2C, 4C), wh (C, 4C), b
// (4C).
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
                       DR = DE + MAX_ATOMS, WORDS = DR + 32;
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

// K4b's one-warp steps, from here to set2set_bwd_kernel (K4 has its own,
// molecule_steps).
template <int C>
__device__ __forceinline__ void load_weights(float* s_w, const float* wx,
                                             const float* wh, const float* b,
                                             int threads) {
  using W = S2sWeights<C>;
  for (int i = threadIdx.x; i < 2 * C * W::G; i += threads) s_w[W::WX + i] = wx[i];
  for (int i = threadIdx.x; i < C * W::G; i += threads) s_w[W::WH + i] = wh[i];
  for (int i = threadIdx.x; i < W::G; i += threads) s_w[W::B + i] = b[i];
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

// K4's shared-memory words: the weights' mbarrier (a 4-word header) and
// staging area wx (2C, 4C), wh (C, 4C), then per group two atom tables
// (n_max, C) unpadded, q and r (C each), the activated gates (4C), the
// energies (n_max, rounded up to 4), the weighted sum's partials (GROUP /
// C rows of C) and the tables' two mbarriers (4 words).  Every block
// starts on a 16-byte boundary.
template <int C>
struct FwdPlan {
  static constexpr int G = 4 * C;
  static constexpr int W = 4;                // wx, then wh
  static constexpr int GROUPS_AT = W + 3 * C * G;
  int table, q, r, y, e, part, bar, words;   // a group's blocks and size
  __host__ __device__ constexpr explicit FwdPlan(int n_max)
      : table(n_max * C), q(2 * table), r(q + C), y(r + C), e(y + G),
        part(e + ((n_max + 3) & ~3)), bar(part + GROUP), words(bar + 4) {}
  __host__ __device__ constexpr size_t bytes(int groups) const {
    return size_t(GROUPS_AT + groups * words) * 4;
  }
};

// Thread j < 4C's LSTM weights: b_j, and columns j of W_q = wx[0:C] + wh
// (the LSTM's hidden is q) and of W_r = wx[C:2C] in registers, taken from
// the CTA's staged copy of wx and wh once its bulk copy has landed.
template <int C>
struct ColumnWeights {
  float wq[C], wr[C], bj;
  bool ready;
  const float* s_w;          // wx (2C, 4C), then wh (C, 4C)
  unsigned long long* bar;   // completes when s_w has landed
  __device__ __forceinline__ void take(int j) {
    constexpr int G = 4 * C;
    mbar_wait(bar, 0);
#pragma unroll
    for (int d = 0; d < C; ++d) {
      wq[d] = s_w[d * G + j] + s_w[(2 * C + d) * G + j];
      wr[d] = s_w[(C + d) * G + j];
    }
    ready = true;
  }
};

// e += a . b for four channels
__device__ __forceinline__ float dot4(float4 a, float4 b, float e) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, e))));
}

// The K4 steps of one molecule by one group (thread tid < GROUP of it, on
// named barrier `bar`) over its table s_atoms, NPL = ceil(n_max / 32)
// atoms per lane.  Returns, on threads tid < C, the molecule's q and r of
// channel tid.
template <int C, int NPL>
__device__ __forceinline__ void molecule_steps(ColumnWeights<C>& w,
                                               const float* s_atoms,
                                               float* s_g, const FwdPlan<C>& pl,
                                               const float (&am)[NPL],
                                               int n_max, int steps, int bar,
                                               int tid, float& q, float& r) {
  constexpr int G = 4 * C;
  constexpr int CPT = C / EPT;       // channels per energy thread: 8 or 4
  constexpr int PARTS = GROUP / C;   // weighted-sum partials per channel
  const int lane = tid & 31, warp = tid >> 5;
  float* s_q = s_g + pl.q;
  float* s_r = s_g + pl.r;
  float* s_y = s_g + pl.y;
  float* s_e = s_g + pl.e;
  float* s_part = s_g + pl.part;
  float c = 0.0f;
  q = r = 0.0f;
  for (int s = 0; s < steps; ++s) {
    // LSTM: y_j = b_j + q . W_q[:, j] + r . W_r[:, j] (hh = q), in four
    // partial sums; at step 0 q* = hh = 0 and y = b, so the weights are
    // waited for (and taken into registers) only at the first step 1
    if (tid < G) {
      float y = w.bj;
      if (s == 1 && !w.ready) w.take(tid);
      if (s > 0) {
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
        for (int d = 0; d < C; d += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(s_q + d);
          const float4 rv = *reinterpret_cast<const float4*>(s_r + d);
          a0 = fmaf(qv.x, w.wq[d], a0);
          a1 = fmaf(qv.y, w.wq[d + 1], a1);
          a2 = fmaf(qv.z, w.wq[d + 2], a2);
          a3 = fmaf(qv.w, w.wq[d + 3], a3);
          a0 = fmaf(rv.x, w.wr[d], a0);
          a1 = fmaf(rv.y, w.wr[d + 1], a1);
          a2 = fmaf(rv.z, w.wr[d + 2], a2);
          a3 = fmaf(rv.w, w.wr[d + 3], a3);
        }
        y += (a0 + a1) + (a2 + a3);
      }
      s_y[tid] = tid / C == 2 ? tanhf(y) : sigmoidf(y);
    }
    named_sync(bar, GROUP);
    if (tid < C) {
      c = s_y[C + tid] * c + s_y[tid] * s_y[2 * C + tid];
      q = s_y[3 * C + tid] * tanhf(c);
      s_q[tid] = q;
    }
    named_sync(bar, GROUP);
    // energies atoms . q: EPT threads per atom, thread u the CPT channels
    // from u CPT on, as 16-byte reads (at C = 32 the two halves in an
    // order that alternates with the atom, so that each quarter warp's
    // reads fall on distinct banks); q's CPT channels in registers
    const int u = tid % EPT;
    const float4* qu = reinterpret_cast<const float4*>(s_q + u * CPT);
    const float4 qa = qu[0], qb = qu[CPT / 4 - 1];
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int n = 32 * k + tid / EPT;
      float e = 0.0f;
      if (n < n_max) {
        const float4* row = reinterpret_cast<const float4*>(s_atoms + n * C + u * CPT);
        if (CPT == 8) {
          const int odd = n & 1;
          e = dot4(row[odd], odd ? qb : qa, e);
          e = dot4(row[1 - odd], odd ? qa : qb, e);
        } else {
          e = dot4(row[0], qa, e);
        }
      }
      e += __shfl_xor_sync(FULL, e, 1);
      e += __shfl_xor_sync(FULL, e, 2);
      if (u == 0 && n < n_max) s_e[n] = e;
    }
    named_sync(bar, GROUP);
    // softmax over the atoms, -1e9 where the mask is 0: every warp takes
    // the whole of it (lane holds atoms lane + 32k), then p amask
    float p[NPL];
    float mx = -3.0e38f;  // below every energy, -1e9 included
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      if (lane + 32 * k < n_max) {
        p[k] = am[k] > 0.0f ? s_e[lane + 32 * k] : NEG;
        mx = fmaxf(mx, p[k]);
      }
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      p[k] = lane + 32 * k < n_max ? expf(p[k] - mx) : 0.0f;
      sum += p[k];
    }
    const float inv = 1.0f / warp_sum(sum);
#pragma unroll
    for (int k = 0; k < NPL; ++k) p[k] = p[k] * inv * am[k];
    // r = sum_n (p amask)_n atoms_n: partial `part` (a warp, or half of
    // one at C = 16) sums the atoms n = part mod PARTS for channel ch,
    // then threads tid < C add the partials in order
    const int part = warp * (32 / C) + lane / C, ch = lane % C;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
#pragma unroll
      for (int j = part; j < 32; j += PARTS) {
        const float pk = __shfl_sync(FULL, p[k], j);
        if (32 * k + j < n_max) acc = fmaf(pk, s_atoms[(32 * k + j) * C + ch], acc);
      }
    }
    s_part[part * C + ch] = acc;
    named_sync(bar, GROUP);
    if (tid < C) {
      r = s_part[tid];
#pragma unroll
      for (int i = 1; i < PARTS; ++i) r += s_part[i * C + tid];
      s_r[tid] = r;
    }
    if (s + 1 < steps) named_sync(bar, GROUP);
  }
}

// K4: groups of GROUP threads (blockDim.x / GROUP of them) each walk the
// molecules blockIdx.x + group gridDim.x, then on by gridDim.x groups.
template <int C, int NPL>
__global__ void __launch_bounds__(MAX_GROUPS * GROUP, 1)
set2set_fwd_kernel(const float* __restrict__ atoms,
                   const float* __restrict__ amask,
                   const float* __restrict__ wx, const float* __restrict__ wh,
                   const float* __restrict__ b, float* __restrict__ out, int m,
                   int n_max, int steps) {
  using Pl = FwdPlan<C>;
  constexpr int G = Pl::G;
  extern __shared__ float smem[];
  const FwdPlan<C> pl(n_max);
  const int groups = blockDim.x / GROUP;
  const int group = threadIdx.x / GROUP, tid = threadIdx.x % GROUP;
  const int lane = tid & 31;
  float* s_w = smem + Pl::W;
  float* s_g = smem + Pl::GROUPS_AT + group * pl.words;
  unsigned long long* wbar = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* tbar = reinterpret_cast<unsigned long long*>(s_g + pl.bar);
  if (threadIdx.x == 0) {  // wx and wh by one bulk copy each, behind step 0
    mbar_init(wbar, 1);
    for (int g = 0; g < groups; ++g) {
      unsigned long long* gb = reinterpret_cast<unsigned long long*>(
          smem + Pl::GROUPS_AT + g * pl.words + pl.bar);
      mbar_init(gb, 1);
      mbar_init(gb + 1, 1);
    }
    mbar_fence_init();
    mbar_expect_tx(wbar, 3 * C * G * 4);
    bulk_copy(s_w, wx, 2 * C * G * 4, wbar);
    bulk_copy(s_w + 2 * C * G, wh, C * G * 4, wbar);
  }
  __syncthreads();  // the barrier is initialised before any thread waits on it
  ColumnWeights<C> w;
  w.ready = false;
  w.s_w = s_w;
  w.bar = wbar;
  w.bj = tid < G ? b[tid] : 0.0f;
  // the group's molecules first, first + stride, ...: molecule i's table
  // lands in table i % 2 by one bulk copy, started two molecules ahead
  const int stride = gridDim.x * groups;
  const int first = blockIdx.x + group * gridDim.x;
  const unsigned bytes = unsigned(pl.table) * 4;
  auto fetch = [&](int buf, int mol) {
    mbar_expect_tx(tbar + buf, bytes);
    bulk_copy(s_g + buf * pl.table, atoms + size_t(mol) * pl.table, bytes, tbar + buf);
  };
  if (tid == 0) {
    if (first < m) fetch(0, first);
    if (first + stride < m) fetch(1, first + stride);
  }
  int i = 0;
  for (int mol = first; mol < m; mol += stride, ++i) {
    const int buf = i & 1;
    float am[NPL];
#pragma unroll
    for (int k = 0; k < NPL; ++k)
      am[k] = lane + 32 * k < n_max ? amask[size_t(mol) * n_max + lane + 32 * k] : 0.0f;
    mbar_wait(tbar + buf, (i >> 1) & 1);
    float q, r;
    molecule_steps<C, NPL>(w, s_g + buf * pl.table, s_g, pl, am, n_max, steps,
                           1 + group, tid, q, r);
    // every thread of the group is past its last read of the table (the
    // last step's partials barrier): the table takes molecule i + 2
    if (tid == 0 && mol + 2 * stride < m) {
      fence_proxy_async();
      fetch(buf, mol + 2 * stride);
    }
    if (tid < C) {
      out[size_t(mol) * 2 * C + tid] = q;
      out[size_t(mol) * 2 * C + C + tid] = r;
    }
  }
  if (threadIdx.x == 0) mbar_wait(wbar, 0);  // no exit before the copy lands
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

// The backward of each molecule, one warp per molecule (the warps walk the
// molecules grid-stride over the whole grid): the forward steps again,
// stashing each step's values, then the reverse; writes the molecule's
// datoms and its S rows of the weight-gradient scratch xs (M, S, 6C):
// [q, r] of the step before (zero at the first step) and dy of the step.
template <int C>
__global__ void __launch_bounds__(MAX_BWD_WARPS * 32)
set2set_bwd_kernel(const float* __restrict__ atoms,
                   const float* __restrict__ amask,
                   const float* __restrict__ wx, const float* __restrict__ wh,
                   const float* __restrict__ b, const float* __restrict__ dg,
                   float* __restrict__ datoms, float* __restrict__ xs,
                   int m, int n_max, int steps) {
  using W = S2sWeights<C>;
  extern __shared__ float smem[];
  float* s_w = smem;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int per_warp = n_max * (C + 1) + n_max + steps * Stash::WORDS;
  float* s_atoms = smem + W::WORDS + warp * per_warp;
  float* s_am = s_atoms + n_max * (C + 1);
  float* stash = s_am + n_max;
  load_weights<C>(s_w, wx, wh, b, blockDim.x);
  __syncthreads();

  for (int mol = blockIdx.x * warps + warp; mol < m; mol += gridDim.x * warps) {
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
      const float* prev = stash + (s > 0 ? s - 1 : 0) * Stash::WORDS;  // read when s > 0
      const float c_prev = s > 0 ? prev[Stash::CN + lane] : 0.0f;
      const float dq_t = dq + dhh;
      const float tc = tanhf(c_new);
      const float dc_new = dq_t * go * (1.0f - tc * tc) + dc;
      dc = dc_new * gf;
      const bool live = lane < C;
      const float dyi = live ? dc_new * gg * gi * (1.0f - gi) : 0.0f;
      const float dyf = live ? dc_new * c_prev * gf * (1.0f - gf) : 0.0f;
      const float dyg = live ? dc_new * gi * (1.0f - gg * gg) : 0.0f;
      const float dyo = live ? dq_t * tc * go * (1.0f - go) : 0.0f;
      if (live) {  // the step's scratch row: x = [q, r] of step s - 1, dy
        float* row = xs + (size_t(mol) * steps + s) * 6 * C;
        row[lane] = s > 0 ? prev[Stash::Q + lane] : 0.0f;
        row[C + lane] = s > 0 ? prev[Stash::R + lane] : 0.0f;
        row[2 * C + lane] = dyi;
        row[3 * C + lane] = dyf;
        row[4 * C + lane] = dyg;
        row[5 * C + lane] = dyo;
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
    __syncwarp();  // the table and stash are rewritten for the next molecule
  }
}

// One split's weight gradients from the scratch rows [split GRAD_ROWS,
// + GRAD_ROWS) (fewer in the last split): dwx (2C, 4C) = X^T DY, X the
// rows' first 2C columns and DY their last 4C, and db = sum DY, into the
// split's row of partials in the order [dwx, dwh, db] (dwh is dwx's top C
// rows).  Thread (ta, tc) = (warp, lane) owns the (C/8) x (C/8) block of
// dwx at rows ta C/8, columns tc C/8: per row one broadcast load of x and
// one coalesced load of dy (from L1 after the first warp).  Warp 0's
// blocks span all of dy's columns, so it sums db too.  Every output
// belongs to one thread and sums its rows in order.
template <int C>
__global__ void __launch_bounds__(GRAD_THREADS)
set2set_grad_kernel(const float* __restrict__ xs, float* __restrict__ partial,
                    int n_rows) {
  using W = S2sWeights<C>;
  constexpr int BK = C / 8;
  constexpr int X = 6 * C;  // scratch row length
  static_assert((2 * C / BK) * (4 * C / BK) == GRAD_THREADS, "one block a thread");
  const int ta = threadIdx.x >> 5, tc = threadIdx.x & 31;
  const int r0 = blockIdx.x * GRAD_ROWS;
  const int r1 = min(r0 + GRAD_ROWS, n_rows);
  float acc[BK][BK] = {}, db[BK] = {};
  for (int i = r0; i < r1; ++i) {
    float av[BK], bv[BK];
    ggnn::ldv<BK>(xs + size_t(i) * X + ta * BK, av);
    ggnn::ldv<BK>(xs + size_t(i) * X + 2 * C + tc * BK, bv);
#pragma unroll
    for (int x = 0; x < BK; ++x)
#pragma unroll
      for (int y = 0; y < BK; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
#pragma unroll
    for (int y = 0; y < BK; ++y) db[y] += bv[y];
  }
  float* out = partial + size_t(blockIdx.x) * W::WORDS;
#pragma unroll
  for (int x = 0; x < BK; ++x)
#pragma unroll
    for (int y = 0; y < BK; ++y) {
      const int a = ta * BK + x, j = tc * BK + y;
      out[W::WX + a * W::G + j] = acc[x][y];
      if (a < C) out[W::WH + a * W::G + j] = acc[x][y];
    }
  if (ta == 0)
#pragma unroll
    for (int y = 0; y < BK; ++y) out[W::B + tc * BK + y] = db[y];
}

int grad_splits(int m, int steps) {
  return (m * steps + GRAD_ROWS - 1) / GRAD_ROWS;
}

// The backward's launch for m molecules: warps per CTA (as many as fit
// beside the weights, at most MAX_BWD_WARPS, and no more than one
// molecule per warp when every SM holds a CTA), CTAs (at most one per SM)
// and their shared memory.  Opts the kernel into SMEM_MAX first.
struct BwdLaunch {
  int warps, ctas;
  size_t bytes;
};

template <int C>
cudaError_t bwd_launch(int m, int n_max, int steps, BwdLaunch& out) {
  static_assert(size_t(S2sWeights<C>::WORDS + MAX_ATOMS * (C + 2) +
                       MAX_STEPS * Stash::WORDS) * 4 <= SMEM_MAX,
                "a warp of the widest table fits beside the weights");
  static bool opted_in[MAX_DEVICES] = {};
  cudaError_t err = opt_in_smem(set2set_bwd_kernel<C>, SMEM_MAX, opted_in);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int per_warp = n_max * (C + 1) + n_max + steps * Stash::WORDS;
  const int fit = int((SMEM_MAX / 4 - S2sWeights<C>::WORDS) / per_warp);
  out.warps = max(1, min(min(MAX_BWD_WARPS, fit), (m + sms - 1) / sms));
  out.ctas = min(sms, (m + out.warps - 1) / out.warps);
  out.bytes = size_t(S2sWeights<C>::WORDS + out.warps * per_warp) * 4;
  return cudaSuccess;
}

// K4's launch for m molecules: one CTA per SM at most (ctas), each of
// `groups` groups, so that every SM works at small m and each SM keeps
// MAX_GROUPS molecules (16 warps) in flight at large m.  Opts the kernel
// into the widest table's shared memory first.
struct FwdLaunch {
  int ctas, groups;
  size_t bytes;
};

template <int C, int NPL>
cudaError_t fwd_launch(int m, int n_max, FwdLaunch& out) {
  static_assert(FwdPlan<C>(MAX_ATOMS).bytes(MAX_GROUPS) <= SMEM_MAX,
                "the widest tables of every group fit beside the weights");
  static bool opted_in[MAX_DEVICES] = {};
  static int sm_count[MAX_DEVICES] = {};
  cudaError_t err = opt_in_smem(set2set_fwd_kernel<C, NPL>,
                                FwdPlan<C>(32 * NPL).bytes(MAX_GROUPS), opted_in);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess && sm_count[dev] == 0)
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  out.ctas = min(sm_count[dev], m);
  out.groups = min(MAX_GROUPS, (m + out.ctas - 1) / out.ctas);
  out.bytes = FwdPlan<C>(n_max).bytes(out.groups);
  return cudaSuccess;
}

template <int C, int NPL>
cudaError_t launch_fwd(const float* atoms, const float* amask, const float* wx,
                       const float* wh, const float* b, float* out, int m,
                       int n_max, int steps, cudaStream_t stream) {
  FwdLaunch lc;
  const cudaError_t err = fwd_launch<C, NPL>(m, n_max, lc);
  if (err != cudaSuccess) return err;
  set2set_fwd_kernel<C, NPL><<<lc.ctas, lc.groups * GROUP, lc.bytes, stream>>>(
      atoms, amask, wx, wh, b, out, m, n_max, steps);
  return cudaGetLastError();
}

template <int C, int NPL>
cudaError_t fwd_occupancy(int m, int n_max, int* out) {
  FwdLaunch lc;
  const cudaError_t err = fwd_launch<C, NPL>(m, n_max, lc);
  if (err != cudaSuccess) return err;
  out[1] = lc.ctas;
  out[2] = lc.groups * GROUP / 32;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, set2set_fwd_kernel<C, NPL>, lc.groups * GROUP, lc.bytes);
}

// K4's instance for C channels and n_max atoms (atoms per lane
// ceil(n_max / 32)): launched, or its occupancy queried
template <int C>
cudaError_t fwd_dispatch(bool launch, const float* atoms, const float* amask,
                         const float* wx, const float* wh, const float* b,
                         float* out, int m, int n_max, int steps,
                         cudaStream_t stream, int* occ) {
  switch ((n_max + 31) / 32) {
#define K4_NPL(NPL)                                                            \
  case NPL:                                                                    \
    return launch ? launch_fwd<C, NPL>(atoms, amask, wx, wh, b, out, m, n_max, \
                                       steps, stream)                          \
                  : fwd_occupancy<C, NPL>(m, n_max, occ);
    K4_NPL(1) K4_NPL(2) K4_NPL(3) K4_NPL(4)
#undef K4_NPL
    default: return cudaErrorInvalidValue;
  }
}

template <int C>
cudaError_t launch_bwd(const float* atoms, const float* amask, const float* wx,
                       const float* wh, const float* b, const float* dg,
                       float* datoms, float* xs, float* partial, float* grads,
                       int m, int n_max, int steps, cudaStream_t stream) {
  BwdLaunch lc;
  cudaError_t err = bwd_launch<C>(m, n_max, steps, lc);
  if (err != cudaSuccess) return err;
  set2set_bwd_kernel<C><<<lc.ctas, lc.warps * 32, lc.bytes, stream>>>(
      atoms, amask, wx, wh, b, dg, datoms, xs, m, n_max, steps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int splits = grad_splits(m, steps);
  set2set_grad_kernel<C><<<splits, GRAD_THREADS, 0, stream>>>(xs, partial, m * steps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int NW = S2sWeights<C>::WORDS;
  sum_tiles_kernel<<<(NW + 255) / 256, 256, 0, stream>>>(partial, grads, splits, NW);
  return cudaGetLastError();
}

template <int C>
cudaError_t bwd_occupancy(int m, int n_max, int steps, int* out) {
  BwdLaunch lc;
  const cudaError_t err = bwd_launch<C>(m, n_max, steps, lc);
  if (err != cudaSuccess) return err;
  out[1] = lc.ctas;
  out[2] = lc.warps;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, set2set_bwd_kernel<C>, lc.warps * 32, lc.bytes);
}

// K4's bulk copies read 16-byte-aligned global memory
bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

bool valid(int m, int n_max, int steps) {
  return m > 0 && n_max > 0 && n_max <= MAX_ATOMS && steps > 0 &&
         steps <= MAX_STEPS;
}

}  // namespace

// The rows of K4b's partial buffer (splits of its weight gradients) for m
// molecules and `steps` steps.
extern "C" int set2set_bwd_splits(int m, int steps) { return grad_splits(m, steps); }

// K4b's main kernel for m molecules: the CTAs an SM holds at the shared
// memory its launch asks, the CTAs it launches and the warps of each, in
// out[0..2].  Returns a cudaError_t.
extern "C" int set2set_bwd_occupancy(int m, int n_max, int channels,
                                     int steps, int* out) {
  if (!valid(m, n_max, steps)) return int(cudaErrorInvalidValue);
  switch (channels) {
    case 16: return int(bwd_occupancy<16>(m, n_max, steps, out));
    case 32: return int(bwd_occupancy<32>(m, n_max, steps, out));
    default: return int(cudaErrorInvalidValue);
  }
}

// K4's launch for m molecules: the CTAs an SM holds at the shared memory
// the launch asks, the CTAs it launches and the warps of each (four per
// group), in out[0..2].  Returns a cudaError_t.
extern "C" int set2set_fwd_occupancy(int m, int n_max, int channels,
                                     int steps, int* out) {
  if (!valid(m, n_max, steps)) return int(cudaErrorInvalidValue);
  switch (channels) {
    case 16: return int(fwd_dispatch<16>(false, nullptr, nullptr, nullptr, nullptr,
                                         nullptr, nullptr, m, n_max, steps, nullptr, out));
    case 32: return int(fwd_dispatch<32>(false, nullptr, nullptr, nullptr, nullptr,
                                         nullptr, nullptr, m, n_max, steps, nullptr, out));
    default: return int(cudaErrorInvalidValue);
  }
}

// K4: q* (M, 2C) after `steps` Set2Set steps over atoms (M, n_max, C) with
// mask amask (M, n_max); wx (2C, 4C), wh (C, 4C), b (4C).  Returns a
// cudaError_t.
extern "C" int fused_set2set_fwd(const float* atoms, const float* amask,
                                 const float* wx, const float* wh,
                                 const float* b, float* out, int m, int n_max,
                                 int channels, int steps, void* stream) {
  if (!valid(m, n_max, steps) || !aligned16(atoms) || !aligned16(wx) ||
      !aligned16(wh))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 16: return int(fwd_dispatch<16>(true, atoms, amask, wx, wh, b, out, m, n_max, steps, st, nullptr));
    case 32: return int(fwd_dispatch<32>(true, atoms, amask, wx, wh, b, out, m, n_max, steps, st, nullptr));
    default: return int(cudaErrorInvalidValue);
  }
}

// K4b: datoms (M, n_max, C) and the summed weight gradients grads = [dwx
// (2C, 4C), dwh (C, 4C), db (4C)] for the upstream gradient dg (M, 2C);
// xs (M, steps, 6C) and partial (set2set_bwd_splits(m, steps), 12C^2 +
// 4C) are scratch.  Returns a cudaError_t.
extern "C" int fused_set2set_bwd(const float* atoms, const float* amask,
                                 const float* wx, const float* wh,
                                 const float* b, const float* dg,
                                 float* datoms, float* xs, float* partial,
                                 float* grads, int m, int n_max, int channels,
                                 int steps, void* stream) {
  if (!valid(m, n_max, steps)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 16: return int(launch_bwd<16>(atoms, amask, wx, wh, b, dg, datoms, xs, partial, grads, m, n_max, steps, st));
    case 32: return int(launch_bwd<32>(atoms, amask, wx, wh, b, dg, datoms, xs, partial, grads, m, n_max, steps, st));
    default: return int(cudaErrorInvalidValue);
  }
}
