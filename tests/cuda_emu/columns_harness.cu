// A test harness for the column-list build of fused_ggnn_common.cuh
// (count_columns): one CTA loads one tile's row lists from global memory,
// builds the column lists and writes them back, so that
// tests/test_torch_fwd_emulated.py can hold them against lists built in
// numpy.  Built only by tests/cuda_emu/emulate.py, against the CPU stand-in.

#include "fused_ggnn_common.cuh"

namespace {

using namespace ggnn;

constexpr int SLOTS = TILE * NBR_CAP;
// shared-memory plan in words: row-list values and columns, counts, column
// starts, rows and values, crowded rows and their count, the row masks
constexpr int NV = 0, NK = NV + SLOTS, NC = NK + SLOTS, CS = NC + TILE;
constexpr int CR = CS + ROW_LEN + 1, CV = CR + SLOTS, OV = CV + SLOTS;
constexpr int OVN = OV + TILE, BITS = OVN + 1, WORDS = BITS + ROW_LEN * TILE / 32;

template <typename Idx>
__global__ void columns_kernel(const int* nk, const float* nv, const int* nc,
                               int* cs, int* cr, float* cv, int* ov, int* ovn) {
  extern __shared__ float smem[];
  Idx* s_nk = reinterpret_cast<Idx*>(smem + NK);
  Idx* s_cr = reinterpret_cast<Idx*>(smem + CR);
  int* s_nc = reinterpret_cast<int*>(smem + NC);
  int* s_cs = reinterpret_cast<int*>(smem + CS);
  int* s_ov = reinterpret_cast<int*>(smem + OV);
  int* s_ovn = reinterpret_cast<int*>(smem + OVN);
  const int tid = threadIdx.x;
  for (int q = tid; q < SLOTS; q += THREADS) {
    s_nk[q] = Idx(nk[q]);
    smem[NV + q] = nv[q];
  }
  for (int i = tid; i < TILE; i += THREADS) s_nc[i] = nc[i];
  __syncthreads();
  count_columns(s_nk, smem + NV, s_nc, s_cs, s_cr, smem + CV, s_ov, s_ovn,
                reinterpret_cast<unsigned*>(smem + BITS), tid);
  for (int k = tid; k <= ROW_LEN; k += THREADS) cs[k] = s_cs[k];
  for (int q = tid; q < s_cs[ROW_LEN]; q += THREADS) {
    cr[q] = int(s_cr[q]);
    cv[q] = smem[CV + q];
  }
  for (int o = tid; o < *s_ovn; o += THREADS) ov[o] = s_ov[o];
  if (tid == 0) *ovn = *s_ovn;
}

template <typename Idx>
int launch(const int* nk, const float* nv, const int* nc, int* cs, int* cr,
           float* cv, int* ov, int* ovn) {
  columns_kernel<Idx><<<1, THREADS, size_t(WORDS) * 4, nullptr>>>(
      nk, nv, nc, cs, cr, cv, ov, ovn);
  return int(cudaGetLastError());
}

}  // namespace

// The column lists of one tile's row lists nk, nv (T, NBR_CAP) with row
// counts nc (T), built with int (columns_int) or 16-bit (columns_u16) list
// indices: column starts cs (4T + 1), rows cr and values cv (T NBR_CAP),
// crowded rows ov (T) and their count ovn (1).
extern "C" int columns_int(const int* nk, const float* nv, const int* nc,
                           int* cs, int* cr, float* cv, int* ov, int* ovn) {
  return launch<int>(nk, nv, nc, cs, cr, cv, ov, ovn);
}

extern "C" int columns_u16(const int* nk, const float* nv, const int* nc,
                           int* cs, int* cr, float* cv, int* ov, int* ovn) {
  return launch<unsigned short>(nk, nv, nc, cs, cr, cv, ov, ovn);
}
