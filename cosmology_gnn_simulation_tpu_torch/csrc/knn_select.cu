// K1: exact cell-list k-NN selection, ids mode, codes mode (K1') and the
// dual mode (K1'', ids and codes together).
//
// Replaces the JAX package's TPU kernel ops/pallas_knn.py::
// _select_kernel (ids body `kernel`, also with `with_codes`; codes body
// `codes_kernel`; pallas_call in pallas_cell_list_knn). Computes what it
// computes, per table row (cell, rank):
//   * candidates: the 27 neighbor cells' rows of the [G^3, cap] tables in lane
//     order j27 * cap + rank (dx slowest), a coordinate pre-shifted by +-box
//     where its neighbor index wraps, then the spill_cap global spill lanes;
//   * d2 = ((dx^2) + dy^2) + dz^2 of the plain differences q - c, with the
//     lanes from mi_start on min-imaged by the same two selects
//     (d > box/2 -> d - box, then d < -box/2 -> d + box);
//   * ids mode: the k smallest (d2, id) pairs, ascending: smallest id wins
//     exact ties, picks past the row's valid candidates are the sentinel id
//     n. Codes mode: the k smallest (d2, lane) pairs, the candidate LANE as
//     the only payload: smallest lane wins exact ties, exhausted picks are
//     the sentinel lane 27 * cap + spill_cap. Dual mode: the ids mode's
//     selection, with each pick's lane as a second output (the sentinel lane
//     for exhausted picks). The TPU kernel emits the smallest lane holding
//     the picked id; a row holds each particle id in at most one lane (the
//     27 ring cells are distinct for G >= 3, and the table keeps ranks
//     < cap while the spill block keeps ranks >= cap), so that lane is the
//     lane the pick came from, which the list carries. kth is the k-th d2
//     (1e30 when exhausted). Empty table rows get sentinel rows.
// The arithmetic uses __fsub_rn/__fmul_rn/__fadd_rn, which nvcc never
// contracts into FMAs, so every d2 is bit-equal to the plain PyTorch version.
//
// Bound on the H100: neither bytes (the tables, ~3 MB in, ~11 MB out at the
// flagship size) nor the f32 ALU work of ~17 M occupied (query, candidate)
// pairs is large; what costs is latency and lane occupancy. Design: one warp
// per cell. The warp copies its 27 * cap + spill_cap candidates (16 B each,
// 12 kB at cap 24) from the tables straight into shared memory, applying the
// pre-shift on the way (the TPU path materialized four [G^3, 768] candidate
// planes through 27 rolls in HBM instead). Then each lane owns one query row,
// passes over the candidates once (shared-memory broadcast reads, empty slots
// skipped) and keeps a sorted top-KT list of (d2, payload) in registers: an
// insertion is one unrolled compare-swap pass, taken only by candidates that
// beat the current k-th. Rows past the cell's occupancy exit at once, which
// the TPU kernel could not do (row gating serialized its pipeline). The
// codes mode differs only in the payload (the lane index c instead of the
// candidate's id) and the dual mode only in a third list that carries the
// lane beside the id, so all modes share the body as a template parameter.
// The list length KT is a template parameter, instantiated at 8, 16, 32, 64
// and 128 (k <= 128, the TPU kernel's limit). At KT = 64 the list still
// fits the registers (168, no spills); at KT = 128 it outgrows them and
// the compiler spills about 200 bytes of it to local memory (L1-cached;
// nvcc -Xptxas -v reports it): the same exact selection, slower per
// candidate. The dual mode's third list adds KT registers a thread. A list
// in shared memory is the route if k > 64 ever matters.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

__device__ __forceinline__ float min_image(float d, float box, float half) {
  if (d > half) d = __fsub_rn(d, box);
  if (d < -half) d = __fadd_rn(d, box);
  return d;
}

enum Mode { kIds = 0, kCodes = 1, kDual = 2 };

template <int KT, int MODE>
__global__ void knn_select_kernel(
    const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, const int* __restrict__ tids,
    const float* __restrict__ sx, const float* __restrict__ sy,
    const float* __restrict__ sz, const int* __restrict__ sids,
    int num_cells, int g, int cap, int spill_cap, int k, int n, float box,
    int mi_start, int* __restrict__ out_ids, int* __restrict__ out_codes,
    float* __restrict__ out_kth) {
  constexpr bool CODES = MODE == kCodes;
  constexpr bool DUAL = MODE == kDual;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * (blockDim.x >> 5) + warp;
  if (cell >= num_cells) return;
  const int ring = 27 * cap;
  const int ncand = ring + spill_cap;
  float* cx = smem + (size_t)warp * ncand * 4;
  float* cy = cx + ncand;
  float* cz = cy + ncand;
  int* cid = reinterpret_cast<int*>(cz + ncand);

  const int ci = cell / (g * g), cj = (cell / g) % g, cl = cell % g;
  for (int idx = lane; idx < ring; idx += 32) {
    const int j27 = idx / cap;
    const int r = idx - j27 * cap;
    int ni = ci + j27 / 9 - 1, nj = cj + (j27 / 3) % 3 - 1, nl = cl + j27 % 3 - 1;
    float shx = 0.f, shy = 0.f, shz = 0.f;
    if (ni < 0) { ni += g; shx = -box; } else if (ni >= g) { ni -= g; shx = box; }
    if (nj < 0) { nj += g; shy = -box; } else if (nj >= g) { nj -= g; shy = box; }
    if (nl < 0) { nl += g; shz = -box; } else if (nl >= g) { nl -= g; shz = box; }
    const int src = ((ni * g + nj) * g + nl) * cap + r;
    const float x = tx[src], y = ty[src], z = tz[src];
    cx[idx] = shx != 0.f ? __fadd_rn(x, shx) : x;
    cy[idx] = shy != 0.f ? __fadd_rn(y, shy) : y;
    cz[idx] = shz != 0.f ? __fadd_rn(z, shz) : z;
    cid[idx] = tids[src];
  }
  for (int s = lane; s < spill_cap; s += 32) {
    cx[ring + s] = sx[s];
    cy[ring + s] = sy[s];
    cz[ring + s] = sz[s];
    cid[ring + s] = sids[s];
  }
  __syncwarp();

  const float half = 0.5f * box;
  const int sentinel = CODES ? ncand : n;
  for (int r = lane; r < cap; r += 32) {
    const int row = cell * cap + r;
    int* oi = out_ids + (size_t)row * k;
    int* oc = DUAL ? out_codes + (size_t)row * k : nullptr;
    if (tids[row] >= n) {
      for (int j = 0; j < k; ++j) {
        oi[j] = sentinel;
        if constexpr (DUAL) oc[j] = ncand;
      }
      out_kth[row] = kBig;
      continue;
    }
    const float qx = tx[row], qy = ty[row], qz = tz[row];
    float bd[KT];
    int bi[KT];
    int bl[DUAL ? KT : 1];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      bd[j] = kBig;
      bi[j] = sentinel;
      if constexpr (DUAL) bl[j] = ncand;
    }
    for (int c = 0; c < ncand; ++c) {
      const int id = cid[c];
      if (id >= n) continue;
      float dx = __fsub_rn(qx, cx[c]);
      float dy = __fsub_rn(qy, cy[c]);
      float dz = __fsub_rn(qz, cz[c]);
      if (c >= mi_start) {
        dx = min_image(dx, box, half);
        dy = min_image(dy, box, half);
        dz = min_image(dz, box, half);
      }
      float d2 = __fmul_rn(dx, dx);
      d2 = __fadd_rn(d2, __fmul_rn(dy, dy));
      d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
      const int payload = CODES ? c : id;
      if (lex_less(d2, payload, bd[KT - 1], bi[KT - 1])) {
        bd[KT - 1] = d2;
        bi[KT - 1] = payload;
        if constexpr (DUAL) bl[KT - 1] = c;
#pragma unroll
        for (int j = KT - 1; j > 0; --j) {
          if (lex_less(bd[j], bi[j], bd[j - 1], bi[j - 1])) {
            const float td = bd[j]; bd[j] = bd[j - 1]; bd[j - 1] = td;
            const int ti = bi[j]; bi[j] = bi[j - 1]; bi[j - 1] = ti;
            if constexpr (DUAL) {
              const int tl = bl[j];
              bl[j] = bl[j - 1];
              bl[j - 1] = tl;
            }
          }
        }
      }
    }
    float kth = kBig;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const bool picked = bd[j] < 0.5f * kBig;
      if (j < k) {
        oi[j] = picked ? bi[j] : sentinel;
        if constexpr (DUAL) oc[j] = picked ? bl[j] : ncand;
      }
      if (j == k - 1) kth = bd[j];
    }
    out_kth[row] = kth;
  }
}

template <int KT, int MODE>
cudaError_t launch(const float* tx, const float* ty, const float* tz,
                   const int* tids, const float* sx, const float* sy,
                   const float* sz, const int* sids, int num_cells, int g,
                   int cap, int spill_cap, int k, int n, float box,
                   int mi_start, int* out_ids, int* out_codes, float* out_kth,
                   cudaStream_t stream) {
  const size_t per_warp = (size_t)(27 * cap + spill_cap) * 16;
  if (per_warp > 227 * 1024) return cudaErrorInvalidValue;
  int warps = (int)((96 * 1024) / per_warp);
  warps = warps < 1 ? 1 : (warps > 4 ? 4 : warps);
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_select_kernel<KT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (num_cells + warps - 1) / warps;
  knn_select_kernel<KT, MODE><<<blocks, 32 * warps, smem, stream>>>(
      tx, ty, tz, tids, sx, sy, sz, sids, num_cells, g, cap, spill_cap, k, n,
      box, mi_start, out_ids, out_codes, out_kth);
  return cudaGetLastError();
}

template <int MODE>
int dispatch(const float* tx, const float* ty, const float* tz, const int* tids,
             const float* sx, const float* sy, const float* sz, const int* sids,
             int num_cells, int g, int cap, int spill_cap, int k, int n,
             float box, int mi_start, int* out, int* out_codes, float* out_kth,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 128) return (int)cudaErrorInvalidValue;
#define KNN_LAUNCH(KT)                                                        \
  return (int)launch<KT, MODE>(tx, ty, tz, tids, sx, sy, sz, sids, num_cells, \
                               g, cap, spill_cap, k, n, box, mi_start, out,   \
                               out_codes, out_kth, s)
  if (k <= 8) KNN_LAUNCH(8);
  if (k <= 16) KNN_LAUNCH(16);
  if (k <= 32) KNN_LAUNCH(32);
  if (k <= 64) KNN_LAUNCH(64);
  KNN_LAUNCH(128);
#undef KNN_LAUNCH
}

}  // namespace

// Plain C entry points (loaded with ctypes). Table planes are [num_cells, cap]
// row-major, spill planes [spill_cap]; out [num_cells * cap, k] int32 (ids,
// or candidate lanes for knn_codes_launch; knn_dual_launch writes ids to out
// and lanes to out_codes), out_kth [num_cells * cap] float32. Launch on
// `stream`, do not synchronize, return the launch's cudaError_t.
extern "C" int knn_select_launch(
    const float* tx, const float* ty, const float* tz, const int* tids,
    const float* sx, const float* sy, const float* sz, const int* sids,
    int num_cells, int g, int cap, int spill_cap, int k, int n, float box,
    int mi_start, int* out_ids, float* out_kth, void* stream) {
  return dispatch<kIds>(tx, ty, tz, tids, sx, sy, sz, sids, num_cells, g, cap,
                        spill_cap, k, n, box, mi_start, out_ids, nullptr,
                        out_kth, stream);
}

extern "C" int knn_codes_launch(
    const float* tx, const float* ty, const float* tz, const int* tids,
    const float* sx, const float* sy, const float* sz, const int* sids,
    int num_cells, int g, int cap, int spill_cap, int k, int n, float box,
    int mi_start, int* out_codes, float* out_kth, void* stream) {
  return dispatch<kCodes>(tx, ty, tz, tids, sx, sy, sz, sids, num_cells, g,
                          cap, spill_cap, k, n, box, mi_start, out_codes,
                          nullptr, out_kth, stream);
}

extern "C" int knn_dual_launch(
    const float* tx, const float* ty, const float* tz, const int* tids,
    const float* sx, const float* sy, const float* sz, const int* sids,
    int num_cells, int g, int cap, int spill_cap, int k, int n, float box,
    int mi_start, int* out_ids, int* out_codes, float* out_kth, void* stream) {
  return dispatch<kDual>(tx, ty, tz, tids, sx, sy, sz, sids, num_cells, g, cap,
                         spill_cap, k, n, box, mi_start, out_ids, out_codes,
                         out_kth, stream);
}
