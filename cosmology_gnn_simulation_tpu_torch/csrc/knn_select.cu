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
//     lane the pick came from, which travels with its key. kth is the k-th
//     d2 (1e30 when exhausted). Empty table rows get sentinel rows.
// The arithmetic uses __fsub_rn/__fmul_rn/__fadd_rn, which nvcc never
// contracts into FMAs, so every d2 is bit-equal to the plain PyTorch version.
//
// Bound on the H100: neither bytes (the tables, ~3 MB in, ~11 MB out at the
// flagship size) nor the f32 ALU work of ~17 M occupied (query, candidate)
// pairs is large; what costs is the selection's instructions and their
// latency. Design: one block of four warps per cell.
//   * The block stages the cell's candidates in shared memory once and
//     compacts them on the way: a warp reads 32 slots, ballots the occupied
//     ones and reserves their places with one shared atomic, so the ~510 of
//     768 slots that are empty at the flagship size (cap 24, spill_cap 120,
//     about 9.6 particles a cell) are never scanned. It stages in three
//     passes, the cell itself, then its six face neighbors, then the rest,
//     so a row's first rounds hold its nearest candidates and the k-th falls
//     early. Each candidate keeps its original lane: it decides the
//     min-image and is the codes' payload and the dual mode's second output.
//     The compacted order depends on the atomics' order; the result does not
//     (select_common.cuh: the keys are distinct, so the k smallest are one
//     set in any order).
//   * Each warp takes one query row at a time: its 32 lanes split the row's
//     candidates, 32 a round, and WarpSelect (select_common.cuh) keeps the
//     row's top k in a warp queue. A round first votes on d2 <= the k-th's
//     d2; only a round where some lane passes offers keys and merges.
//   * The key packs (d2, payload) in 64 bits: one compare is the (d2, id)
//     or (d2, lane) order. The dual mode's payload is id << lane_bits | lane
//     (the ids are distinct, so this orders as (d2, id)) where it fits in 32
//     bits (n <= 2^(32 - lane_bits): 4,194,304 at the flagship layout);
//     past that the lane rides beside the key as WarpSelect's value.
//   * The warp queue holds 32 * KW keys, KW = 1, 2, 4 for k <= 32, 64, 128
//     (the TPU kernel's limit), instead of a k-deep sorted list in each
//     lane's registers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select_common.cuh"


namespace {

using select_common::kBig;
using select_common::kFull;
using select_common::key_d2;
using select_common::key_payload;
using select_common::WarpSelect;

constexpr int kThreads = 128;
// Keys a lane's thread queue holds before the warp merges (one, as K8).
constexpr int kQueueDepth = 1;
// The 27 ring cells in staging order: the cell itself, its six face
// neighbors, then the rest (j27 = 9 * (dx + 1) + 3 * (dy + 1) + dz + 1).
__constant__ int kNearFirst[27] = {13, 4, 10, 12, 14, 16, 22, 0, 1, 2, 3, 5, 6, 7,
                                   8, 9, 11, 15, 17, 18, 19, 20, 21, 23, 24, 25, 26};

__device__ __forceinline__ float min_image(float d, float box, float half) {
  if (d > half) d = __fsub_rn(d, box);
  if (d < -half) d = __fadd_rn(d, box);
  return d;
}

// kDual packs id and lane into the payload; kDualWide carries the lane as
// a value (n too large to pack).
enum Mode { kIds = 0, kCodes = 1, kDual = 2, kDualWide = 3 };

// Stage slot o of the staging order (kNearFirst, then the spill block) if
// it is below end and occupied: pre-shift a coordinate by +-box where the
// neighbor index wraps, and reserve its compacted place with the warp's
// ballot and one shared atomic. The whole warp calls it.
__device__ __forceinline__ void stage_slot(
    int o, int end, int ci, int cj, int cl, int g, int cap, int ring, int n,
    float box, const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, const int* __restrict__ tids,
    const float* __restrict__ sx, const float* __restrict__ sy,
    const float* __restrict__ sz, const int* __restrict__ sids, float4* cand,
    int* cand_lane, int* staged) {
  const int lane = threadIdx.x & 31;
  bool valid = false;
  float x = 0.f, y = 0.f, z = 0.f;
  int id = n, idx = o;
  if (o < end && o < ring) {
    const int j27 = kNearFirst[o / cap];
    const int r = o - (o / cap) * cap;
    idx = j27 * cap + r;
    int ni = ci + j27 / 9 - 1, nj = cj + (j27 / 3) % 3 - 1, nl = cl + j27 % 3 - 1;
    float shx = 0.f, shy = 0.f, shz = 0.f;
    if (ni < 0) { ni += g; shx = -box; } else if (ni >= g) { ni -= g; shx = box; }
    if (nj < 0) { nj += g; shy = -box; } else if (nj >= g) { nj -= g; shy = box; }
    if (nl < 0) { nl += g; shz = -box; } else if (nl >= g) { nl -= g; shz = box; }
    const int src = ((ni * g + nj) * g + nl) * cap + r;
    id = tids[src];
    valid = id < n;
    if (valid) {
      x = tx[src];
      y = ty[src];
      z = tz[src];
      if (shx != 0.f) x = __fadd_rn(x, shx);
      if (shy != 0.f) y = __fadd_rn(y, shy);
      if (shz != 0.f) z = __fadd_rn(z, shz);
    }
  } else if (o < end) {
    const int s = o - ring;
    id = sids[s];
    valid = id < n;
    if (valid) {
      x = sx[s];
      y = sy[s];
      z = sz[s];
    }
  }
  const unsigned occupied = __ballot_sync(kFull, valid);
  if (occupied) {
    int at = 0;
    if (lane == 0) at = atomicAdd(staged, __popc(occupied));
    at = __shfl_sync(kFull, at, 0);
    if (valid) {
      const int p = at + __popc(occupied & ((1u << lane) - 1u));
      cand[p] = make_float4(x, y, z, __int_as_float(id));
      cand_lane[p] = idx;
    }
  }
}

template <int KW, int MODE>
__global__ void __launch_bounds__(kThreads) knn_select_kernel(
    const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, const int* __restrict__ tids,
    const float* __restrict__ sx, const float* __restrict__ sy,
    const float* __restrict__ sz, const int* __restrict__ sids, int g,
    int cap, int spill_cap, int k, int n, float box, int mi_start,
    int lane_bits, int* __restrict__ out_ids, int* __restrict__ out_codes,
    float* __restrict__ out_kth) {
  constexpr bool CODES = MODE == kCodes;
  constexpr bool PACKED = MODE == kDual;
  constexpr bool WIDE = MODE == kDualWide;
  constexpr bool DUAL = PACKED || WIDE;
  extern __shared__ float4 cand[];  // x, y, z, id bits; then the lanes
  __shared__ int staged;
  const int ring = 27 * cap;
  const int ncand = ring + spill_cap;
  int* cand_lane = reinterpret_cast<int*>(cand + ncand);
  const int cell = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  if (threadIdx.x == 0) staged = 0;
  __syncthreads();

  // Stage the occupied candidates, compacted, each with its lane.
  const int ci = cell / (g * g), cj = (cell / g) % g, cl = cell % g;
  // Three passes: the cell, its face neighbors, the rest and the spill.
  const int ends[3] = {cap, 7 * cap, ncand};
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const int from = pass == 0 ? 0 : ends[pass - 1];
    for (int base = from + warp * 32; base < ends[pass]; base += blockDim.x)
      stage_slot(base + lane, ends[pass], ci, cj, cl, g, cap, ring, n, box, tx, ty,
                 tz, tids, sx, sy, sz, sids, cand, cand_lane, &staged);
    __syncthreads();
  }
  const int count = staged;

  const float half = 0.5f * box;
  const int sentinel = CODES ? ncand : n;
  const uint32_t lane_mask = (1u << lane_bits) - 1u;
  for (int r = warp; r < cap; r += warps) {
    const int row = cell * cap + r;
    int* oi = out_ids + (size_t)row * k;
    int* oc = DUAL ? out_codes + (size_t)row * k : nullptr;
    if (tids[row] >= n) {
      for (int j = lane; j < k; j += 32) {
        oi[j] = sentinel;
        if constexpr (DUAL) oc[j] = ncand;
      }
      if (lane == 0) out_kth[row] = kBig;
      continue;
    }
    const float qx = tx[row], qy = ty[row], qz = tz[row];
    WarpSelect<KW, kQueueDepth, WIDE> sel;
    sel.init(k);
    for (int base = 0; base < count; base += 32) {
      const int c = base + lane;
      float d2 = 0.f;
      uint32_t payload = 0;
      int ln = 0;
      if (c < count) {
        const float4 p = cand[c];
        ln = cand_lane[c];
        float dx = __fsub_rn(qx, p.x);
        float dy = __fsub_rn(qy, p.y);
        float dz = __fsub_rn(qz, p.z);
        if (ln >= mi_start) {
          dx = min_image(dx, box, half);
          dy = min_image(dy, box, half);
          dz = min_image(dz, box, half);
        }
        d2 = __fmul_rn(dx, dx);
        d2 = __fadd_rn(d2, __fmul_rn(dy, dy));
        d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
        const uint32_t id = __float_as_uint(p.w);
        payload = CODES ? (uint32_t)ln : PACKED ? (id << lane_bits) | ln : id;
      }
      // One vote a round: almost every round admits nothing.
      if (__any_sync(kFull, c < count && sel.may_admit(d2))) {
        if (c < count) sel.add(d2, payload, ln);
        sel.check();
      }
    }
    sel.finish();
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int q = w * 32 + lane;
      if (q < k) {
        const bool picked = key_d2(sel.wk[w]) < 0.5f * kBig;
        const uint32_t payload = key_payload(sel.wk[w]);
        oi[q] = !picked ? sentinel : PACKED ? (int)(payload >> lane_bits) : (int)payload;
        if constexpr (PACKED) oc[q] = picked ? (int)(payload & lane_mask) : ncand;
        if constexpr (WIDE) oc[q] = picked ? sel.wv[w] : ncand;
      }
    }
    const float kth = key_d2(sel.kth_key());
    if (lane == 0) out_kth[row] = kth;
  }
}

template <int KW, int MODE>
cudaError_t launch(const float* tx, const float* ty, const float* tz,
                   const int* tids, const float* sx, const float* sy,
                   const float* sz, const int* sids, int num_cells, int g,
                   int cap, int spill_cap, int k, int n, float box,
                   int mi_start, int lane_bits, int* out_ids, int* out_codes,
                   float* out_kth, cudaStream_t stream) {
  const size_t smem = (size_t)(27 * cap + spill_cap) * (sizeof(float4) + sizeof(int));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_select_kernel<KW, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  knn_select_kernel<KW, MODE><<<num_cells, kThreads, smem, stream>>>(
      tx, ty, tz, tids, sx, sy, sz, sids, g, cap, spill_cap, k, n, box,
      mi_start, lane_bits, out_ids, out_codes, out_kth);
  return cudaGetLastError();
}

template <int MODE>
int dispatch(const float* tx, const float* ty, const float* tz, const int* tids,
             const float* sx, const float* sy, const float* sz, const int* sids,
             int num_cells, int g, int cap, int spill_cap, int k, int n,
             float box, int mi_start, int* out, int* out_codes, float* out_kth,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 128 || num_cells < 1 || n < 1) return (int)cudaErrorInvalidValue;
  // Bits of a candidate lane (< 27 * cap + spill_cap) in the packed payload.
  const int ncand = 27 * cap + spill_cap;
  int lane_bits = 1;
  while ((1 << lane_bits) < ncand) ++lane_bits;
#define KNN_LAUNCH(KW, M)                                                      \
  return (int)launch<KW, M>(tx, ty, tz, tids, sx, sy, sz, sids, num_cells, g,  \
                            cap, spill_cap, k, n, box, mi_start, lane_bits,    \
                            out, out_codes, out_kth, s)
  if constexpr (MODE == kDual) {
    // Ids below n need 32 - lane_bits bits; else the lane rides as a value.
    if (lane_bits >= 32 || (long long)(n - 1) >= (1ll << (32 - lane_bits))) {
      if (k <= 32) KNN_LAUNCH(1, kDualWide);
      if (k <= 64) KNN_LAUNCH(2, kDualWide);
      KNN_LAUNCH(4, kDualWide);
    }
  }
  if (k <= 32) KNN_LAUNCH(1, MODE);
  if (k <= 64) KNN_LAUNCH(2, MODE);
  KNN_LAUNCH(4, MODE);
#undef KNN_LAUNCH
}

}  // namespace

// Plain C entry points (loaded with ctypes). Table planes are [num_cells, cap]
// row-major, spill planes [spill_cap]; out [num_cells * cap, k] int32 (ids,
// or candidate lanes for knn_codes_launch; knn_dual_launch writes ids to out
// and lanes to out_codes), out_kth [num_cells * cap] float32. `box` is the
// box size as float32 (the wrapper rounds it on the host). Launch on
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
