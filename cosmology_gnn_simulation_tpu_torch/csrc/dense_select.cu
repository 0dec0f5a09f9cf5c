// K8: the dense-query k-selection over 9 column windows.
//
// Replaces the JAX package's TPU kernel ops/cellblock.py::
// _dense_select_kernel (pallas_call in _dense_search_offsets). Computes what
// it computes, per search tile t of QB_s query rows (queries [T * QB_s, 3]):
//   * candidates: for each ring column j (0..8), the w_eff rows of the padded
//     coordinate table [C, 3, ccp] at column windows[t, j, 0] from row
//     windows[t, j, 1], lane j * w_eff + row; x and y shifted by
//     windows[t, j, 2] * box and windows[t, j, 3] * box (one exact product,
//     one f32 add), z as stored (the z-wrap copies are pre-shifted);
//   * d2 = ((dx^2 + dy^2) + dz^2) of the plain differences q - c;
//   * the k smallest (d2, lane) pairs in ascending order (the smallest lane
//     wins exact ties: the TPU kernel's masked re-min), lanes to out_lanes
//     [T * QB_s, k], and the k-th d2 to out_kth [T * QB_s].
// Only each tile's live rows are searched (rows[t], the plan's ds.rows):
// its rows from rows[t] on are padding and get the no-pick lane 9 * w_eff
// and kth 1e30.
// The arithmetic uses __fsub_rn/__fmul_rn/__fadd_rn, which nvcc never
// contracts into FMAs, so every d2 is bit-equal to the plain PyTorch version.
//
// Bound on the H100: the bytes are small (the table and the queries, a few
// MB, read once); the work is ~9 f32 operations per (query, candidate) pair,
// 151 M pairs for the 65,536 live rows at the flagship size (2,304 lanes a
// row), plus the selection; what costs is instructions issued per pair.
// Design: one block per tile. The block stages the tile's 9 windows in
// shared memory once, with the periodic shift applied on load (27.6 kB at
// w_eff = 256). Each warp searches R = 2 query rows together, so one
// shared-memory read of a candidate serves both; its 32 lanes split the
// candidates, 32 a round, and WarpSelect (select_common.cuh) keeps each
// row's top k in a warp queue. A round computes both rows' d2 and votes
// once on d2 <= the k-th's d2: only a round where some lane passes offers
// keys and merges, so a settled round costs the d2 arithmetic, a compare
// and one vote. The key packs (d2, lane) in 64 bits, so one compare is the
// (d2, lane) order, and the scan order is free: the warp starts at its
// rows' own position in their own column (ring column 4; the block finds
// the tile's first query there by its coordinates), so its first round
// holds its nearest neighbours in z and the k-th falls fast. The warp
// queue holds 32 * KW keys, KW = 1, 2, 4 for k <= 32, 64, 128, instead of
// a k-deep sorted list in each lane's registers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select_common.cuh"


namespace {

using select_common::kBig;
using select_common::kFull;
using select_common::key_d2;
using select_common::key_payload;
using select_common::WarpSelect;

// Query rows a warp searches together, and keys a lane's thread queue
// holds before the warp merges (one: a merge inserts few keys once the
// k-th has settled, and a deeper queue admits more against a staler k-th).
constexpr int kRowsPerWarp = 2;
constexpr int kQueueDepth = 1;
constexpr int kMaxWarps = 8;

template <int KW>
__global__ void __launch_bounds__(32 * kMaxWarps) dense_select_kernel(
    const float* __restrict__ table, const float* __restrict__ queries,
    const int* __restrict__ windows, const int* __restrict__ rows, int qb,
    int w_eff, int ccp, int k, float box, int* __restrict__ out_lanes,
    float* __restrict__ out_kth) {
  constexpr int R = kRowsPerWarp;
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int ncand = 9 * w_eff;
  const int live = min(max(rows[t], 0), qb);
  const size_t row0 = (size_t)t * qb;
  __shared__ int first_row;  // the tile's first query in its own column's window
  if (threadIdx.x == 0) first_row = w_eff;
  // Padding rows: the no-pick lane and kth 1e30.
  for (int i = threadIdx.x; i < (qb - live) * k; i += blockDim.x)
    out_lanes[(row0 + live) * k + i] = ncand;
  for (int r = live + threadIdx.x; r < qb; r += blockDim.x) out_kth[row0 + r] = kBig;
  if (live == 0) return;

  // The windows' first rows and shifts first, so that the copy loop's
  // loads do not wait on one another.
  __shared__ long long win_at[9];
  __shared__ float win_sx[9], win_sy[9];
  if (threadIdx.x < 9) {
    const int* w = windows + ((size_t)t * 9 + threadIdx.x) * 4;
    win_at[threadIdx.x] = (long long)w[0] * 3 * ccp + w[1];
    win_sx[threadIdx.x] = __fmul_rn((float)w[2], box);
    win_sy[threadIdx.x] = __fmul_rn((float)w[3], box);
  }
  __syncthreads();
  float* cx = smem;
  float* cy = cx + ncand;
  float* cz = cy + ncand;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ncand; idx += blockDim.x) {
    const int j = idx / w_eff;
    const float* col = table + win_at[j] + (idx - j * w_eff);
    cx[idx] = __fadd_rn(col[0], win_sx[j]);
    cy[idx] = __fadd_rn(col[ccp], win_sy[j]);
    cz[idx] = col[2 * ccp];
  }
  __syncthreads();
  // Find the tile's first query among its own column's candidates (ring
  // column 4, unshifted): a warp's scan starts at its rows' neighbours in
  // z, so its first round sets a tight k-th. Any start gives the same
  // result; a query not found (a truncated window) starts at row 0.
  {
    const float fx = queries[row0 * 3], fy = queries[row0 * 3 + 1], fz = queries[row0 * 3 + 2];
    for (int i = threadIdx.x; i < w_eff; i += blockDim.x) {
      const int c = 4 * w_eff + i;
      if (cx[c] == fx && cy[c] == fy && cz[c] == fz) atomicMin(&first_row, i);
    }
  }
  __syncthreads();
  const int q0 = first_row < w_eff ? first_row : 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int r0 = warp * R; r0 < live; r0 += warps * R) {
    // The round of 32 candidates around the warp's rows comes first. Rows
    // past the live ones search row r0's query and are not written.
    const int first = 4 * w_eff + max(0, min(q0 + r0 - 15, w_eff - 32));
    float qx[R], qy[R], qz[R];
    WarpSelect<KW, kQueueDepth, false> sel[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const size_t row = row0 + (r0 + i < live ? r0 + i : r0);
      qx[i] = queries[row * 3];
      qy[i] = queries[row * 3 + 1];
      qz[i] = queries[row * 3 + 2];
      sel[i].init(k);
    }
    for (int base = 0; base < ncand; base += 32) {
      const bool in = base + lane < ncand;
      int c = first + base + lane;
      if (c >= ncand) c -= ncand;
      if (!in) c = 0;
      const float x = cx[c], y = cy[c], z = cz[c];
      float d2[R];
      bool near_any = false;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float dx = __fsub_rn(qx[i], x);
        const float dy = __fsub_rn(qy[i], y);
        const float dz = __fsub_rn(qz[i], z);
        d2[i] = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        d2[i] = __fadd_rn(d2[i], __fmul_rn(dz, dz));
        near_any |= in && sel[i].may_admit(d2[i]);
      }
      // One vote a round: almost every round admits nothing.
      if (__any_sync(kFull, near_any)) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (in) sel[i].add(d2[i], (uint32_t)c, 0);
          sel[i].check();
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      sel[i].finish();
      if (r0 + i >= live) continue;
      int* out = out_lanes + (row0 + r0 + i) * k;
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        const int q = w * 32 + lane;
        if (q < k) out[q] = (int)key_payload(sel[i].wk[w]);
      }
      const float kth = key_d2(sel[i].kth_key());
      if (lane == 0) out_kth[row0 + r0 + i] = kth;
    }
  }
}

template <int KW>
cudaError_t launch(const float* table, const float* queries, const int* windows,
                   const int* rows, int num_tiles, int qb, int w_eff, int ccp,
                   int k, float box, int* out_lanes, float* out_kth,
                   cudaStream_t stream) {
  const size_t smem = (size_t)9 * w_eff * 3 * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_select_kernel<KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int groups = (qb + kRowsPerWarp - 1) / kRowsPerWarp;
  const int warps = groups < kMaxWarps ? groups : kMaxWarps;
  dense_select_kernel<KW><<<num_tiles, 32 * warps, smem, stream>>>(
      table, queries, windows, rows, qb, w_eff, ccp, k, box, out_lanes, out_kth);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). table [C, 3, ccp] float32,
// queries [num_tiles * qb, 3] float32, windows [num_tiles, 9, 4] int32
// (column, first row, x shift, y shift), rows [num_tiles] int32 (live rows
// of each tile); out_lanes [num_tiles * qb, k]
// int32, out_kth [num_tiles * qb] float32. Launch on `stream`, do not
// synchronize, return the launch's cudaError_t.
extern "C" int dense_select_launch(const float* table, const float* queries,
                                   const int* windows, const int* rows,
                                   int num_tiles, int qb, int w_eff, int ccp,
                                   int k, float box, int* out_lanes,
                                   float* out_kth, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 128 || k > 9 * w_eff || qb < 1 || num_tiles < 1)
    return (int)cudaErrorInvalidValue;
  if (k <= 32)
    return (int)launch<1>(table, queries, windows, rows, num_tiles, qb, w_eff,
                          ccp, k, box, out_lanes, out_kth, s);
  if (k <= 64)
    return (int)launch<2>(table, queries, windows, rows, num_tiles, qb, w_eff,
                          ccp, k, box, out_lanes, out_kth, s);
  return (int)launch<4>(table, queries, windows, rows, num_tiles, qb, w_eff,
                        ccp, k, box, out_lanes, out_kth, s);
}
