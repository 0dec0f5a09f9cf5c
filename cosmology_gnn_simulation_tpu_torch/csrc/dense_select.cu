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
//     [T * QB_s, k] (9 * w_eff for a pick past the candidates), and the k-th
//     d2 to out_kth [T * QB_s] (1e30 then).
// The arithmetic uses __fsub_rn/__fmul_rn/__fadd_rn, which nvcc never
// contracts into FMAs, so every d2 is bit-equal to the plain PyTorch version.
//
// Bound on the H100: the bytes are small (the table and the queries, a few
// MB, read once); the work is ~9 f32 operations per (query, candidate) pair,
// 164 M pairs at the flagship size (71,312 query rows x 2,304 lanes), plus
// the selection. Design: one block per tile. The block stages the tile's 9
// windows in shared memory once, with the periodic shift applied on load
// (27.6 kB at w_eff = 256). One warp per query row: each lane scans the
// candidates lane, lane + 32, ... and keeps a sorted top-KT list of (d2,
// lane) in registers (K1's list); since it scans its candidates in
// ascending lane order, a later equal d2 never passes an earlier one. The
// warp then merges its 32 lists in k rounds: a shuffle argmin by (d2, lane)
// over the lists' heads, and the lane whose head won pops it. The global
// top k lies in the union of the per-lane top k, so KT >= k suffices. KT is
// a template parameter instantiated at 8, 16, 32, 64 and 128.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;

__device__ __forceinline__ bool lex_less(float da, int la, float db, int lb) {
  return da < db || (da == db && la < lb);
}

template <int KT>
__global__ void dense_select_kernel(
    const float* __restrict__ table, const float* __restrict__ queries,
    const int* __restrict__ windows, int qb, int w_eff, int ccp, int k,
    float box, int* __restrict__ out_lanes, float* __restrict__ out_kth) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int ncand = 9 * w_eff;
  float* cx = smem;
  float* cy = cx + ncand;
  float* cz = cy + ncand;
  for (int idx = threadIdx.x; idx < ncand; idx += blockDim.x) {
    const int j = idx / w_eff;
    const int* w = windows + ((size_t)t * 9 + j) * 4;
    const float* col = table + (size_t)w[0] * 3 * ccp + w[1] + (idx - j * w_eff);
    cx[idx] = __fadd_rn(col[0], __fmul_rn((float)w[2], box));
    cy[idx] = __fadd_rn(col[ccp], __fmul_rn((float)w[3], box));
    cz[idx] = col[2 * ccp];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int r = warp; r < qb; r += warps) {
    const size_t row = (size_t)t * qb + r;
    const float qx = queries[row * 3], qy = queries[row * 3 + 1],
                qz = queries[row * 3 + 2];
    float bd[KT];
    int bl[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) { bd[j] = kBig; bl[j] = ncand; }
    for (int c = lane; c < ncand; c += 32) {
      const float dx = __fsub_rn(qx, cx[c]);
      const float dy = __fsub_rn(qy, cy[c]);
      const float dz = __fsub_rn(qz, cz[c]);
      float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
      if (lex_less(d2, c, bd[KT - 1], bl[KT - 1])) {
        bd[KT - 1] = d2;
        bl[KT - 1] = c;
#pragma unroll
        for (int j = KT - 1; j > 0; --j) {
          if (lex_less(bd[j], bl[j], bd[j - 1], bl[j - 1])) {
            const float td = bd[j]; bd[j] = bd[j - 1]; bd[j - 1] = td;
            const int tl = bl[j]; bl[j] = bl[j - 1]; bl[j - 1] = tl;
          }
        }
      }
    }
    // Merge the 32 lists: k rounds of a warp argmin over their heads.
    int* out = out_lanes + row * k;
    for (int p = 0; p < k; ++p) {
      float hd = bd[0];
      int hl = bl[0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(kFull, hd, off);
        const int ol = __shfl_xor_sync(kFull, hl, off);
        if (lex_less(od, ol, hd, hl)) { hd = od; hl = ol; }
      }
      if (bl[0] == hl) {  // this lane's head won (or all lists are spent)
#pragma unroll
        for (int j = 0; j < KT - 1; ++j) { bd[j] = bd[j + 1]; bl[j] = bl[j + 1]; }
        bd[KT - 1] = kBig;
        bl[KT - 1] = ncand;
      }
      if (lane == 0) {
        const bool picked = hd < 0.5f * kBig;
        out[p] = picked ? hl : ncand;
        if (p == k - 1) out_kth[row] = hd;
      }
    }
  }
}

template <int KT>
cudaError_t launch(const float* table, const float* queries, const int* windows,
                   int num_tiles, int qb, int w_eff, int ccp, int k, float box,
                   int* out_lanes, float* out_kth, cudaStream_t stream) {
  const size_t smem = (size_t)9 * w_eff * 3 * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_select_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int warps = qb < kMaxWarps ? qb : kMaxWarps;
  dense_select_kernel<KT><<<num_tiles, 32 * warps, smem, stream>>>(
      table, queries, windows, qb, w_eff, ccp, k, box, out_lanes, out_kth);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). table [C, 3, ccp] float32,
// queries [num_tiles * qb, 3] float32, windows [num_tiles, 9, 4] int32
// (column, first row, x shift, y shift); out_lanes [num_tiles * qb, k]
// int32, out_kth [num_tiles * qb] float32. Launch on `stream`, do not
// synchronize, return the launch's cudaError_t.
extern "C" int dense_select_launch(const float* table, const float* queries,
                                   const int* windows, int num_tiles, int qb,
                                   int w_eff, int ccp, int k, float box,
                                   int* out_lanes, float* out_kth,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 128 || k > 9 * w_eff || qb < 1 || num_tiles < 1)
    return (int)cudaErrorInvalidValue;
  if (k <= 8)
    return (int)launch<8>(table, queries, windows, num_tiles, qb, w_eff, ccp,
                          k, box, out_lanes, out_kth, s);
  if (k <= 16)
    return (int)launch<16>(table, queries, windows, num_tiles, qb, w_eff, ccp,
                           k, box, out_lanes, out_kth, s);
  if (k <= 32)
    return (int)launch<32>(table, queries, windows, num_tiles, qb, w_eff, ccp,
                           k, box, out_lanes, out_kth, s);
  if (k <= 64)
    return (int)launch<64>(table, queries, windows, num_tiles, qb, w_eff, ccp,
                           k, box, out_lanes, out_kth, s);
  return (int)launch<128>(table, queries, windows, num_tiles, qb, w_eff, ccp, k,
                          box, out_lanes, out_kth, s);
}
