// K9: exact brute-force periodic k-NN, gated on the device.
//
// Replaces no TPU kernel. The JAX package computes brute force in XLA
// (ops/neighbors.py::knn_periodic) and, under exactness_guard="fallback",
// reruns it only where the cell-list search's certificate fails, with
// lax.cond inside its scan (rollout.py). In an eager PyTorch loop the branch
// would cost a host read of the flag every step, or the N^2 search every
// step under torch.where. This kernel takes the flag as a gate byte and
// reads it on the device first: when it is set (the certificate holds)
// every block returns at once and the output buffer keeps the cell-list
// search's ids; when it is clear the kernel overwrites every row.
//
// Computes what ops/neighbors.py::knn_periodic_reference computes: per
// query row, over all n reference points,
//   * per axis d = q - p, then d - box * rint(d / box) (a true division,
//     rint half-to-even), each operation rounded (__fsub_rn, __fdiv_rn,
//     __fmul_rn: nvcc never contracts them into FMAs);
//   * d2 = dx*dx, + dy*dy, + dz*dz in that order;
//   * the k smallest (d2, id) pairs, ascending: the smallest id wins exact
//     ties, as the plain version's stable sort. Every d2 and pick is then
//     bit-equal to the plain version's.
//
// Bound on the H100: operations. Each (query, reference) pair costs 21
// (per axis a subtraction, a division, a rint, a product and a
// subtraction, then three squares, two sums and a compare), 9.0e10 for
// 65,536 x 65,536; the bytes (12 per point in, 8 or 12 per pick out) are
// small. The division is a multi-instruction IEEE sequence, so the kernel
// runs well above that bound. Design, simple first:
//   * a persistent grid of as many blocks as the card holds at once; each
//     block walks over groups of kWarps query rows, one row a warp;
//   * the block stages the reference set through shared memory in tiles of
//     kTile points (x, y, z planes), shared by its warps;
//   * the warp's 32 lanes split each tile, 32 points a round; a round first
//     votes on d2 <= the row's k-th d2 and offers keys only where some lane
//     passes; WarpSelect (select_common.cuh) keeps the row's k smallest keys
//     bits(d2) << 32 | id, whose unsigned order is the (d2, id) order;
//   * KW = 1, 2, 4 warp-queue registers for k <= 32, 64, 128.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select_common.cuh"

namespace {

using select_common::kFull;
using select_common::key_d2;
using select_common::key_payload;
using select_common::WarpSelect;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 2048;
// Keys a lane's thread queue holds before the warp merges (one, as K1).
constexpr int kQueueDepth = 1;

__device__ __forceinline__ float min_image(float d, float box) {
  return __fsub_rn(d, __fmul_rn(box, rintf(__fdiv_rn(d, box))));
}

template <int KW>
__global__ void __launch_bounds__(kThreads) knn_brute_kernel(
    const float* __restrict__ ref, int n, const float* __restrict__ queries, int q,
    int k, float box, const unsigned char* __restrict__ gate,
    long long* __restrict__ out_ids, float* __restrict__ out_d2) {
  if (gate != nullptr && *gate != 0) return;  // the certificate holds
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = (q + kWarps - 1) / kWarps;
  for (int group = blockIdx.x; group < groups; group += gridDim.x) {
    const int row = group * kWarps + warp;
    const bool live = row < q;  // warp-uniform
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (live) {
      qx = queries[3 * (size_t)row];
      qy = queries[3 * (size_t)row + 1];
      qz = queries[3 * (size_t)row + 2];
    }
    WarpSelect<KW, kQueueDepth, false> sel;
    sel.init(k);
    for (int base = 0; base < n; base += kTile) {
      const int count = min(kTile, n - base);
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < count; i += kThreads) {
        const float* p = ref + 3 * (size_t)(base + i);
        sx[i] = p[0];
        sy[i] = p[1];
        sz[i] = p[2];
      }
      __syncthreads();
      if (!live) continue;
      for (int c0 = 0; c0 < count; c0 += 32) {
        const int c = c0 + lane;
        float d2 = 0.f;
        if (c < count) {
          const float dx = min_image(__fsub_rn(qx, sx[c]), box);
          const float dy = min_image(__fsub_rn(qy, sy[c]), box);
          const float dz = min_image(__fsub_rn(qz, sz[c]), box);
          d2 = __fmul_rn(dx, dx);
          d2 = __fadd_rn(d2, __fmul_rn(dy, dy));
          d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
        }
        // One vote a round: once the k-th settles, almost no round admits.
        if (__any_sync(kFull, c < count && sel.may_admit(d2))) {
          if (c < count) sel.add(d2, (uint32_t)(base + c), 0);
          sel.check();
        }
      }
    }
    if (!live) continue;
    sel.finish();
    // k <= n: the first k queue positions all hold real picks.
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int j = w * 32 + lane;
      if (j < k) {
        out_ids[(size_t)row * k + j] = (long long)key_payload(sel.wk[w]);
        if (out_d2 != nullptr) out_d2[(size_t)row * k + j] = key_d2(sel.wk[w]);
      }
    }
  }
}

template <int KW>
cudaError_t launch(const float* ref, int n, const float* queries, int q, int k, float box,
                   const unsigned char* gate, long long* out_ids, float* out_d2,
                   cudaStream_t stream) {
  // A persistent grid: as many blocks as are resident at once (a gated
  // launch is then one short wave), at most one per group of rows.
  // The count is asked once per device and instantiation.
  static int cached_device = -1, resident = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != cached_device) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, knn_brute_kernel<KW>,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    cached_device = device;
  }
  const long long groups = (q + kWarps - 1) / kWarps;
  const int grid = (int)(groups < resident ? groups : resident);
  knn_brute_kernel<KW><<<grid > 0 ? grid : 1, kThreads, 0, stream>>>(
      ref, n, queries, q, k, box, gate, out_ids, out_d2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). ref [n, 3] and queries [q, 3]
// float32 row-major; out_ids [q, k] int64, out_d2 [q, k] float32 or null;
// gate a byte on the device (a torch.bool 0-d tensor) or null for no gate.
// `box` is the box size as float32 (the wrapper rounds it on the host).
// Launch on `stream`, do not synchronize, return the launch's cudaError_t.
extern "C" int knn_brute_launch(const float* ref, int n, const float* queries, int q, int k,
                                float box, const unsigned char* gate, long long* out_ids,
                                float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 128 || k > n || q < 1) return (int)cudaErrorInvalidValue;
  if (k <= 32) return (int)launch<1>(ref, n, queries, q, k, box, gate, out_ids, out_d2, s);
  if (k <= 64) return (int)launch<2>(ref, n, queries, q, k, box, gate, out_ids, out_d2, s);
  return (int)launch<4>(ref, n, queries, q, k, box, gate, out_ids, out_d2, s);
}
