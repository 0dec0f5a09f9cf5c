// K3: int8 selection-matrix rows from per-row lane offsets.
//
// Replaces the JAX package's TPU kernel ops/cellblock.py::
// _s_from_offsets (pallas_call in the same function). Computes
//   S[row, lane] = #{p < k : offsets[row, p] == lane}   for lane in [0, width)
// as int8 (offsets outside [0, width) — the no-edge and dropped-edge
// sentinels — are ignored; k <= 127, so a count cannot overflow).
//
// Bound on the H100: bytes — the S table it writes (width bytes a row,
// 213 MB at the flagship spec) against 2k bytes of offsets read a row.
// Design: one warp per row. The warp zeroes a row buffer of width bytes in
// shared memory, adds each offset's count into its byte with a 32-bit
// shared-memory atomicAdd of 1 << (8 * (lane & 3)) (counts stay below 128,
// so no carry crosses a byte), then streams the finished row to device
// memory with 8-byte coalesced stores: S is written once, never
// read-modified-written. The TPU kernel instead compared every lane
// against every offset (k passes over a [rows, width] tile).
//
// With a `total` pointer (the plan build's training path) it also counts
// the offsets it accumulates, the sum of S, for the transpose certificate
// reverse_mismatch: a warp reduce and one atomicAdd a block into an int32
// the caller zeroed. A null pointer skips the count (rollouts).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void s_onehot_kernel(const int16_t* __restrict__ offsets,
                                uint8_t* __restrict__ out, int* __restrict__ total,
                                int rows, int k, int width) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int warp_sums[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int words = width >> 2;
  uint32_t* buf = smem + warp * words;
  int count = 0;
  for (long long row = (long long)blockIdx.x * warps + warp; row < rows;
       row += (long long)gridDim.x * warps) {
    for (int w = lane; w < words; w += 32) buf[w] = 0u;
    __syncwarp();
    const int16_t* o = offsets + row * k;
    for (int p = lane; p < k; p += 32) {
      const int v = o[p];
      if (v >= 0 && v < width) {
        atomicAdd(&buf[v >> 2], 1u << ((v & 3) * 8));
        ++count;
      }
    }
    __syncwarp();
    const uint2* src = reinterpret_cast<const uint2*>(buf);
    uint2* dst = reinterpret_cast<uint2*>(out + row * width);
    for (int w = lane; w < (width >> 3); w += 32) dst[w] = src[w];
    __syncwarp();
  }
  if (total == nullptr) return;
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int i = 0; i < warps; ++i) sum += warp_sums[i];
    if (sum) atomicAdd(total, sum);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). offsets [rows, k] int16, out
// [rows, width] int8, contiguous; width % 8 == 0 and k <= 127; total one
// int32 zeroed by the caller, or null. Launches on `stream`, does not
// synchronize, returns the cudaError_t.
extern "C" int s_onehot_launch(const void* offsets, void* out, int* total, int rows, int k,
                               int width, void* stream) {
  if (width % 8 || width <= 0 || k < 1 || k > 127)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  int warps = (96 * 1024) / width;
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const size_t smem = (size_t)warps * width;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        s_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  long long blocks = ((long long)rows + warps - 1) / warps;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  s_onehot_kernel<<<(unsigned)blocks, 32 * warps, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(offsets), static_cast<uint8_t*>(out), total, rows, k,
      width);
  return (int)cudaGetLastError();
}
