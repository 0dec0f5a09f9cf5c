// K7: the cell-block plan's reverse selection table.
//
// Replaces the JAX package's TPU kernel ops/cellblock.py::
// _reverse_table_kernel (pallas_call in the same function). For sender tile
// t, ring column j and window row p (padded-image row start[t, j] + p, a
// candidate RECEIVER image):
//   S_rev[t, j*W + p, q] = #{kk < k : packed[row, kk] == t*QB + q}
// if the row speaks for its particle, else 0. packed [num_pad, k + 1] int32
// holds, per padded row, the k sender slots (pack ids) of its particle's
// neighbor list and, last, the padded row of the particle's main image; a
// row speaks for its particle iff it IS the main image or the main image
// lies outside this window (a particle counts once per window, through its
// main image when the window holds it, else through its one wrap image).
// Lanes q in [QB, rev_lanes) are never set. int8 counts: k <= 127.
//
// Bound on the H100: bytes — the table it writes (rev_lanes bytes a row,
// 213 MB at the flagship spec) against k + 1 ints read a row. Design: K3's.
// One warp per output row counts the row's senders into a shared-memory row
// of rev_lanes bytes with byte-lane atomicAdds of 1 << (8 * (q & 3)) (counts
// stay below 128, so no carry crosses a byte) and streams the finished row
// out with 8-byte stores: S_rev is written once, never read back. The TPU
// kernel instead compared every lane against every sender, k passes over a
// [W, QB] tile per window.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void reverse_table_kernel(const int* __restrict__ packed,
                                     const int* __restrict__ starts,
                                     uint8_t* __restrict__ out, long long rows, int qb,
                                     int w, int k, int rev_lanes) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int words = rev_lanes >> 2;
  uint32_t* buf = smem + warp * words;
  const int win_rows = 9 * w;
  for (long long row = (long long)blockIdx.x * warps + warp; row < rows;
       row += (long long)gridDim.x * warps) {
    const int t = (int)(row / win_rows);
    const int rem = (int)(row - (long long)t * win_rows);
    const int j = rem / w, p = rem - j * w;
    const int start = starts[t * 9 + j];
    const int* pr = packed + (size_t)(start + p) * (k + 1);
    const int main_row = pr[k];
    const bool in_win = main_row >= start && main_row < start + w;
    const bool canonical = main_row == start + p || !in_win;
    for (int i = lane; i < words; i += 32) buf[i] = 0u;
    __syncwarp();
    if (canonical) {
      const int base = t * qb;
      for (int kk = lane; kk < k; kk += 32) {
        const int q = pr[kk] - base;
        if (q >= 0 && q < qb) atomicAdd(&buf[q >> 2], 1u << ((q & 3) * 8));
      }
    }
    __syncwarp();
    const uint2* src = reinterpret_cast<const uint2*>(buf);
    uint2* dst = reinterpret_cast<uint2*>(out + row * rev_lanes);
    for (int i = lane; i < (rev_lanes >> 3); i += 32) dst[i] = src[i];
    __syncwarp();
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). packed [num_pad, k + 1] int32;
// starts [num_tiles, 9] int32 (start + w <= num_pad); out [num_tiles, 9 * w,
// rev_lanes] int8; all contiguous. rev_lanes % 8 == 0, qb <= rev_lanes,
// 1 <= k <= 127. Launches on `stream`, does not synchronize, returns the
// cudaError_t.
extern "C" int reverse_table_launch(const int* packed, const int* starts, void* out,
                                    int num_tiles, int qb, int w, int k, int rev_lanes,
                                    void* stream) {
  if (rev_lanes % 8 || qb > rev_lanes || qb <= 0 || w <= 0 || k < 1 || k > 127)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)num_tiles * 9 * w;
  if (rows == 0) return (int)cudaSuccess;
  int warps = (48 * 1024) / rev_lanes;
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const size_t smem = (size_t)warps * rev_lanes;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        reverse_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  long long blocks = (rows + warps - 1) / warps;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  reverse_table_kernel<<<(unsigned)blocks, 32 * warps, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      packed, starts, static_cast<uint8_t*>(out), rows, qb, w, k, rev_lanes);
  return (int)cudaGetLastError();
}
