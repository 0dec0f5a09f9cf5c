// K4: the cell-block window matmul, forward.
//
// Replaces the JAX package's TPU kernel ops/cellblock.py::
// _window_kernel (forward body; pallas_call in _window_matmul). Per query
// tile t of QB slot rows:
//   out[t*QB + q, :] = sum_{j<9} sum_{w<W} S[t*QB + q, j*W + w]
//                                          * z_pad[start[t, j] + w, :]
// with S int8 multiplicity counts taken as bf16 (exact), z_pad bf16, and
// float32 accumulation; out float32.
//
// Bound on the H100: bytes. At the flagship spec (QB = W = 256, H = 128) it
// must read the 213 MB S table once and z_pad (30 MB, re-read per tile from
// the 50 MB L2) and write 47 MB: 87 us. The dense product it runs is 54.5
// GFLOP of bf16 (55 us at 989 TFLOP/s), but S holds only ~N*k nonzeros, so
// the work the data needs is 0.27 GFLOP. Design (a first, simple kernel):
// the TPU kernel's dense product, one block of 8 warps per (128-row half
// of a tile, 128-wide h block); each warp owns 16 rows x 128 columns in
// registers (16 m16n8 f32 accumulator tiles). The block walks the 9
// windows in 64-row chunks, staging the S chunk [128, 64] as int8 and the
// window chunk [64, 128] as bf16 in shared memory with 8- and 16-byte
// loads; products run on mma.sync m16n8k16 (bf16 -> f32), the int8 S pairs
// converted to bf16 A fragments in registers. Rows past the tile, window
// rows past W and columns past H are zero-filled, so any QB (multiple of
// 32), W (multiple of 8) and H (multiple of 8) work. wgmma, TMA and double
// buffering are later work.
//
// K4^T, the S^T mode (the TPU kernel's s_rev3=True, run by
// _aggregate_slots_bwd): the training backward of the same aggregation,
//   dz[t*QB + q, :] = sum_{j<9} sum_{w<W} S_rev[t, j*W + w, q] * g_pad[start[t, j] + w, :]
// with the reverse table S_rev [num_tiles, 9W, rev_lanes] int8 (the
// transpose selection matrices; rev_lanes = QB rounded up to 128, lanes past
// QB never set). Its A operand is S_rev's [W, rev_lanes] block read
// transposed, so only the staging of S differs: each 8-byte load of a window
// row's lanes is scattered into the [row q][window row w] stage the forward
// mode reads, and the products, windows and f32 sums are K4's. Rows q >= QB
// are computed from in-bounds lanes and dropped. Bound: as K4's, the 213 MB
// of S_rev plus the padded bf16 cotangent and the f32 output, 87 us.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BM = WARPS * 16;  // rows per block
constexpr int BN = 128;         // columns per block
constexpr int BK = 64;          // window rows per stage
constexpr int NT = BN / 8;      // n-tiles per warp
constexpr int LDS = BK + 16;    // int8 row stride of the S stage
constexpr int LDW = BN + 8;     // bf16 row stride of the window stage

__device__ __forceinline__ uint32_t pack_counts(uint16_t v) {
  // Two int8 counts (low byte first) -> two bf16 (low half first), exact.
  const float lo = (float)(int8_t)(v & 0xff);
  const float hi = (float)(int8_t)(v >> 8);
  __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&b);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// TRANS = false: s_table is S [num_tiles * qb, width], width = 9w.
// TRANS = true: s_table is S_rev [num_tiles, 9w, width], width = rev_lanes.
template <bool TRANS>
__global__ void __launch_bounds__(THREADS, 2) window_matmul_kernel(
    const int8_t* __restrict__ s_table, const __nv_bfloat16* __restrict__ z_pad,
    const int* __restrict__ starts, float* __restrict__ out, int qb, int w,
    int h, int num_pad, int width) {
  __shared__ __align__(16) int8_t s_stage[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 w_stage[BK * LDW];

  const int mblocks = (qb + BM - 1) / BM;
  const int tile = blockIdx.x / mblocks;
  const int row0 = tile * qb + (blockIdx.x % mblocks) * BM;
  const int row_end = min(row0 + BM, (tile + 1) * qb);
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const bool warp_live = row0 + warp * 16 < row_end;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  }

  for (int j = 0; j < 9; ++j) {
    const int start = starts[tile * 9 + j];
    for (int kk = 0; kk < w; kk += BK) {
      __syncthreads();
      if (!TRANS) {
        // S chunk: BM rows x BK int8, 8 bytes a load (W % 8 == 0, so a load
        // is wholly inside or outside the window).
        for (int i = threadIdx.x; i < BM * (BK / 8); i += THREADS) {
          const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
          uint2 v = make_uint2(0u, 0u);
          if (row0 + r < row_end && kk + c < w)
            v = *reinterpret_cast<const uint2*>(
                s_table + (size_t)(row0 + r) * width + j * w + kk + c);
          *reinterpret_cast<uint2*>(s_stage + r * LDS + c) = v;
        }
      } else {
        // S_rev chunk: BK window rows x BM lanes, 8 lanes a load, written
        // transposed to the stage (lane q = row0 - tile * qb + c + b).
        const int8_t* src = s_table + ((size_t)tile * 9 * w + j * w + kk) * width +
                            (row0 - tile * qb);
        for (int i = threadIdx.x; i < BK * (BM / 8); i += THREADS) {
          const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
          uint2 v = make_uint2(0u, 0u);
          if (kk + r < w) v = *reinterpret_cast<const uint2*>(src + (size_t)r * width + c);
          const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
          for (int e = 0; e < 8; ++e) s_stage[(c + e) * LDS + r] = b[e];
        }
      }
      // Window chunk: BK rows x BN bf16 columns, 16 bytes a load.
      for (int i = threadIdx.x; i < BK * (BN / 8); i += THREADS) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const int zr = start + kk + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (kk + r < w && zr < num_pad && n0 + c < h)
          v = *reinterpret_cast<const uint4*>(z_pad + (size_t)zr * h + n0 + c);
        *reinterpret_cast<uint4*>(w_stage + r * LDW + c) = v;
      }
      __syncthreads();
      if (!warp_live) continue;
      const uint16_t* w16 = reinterpret_cast<const uint16_t*>(w_stage);
#pragma unroll
      for (int k16 = 0; k16 < BK; k16 += 16) {
        const int8_t* sa = s_stage + (warp * 16 + gid) * LDS + k16 + 2 * tig;
        uint32_t a[4];
        a[0] = pack_counts(*reinterpret_cast<const uint16_t*>(sa));
        a[1] = pack_counts(*reinterpret_cast<const uint16_t*>(sa + 8 * LDS));
        a[2] = pack_counts(*reinterpret_cast<const uint16_t*>(sa + 8));
        a[3] = pack_counts(*reinterpret_cast<const uint16_t*>(sa + 8 * LDS + 8));
        const uint16_t* wb = w16 + (k16 + 2 * tig) * LDW + gid;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint16_t* p = wb + nt * 8;
          const uint32_t b0 = (uint32_t)p[0] | ((uint32_t)p[LDW] << 16);
          const uint32_t b1 = (uint32_t)p[8 * LDW] | ((uint32_t)p[9 * LDW] << 16);
          mma_bf16(acc[nt], a, b0, b1);
        }
      }
    }
  }

  const int r0 = row0 + warp * 16 + gid;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + nt * 8 + 2 * tig;
    if (col >= h) continue;
    if (r0 < row_end)
      *reinterpret_cast<float2*>(out + (size_t)r0 * h + col) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (r0 + 8 < row_end)
      *reinterpret_cast<float2*>(out + (size_t)(r0 + 8) * h + col) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). s_table [num_tiles * qb, width]
// int8 with width = 9 * w; z_pad [num_pad, h] bf16; starts [num_tiles, 9]
// int32 (start + w <= num_pad); out [num_tiles * qb, h] float32; all
// contiguous. qb % 32 == 0, w % 8 == 0, h % 8 == 0. Launches on `stream`,
// does not synchronize, returns the cudaError_t.
extern "C" int window_matmul_launch(const void* s_table, const void* z_pad,
                                    const int* starts, float* out, int num_tiles,
                                    int qb, int w, int h, int num_pad, int width,
                                    void* stream) {
  if (qb % 32 || w % 8 || h % 8 || width != 9 * w || qb <= 0 || w <= 0 || h <= 0)
    return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return (int)cudaSuccess;
  const int mblocks = (qb + BM - 1) / BM;
  const dim3 grid((unsigned)(num_tiles * mblocks), (unsigned)((h + BN - 1) / BN));
  window_matmul_kernel<false><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(s_table),
      static_cast<const __nv_bfloat16*>(z_pad), starts, out, qb, w, h, num_pad,
      width);
  return (int)cudaGetLastError();
}

// S^T mode. s_rev [num_tiles, 9 * w, rev_lanes] int8 with rev_lanes % 128 == 0
// and qb <= rev_lanes; g_pad [num_pad, h] bf16; starts and out as above.
extern "C" int window_matmul_t_launch(const void* s_rev, const void* g_pad,
                                      const int* starts, float* out, int num_tiles,
                                      int qb, int w, int h, int num_pad, int rev_lanes,
                                      void* stream) {
  if (qb % 32 || w % 8 || h % 8 || rev_lanes % BM || qb > rev_lanes || qb <= 0 || w <= 0 ||
      h <= 0)
    return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return (int)cudaSuccess;
  const int mblocks = (qb + BM - 1) / BM;
  const dim3 grid((unsigned)(num_tiles * mblocks), (unsigned)((h + BN - 1) / BN));
  window_matmul_kernel<true><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(s_rev),
      static_cast<const __nv_bfloat16*>(g_pad), starts, out, qb, w, h, num_pad,
      rev_lanes);
  return (int)cudaGetLastError();
}
