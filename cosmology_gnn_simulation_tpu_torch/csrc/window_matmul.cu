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
// K4^T, the S^T mode (the TPU kernel's s_rev3=True, run by
// _aggregate_slots_bwd): the training backward of the same aggregation,
//   dz[t*QB + q, :] = sum_{j<9} sum_{w<W} S_rev[t, j*W + w, q] * g_pad[start[t, j] + w, :]
// with the reverse table S_rev [num_tiles, 9W, rev_lanes] int8 (the
// transpose selection matrices; rev_lanes = QB rounded up to 128, lanes past
// QB never set).
//
// Bound on the H100: bytes. At the flagship spec (QB = W = 256, H = 128)
// either mode must read its 213 MB selection table once, z_pad (30 MB; its
// windows re-read from the 50 MB L2) and write 47 MB of f32: 87 us at
// 3.35 TB/s. The dense product is 54.5 GFLOP of bf16, 55 us at the
// tensor cores' 989 TFLOP/s. At config 4 (QB 224, W 384, H 256: a 2.10 GB
// S, a 2.40 GB S_rev) the bytes bound is 0.92 / 1.01 ms and the dense
// product 1.07 TFLOP, 1.08 ms: above the bytes. S holds ~N*k nonzeros
// (99.5 % zeros), so the work this data needs is bytes, not products.
//
// Two kernels, picked by shape alone (cellblock.py's window_kernel):
// - persistent (every shape TMA can describe: W % 16 == 0 and H >= 64): a
//   work item is a 128-row slice of one query tile (K4: S rows; K4^T: a
//   128-lane box of S_rev) across up to 256 latent columns, so S or S_rev
//   leaves HBM once and is widened once whatever H is; only the windows
//   are read by both slices of a tile, from L2.
// - tiled (W % 16 != 0 or H < 64): a block a whole query tile (up to 256
//   rows) x a 128-column latent block, its stages filled by cp.async.
// The order of summation of both is fixed (window, chunk, k16 step), there
// are no atomics, and two launches on the same inputs are bit-equal.
//
// The persistent kernel. One block an SM of three warpgroups (384 threads,
// so ptxas caps a thread at 168 registers; the consumers use ~156) walks
// its items in (tile, slice, column block) order, so the two slices of a
// tile run at about the same time and the second reads the windows from
// L2; the chunks (64 window rows) of its items form one sequence, so an
// item's epilogue overlaps the next item's first loads. No barrier spans
// the block: the warpgroups meet on mbarriers.
// - The widening warpgroup: thread 256 keeps SS S chunks ([128 rows][64 B],
//   or S_rev [64 rows][128 lanes]; 3-D maps, so rows past QB read as 0 and
//   never the next tile's) in flight by TMA. Each warp scans its 32 rows
//   of a landed chunk for a count; thread 288 loads the chunk's window
//   ([BN / 64][64 rows][64 bf16], one copy of a 3-D map of z_pad where H %
//   64 == 0) only if some warp found one, so the window of a chunk that
//   holds no neighbor of the slice never leaves L2 (57 % of them at
//   config 4). Then every thread widens its 64 bytes into a ring of NA
//   count buffers (exact int8 -> bf16, one byte permutation and one
//   subtraction a pair when no count is negative; a warp with no count
//   writes zeros only where the buffer may hold its earlier ones).
// - Two consumer warpgroups, one 64-row group x BN columns each (wgmma
//   m64nBNk16, bf16 -> f32, A the counts and B the window read by
//   descriptors, BN / 2 f32 accumulators a thread): a warpgroup none of
//   whose rows holds a count of a chunk issues no products for it.
// - Epilogue: the accumulators leave through a [64 rows][32 f32] box a
//   warpgroup in shared memory by 3-D TMA stores (rows past QB clipped).
// What holds it back (PERF.md): the widening warpgroup sets the pace, one
// warp a scheduler, with the issue of each tensor copy on its path.
//
// The tiled kernel (PR 8). One block of two warpgroups per (whole query
// tile, 128-wide latent block). The block walks the 9 windows in 64-row
// chunks through a ring of STAGES shared-memory stages (S or S_rev chunk,
// window chunk):
// - Every thread fills a stage by cp.async (completion on an mbarrier), in
//   the 64- or 128-byte swizzled layouts a tensor copy would write.
// - Every thread widens its row's (K4) or its lanes' (K4^T) counts of the
//   chunk to bf16 in a count buffer, exactly (with m the low 7 bits and s
//   the sign bit of a byte, bf16 0x43|m - 0x43|s), in the 128-byte swizzled
//   layouts wgmma reads: K4 K-major [row][k], K4^T M-major [k][lane] in
//   64-lane groups, so S_rev needs no transpose. A warp whose 32 rows hold
//   no nonzero count skips the conversion.
// - Products: wgmma m64n128k16 (bf16 -> f32) with A (the counts) and B
//   (the window stage, N-major) read from shared memory by descriptors;
//   each warpgroup owns two 64-row groups, 128 f32 accumulators a thread.
// - Software-pipelined: the phase that issues chunk c's products widens
//   chunk c + 1 (two count buffers) while they run, then waits for them;
//   one barrier a phase.
// Rows past the tile, window rows past W and columns past H are zero-filled
// or not stored, so any QB (multiple of 32), W (multiple of 8) and H
// (multiple of 8) work.
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int WARPS = 8;        // two warpgroups
constexpr int THREADS = WARPS * 32;
constexpr int BM = 256;         // query rows per block: four 64-row groups
constexpr int BN = 128;         // latent columns per block: one wgmma's N
constexpr int BK = 64;          // window rows per stage: four k16 steps
constexpr int STAGES = 4;
constexpr int HALF = 128;       // bytes per swizzled row of a 2-D copy's box
constexpr int S_STAGE_BYTES = BM * BK;        // K4: [BM][BK]; K4^T: [2][BK][128]
constexpr int W_STAGE_BYTES = 2 * BK * HALF;  // [2][BK][64 bf16]
constexpr int STAGE_BYTES = S_STAGE_BYTES + W_STAGE_BYTES;
constexpr int A_BYTES = 2 * BM * BK;          // a chunk's counts as bf16 (two buffers)
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * A_BYTES + 1024;  // + 1 KB alignment
static_assert(THREADS == BM && BM == 32 * WARPS && 2 * BK * HALF == S_STAGE_BYTES,
              "one row per thread and 32 rows or lanes per warp; two 128-lane S_rev boxes");
static_assert(BK == 64, "the S stage's 64-byte swizzle; four k16 steps a chunk");
static_assert(SMEM_BYTES <= 227 * 1024, "shared memory");

// The TMA swizzles, as 16-byte chunk indices: a [rows][128 B] box XORs its
// chunk with row % 8; a [rows][64 B] box with (row / 2) % 4. The bf16 count
// buffers use the first for their 128-byte rows too (wgmma's layouts).
__device__ __forceinline__ int swz128(int row, int chunk) { return chunk ^ (row & 7); }
__device__ __forceinline__ int s_swz(int row, int chunk) { return chunk ^ ((row >> 1) & 3); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 8 : 0));
}
// Arrive on the mbarrier once this thread's earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Barrier `id` (1..15) among the 128 threads of a warpgroup.
__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
  __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
  __nv_bfloat162 d = __hsub2(x, y);
  return *reinterpret_cast<uint32_t*>(&d);
}

// Four int8 counts (byte 0 first) -> two bf16 pairs, exact: lo holds bytes
// 0, 1 and hi bytes 2, 3 (low half first). With m the low 7 bits and s the
// sign bit of a byte, the bf16 0x43|m is 128 + m and 0x43|s is 128 or 256,
// so their difference is the signed count.
__device__ __forceinline__ void counts_to_bf16(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t m = v & 0x7f7f7f7fu, s = v & 0x80808080u, c = 0x43434343u;
  lo = bf16x2_sub(__byte_perm(m, c, 0x4140), __byte_perm(s, c, 0x4140));
  hi = bf16x2_sub(__byte_perm(m, c, 0x4342), __byte_perm(s, c, 0x4342));
}

// 16 counts -> 16 bf16 at two 16-byte chunks of shared memory.
__device__ __forceinline__ void store_counts(unsigned char* lo_chunk, unsigned char* hi_chunk,
                                             uint4 v) {
  uint4 a, b;
  counts_to_bf16(v.x, a.x, a.y);
  counts_to_bf16(v.y, a.z, a.w);
  counts_to_bf16(v.z, b.x, b.y);
  counts_to_bf16(v.w, b.z, b.w);
  *reinterpret_cast<uint4*>(lo_chunk) = a;
  *reinterpret_cast<uint4*>(hi_chunk) = b;
}

// The same for counts known to be nonnegative (no sign bit set): bf16
// 0x43|b is 128 + b, so one byte permutation and one subtraction a pair.
__device__ __forceinline__ void store_counts_nonneg(unsigned char* lo_chunk,
                                                    unsigned char* hi_chunk, uint4 v) {
  const uint32_t c = 0x43434343u, k = 0x43004300u;  // k: bf16 (128, 128)
  uint4 a, b;
  a.x = bf16x2_sub(__byte_perm(v.x, c, 0x4140), k);
  a.y = bf16x2_sub(__byte_perm(v.x, c, 0x4342), k);
  a.z = bf16x2_sub(__byte_perm(v.y, c, 0x4140), k);
  a.w = bf16x2_sub(__byte_perm(v.y, c, 0x4342), k);
  b.x = bf16x2_sub(__byte_perm(v.z, c, 0x4140), k);
  b.y = bf16x2_sub(__byte_perm(v.z, c, 0x4342), k);
  b.z = bf16x2_sub(__byte_perm(v.w, c, 0x4140), k);
  b.w = bf16x2_sub(__byte_perm(v.w, c, 0x4342), k);
  *reinterpret_cast<uint4*>(lo_chunk) = a;
  *reinterpret_cast<uint4*>(hi_chunk) = b;
}

// A shared-memory matrix descriptor of wgmma (128-byte swizzle): start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// d (64 rows x 128 columns of f32, per warpgroup) += A (64 x 16 bf16, K-major
// or, with TRANS_A, M-major) x B (16 x 128 bf16, N-major).
template <int TRANS_A>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %66, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "n"(TRANS_A), "r"(1));
}

// d (64 rows x 256 columns of f32, per warpgroup) += A (64 x 16 bf16) x B
// (16 x 256 bf16, N-major), as wgmma_m64n128k16.
template <int TRANS_A>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %131, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %130, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "n"(TRANS_A), "r"(1));
}

// TRANS = false: s_table is S [num_tiles * qb, width], width = 9w.
// TRANS = true: s_table is S_rev [num_tiles, 9w, width], width = rev_lanes.
// The stages are filled by cp.async (16-byte, or 8-byte where w % 16 != 0).
template <bool TRANS>
__global__ void __launch_bounds__(THREADS, 1) window_matmul_kernel(
    const int8_t* __restrict__ s_table, const __nv_bfloat16* __restrict__ z_pad,
    const int* __restrict__ starts, float* __restrict__ out, int qb, int w, int h,
    int num_pad, int width) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];  // full[s]: stage s holds its chunk

  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t smem0 = (raw0 + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (smem0 - raw0);
  const uint32_t full0 = smem_addr(full);

  const int mblocks = (qb + BM - 1) / BM;
  const int tile = blockIdx.x / mblocks;
  const int q0 = (blockIdx.x % mblocks) * BM;  // first query row of the block in its tile
  const int rows = min(BM, qb - q0);           // a multiple of 32
  const int n0 = blockIdx.y * BN;
  const int cols = min(BN, h - n0);            // a multiple of 8
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kchunks = (w + BK - 1) / BK;
  const int nchunks = 9 * kchunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full0 + 8 * s, THREADS);
    mbar_init_fence();
  }
  __syncthreads();

  // Fill stage c % STAGES with chunk c: every thread's cp.async.
  auto load_chunk = [&](int c) {
    const int stage = c % STAGES;
    const int j = c / kchunks, kk = (c - j * kchunks) * BK;
    const int start = __ldg(starts + tile * 9 + j);
    const uint32_t s_dst = smem0 + stage * STAGE_BYTES;
    const uint32_t w_dst = s_dst + S_STAGE_BYTES;
    const uint32_t bar = full0 + 8 * stage;
    if (!TRANS) {
      // S chunk: rows x BK counts, zero past the window.
      const int8_t* src = s_table + (size_t)(tile * qb + q0) * width + j * w + kk;
      const int step = w % 16 ? 8 : 16;
      for (int i = threadIdx.x; i < rows * (BK / step); i += THREADS) {
        const int r = i / (BK / step), b = (i % (BK / step)) * step;
        const bool live = kk + b < w;
        const uint32_t dst = s_dst + r * BK + (s_swz(r, b >> 4) << 4) + (b & 15);
        const int8_t* p = live ? src + (size_t)r * width + b : s_table;
        if (step == 16) cp_async16(dst, p, live);
        else cp_async8(dst, p, live);
      }
    } else {
      // S_rev chunk as it lies: BK window rows x rows lanes.
      const int8_t* src = s_table + ((size_t)(tile * 9 + j) * w + kk) * width + q0;
      const int per_row = rows / 16;
      for (int i = threadIdx.x; i < BK * per_row; i += THREADS) {
        const int p = i / per_row, c16 = i - p * per_row;
        const bool live = kk + p < w;
        cp_async16(s_dst + (c16 >> 3) * BK * HALF + p * HALF + (swz128(p, c16 & 7) << 4),
                   live ? src + (size_t)p * width + c16 * 16 : s_table, live);
      }
    }
    // Window chunk: BK rows x BN bf16 columns, in two 64-column halves.
    const __nv_bfloat16* wsrc = z_pad + (size_t)(start + kk) * h + n0;
    for (int i = threadIdx.x; i < BK * (BN / 8); i += THREADS) {
      const int p = i / (BN / 8), c16 = i % (BN / 8);
      const bool live = kk + p < w && start + kk + p < num_pad && c16 * 8 < cols;
      cp_async16(w_dst + (c16 >> 3) * BK * HALF + p * HALF + (swz128(p, c16 & 7) << 4),
                 live ? wsrc + (size_t)p * h + c16 * 8 : z_pad, live);
    }
    cp_async_arrive(bar);
  };

  // Warpgroup wg (warps 4 wg .. 4 wg + 3) owns the 64-row groups wg and
  // wg + 2 x all 128 columns: two m64n128 f32 accumulators.
  const int wg = warp >> 2;
  float acc[2][64];
#pragma unroll
  for (int gi = 0; gi < 2; ++gi)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[gi][e] = 0.f;

  for (int c = 0; c < STAGES - 1 && c < nchunks; ++c) load_chunk(c);

  // Widen chunk c's counts to bf16 in count buffer c % 2, window rows past
  // W as 0 (a TMA box reads on into the next window). Each warp widens 32
  // rows (K4) or lanes (K4^T); where they hold no nonzero count it only
  // zeroes them, and only if the buffer may hold nonzeros from an earlier
  // chunk (bit b of dirty for buffer b).
  uint32_t dirty = 3u;
  auto scan = [&](int c) {
    const unsigned char* s_stage = smem + (c % STAGES) * STAGE_BYTES;
    unsigned char* a_buf = smem + STAGES * STAGE_BYTES + (c & 1) * A_BYTES;
    const int kk = (c % kchunks) * BK;
    uint4 v[4];
    if (!TRANS) {
      // Thread r: query row r, the four k16 steps.
      const int r = threadIdx.x;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        v[ks] = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows && kk + ks * 16 < w)
          v[ks] = *reinterpret_cast<const uint4*>(s_stage + r * BK + (s_swz(r, ks) << 4));
      }
    } else {
      // The warp's 32 lanes (16-lane chunks c16, c16 + 1 of half hb) in
      // window rows 2 (lane / 2) + {0, 1, 32, 33}.
      const int hb = warp / 4, c16 = 2 * (warp % 4) + (lane & 1);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int p = 2 * (lane >> 1) + (m & 1) + 32 * (m >> 1);
        v[m] = make_uint4(0u, 0u, 0u, 0u);
        if (warp * 32 < rows && kk + p < w)
          v[m] = *reinterpret_cast<const uint4*>(s_stage + hb * BK * HALF + p * HALF +
                                                 (swz128(p, c16) << 4));
      }
    }
    uint32_t any = 0u;
#pragma unroll
    for (int m = 0; m < 4; ++m) any |= v[m].x | v[m].y | v[m].z | v[m].w;
    const uint32_t buf = 1u << (c & 1);
    if (__any_sync(0xffffffffu, any != 0u)) {
      dirty |= buf;
    } else if (dirty & buf) {
      dirty &= ~buf;  // write the zeros below once
    } else {
      return;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (!TRANS) {
        const int r = threadIdx.x;
        unsigned char* row = a_buf + r * 2 * BK;
        store_counts(row + (swz128(r, 2 * m) << 4), row + (swz128(r, 2 * m + 1) << 4), v[m]);
      } else {
        // [4 groups of 64 lanes][BK][128 B]: the warp's 32 lanes are half
        // of group warp / 2.
        const int lc = 4 * (warp & 1) + 2 * (lane & 1);
        const int p = 2 * (lane >> 1) + (m & 1) + 32 * (m >> 1);
        unsigned char* row = a_buf + (warp >> 1) * BK * HALF + p * HALF;
        store_counts(row + (swz128(p, lc) << 4), row + (swz128(p, lc + 1) << 4), v[m]);
      }
    }
  };

  // Software-pipelined over chunks: phase c issues chunk c's products,
  // widens chunk c + 1 while they run, and waits for them; one barrier a
  // phase.
  mbar_wait(full0, 0);
  scan(0);
  fence_async_smem();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) mbar_wait(full0 + 8 * ((c + 1) % STAGES), ((c + 1) / STAGES) & 1);
    __syncthreads();  // chunk c is widened; chunk c - 1's products are done
    if (c + STAGES - 1 < nchunks) load_chunk(c + STAGES - 1);
    const uint32_t w_base = smem0 + (c % STAGES) * STAGE_BYTES + S_STAGE_BYTES;
    const uint32_t a_base = smem0 + STAGES * STAGE_BYTES + (c & 1) * A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      const int g = 2 * gi + wg;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        // A: K4 [BM][BK] K-major; K4^T [4][BK][64 lanes] M-major. B: the
        // window stage, [2][BK][64 columns] N-major.
        const uint64_t da =
            TRANS ? gmma_desc(a_base + g * BK * HALF + ks * 16 * HALF, BK * HALF, 8 * HALF)
                  : gmma_desc(a_base + g * 64 * 2 * BK + ks * 32, 16, 8 * 2 * BK);
        const uint64_t db = gmma_desc(w_base + ks * 16 * HALF, BK * HALF, 8 * HALF);
        wgmma_m64n128k16<TRANS ? 1 : 0>(acc[gi], da, db);
      }
    }
    wgmma_commit();
    if (c + 1 < nchunks) {
      scan(c + 1);
      fence_async_smem();
    }
    wgmma_wait_all();
  }

  // Accumulator d[4 j + e] of group g: rows 16 (warp % 4) + gid (e = 0, 1)
  // and + 8 (e = 2, 3), columns 8 j + 2 tig + (e % 2).
#pragma unroll
  for (int gi = 0; gi < 2; ++gi) {
    const int g = 2 * gi + wg;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 64 * g + 16 * (warp & 3) + 8 * half + gid;
      if (row >= rows) continue;
      float* dst = out + (size_t)(tile * qb + q0 + row) * h + n0 + 2 * tig;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (8 * j < cols)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(acc[gi][4 * j + 2 * half], acc[gi][4 * j + 2 * half + 1]);
      }
    }
  }
}


// ---- the persistent kernel ----------------------------------------------

namespace persistent {

constexpr int BM = 128;                // an item's rows (K4) or lanes (K4^T)
constexpr int S_BYTES = BM * BK;       // K4: [BM][BK] (64-byte swizzle); K4^T: [BK][128]
constexpr int A_BYTES = BM * BK * 2;   // a chunk's counts as bf16
constexpr int OUT_BOX = 64 * 128;      // [64 rows][32 f32], one TMA store
constexpr int FLAGS = 8;               // chunks whose liveness is kept
constexpr int WS_THREADS = 3 * 128;    // two consumer warpgroups and the widening one
constexpr int HELPER = 256;            // the widening warpgroup's first thread

// BN = 256 (H > 128): 3 window stages of 32 KB; BN = 128: 4 of 16 KB.
template <int BN>
struct Cfg {
  static constexpr int WS = BN == 256 ? 3 : 4;    // window stages
  static constexpr int NA = 4;                    // count buffers
  static constexpr int SS = BN == 256 ? 6 : 10;   // S stages
  static constexpr int W_BYTES = BK * BN * 2;     // [BN / 64 boxes][BK rows][64 bf16]
  static constexpr int SMEM =
      SS * S_BYTES + WS * W_BYTES + NA * A_BYTES + 2 * OUT_BOX + 1024;
  static_assert(SMEM <= 227 * 1024 - 256, "shared memory");
  // A chunk's flags are written before it is widened and read until its
  // products are done, at most NA chunks later.
  static_assert(FLAGS > NA, "rings");
};

// Keep the compiler from moving reads of the sums above the wait that
// completes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, bool trans) {
  if (trans) wgmma_m64n128k16<1>(d, a, b);
  else wgmma_m64n128k16<0>(d, a, b);
}
__device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b, bool trans) {
  if (trans) wgmma_m64n256k16<1>(d, a, b);
  else wgmma_m64n256k16<0>(d, a, b);
}

// An item of the block: its tile, first row or lane q0, first column n0.
struct Item {
  int tile, q0, n0;
};
__device__ __forceinline__ Item item_at(int il, int slices, int colblocks, int bn) {
  const int item = (int)blockIdx.x + il * (int)gridDim.x;
  const int r = item / colblocks;
  return Item{r / slices, (r % slices) * BM, (item % colblocks) * bn};
}

// s_map: S as [num_tiles][qb][9w] bytes, boxes [BM][BK] (K4), or S_rev as
// [num_tiles][9w][rev_lanes], boxes [BK][128] (K4^T); z_map: z_pad, boxes
// [BK][64], or with wide_map (h % 64 == 0) z_pad as [h / 64][num_pad][64]
// (the 64-column blocks outermost), boxes [BN / 64][BK][64]: a window
// chunk in one copy; o_map: out as [num_tiles][qb][h] f32, boxes [64][32].
// Items: num_tiles x slices (of BM rows or lanes) x colblocks (of BN
// columns).
template <bool TRANS, int BN>
__global__ void __launch_bounds__(WS_THREADS, 1) kernel(
    const __grid_constant__ CUtensorMap s_map, const __grid_constant__ CUtensorMap z_map,
    const __grid_constant__ CUtensorMap o_map, const int* __restrict__ starts, int qb, int w,
    int h, int num_items, int slices, int colblocks, int wide_map) {
  using C = Cfg<BN>;
  constexpr int SS = C::SS, WS = C::WS, NA = C::NA, W_BYTES = C::W_BYTES;
  extern __shared__ unsigned char smem_raw[];
  // s_full: an S chunk landed; w_full / w_empty: a window chunk landed / both
  // consumers are done with it; a_full / a_empty: a chunk's counts and
  // flags are written / both consumers' products of it are done.
  __shared__ __align__(8) uint64_t s_full[SS], w_full[WS], w_empty[WS], a_full[NA], a_empty[NA];
  __shared__ __align__(4) uint8_t live[FLAGS][4];  // [chunk % FLAGS][widening warp]

  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t smem0 = (raw0 + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (smem0 - raw0);
  const uint32_t w0 = smem0 + SS * S_BYTES;  // the window ring
  const uint32_t a0 = w0 + WS * W_BYTES;     // the count buffers
  const uint32_t o0 = a0 + NA * A_BYTES;     // an output box a consumer warpgroup
  const uint32_t sf0 = smem_addr(s_full), wf0 = smem_addr(w_full), we0 = smem_addr(w_empty);
  const uint32_t af0 = smem_addr(a_full), ae0 = smem_addr(a_empty);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wtid = threadIdx.x & 127;
  const int kchunks = (w + BK - 1) / BK, nchunks = 9 * kchunks;
  const int items =
      (int)blockIdx.x < num_items ? (num_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int total = items * nchunks;  // the block's chunks, item after item

  if (threadIdx.x == HELPER) {
    prefetch_map(&s_map);
    prefetch_map(&z_map);
  }
  if (threadIdx.x == 0) {
    prefetch_map(&o_map);
    for (int s = 0; s < SS; ++s) mbar_init(sf0 + 8 * s, 1);
    for (int s = 0; s < WS; ++s) {
      mbar_init(wf0 + 8 * s, 1);
      mbar_init(we0 + 8 * s, 2 * 4);  // a lane of each consumer warp
    }
    for (int s = 0; s < NA; ++s) {
      mbar_init(af0 + 8 * s, 128);    // every widening thread
      mbar_init(ae0 + 8 * s, 2 * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- the widening warpgroup ----------------------------------------
    // Chunk x: wait for its S copy; each warp records whether its 32 rows
    // (K4) or its 32 window rows x 64 lanes (K4^T) hold a count (warps 0, 1
    // of the group serve consumer 0, rows or lanes 0-63, warps 2, 3
    // consumer 1). After the group's barrier thread 256 refills chunk x's S
    // stage with chunk x + SS and thread 288 loads chunk x's window if any
    // warp's rows hold a count (once both consumers are done with that
    // window stage). Once both consumers are done with chunk x - NA, every
    // thread widens its 64 bytes into count buffer x % NA (K4 [BM][BK]
    // K-major, K4^T [2 groups][BK][64 lanes] M-major) and arrives on
    // a_full; a warp with no count writes zeros only where the buffer may
    // hold its earlier ones.
    const int hw = warp & 3;
    const bool s_leader = threadIdx.x == HELPER, w_leader = threadIdx.x == HELPER + 32;
    // Issuers' cursors: item il of the block, window j, chunk kc of it.
    int il = 0, j = 0, kc = 0;
    Item it = item_at(0, slices, colblocks, BN);
    auto advance = [&]() {
      if (++kc < kchunks) return;
      kc = 0;
      if (++j < 9) return;
      j = 0;
      if (++il < items) it = item_at(il, slices, colblocks, BN);
    };
    auto load_s = [&](int x) {  // thread 256: chunk x, the cursor's
      const uint32_t bar = sf0 + 8 * (x % SS), dst = smem0 + (x % SS) * S_BYTES;
      mbar_expect_tx(bar, S_BYTES);
      if (!TRANS) tma_load_3d(dst, &s_map, j * w + kc * BK, it.q0, it.tile, bar);
      else tma_load_3d(dst, &s_map, it.q0, j * w + kc * BK, it.tile, bar);
      advance();
    };
    int vh = 0;  // thread 288: live chunks so far (window stage vh % WS)
    auto load_w = [&](bool is_live) {  // thread 288: the cursor's chunk, if live
      if (is_live) {
        if (vh >= WS) mbar_wait(we0 + 8 * (vh % WS), ((vh / WS) - 1) & 1);
        const int start = __ldg(starts + it.tile * 9 + j) + kc * BK;
        const uint32_t bar = wf0 + 8 * (vh % WS), dst = w0 + (vh % WS) * W_BYTES;
        const int boxes = min(BN / 64, (h - it.n0 + 63) / 64);
        mbar_expect_tx(bar, wide_map ? W_BYTES : boxes * BK * HALF);
        if (wide_map) {
          tma_load_3d(dst, &z_map, 0, start, it.n0 / 64, bar);
        } else {
          for (int b = 0; b < boxes; ++b)
            tma_load_2d(dst + b * BK * HALF, &z_map, it.n0 + 64 * b, start, bar);
        }
        ++vh;
      }
      advance();
    };

    if (s_leader)
      for (int x = 0; x < SS && x < total; ++x) load_s(x);
    uint32_t dirty = (1u << NA) - 1u;
    int kc_x = 0;  // chunk x's chunk of its window
    for (int x = 0; x < total; ++x) {
      mbar_wait(sf0 + 8 * (x % SS), (x / SS) & 1);
      const unsigned char* st = smem + (x % SS) * S_BYTES;
      const int kk = kc_x * BK;
      kc_x = kc_x + 1 == kchunks ? 0 : kc_x + 1;
      uint4 v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        v[m] = make_uint4(0u, 0u, 0u, 0u);
        if (!TRANS) {
          if (kk + 16 * m < w)
            v[m] = *reinterpret_cast<const uint4*>(st + wtid * BK + (s_swz(wtid, m) << 4));
        } else {
          const int p = 32 * (hw & 1) + 4 * (lane >> 2) + m, c16 = 4 * (hw >> 1) + (lane & 3);
          if (kk + p < w)
            v[m] = *reinterpret_cast<const uint4*>(st + p * HALF + (swz128(p, c16) << 4));
        }
      }
      uint32_t any = 0u;
#pragma unroll
      for (int m = 0; m < 4; ++m) any |= v[m].x | v[m].y | v[m].z | v[m].w;
      const bool a = __any_sync(0xffffffffu, any != 0u);
      if (lane == 0) live[x % FLAGS][hw] = a;
      named_barrier(1);  // the flags are written; the S stage is read
      if (s_leader && x + SS < total) load_s(x + SS);
      if (w_leader) load_w(*reinterpret_cast<const uint32_t*>(live[x % FLAGS]) != 0u);
      const int slot = x % NA;
      if (x >= NA) mbar_wait(ae0 + 8 * slot, ((x / NA) - 1) & 1);
      const uint32_t buf = 1u << slot;
      bool write = true;
      if (a) {
        dirty |= buf;
      } else if (dirty & buf) {
        dirty &= ~buf;  // write the zeros below once
      } else {
        write = false;
      }
      if (write) {
        const bool neg = __any_sync(0xffffffffu, (any & 0x80808080u) != 0u);
        unsigned char* ab = smem + (a0 - smem0) + slot * A_BYTES;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          unsigned char *lo, *hi;
          if (!TRANS) {
            unsigned char* row = ab + wtid * 2 * BK;
            lo = row + (swz128(wtid, 2 * m) << 4);
            hi = row + (swz128(wtid, 2 * m + 1) << 4);
          } else {
            const int p = 32 * (hw & 1) + 4 * (lane >> 2) + m, cc = lane & 3;
            unsigned char* row = ab + (hw >> 1) * BK * HALF + p * HALF;
            lo = row + (swz128(p, 2 * cc) << 4);
            hi = row + (swz128(p, 2 * cc + 1) << 4);
          }
          if (neg) store_counts(lo, hi, v[m]);
          else store_counts_nonneg(lo, hi, v[m]);
        }
        fence_async_smem();
      }
      mbar_arrive(af0 + 8 * slot);
    }
    return;
  }

  // ---- the consumer warpgroups ------------------------------------------
  // Chunk x: once its counts are written, a warpgroup whose 64 rows or
  // lanes hold a count of it multiplies them by its window; a lane of each
  // warp then releases the count buffer and (if the chunk was live) the
  // window stage. An item's last chunk ends in its epilogue.
  float acc[BN / 2];  // the warpgroup's 64 rows x BN columns of f32 sums
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  int v = 0;   // live chunks before x: chunk x's window stage is v % WS
  int il = 0, cin = 0;
  for (int x = 0; x < total; ++x) {
    const int slot = x % NA;
    mbar_wait(af0 + 8 * slot, (x / NA) & 1);
    const uint32_t f = *reinterpret_cast<const uint32_t*>(live[x % FLAGS]);
    const bool mine = (wg ? f >> 16 : f & 0xffffu) != 0u;
    if (mine) {
      mbar_wait(wf0 + 8 * (v % WS), (v / WS) & 1);
      const uint32_t ab = a0 + slot * A_BYTES + wg * 64 * 2 * BK;
      const uint32_t wb = w0 + (v % WS) * W_BYTES;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        // A: K4 [64 rows][BK] K-major; K4^T [BK][64 lanes] M-major. B: the
        // window stage, [BN / 64][BK][64 columns] N-major.
        const uint64_t da = TRANS ? gmma_desc(ab + ks * 16 * HALF, BK * HALF, 8 * HALF)
                                  : gmma_desc(ab + ks * 32, 16, 8 * 2 * BK);
        const uint64_t db = gmma_desc(wb + ks * 16 * HALF, BK * HALF, 8 * HALF);
        mma(acc, da, db, TRANS);
      }
      wgmma_commit();
      wgmma_wait_all();
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(ae0 + 8 * slot);
      if (f != 0u) mbar_arrive(we0 + 8 * (v % WS));
    }
    if (f != 0u) ++v;
    if (++cin < nchunks) continue;
    // Epilogue: the sums through a [64][32] f32 box in shared memory by
    // 3-D TMA stores (rows past QB clipped), the box refilled once its
    // previous store has read it. acc[4 j + e] is row 16 (warp % 4) +
    // lane / 4 + 8 (e / 2) of the group, column 8 j + 2 (lane % 4) + e % 2.
    fence_regs(acc);
    const Item k = item_at(il, slices, colblocks, BN);
    const int row0 = k.q0 + 64 * wg;
    if (row0 < qb) {
      const int r0 = 16 * (warp & 3) + (lane >> 2), tig = lane & 3;
#pragma unroll
      for (int s = 0; s < BN / 32; ++s) {
        if (k.n0 + 32 * s >= h) break;
        const uint32_t box = o0 + wg * OUT_BOX;
        if (wtid == 0) bulk_wait_read<0>();
        named_barrier(2 + wg);
        unsigned char* p = smem + (box - smem0);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int jc = 4 * s + jj;
          // [64 rows][32 f32] in the 128-byte swizzle: 16-byte chunk
          // (2 jj + tig / 2) ^ (row % 8).
          const int off =
              r0 * HALF + (((2 * jj + (tig >> 1)) ^ (r0 & 7)) << 4) + (tig & 1) * 8;
          *reinterpret_cast<float2*>(p + off) = make_float2(acc[4 * jc], acc[4 * jc + 1]);
          *reinterpret_cast<float2*>(p + off + 8 * HALF) =
              make_float2(acc[4 * jc + 2], acc[4 * jc + 3]);
        }
        fence_async_smem();
        named_barrier(2 + wg);
        if (wtid == 0) {
          tma_store_3d(&o_map, k.n0 + 32 * s, row0, k.tile, box);
          bulk_commit();
        }
      }
    }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
    cin = 0;
    ++il;
  }
  if (wtid == 0) bulk_wait<0>();
}

}  // namespace persistent

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool TRANS>
int launch_tiled(const void* s_table, const void* z_pad, const int* starts, float* out,
                 int num_tiles, int qb, int w, int h, int num_pad, int width,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(window_matmul_kernel<TRANS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int mblocks = (qb + BM - 1) / BM;
  const dim3 grid((unsigned)(num_tiles * mblocks), (unsigned)((h + BN - 1) / BN));
  window_matmul_kernel<TRANS><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const int8_t*>(s_table), static_cast<const __nv_bfloat16*>(z_pad), starts, out,
      qb, w, h, num_pad, width);
  return (int)cudaGetLastError();
}

template <bool TRANS, int BN>
int launch_persistent(const void* s_table, const void* z_pad, const int* starts, float* out,
                      int num_tiles, int qb, int w, int h, int num_pad, int width,
                      cudaStream_t stream) {
  using persistent::BM;
  if (w % 16 || h < 64 || !aligned16(s_table)) return (int)cudaErrorInvalidValue;
  CUtensorMap s_map = {}, z_map = {}, o_map = {};
  const bool s_ok =
      TRANS ? tensor_map_3d(&s_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, s_table, width, 9 * (uint64_t)w,
                            num_tiles, width, 9 * (uint64_t)w * width, HALF, BK,
                            CU_TENSOR_MAP_SWIZZLE_128B)
            : tensor_map_3d(&s_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, s_table, width, qb, num_tiles,
                            width, (uint64_t)qb * width, BK, BM, CU_TENSOR_MAP_SWIZZLE_64B);
  const int wide_map = h % 64 == 0;
  const bool z_ok =
      wide_map ? tensor_map_3d(&z_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, z_pad, 64, num_pad,
                               h / 64, 2 * (uint64_t)h, 128, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B,
                               BN / 64)
               : tensor_map(&z_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, z_pad, h, num_pad,
                            2 * (uint64_t)h, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!s_ok || !z_ok ||
      !tensor_map_3d(&o_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out, h, qb, num_tiles,
                     4 * (uint64_t)h, 4 * (uint64_t)h * qb, 32, 64, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  auto kernel = persistent::kernel<TRANS, BN>;
  constexpr int smem = persistent::Cfg<BN>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const int slices = (qb + BM - 1) / BM, colblocks = (h + BN - 1) / BN;
  const int items = num_tiles * slices * colblocks;
  kernel<<<items < sms ? items : sms, persistent::WS_THREADS, smem, stream>>>(
      s_map, z_map, o_map, starts, qb, w, h, items, slices, colblocks, wide_map);
  return (int)cudaGetLastError();
}

// kernel: 0 the tiled kernel, 1 the persistent one (cellblock.py's
// window_kernel picks it by shape).
template <bool TRANS>
int launch(const void* s_table, const void* z_pad, const int* starts, float* out,
           int num_tiles, int qb, int w, int h, int num_pad, int width, int kernel,
           void* stream_) {
  if (num_tiles == 0) return (int)cudaSuccess;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (kernel == 0)
    return launch_tiled<TRANS>(s_table, z_pad, starts, out, num_tiles, qb, w, h, num_pad, width,
                               stream);
  if (kernel != 1) return (int)cudaErrorInvalidValue;
  return h > 128 ? launch_persistent<TRANS, 256>(s_table, z_pad, starts, out, num_tiles, qb, w, h,
                                                 num_pad, width, stream)
                 : launch_persistent<TRANS, 128>(s_table, z_pad, starts, out, num_tiles, qb, w, h,
                                                 num_pad, width, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). s_table [num_tiles * qb, width]
// int8 with width = 9 * w; z_pad [num_pad, h] bf16; starts [num_tiles, 9]
// int32 (start + w <= num_pad); out [num_tiles * qb, h] float32; all
// contiguous, z_pad 16-byte aligned. qb % 32 == 0, w % 8 == 0, h % 8 == 0;
// the persistent kernel (kernel 1) also w % 16 == 0, h >= 64 and s_table
// 16-byte aligned. Launches on `stream`, does not synchronize, returns the
// cudaError_t.
extern "C" int window_matmul_launch(const void* s_table, const void* z_pad,
                                    const int* starts, float* out, int num_tiles,
                                    int qb, int w, int h, int num_pad, int width, int kernel,
                                    void* stream) {
  if (qb % 32 || w % 8 || h % 8 || width != 9 * w || qb <= 0 || w <= 0 || h <= 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(z_pad) || (reinterpret_cast<uintptr_t>(s_table) & 7))
    return (int)cudaErrorMisalignedAddress;
  return launch<false>(s_table, z_pad, starts, out, num_tiles, qb, w, h, num_pad, width, kernel,
                       stream);
}

// S^T mode. s_rev [num_tiles, 9 * w, rev_lanes] int8 with rev_lanes % 16 == 0
// and qb <= rev_lanes, 16-byte aligned; g_pad [num_pad, h] bf16; starts,
// out and kernel as above.
extern "C" int window_matmul_t_launch(const void* s_rev, const void* g_pad,
                                      const int* starts, float* out, int num_tiles,
                                      int qb, int w, int h, int num_pad, int rev_lanes,
                                      int kernel, void* stream) {
  if (qb % 32 || w % 8 || h % 8 || rev_lanes % 16 || qb > rev_lanes || qb <= 0 || w <= 0 ||
      h <= 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(g_pad) || !aligned16(s_rev)) return (int)cudaErrorMisalignedAddress;
  return launch<true>(s_rev, g_pad, starts, out, num_tiles, qb, w, h, num_pad, rev_lanes, kernel,
                      stream);
}
