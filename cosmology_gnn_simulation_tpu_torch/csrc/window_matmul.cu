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
// tensor cores' 989 TFLOP/s: under the bytes, if it overlaps the stream of
// S and costs few instructions. (S holds ~N*k nonzeros, 99.5 % zeros, but
// skipping its empty blocks cost more in control than it saved in products:
// chip_smoke.py prints the share of live blocks.)
//
// Design. One block of two warpgroups per (whole query tile of up to 256
// rows, 128-wide latent block), so every window chunk leaves L2 once per
// tile. The block walks the 9 windows in 64-row chunks through a ring of
// STAGES shared-memory stages (S or S_rev chunk, window chunk):
// - One thread fills a stage with 2-D tensor copies (TMA; completion on an
//   mbarrier), in the hardware's 64- or 128-byte swizzle, so no load/store
//   unit traffic competes with the block's shared-memory reads. (Filling
//   the stages with per-thread cp.async instead capped the bytes in flight
//   per SM and queued the products' shared loads behind the copies.) Where
//   TMA cannot describe an input (an S row stride 9W not a multiple of 16
//   bytes, or H < 64) every thread fills the same layout by cp.async.
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
// The order of summation is fixed (window, chunk, k16 step), there are no
// atomics, and two launches on the same inputs are bit-equal. Rows past the
// tile, window rows past W and columns past H are zero-filled or not
// stored, so any QB (multiple of 32), W (multiple of 8) and H (multiple of
// 8) work. What holds it back (PERF.md): the widening pass and the one
// barrier a chunk, at one block an SM; a persistent grid and a producer
// warp are next.
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

// TRANS = false: s_table is S [num_tiles * qb, width], width = 9w.
// TRANS = true: s_table is S_rev [num_tiles, 9w, width], width = rev_lanes.
// use_tma: s_map and z_map describe s_table and z_pad (boxes [32][BK]
// bytes, or [BK][128] lanes for S_rev, and [BK][64] candidates); else the
// stages are filled by cp.async (16-byte, or 8-byte where w % 16 != 0).
template <bool TRANS>
__global__ void __launch_bounds__(THREADS, 1) window_matmul_kernel(
    const __grid_constant__ CUtensorMap s_map, const __grid_constant__ CUtensorMap z_map,
    const int8_t* __restrict__ s_table, const __nv_bfloat16* __restrict__ z_pad,
    const int* __restrict__ starts, float* __restrict__ out, int qb, int w, int h,
    int num_pad, int width, int use_tma) {
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
  const int s_halves = (rows + HALF - 1) / HALF;  // K4^T: 128-lane boxes a chunk
  const uint32_t tx_bytes = (TRANS ? s_halves * BK * HALF : rows * BK) + W_STAGE_BYTES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full0 + 8 * s, use_tma ? 1 : THREADS);
    mbar_init_fence();
  }
  __syncthreads();

  // Fill stage c % STAGES with chunk c: one thread's tensor copies, or every
  // thread's cp.async.
  auto load_chunk = [&](int c) {
    const int stage = c % STAGES;
    const int j = c / kchunks, kk = (c - j * kchunks) * BK;
    const int start = __ldg(starts + tile * 9 + j);
    const uint32_t s_dst = smem0 + stage * STAGE_BYTES;
    const uint32_t w_dst = s_dst + S_STAGE_BYTES;
    const uint32_t bar = full0 + 8 * stage;
    if (use_tma) {
      if (threadIdx.x != 0) return;
      mbar_expect_tx(bar, tx_bytes);
      if (!TRANS) {
        for (int r = 0; r < rows; r += 32)
          tma_load_2d(s_dst + r * BK, &s_map, j * w + kk, tile * qb + q0 + r, bar);
      } else {
        for (int hb = 0; hb < s_halves; ++hb)
          tma_load_2d(s_dst + hb * BK * HALF, &s_map, q0 + hb * HALF, (tile * 9 + j) * w + kk,
                      bar);
      }
      tma_load_2d(w_dst, &z_map, n0, start + kk, bar);
      tma_load_2d(w_dst + BK * HALF, &z_map, n0 + 64, start + kk, bar);
      return;
    }
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool TRANS>
int launch(const void* s_table, const void* z_pad, const int* starts, float* out,
           int num_tiles, int qb, int w, int h, int num_pad, int width, void* stream) {
  if (num_tiles == 0) return (int)cudaSuccess;
  CUtensorMap s_map = {}, z_map = {};
  // TMA needs 16-byte aligned bases and row strides, and a 64-column box
  // no wider than the candidates.
  int use_tma = w % 16 == 0 && h >= 64 && aligned16(s_table) && aligned16(z_pad);
  if (use_tma) {
    const uint64_t s_rows = TRANS ? (uint64_t)num_tiles * 9 * w : (uint64_t)num_tiles * qb;
    use_tma =
        tensor_map(&s_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, s_table, width, s_rows, width,
                   TRANS ? HALF : BK, TRANS ? BK : 32,
                   TRANS ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B) &&
        tensor_map(&z_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, z_pad, h, num_pad, 2 * (uint64_t)h,
                   64, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  cudaError_t err = cudaFuncSetAttribute(window_matmul_kernel<TRANS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int mblocks = (qb + BM - 1) / BM;
  const dim3 grid((unsigned)(num_tiles * mblocks), (unsigned)((h + BN - 1) / BN));
  window_matmul_kernel<TRANS><<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      s_map, z_map, static_cast<const int8_t*>(s_table),
      static_cast<const __nv_bfloat16*>(z_pad), starts, out, qb, w, h, num_pad, width, use_tma);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). s_table [num_tiles * qb, width]
// int8 with width = 9 * w; z_pad [num_pad, h] bf16; starts [num_tiles, 9]
// int32 (start + w <= num_pad); out [num_tiles * qb, h] float32; all
// contiguous, z_pad 16-byte aligned. qb % 32 == 0, w % 8 == 0, h % 8 == 0.
// Launches on `stream`, does not synchronize, returns the cudaError_t.
extern "C" int window_matmul_launch(const void* s_table, const void* z_pad,
                                    const int* starts, float* out, int num_tiles,
                                    int qb, int w, int h, int num_pad, int width,
                                    void* stream) {
  if (qb % 32 || w % 8 || h % 8 || width != 9 * w || qb <= 0 || w <= 0 || h <= 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(z_pad) || (reinterpret_cast<uintptr_t>(s_table) & 7))
    return (int)cudaErrorMisalignedAddress;
  return launch<false>(s_table, z_pad, starts, out, num_tiles, qb, w, h, num_pad, width,
                       stream);
}

// S^T mode. s_rev [num_tiles, 9 * w, rev_lanes] int8 with rev_lanes % 16 == 0
// and qb <= rev_lanes, 16-byte aligned; g_pad [num_pad, h] bf16; starts and
// out as above.
extern "C" int window_matmul_t_launch(const void* s_rev, const void* g_pad,
                                      const int* starts, float* out, int num_tiles,
                                      int qb, int w, int h, int num_pad, int rev_lanes,
                                      void* stream) {
  if (qb % 32 || w % 8 || h % 8 || rev_lanes % 16 || qb > rev_lanes || qb <= 0 || w <= 0 ||
      h <= 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(g_pad) || !aligned16(s_rev)) return (int)cudaErrorMisalignedAddress;
  return launch<true>(s_rev, g_pad, starts, out, num_tiles, qb, w, h, num_pad, rev_lanes,
                      stream);
}
