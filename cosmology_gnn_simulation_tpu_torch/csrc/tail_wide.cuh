// Device code of the width-general K5 (fused_tail_wide.cu) and K6
// (fused_tail_wide_bwd.cu): latent = hidden = D, D = 128 or 256, one hidden
// Linear, the carry x in f32 or bf16, agg in f32 or bf16. The tuned kernels
// of tail_common.cuh hold all three bf16 weights of a 128-wide model in
// shared memory (96 KB); at D = 256 they take 384 KB, more than an SM has,
// so these kernels stream each weight through a ring of shared-memory slabs.
// The tuned kernels' own layouts, copies and products are tail_common.cuh's.
//
// Numerics are the Pallas kernels': products on bf16 operands into f32 sums
// (wgmma), LayerNorm, biases and the residual in f32, the new carry rounded
// once to x's dtype, dx written in x's dtype and dagg in agg's.
//
// A block (persistent, one an SM; 256 threads, so up to 255 registers a
// thread) is two warpgroups walking tiles of 128 rows, 64 each:
// - the weights stream from L2 by TMA through a ring of k-slabs in shared
//   memory (KS = 64 rows of W, or 64 columns of W for W^T, 32 KB at D =
//   256) in the 128-byte swizzled layouts that wgmma reads by descriptor.
//   Both warpgroups multiply by the same slab, so a 128-row tile streams
//   each weight from L2 once; the last of the block's eight warps to be done
//   with a slab issues the copy of the slab STAGES later into its stage, so
//   no thread waits to free a stage and no warp is set aside to produce.
// - a warpgroup holds its 64 rows x D columns of a product's f32 sums in
//   registers (D / 128 wgmma m64n128k16 accumulators of 64 floats a
//   thread), so a row lies in the four lanes of one quad and LayerNorm's
//   row sums take two shuffles. It has two tiles of its own (A, B: 64 rows
//   x D bf16 each) through which every row array moves by TMA: loads
//   (x, agg, g) land there and are read in the accumulator layout, each
//   layer's bf16 output is rounded into a tile as the next product's A, and
//   outputs leave by TMA stores from a tile. Each copy is issued as soon as
//   its tile is free.
// Layouts (128-byte swizzle, every base 1024-byte aligned): a 64-row tile
// of D bf16 columns is D / 64 chunks of [64 rows][64 columns] (8 KB,
// tail::bf16_off), of f32 columns D / 32 chunks of [64 rows][32 columns]
// (tail::f32_off); a forward slab (W rows [k0, k0 + 64), every column) is
// a bf16 tile with rows = k (read N-major: B = W); a backward slab (W
// columns [k0, k0 + 64), every row) is [D rows][64 columns] (read K-major:
// B = W^T).
#pragma once

#include <cuda_bf16.h>

#include "tail_common.cuh"

namespace tailw {

using namespace sm90;
using tail::bf16_off;
using tail::named_barrier;
using tail::Operand;
using tail::pack_bf16;
using tail::quad_sum;

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;                       // a consumer warpgroup's rows: one wgmma M
constexpr int CONSUMERS = 2;                   // warpgroups of a block
constexpr int TILE_ROWS = CONSUMERS * ROWS;    // a block's tile
constexpr int THREADS = CONSUMERS * 128;       // (two warps a sub-partition: 255 registers)
constexpr int WARPS = THREADS / 32;
constexpr int KS = 64;                         // k of a weight slab
constexpr int CHUNK = ROWS * 128;              // [64 rows][64 bf16 columns], 8 KB
constexpr int SMEM_LIMIT = 227 * 1024;         // a block's shared memory on the H100
constexpr float LN_EPS = 1e-5f;

template <int D>
struct Wide {
  static_assert(D == 128 || D == 256, "width");
  static constexpr int NH = D / 128;               // m64n128 accumulators a thread
  static constexpr int NS = D / KS;                // slabs of a weight
  static constexpr int TILE_BYTES = ROWS * D * 2;  // a warpgroup's bf16 tile
  static constexpr int SLAB_BYTES = KS * D * 2;
};

// ---- element access ------------------------------------------------------

__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// p, as a value the compiler cannot follow from one iteration of a loop to
// the next: loads through it stay in the loop (a tile loop's worth of a
// bias vector would not fit in registers), while their constant column
// offsets stay immediates of the load instructions.
template <typename T>
__device__ __forceinline__ const T* fresh(const T* p) {
  asm volatile("" : "+l"(p));
  return p;
}
// The pair of columns (hh, j) of the thread (tail_wide's Lane) from p, a
// row or vector already offset by the thread's 2 tig.
template <typename T>
__device__ __forceinline__ float2 at2(const T* p, int hh, int j) {
  return ld2(p + 128 * hh + 8 * j);
}
template <typename T>
__device__ __forceinline__ void put2(T* p, int hh, int j, float a, float b) {
  st2(p + 128 * hh + 8 * j, a, b);
}
// The pairs (hh, j0 + j), j < J, of the thread's two rows p0 and p1 (zeros
// for a row past n), all loads issued before any is used.
template <int J, typename T>
__device__ __forceinline__ void load_pairs(float2 (&a)[J], float2 (&b)[J], const T* p0,
                                           const T* p1, bool ok0, bool ok1, int hh, int j0) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    a[j] = ok0 ? at2(p0, hh, j0 + j) : make_float2(0.f, 0.f);
    b[j] = ok1 ? at2(p1, hh, j0 + j) : make_float2(0.f, 0.f);
  }
}

// Keep the compiler from moving reads of a product's sums above the wait
// that completes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The thread's place in its warpgroup: rows r0 and r0 + 8 of the tile, and
// accumulator v[hh][4 j + e] is row r0 + 8 (e >> 1), column
// 128 hh + 8 j + 2 tig + (e & 1).
struct Lane {
  int wtid, warp, lane, gid, tig, r0;
  __device__ __forceinline__ Lane() {
    wtid = threadIdx.x & 127;
    warp = wtid >> 5;
    lane = threadIdx.x & 31;
    gid = lane >> 2;
    tig = lane & 3;
    r0 = 16 * warp + gid;
  }
  __device__ __forceinline__ int col(int hh, int j) const { return 128 * hh + 8 * j + 2 * tig; }
};

// The thread's two rows of a 64-row tile at row0 in a [n, d] array: their
// element offsets at its column 2 tig and whether each is a row (< n);
// made where a phase reads or writes rows, so none holds a register across
// the tile.
struct RowsAt {
  size_t o0, o1;
  bool ok0, ok1;
  __device__ __forceinline__ RowsAt(int row0, const Lane& l, int n, int d) {
    const int g0 = row0 + l.r0;
    ok0 = g0 < n;
    ok1 = g0 + 8 < n;
    o0 = (size_t)g0 * d + 2 * l.tig;
    o1 = o0 + 8 * (size_t)d;
  }
};

// Byte offsets of the thread's pairs in the 128-byte swizzled tiles that TMA
// writes (the closed forms of tail::bf16_off and tail::f32_off at its rows
// r0 + 8 h and its columns): a base and an XOR a pair, so no offset holds a
// register of its own across a tile.
struct Frag {
  int b16_base, g16, f32_base, t16;
  __device__ __forceinline__ explicit Frag(const Lane& l) {
    b16_base = l.r0 * 128 + 4 * l.tig;
    g16 = l.gid << 4;
    f32_base = l.r0 * 128 + (l.tig & 1) * 8;
    t16 = ((l.tig >> 1) ^ l.gid) << 4;
  }
  // A bf16 tile of D columns (chunks of 64): the pair at column
  // 128 hh + 8 j + 2 tig.
  __device__ __forceinline__ int b16(int hh, int j, int h) const {
    return b16_base + (2 * hh + (j >> 3)) * CHUNK + h * 1024 + (g16 ^ ((j & 7) << 4));
  }
  // An f32 tile of 128 columns (chunks of 32): the pair at column
  // 8 j + 2 tig, j < 16.
  __device__ __forceinline__ int f32(int j, int h) const {
    return f32_base + (j >> 2) * CHUNK + h * 1024 + (t16 ^ ((2 * (j & 3)) << 4));
  }
};

__device__ __forceinline__ float2 bf16_pair(const unsigned char* tile, int off) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + off));
}
__device__ __forceinline__ void put_bf16_pair(unsigned char* tile, int off, float a, float b) {
  *reinterpret_cast<uint32_t*>(tile + off) = pack_bf16(a, b);
}

// agg of a 64-row tile comes in parts of one tile's bytes: an f32 agg's
// columns [0, D / 2) and [D / 2, D), a bf16 agg's every column as part 0.
// load: part p of rows [row0, + 64) into dst; pair: the thread's pair
// (hh, j, h) of the tile from part 0 at p0 and part 1 at p1.
template <int D, typename T>
struct AggParts {
  static constexpr int PARTS = sizeof(T) == 4 ? 2 : 1, COLS = D / PARTS;
  static __device__ __forceinline__ void load(uint32_t dst, const CUtensorMap* map, int row0,
                                              int part, uint32_t bar) {
    constexpr int BOX = 128 / sizeof(T);  // a box's columns
    mbar_expect_tx(bar, ROWS * COLS * sizeof(T));
#pragma unroll
    for (int c = 0; c < COLS / BOX; ++c)
      tma_load_2d(dst + c * CHUNK, map, part * COLS + BOX * c, row0, bar);
  }
  static __device__ __forceinline__ float2 pair(const unsigned char* p0, const unsigned char* p1,
                                                const Frag& f, int hh, int j, int h) {
    if constexpr (PARTS == 1) {
      return bf16_pair(p0, f.b16(hh, j, h));
    } else {
      const int col = 128 * hh + 8 * j;  // the pair's column less 2 tig
      const int jj = col % COLS / 8;
      return *reinterpret_cast<const float2*>((col < COLS ? p0 : p1) + f.f32(jj, h));
    }
  }
};

// ---- operands --------------------------------------------------------------

// k16 step ks of a tile read K-major (a row product's A).
__device__ __forceinline__ Operand tile_k(int ks) {
  return {(uint32_t)((ks >> 2) * CHUNK + (ks & 3) * 32), 16};
}
// k16 step kk of a forward slab, columns [128 hh, + 128), N-major.
__device__ __forceinline__ Operand fwd_b(int kk, int hh) {
  return {(uint32_t)(hh * 2 * CHUNK + kk * 16 * 128), CHUNK};
}
// k16 step kk of a backward slab, W rows [128 hh, + 128), K-major.
__device__ __forceinline__ Operand bwd_b(int kk, int hh) {
  return {(uint32_t)(hh * 128 * 128 + kk * 32), 16};
}
// k16 step ks (16 rows) of a tile read M- or N-major, from column chunk c.
__device__ __forceinline__ Operand tile_mn(int c, int ks) {
  return {(uint32_t)(c * CHUNK + ks * 16 * 128), CHUNK};
}

// ---- the ring --------------------------------------------------------------

// STAGES slabs of BYTES at shared address base, holding the block's
// sequence of slabs q = 0, 1, ... in stage q % STAGES; full[s] completes
// when a slab's copies have landed, count[s] counts the warps done with
// it. The last of the block's warps to be done with slab q refills its
// stage with slab q + STAGES, so no thread waits for the others to free a
// stage.
template <int STAGES, int BYTES>
struct Ring {
  uint32_t base, full;
  int* count;
  uint32_t q = 0;  // the warp's next slab
  __device__ __forceinline__ Ring(uint32_t base_, uint32_t full_, int* count_)
      : base(base_), full(full_), count(count_) {}
  __device__ __forceinline__ uint32_t slab() const { return base + (q % STAGES) * BYTES; }
  __device__ __forceinline__ void wait_full() const {
    mbar_wait(full + 8 * (q % STAGES), (q / STAGES) & 1);
  }
  // The warp is done with slab q (its products have completed): the last
  // warp refills the stage with load(q + STAGES, dst, bar).
  template <class Load>
  __device__ __forceinline__ void release(uint32_t done, const Load& load) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const int s = done % STAGES;
      if (atomicAdd(&count[s], 1) == WARPS - 1) {
        count[s] = 0;
        load(done + STAGES, base + s * BYTES, full + 8 * s);
      }
    }
  }
  // Thread 0, before the block's first barrier: the barriers, the counts
  // and slabs 0 .. STAGES - 1.
  template <class Load>
  __device__ __forceinline__ void init(const Load& load) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      count[s] = 0;
    }
    mbar_init_fence();
    for (int s = 0; s < STAGES; ++s) load(s, base + s * BYTES, full + 8 * s);
  }
};

// acc = A x B: A the warpgroup's bf16 tile at shared address act (K-major),
// B = W (FWD: forward slabs, N-major) or W^T (backward slabs, K-major), the
// D / KS slabs next in the ring. Each slab's products are committed as one
// group; a slab is released as soon as the group after it is issued and it
// is done.
template <int D, bool FWD, class R, class Load>
__device__ __forceinline__ void product(float (&acc)[D / 128][64], uint32_t act, R& ring,
                                        const Load& load) {
#pragma unroll 1
  for (int s = 0; s < D / KS; ++s) {
    ring.wait_full();
    const uint32_t slab = ring.slab();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk)
#pragma unroll
      for (int hh = 0; hh < D / 128; ++hh)
        tail::wgmma_ss<0, FWD ? 1 : 0>(acc[hh], act, tile_k(s * (KS / 16) + kk), slab,
                                       FWD ? fwd_b(kk, hh) : bwd_b(kk, hh), s > 0 || kk > 0);
    wgmma_commit();
    if (s > 0) {
      wgmma_wait<1>();
      ring.release(ring.q - 1, load);
    }
    ++ring.q;
  }
  wgmma_wait<0>();
  ring.release(ring.q - 1, load);
#pragma unroll
  for (int hh = 0; hh < D / 128; ++hh) fence_regs(acc[hh]);
}

// ---- tensor copies ---------------------------------------------------------

// Forward slab s of weight l (W rows [l D + s KS, + KS) of the stacked
// [3 D, D] bf16 weights, every column): D / 64 boxes of 64 x 64.
template <int D>
__device__ __forceinline__ void load_fwd_slab(uint32_t dst, const CUtensorMap* map, int l, int s,
                                              uint32_t bar) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_load_2d(dst + c * CHUNK, map, 64 * c, l * D + s * KS, bar);
}
// Backward slab s of weight l (rows [l D, + D), columns [s KS, + KS)): one
// box of D x 64.
template <int D>
__device__ __forceinline__ void load_bwd_slab(uint32_t dst, const CUtensorMap* map, int l, int s,
                                              uint32_t bar) {
  tma_load_2d(dst, map, s * KS, l * D, bar);
}
// Rows [row0, row0 + 64) of a [n, D] array of T (map: boxes of 64 rows x
// 128 bytes, row_map) into a tile at dst, rows past n as 0; completion to
// bar.
template <int D, typename T = bf16>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, int row0,
                                          uint32_t bar) {
  constexpr int COLS = 128 / sizeof(T);  // a box's columns
  mbar_expect_tx(bar, ROWS * D * sizeof(T));
#pragma unroll
  for (int c = 0; c < D / COLS; ++c) tma_load_2d(dst + c * CHUNK, map, COLS * c, row0, bar);
}
// The tile at src to rows [row0, row0 + 64) of a bf16 [n, D] array (rows
// past n are not written), as one bulk group.
template <int D>
__device__ __forceinline__ void store_tile(const CUtensorMap* map, int row0, uint32_t src) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_store_2d(map, 64 * c, row0, src + c * CHUNK);
  bulk_commit();
}
// Tile `tile`'s rows of a [n, D] array (nothing past n) into L2, in pieces
// of 16 KB.
template <int D, typename T>
__device__ __forceinline__ void prefetch_tile(const T* base, int tile, int n) {
  const int row0 = tile * TILE_ROWS, rows = n - row0 < TILE_ROWS ? n - row0 : TILE_ROWS;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(base + (size_t)row0 * D);
  const uint32_t bytes = rows > 0 ? (uint32_t)rows * D * sizeof(T) : 0;
  for (uint32_t off = 0; off < bytes; off += 16384)
    prefetch_l2(p + off, bytes - off < 16384 ? bytes - off : 16384);
}

// ---- tiles -----------------------------------------------------------------

// Rows [row0, row0 + 64) of an f32 [n, D] array, rounded to bf16, into the
// warpgroup's tile (rows past n as 0); 8 columns (16 bytes) a step.
template <int D>
__device__ __forceinline__ void load_tile_f32(unsigned char* tile, const float* __restrict__ src,
                                              int row0, int n, int wtid) {
  constexpr int CPR = D / 8;
#pragma unroll 4
  for (int i = wtid; i < ROWS * CPR; i += 128) {
    const int r = i / CPR, c = 8 * (i % CPR);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      const float4* p = reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c);
      const float4 a = __ldg(p), b = __ldg(p + 1);
      v = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                     pack_bf16(b.z, b.w));
    }
    *reinterpret_cast<uint4*>(tile + bf16_off(r, c)) = v;
  }
}

// The accumulators, rounded to bf16, as the warpgroup's tile.
template <int D>
__device__ __forceinline__ void stage(unsigned char* tile, const float (&v)[D / 128][64],
                                      const Frag& f) {
#pragma unroll
  for (int hh = 0; hh < D / 128; ++hh)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      put_bf16_pair(tile, f.b16(hh, j, 0), v[hh][4 * j], v[hh][4 * j + 1]);
      put_bf16_pair(tile, f.b16(hh, j, 1), v[hh][4 * j + 2], v[hh][4 * j + 3]);
    }
}

// ---- LayerNorm ---------------------------------------------------------------

// y (the accumulators) -> yn = (y - mean) rstd per row, two passes (the mean,
// then the variance of y - mean); rstd[h] of rows r0 + 8 h.
template <int NH>
__device__ __forceinline__ void layer_norm(float (&v)[NH][64], float (&rstd)[2], int d) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s0 += v[hh][4 * j] + v[hh][4 * j + 1];
      s1 += v[hh][4 * j + 2] + v[hh][4 * j + 3];
    }
  const float mean0 = quad_sum(s0) / d, mean1 = quad_sum(s1) / d;
  float q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      v[hh][4 * j] -= mean0;
      v[hh][4 * j + 1] -= mean0;
      v[hh][4 * j + 2] -= mean1;
      v[hh][4 * j + 3] -= mean1;
      q0 += v[hh][4 * j] * v[hh][4 * j] + v[hh][4 * j + 1] * v[hh][4 * j + 1];
      q1 += v[hh][4 * j + 2] * v[hh][4 * j + 2] + v[hh][4 * j + 3] * v[hh][4 * j + 3];
    }
  rstd[0] = rsqrtf(quad_sum(q0) / d + LN_EPS);
  rstd[1] = rsqrtf(quad_sum(q1) / d + LN_EPS);
}

// ---- column sums -------------------------------------------------------------

// Sum t[0..7] over the warp's eight gid lanes (a reduce-scatter: keep one
// half, send the other, three times); lane gid returns the total of t[gid].
__device__ __forceinline__ float reduce8(float (&t)[8], int gid) {
  const bool b2 = gid & 4, b1 = gid & 2, b0 = gid & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = t[i], hi = t[i + 4];
    t[i] = (b2 ? hi : lo) + __shfl_xor_sync(0xffffffffu, b2 ? lo : hi, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lo = t[i], hi = t[i + 2];
    t[i] = (b1 ? hi : lo) + __shfl_xor_sync(0xffffffffu, b1 ? lo : hi, 8);
  }
  return (b0 ? t[1] : t[0]) + __shfl_xor_sync(0xffffffffu, b0 ? t[0] : t[1], 4);
}

// A tile's column sums of one vector over a warp's rows of v (accumulators)
// to dst: lane (gid, tig) writes element [hh][k] of the reduce-scatter to
// dst[128 hh + 32 k] (dst already offset to its column of a group).
template <int D>
__device__ __forceinline__ void col_sums(float* dst, int gid, const float (&v)[D / 128][64]) {
#pragma unroll
  for (int hh = 0; hh < D / 128; ++hh)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float t[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 4 * (4 * k + (i >> 1)) + (i & 1);
        t[i] = v[hh][c] + v[hh][c + 2];
      }
      dst[128 * hh + 32 * k] = reduce8(t, gid);
    }
}

// ---- host ----------------------------------------------------------------------

// A map of a row-major [rows, d] bf16 array, boxes of box_rows rows x 64
// columns in the 128-byte swizzle (rows past `rows` read as 0 and are not
// written); false if the encoder is missing or refuses it.
inline bool bf16_map(CUtensorMap* map, const void* base, int d, int rows, int box_rows) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, d, rows, (uint64_t)d * 2, 64,
                    box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}
// The same for a row array of T (bf16 or f32): boxes of 64 rows x 128 bytes.
template <typename T>
inline bool row_map(CUtensorMap* map, const void* base, int d, int rows) {
  return tensor_map(map,
                    sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                    base, d, rows, (uint64_t)d * sizeof(T), 128 / sizeof(T), ROWS,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// The three f32 [D, D] weights as bf16, one after another in wb ([3 D, D]).
__global__ void wide_weights_kernel(const float* __restrict__ w0, const float* __restrict__ w1,
                                    const float* __restrict__ wf, bf16* __restrict__ wb,
                                    int dd) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * dd) return;
  const float* w = i < dd ? w0 : (i < 2 * dd ? w1 : wf);
  wb[i] = __float2bfloat16_rn(w[i % dd]);
}

inline cudaError_t convert_weights(const float* w0, const float* w1, const float* wf, bf16* wb,
                                   int d, cudaStream_t stream) {
  const int total = 3 * d * d;
  wide_weights_kernel<<<(total + 255) / 256, 256, 0, stream>>>(w0, w1, wf, wb, d * d);
  return cudaGetLastError();
}

}  // namespace tailw
