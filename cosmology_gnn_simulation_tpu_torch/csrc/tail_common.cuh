// Device code shared by K5 (fused_tail.cu) and K6 (fused_tail_bwd.cu): the
// tile layouts in shared memory, the bf16 weight copy, the tiles' 2-D
// tensor copies (TMA) and their warpgroup products (wgmma); the PTX they
// share with window_matmul.cu is in sm90.cuh.
//
// Layouts (all 128-byte swizzled, every base 1024-byte aligned: the
// swizzle XORs a row's 16-byte chunk index with row % 8):
// - a weight W [in = k][out = n], bf16: [2 halves of n][128 k rows][64 n].
//   wgmma reads it N-major as B = W (the forward products) and K-major as
//   B = W^T (the backward products), so one copy serves both.
// - a tile of 64 rows x 128 columns, bf16: [2 halves][64 rows][64 columns],
//   which is also what a TMA copy of a bf16 [n, 128] array in two
//   [64 rows][64 columns] boxes writes. Read K-major as a row product's A,
//   M-major as a weight gradient's A (A^T, M = columns), N-major as its B.
// - a tile of 64 rows x 128 f32 columns as TMA writes it in four
//   [64 rows][32 columns] boxes: [4 boxes][64 rows][32 columns].
#pragma once

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace tail {

using namespace sm90;

constexpr int D = 128;                       // latent = hidden width
constexpr int ROWS = 64;                     // rows of a tile: one wgmma M
constexpr int W_BYTES = D * D * 2;           // one bf16 weight, 32 KB
constexpr int ACT_BYTES = ROWS * D * 2;      // one bf16 tile, 16 KB
constexpr int F32_TILE_BYTES = ROWS * D * 4; // one f32 tile, 32 KB
constexpr float LN_EPS = 1e-5f;

// Byte offsets of element (row, col) in the layouts above (col even for
// bf16 pairs, any col for f32).
__device__ __forceinline__ int bf16_off(int row, int col) {
  return (col >> 6) * (ROWS * 128) + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) +
         (col & 7) * 2;
}
__device__ __forceinline__ int weight_off(int k, int n) {
  return (n >> 6) * (D * 128) + k * 128 + ((((n >> 3) & 7) ^ (k & 7)) << 4) + (n & 7) * 2;
}
__device__ __forceinline__ int f32_off(int row, int col) {
  return (col >> 5) * (ROWS * 128) + row * 128 + ((((col >> 2) & 7) ^ (row & 7)) << 4) +
         (col & 3) * 4;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// The three f32 [in, out] weights as bf16 in the weight layout, at dst (a
// shared-memory base 1024-byte aligned, 3 * W_BYTES), by `threads` threads.
__device__ __forceinline__ void load_weights(unsigned char* dst, const float* w0,
                                             const float* w1, const float* wf, int tid,
                                             int threads) {
  const float* ws[3] = {w0, w1, wf};
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    // Chunk i: row k = i / 16, columns 8 (i % 16) .. + 7 -> one 16-byte store.
    for (int i = tid; i < D * D / 8; i += threads) {
      const int k = i >> 4, n = (i & 15) * 8;
      const float4 a = __ldg(reinterpret_cast<const float4*>(ws[l] + k * D + n));
      const float4 b = __ldg(reinterpret_cast<const float4*>(ws[l] + k * D + n + 4));
      *reinterpret_cast<uint4*>(dst + l * W_BYTES + weight_off(k, n)) =
          make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                     pack_bf16(b.z, b.w));
    }
  }
}

// ---- tensor copies ------------------------------------------------------

// Copy rows [row0, row0 + 64) of a [n, 128] array (map with boxes of
// `box_cols` columns x 64 rows) into a tile at dst; rows past n read as 0.
// Completion (`bytes` in all) is reported to bar.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int box_cols,
                                         int row0, uint32_t bar, uint32_t bytes) {
  mbar_expect_tx(bar, bytes);
  for (int c = 0; c < D; c += box_cols)
    tma_load_2d(dst + (c / box_cols) * (ROWS * 128), map, c, row0, bar);
}

// Barrier `id` (1..15) among `count` threads.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- warpgroup products ----------------------------------------------

// Shared-memory matrix descriptors (128-byte swizzle): a start address, a
// leading and a stride byte offset. Each operand is named by a base address
// and a constant offset, and the descriptor is built inside the product's
// own asm from the base: computed outside, the compiler hoists each
// loop-invariant descriptor out of a tile loop into registers of its own
// (two a descriptor, ~100 of them in K6), which spills.
struct Operand {
  uint32_t off;  // byte offset from the base
  uint32_t lbo;  // leading byte offset
};
// k16 step ks of a tile read K-major (a row product's A): 32 bytes along a
// 128-byte row, then the next 64-column half.
__device__ __forceinline__ Operand tile_k(int ks) {
  return {(uint32_t)((ks >> 2) * (ROWS * 128) + (ks & 3) * 32), 16};
}
// k16 step ks (16 rows) of a tile read M- or N-major (a weight gradient's
// operands), starting at 64-column half `half`.
__device__ __forceinline__ Operand tile_mn(int half, int ks) {
  return {(uint32_t)(half * (ROWS * 128) + ks * 16 * 128), ROWS * 128};
}
// k16 step ks of weight l read N-major (B = W) or K-major (B = W^T).
__device__ __forceinline__ Operand weight_n(int l, int ks) {
  return {(uint32_t)(l * W_BYTES + ks * 16 * 128), D * 128};
}
__device__ __forceinline__ Operand weight_k(int l, int ks) {
  return {(uint32_t)(l * W_BYTES + (ks >> 2) * (D * 128) + (ks & 3) * 32), 16};
}
// The operand o moved by `bytes` (another tile or weight from the same base).
__device__ __forceinline__ Operand at(Operand o, uint32_t bytes) { return {o.off + bytes, o.lbo}; }
// PTX: descriptor d<x> from base %<b> + offset %<o>, leading offset field %<l>.
#define TAIL_DESC(x, b, o, l)                                                                \
  "add.u32 a" x ", " b ", " o ";\n"                                                          \
  "shr.u32 a" x ", a" x ", 4;\n"                                                             \
  "or.b32 a" x ", a" x ", " l ";\n"                                                          \
  "mov.b64 d" x ", {a" x ", hi};\n"
constexpr uint32_t DESC_HI = (1024u >> 4) | (1u << 30);  // stride 1024, 128-byte swizzle

#define TAIL_WGMMA_D64                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define TAIL_WGMMA_D64_OUT(d)                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),             \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),          \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),          \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),          \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),          \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),          \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),          \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128 f32 per warpgroup) = A (64 x 16 bf16) x B (16 x 128 bf16)
// + (scale_d ? d : 0), A and B read from shared memory at a_base + a.off
// and b_base + b.off; TA / TB: A M-major / B N-major (else K-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint32_t a_base, Operand a,
                                         uint32_t b_base, Operand b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 aa, ab, hi;\n"
      ".reg .b64 da, db;\n"
      "mov.b32 hi, %72;\n" TAIL_DESC("a", "%64", "%65", "%66") TAIL_DESC("b", "%67", "%68", "%69")
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TAIL_WGMMA_D64
      ", da, db, p, 1, 1, %71, %73;\n"
      "}\n"
      : TAIL_WGMMA_D64_OUT(d)
      : "r"(a_base), "r"(a.off), "r"((a.lbo >> 4) << 16), "r"(b_base), "r"(b.off),
        "r"((b.lbo >> 4) << 16), "r"(scale_d), "n"(TA), "r"(DESC_HI), "n"(TB));
}

// The same with A from registers: a[0..3] is the warp's 16 rows x 16 k in
// the m16n8k16 A-fragment layout; B N-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint32_t b_base, Operand b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 ab, hi;\n"
      ".reg .b64 db;\n"
      "mov.b32 hi, %72;\n" TAIL_DESC("b", "%68", "%69", "%70")
      "setp.ne.b32 p, %71, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TAIL_WGMMA_D64
      ", {%64, %65, %66, %67}, db, p, 1, 1, 1;\n"
      "}\n"
      : TAIL_WGMMA_D64_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b_base), "r"(b.off),
        "r"((b.lbo >> 4) << 16), "r"(scale_d), "r"(DESC_HI));
}

// Two f32 of a small constant vector, loaded where they are used (an opaque
// load: the compiler cannot hoist a tile loop's worth of them into
// registers).
__device__ __forceinline__ float2 ld_vec2(const float* p) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "l"(p));
  return v;
}

// Accumulator layout of m64n128 (thread t of the warpgroup, warp w = t / 32,
// g = lane / 4, q = lane % 4): d[4 j + e] is row 16 w + g + 8 (e >> 1),
// column 8 j + 2 q + (e & 1).

// Sum over the four lanes of a quad (a row's 128 columns).
__device__ __forceinline__ float quad_sum(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// out[i] = sum over blocks b (in order) of partials[b * len + i], i < len.
__global__ void reduce_partials_kernel(const float* __restrict__ partials, int blocks, int len,
                                       float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partials[(size_t)b * len + i];
  out[i] = s;
}

// ---- host: tensor maps --------------------------------------------------

// A map of a row-major [n, 128] array of 2- or 4-byte elements, boxes of
// 64 rows x 128 bytes in the 128-byte swizzle (rows past n read as 0);
// false if the encoder is missing or refuses it.
inline bool tile_map(CUtensorMap* map, const void* base, int n, int elem_bytes) {
  return tensor_map(
      map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      base, D, n, (uint64_t)D * elem_bytes, 128 / elem_bytes, ROWS, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A kernel's launch setup, once per device: its dynamic shared memory
// limit raised to `smem` bytes and, where `regs` > 0, a check that it runs
// with exactly `regs` registers a thread (cudaErrorInvalidDeviceFunction
// otherwise). Sets *sms to the device's SM count.
template <auto Kernel>
inline cudaError_t launch_setup(int smem, int regs, int* sms) {
  constexpr int MAX_DEVICES = 64;
  static int ready[MAX_DEVICES] = {};  // the device's SM count once set up
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES && ready[device] > 0) {
    *sms = ready[device];
    return cudaSuccess;
  }
  if ((err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return err;
  if (regs > 0) {
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, Kernel)) != cudaSuccess) return err;
    if (attr.numRegs != regs) return cudaErrorInvalidDeviceFunction;
  }
  int count = 0;
  if ((err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if (count < 1) return cudaErrorInvalidDevice;
  if (device < MAX_DEVICES) ready[device] = count;
  *sms = count;
  return cudaSuccess;
}

}  // namespace tail
