// Device code of the width-general variants of K5 (fused_tail.cu) and K6
// (fused_tail_bwd.cu): latent = hidden = D, D = 128 or 256, one hidden
// Linear, the carry x in f32 or bf16, agg in f32 or bf16. The tuned
// kernels of tail_common.cuh hold all three bf16 weights of a 128-wide
// model in shared memory (96 KB); at D = 256 they take 384 KB, more than
// an SM has, so these kernels stream each weight through shared memory in
// k-slabs by asynchronous copies (cp.async), two slabs in flight.
//
// Numerics are the Pallas kernels': products on bf16 operands into f32
// sums (mma.sync m16n8k16), LayerNorm, biases and the residual in f32, the
// new carry rounded once to x's dtype, dx written in x's dtype and dagg in
// agg's.
//
// Layout of a block (256 threads, 8 warps as 2 row groups x 4 column
// groups): a tile of 64 rows, one bf16 activation tile [64][D + 8] in
// shared memory (the A operand of every product), and a warp's 32 rows x
// D / 4 columns of each product's f32 result in registers (the mma
// accumulator layout: thread (g = lane / 4, t = lane % 4) holds rows g and
// g + 8 of each 16-row tile, columns 2t and 2t + 1 of each 8-column tile).
// The rows of a product's result are spread over the four column-group
// warps, so LayerNorm's row sums go through shared memory; the backward's
// column sums (the bias and LayerNorm gradients) likewise across the two
// row groups. Row strides of D + 8 and KS + 8 bf16 keep every ldmatrix
// free of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tailw {

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;      // rows of a tile
constexpr int THREADS = 256;  // 8 warps: 2 row groups x 4 column groups
constexpr int KS = 32;        // k of a weight slab
constexpr float LN_EPS = 1e-5f;

template <int D>
struct Wide {
  static constexpr int NT = D / 32;      // 8-column mma tiles of a warp's D / 4 columns
  static constexpr int ALD = D + 8;      // activation row stride, bf16
  static constexpr int NS = D / KS;      // slabs of a weight
  static constexpr int ACT_BYTES = ROWS * ALD * 2;
  // A slab of W (k rows x D columns) or of W^T (D rows of W x k columns).
  static constexpr int SLAB_ELEMS = KS * (D + 8) > D * (KS + 8) ? KS * (D + 8) : D * (KS + 8);
  static constexpr int SLAB_BYTES = SLAB_ELEMS * 2;
  static constexpr int OFF_SLAB = ACT_BYTES;
  static constexpr int OFF_RED = OFF_SLAB + 2 * SLAB_BYTES;  // [ROWS][4] f32: row partial sums
  static constexpr int OFF_CS = OFF_RED + ROWS * 4 * 4;      // [2][D] f32: column partial sums
  static constexpr int OFF_RUN = OFF_CS + 2 * D * 4;         // [5][D] f32: the block's column sums
  static constexpr int FWD_BYTES = OFF_CS;
  static constexpr int BWD_BYTES = OFF_RUN + 5 * D * 4;
};

// ---- PTX -----------------------------------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; zeros where !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d (16 x 8 f32) += a (16 x 16 bf16) b (16 x 8 bf16).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 consecutive elements as bf16 (16 bytes).
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                    pack_bf16(b.z, b.w));
}
__device__ __forceinline__ uint4 load8(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The thread's place in a tile: warp (wr, wc), lane (g, t).
struct Lane {
  int tid, wr, wc, g, t;
  __device__ __forceinline__ Lane() {
    tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    wr = warp >> 2;
    wc = warp & 3;
    g = lane >> 2;
    t = lane & 3;
  }
  // Tile row of accumulator (i, e) and column of (j, e) (e: 0..3).
  __device__ __forceinline__ int row(int i, int e) const {
    return wr * 32 + i * 16 + g + 8 * (e >> 1);
  }
  template <int D>
  __device__ __forceinline__ int col(int j, int e) const {
    return wc * (D / 4) + j * 8 + 2 * t + (e & 1);
  }
};

// ---- tiles ---------------------------------------------------------------

// Rows [row0, row0 + 64) of a [n, D] array into the activation tile as bf16
// (zeros past n).
template <int D, typename T>
__device__ __forceinline__ void load_act(unsigned char* smem, const T* src, int row0, int n) {
  bf16* act = reinterpret_cast<bf16*>(smem);
  constexpr int CPR = D / 8;
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR, q = c % CPR;
    const uint4 v = row0 + r < n ? load8(src + (size_t)(row0 + r) * D + q * 8)
                                 : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(act + r * Wide<D>::ALD + q * 8) = v;
  }
}

// The activation tile to rows [row0, ...) of a [n, D] bf16 array (rows < n).
template <int D>
__device__ __forceinline__ void store_act(bf16* dst, const unsigned char* smem, int row0, int n) {
  const bf16* act = reinterpret_cast<const bf16*>(smem);
  constexpr int CPR = D / 8;
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR, q = c % CPR;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * D + q * 8) =
          *reinterpret_cast<const uint4*>(act + r * Wide<D>::ALD + q * 8);
  }
}

// The accumulators, rounded to bf16, as the activation tile.
template <int D>
__device__ __forceinline__ void stage(unsigned char* smem, const float (&v)[2][D / 32][4],
                                      const Lane& l) {
  bf16* act = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(act + l.row(i, 2 * h) * Wide<D>::ALD + l.col<D>(j, 0)) =
            pack_bf16(v[i][j][2 * h], v[i][j][2 * h + 1]);
}

// Slab s of a bf16 weight w [D][D] ([in][out]) into buffer buf: WT = false,
// B = W, rows k = in [s KS, + KS) and every column; WT = true, B = W^T (k =
// out), every row of W and columns [s KS, + KS). One commit group.
template <int D, bool WT>
__device__ __forceinline__ void issue_slab(unsigned char* smem, int buf, const bf16* w, int s) {
  bf16* dst = reinterpret_cast<bf16*>(smem + Wide<D>::OFF_SLAB + buf * Wide<D>::SLAB_BYTES);
  if (!WT) {
    constexpr int CPR = D / 8;
    for (int c = threadIdx.x; c < KS * CPR; c += THREADS) {
      const int r = c / CPR, q = c % CPR;
      cp_async16(saddr(dst + r * (D + 8) + q * 8), w + (size_t)(s * KS + r) * D + q * 8, true);
    }
  } else {
    constexpr int CPR = KS / 8;
    for (int c = threadIdx.x; c < D * CPR; c += THREADS) {
      const int r = c / CPR, q = c % CPR;
      cp_async16(saddr(dst + r * (KS + 8) + q * 8), w + (size_t)r * D + s * KS + q * 8, true);
    }
  }
  cp_commit();
}

// acc = act (64 x D, bf16) x B, B = w (WT = false) or w^T (WT = true), w a
// bf16 [D][D] weight in device memory streamed in slabs. The activation
// tile must be written (and fenced by a barrier or by this function's first
// barrier) before the call; returns after a barrier, every read done.
template <int D, bool WT>
__device__ __forceinline__ void product(float (&acc)[2][D / 32][4], unsigned char* smem,
                                        const bf16* w, const Lane& l) {
  using L = Wide<D>;
  constexpr int NT = D / 32;
  const int lane = l.tid & 31, q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const uint32_t act = saddr(smem);
  issue_slab<D, WT>(smem, 0, w, 0);
  for (int s = 0; s < L::NS; ++s) {
    if (s + 1 < L::NS) {
      issue_slab<D, WT>(smem, (s + 1) & 1, w, s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const uint32_t slab = saddr(smem + L::OFF_SLAB + (s & 1) * L::SLAB_BYTES);
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      const int k0 = s * KS + kk * 16;
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i],
                act + ((l.wr * 32 + i * 16 + (lane & 15)) * L::ALD + k0 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        const int n0 = l.wc * (D / 4) + jp * 16;
        uint32_t b[4];
        if (!WT)
          ldsm_x4_t(b, slab + ((kk * 16 + (q & 1) * 8 + r) * (D + 8) + n0 + (q >> 1) * 8) * 2);
        else
          ldsm_x4(b, slab + ((n0 + (q >> 1) * 8 + r) * (KS + 8) + kk * 16 + (q & 1) * 8) * 2);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(acc[i][2 * jp], a[i], b[0], b[1]);
          mma(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
}

// Sum over each row's D columns of f(i, j, e) (the accumulator (i, j, e)'s
// term): out[i][h] for the thread's rows row(i, 2h). Through shared memory;
// ends with a barrier.
template <int D, typename F>
__device__ __forceinline__ void row_sums(float (&out)[2][2], unsigned char* smem, const Lane& l,
                                         F f) {
  float* red = reinterpret_cast<float*>(smem + Wide<D>::OFF_RED);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) s += f(i, j, 2 * h) + f(i, j, 2 * h + 1);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (l.t == 0) red[l.row(i, 2 * h) * 4 + l.wc] = s;
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* p = red + l.row(i, 2 * h) * 4;
      out[i][h] = ((p[0] + p[1]) + p[2]) + p[3];
    }
  __syncthreads();
}

// run[c] += the tile's sum over its 64 rows of f(i, j, e) in column c, in a
// fixed order (each warp over its rows, then row group 0 + row group 1).
// Ends with a barrier.
template <int D, typename F>
__device__ __forceinline__ void col_sums(float* run, unsigned char* smem, const Lane& l, F f) {
  float* cs = reinterpret_cast<float*>(smem + Wide<D>::OFF_CS);
#pragma unroll
  for (int j = 0; j < D / 32; ++j)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float s = (f(0, j, p) + f(0, j, p + 2)) + (f(1, j, p) + f(1, j, p + 2));
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (l.g == 0) cs[l.wr * D + l.col<D>(j, p)] = s;
    }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += THREADS) run[c] += cs[c] + cs[D + c];
  __syncthreads();
}

// The three f32 [D, D] weights as bf16, one after another in wb.
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
