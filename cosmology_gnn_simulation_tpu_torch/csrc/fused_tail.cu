// K5: fused message-passing step tail, forward.
//
// Replaces the JAX package's TPU kernel ops/fused_step.py::
// _tail_kernel (pallas_call in _tail_core), for the default model's layout
// (latent = hidden = 128, one hidden Linear between the first and final):
//   h   = relu(bf16(x) @ bf16(W0) + agg + b0)
//   h   = relu(bf16(h) @ bf16(W1) + b1)
//   y   = bf16(h) @ bf16(Wf) + bf
//   out = x + LayerNorm(y) * scale + bias          (f32, eps 1e-5)
// Products take bf16 operands into f32 accumulators; agg is read as bf16 (the
// gather path) or f32 (the cell-block path: K4's output) and widened in
// registers; LayerNorm, biases and the residual are f32.
//
// Bound on the H100: bytes. Per row it reads x (512 B f32) and agg (256 B
// bf16) and writes out (512 B) against 3 * 2 * 128 * 128 = 98 kFLOP of bf16
// tensor-core work, 77 FLOP/B, far under the card's ~295 FLOP/B ridge, so
// at N = 65,536 it is 84 MB / 3.35 TB/s = 25 us of traffic vs 6.5 us of math.
// Design: keep every intermediate out of device memory. A persistent block
// (256 threads, 8 warps) converts the three f32 [in, out] weights once into
// bf16 [out][in] shared-memory tiles (row stride 136: conflict-free fragment
// loads), then walks 128-row tiles; each warp owns 16 rows. The products run
// on mma.sync m16n8k16 (bf16 -> f32); a layer's f32 accumulator fragments are
// re-packed in registers as the next layer's bf16 A fragments (the m16n8 C
// layout of n-tiles 2j, 2j+1 is the m16k16 A layout of k-tile j), so h never
// touches shared or global memory. LayerNorm reduces each row across the four
// lanes of a quad with two shuffles. wgmma and TMA wait for a later PR.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;             // latent = hidden width
constexpr int LDW = D + 8;         // bf16 row stride of the weight tiles
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE_ROWS = WARPS * 16;
constexpr int NT = D / 8;          // n-tiles of 8 columns
constexpr int KT = D / 16;         // k-tiles of 16
constexpr size_t kSmemBytes = 3 * D * LDW * sizeof(__nv_bfloat16) + 5 * D * sizeof(float);

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] (16 x 8 tile nt) = A (16 x 128, fragments a[kt]) @ W (smem [n][k]).
__device__ __forceinline__ void gemm(float (&acc)[NT][4], const uint32_t (&a)[KT][4],
                                     const __nv_bfloat16* __restrict__ w, int gid,
                                     int tig) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  }
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* p = w + (nt * 8 + gid) * LDW + kt * 16 + 2 * tig;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 8);
      mma_bf16(acc[nt], a[kt], b0, b1);
    }
  }
}

// Re-pack f32 C fragments as bf16 A fragments of the next product.
__device__ __forceinline__ void to_a(uint32_t (&a)[KT][4], const float (&h)[NT][4]) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    a[kt][0] = pack_bf16(h[2 * kt][0], h[2 * kt][1]);
    a[kt][1] = pack_bf16(h[2 * kt][2], h[2 * kt][3]);
    a[kt][2] = pack_bf16(h[2 * kt + 1][0], h[2 * kt + 1][1]);
    a[kt][3] = pack_bf16(h[2 * kt + 1][2], h[2 * kt + 1][3]);
  }
}

__device__ __forceinline__ float2 load_agg2(const __nv_bfloat16* p, bool ok) {
  return ok ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p))
            : make_float2(0.f, 0.f);
}

__device__ __forceinline__ float2 load_agg2(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float2*>(p) : make_float2(0.f, 0.f);
}

template <typename AggT>
__global__ void __launch_bounds__(THREADS, 1) fused_tail_kernel(
    const float* __restrict__ x, const AggT* __restrict__ agg,
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ wf, const float* __restrict__ bf,
    const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    float* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* vec = reinterpret_cast<float*>(wt + 3 * D * LDW);  // b0 b1 bf scale bias

  const float* ws[3] = {w0, w1, wf};
  for (int l = 0; l < 3; ++l) {
    for (int i = threadIdx.x; i < D * D; i += THREADS) {
      const int kk = i / D, nn = i % D;  // W is [in = k][out = n], f32
      wt[l * D * LDW + nn * LDW + kk] = __float2bfloat16_rn(ws[l][i]);
    }
  }
  const float* vs[5] = {b0, b1, bf, ln_scale, ln_bias};
  for (int i = threadIdx.x; i < 5 * D; i += THREADS) vec[i] = vs[i / D][i % D];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int num_tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int r0 = tile * TILE_ROWS + warp * 16 + gid;  // and r0 + 8
    const bool ok0 = r0 < n, ok1 = r0 + 8 < n;
    const float* x0 = x + (size_t)r0 * D;
    const float* x1 = x0 + 8 * D;

    uint32_t a[KT][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const int c = kt * 16 + 2 * tig;
      const float2 z = make_float2(0.f, 0.f);
      const float2 v0 = ok0 ? *reinterpret_cast<const float2*>(x0 + c) : z;
      const float2 v1 = ok1 ? *reinterpret_cast<const float2*>(x1 + c) : z;
      const float2 v2 = ok0 ? *reinterpret_cast<const float2*>(x0 + c + 8) : z;
      const float2 v3 = ok1 ? *reinterpret_cast<const float2*>(x1 + c + 8) : z;
      a[kt][0] = pack_bf16(v0.x, v0.y);
      a[kt][1] = pack_bf16(v1.x, v1.y);
      a[kt][2] = pack_bf16(v2.x, v2.y);
      a[kt][3] = pack_bf16(v3.x, v3.y);
    }

    float h[NT][4];
    gemm(h, a, wt, gid, tig);
    const AggT* g0 = agg + (size_t)r0 * D;
    const AggT* g1 = g0 + 8 * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tig;
      const float2 e0 = load_agg2(g0 + c, ok0);
      const float2 e1 = load_agg2(g1 + c, ok1);
      h[nt][0] = fmaxf(h[nt][0] + e0.x + vec[c], 0.f);
      h[nt][1] = fmaxf(h[nt][1] + e0.y + vec[c + 1], 0.f);
      h[nt][2] = fmaxf(h[nt][2] + e1.x + vec[c], 0.f);
      h[nt][3] = fmaxf(h[nt][3] + e1.y + vec[c + 1], 0.f);
    }
    to_a(a, h);
    gemm(h, a, wt + D * LDW, gid, tig);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tig;
      h[nt][0] = fmaxf(h[nt][0] + vec[D + c], 0.f);
      h[nt][1] = fmaxf(h[nt][1] + vec[D + c + 1], 0.f);
      h[nt][2] = fmaxf(h[nt][2] + vec[D + c], 0.f);
      h[nt][3] = fmaxf(h[nt][3] + vec[D + c + 1], 0.f);
    }
    to_a(a, h);
    gemm(h, a, wt + 2 * D * LDW, gid, tig);

    // y = h + bf; LayerNorm over each row's 128 columns, which the four
    // lanes of a quad hold 32 apiece (two passes: mean, then variance).
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tig;
      h[nt][0] += vec[2 * D + c];
      h[nt][1] += vec[2 * D + c + 1];
      h[nt][2] += vec[2 * D + c];
      h[nt][3] += vec[2 * D + c + 1];
      s0 += h[nt][0] + h[nt][1];
      s1 += h[nt][2] + h[nt][3];
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    const float mean0 = s0 / D, mean1 = s1 / D;
    float q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      h[nt][0] -= mean0;
      h[nt][1] -= mean0;
      h[nt][2] -= mean1;
      h[nt][3] -= mean1;
      q0 += h[nt][0] * h[nt][0] + h[nt][1] * h[nt][1];
      q1 += h[nt][2] * h[nt][2] + h[nt][3] * h[nt][3];
    }
    q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
    q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
    q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
    q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
    const float rstd0 = rsqrtf(q0 / D + 1e-5f), rstd1 = rsqrtf(q1 / D + 1e-5f);

    float* o0 = out + (size_t)r0 * D;
    float* o1 = o0 + 8 * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tig;
      const float sc0 = vec[3 * D + c], sc1 = vec[3 * D + c + 1];
      const float bb0 = vec[4 * D + c], bb1 = vec[4 * D + c + 1];
      if (ok0) {
        const float2 xv = *reinterpret_cast<const float2*>(x0 + c);
        *reinterpret_cast<float2*>(o0 + c) = make_float2(
            xv.x + (h[nt][0] * rstd0 * sc0 + bb0), xv.y + (h[nt][1] * rstd0 * sc1 + bb1));
      }
      if (ok1) {
        const float2 xv = *reinterpret_cast<const float2*>(x1 + c);
        *reinterpret_cast<float2*>(o1 + c) = make_float2(
            xv.x + (h[nt][2] * rstd1 * sc0 + bb0), xv.y + (h[nt][3] * rstd1 * sc1 + bb1));
      }
    }
  }
}

template <typename AggT>
int launch(const float* x, const AggT* agg, const float* w0, const float* b0,
           const float* w1, const float* b1, const float* wf, const float* bf,
           const float* ln_scale, const float* ln_bias, float* out, int n,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_tail_kernel<AggT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_tail_kernel<AggT>, THREADS, kSmemBytes)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int num_tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  int blocks = sms * per_sm;
  if (blocks > num_tiles) blocks = num_tiles;
  if (blocks < 1) return (int)cudaSuccess;
  fused_tail_kernel<AggT><<<blocks, THREADS, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      x, agg, w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). x, out: [n, 128] f32; agg:
// [n, 128] bf16 (fused_tail_launch) or f32 (fused_tail_f32agg_launch); w0,
// w1, wf: [128, 128] f32 in the JAX [in, out] layout; b0, b1, bf, ln_scale,
// ln_bias: [128] f32. All contiguous, out not aliasing x. Launch on
// `stream`, do not synchronize, return the cudaError_t.
extern "C" int fused_tail_launch(const float* x, const void* agg, const float* w0,
                                 const float* b0, const float* w1, const float* b1,
                                 const float* wf, const float* bf,
                                 const float* ln_scale, const float* ln_bias,
                                 float* out, int n, void* stream) {
  return launch(x, static_cast<const __nv_bfloat16*>(agg), w0, b0, w1, b1, wf, bf,
                ln_scale, ln_bias, out, n, stream);
}

extern "C" int fused_tail_f32agg_launch(const float* x, const void* agg,
                                        const float* w0, const float* b0,
                                        const float* w1, const float* b1,
                                        const float* wf, const float* bf,
                                        const float* ln_scale,
                                        const float* ln_bias, float* out, int n,
                                        void* stream) {
  return launch(x, static_cast<const float*>(agg), w0, b0, w1, b1, wf, bf,
                ln_scale, ln_bias, out, n, stream);
}
