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
//
// Design: keep every intermediate out of device memory and the stream of x
// and agg always in flight. A persistent block of two warpgroups converts
// the three weights once into bf16 shared-memory copies (tail_common.cuh's
// swizzled layout, B of wgmma by descriptor), then each warpgroup walks
// 64-row tiles of its own. Each warpgroup has one stage (x f32 and agg) that
// one of its threads fills by TMA; x is read from the stage into registers
// once (the residual's f32 values and the first product's bf16 A
// fragments), after which the stage's x half is refilled with the next
// tile, and agg's half is refilled as soon as the first layer has read it,
// so the next tile's copies run under this tile's three products. The
// products are wgmma m64n128k16 with A in registers: a layer's f32
// accumulators are re-packed as the next layer's bf16 A fragments (the
// accumulator layout of columns 16 kt .. 16 kt + 15 is the A-fragment layout
// of k-step kt), so h never touches shared or device memory. LayerNorm
// reduces each row across the four lanes of a quad with two shuffles.
//
// Width 256, and a bf16 carry at either width, take the width-general
// variant in fused_tail_wide.cu.
#include "tail_common.cuh"

namespace {

using namespace tail;

constexpr int WGS = 2;
constexpr int THREADS = WGS * 128;
constexpr int X_BYTES = F32_TILE_BYTES;

template <typename AggT>
struct Smem {
  static constexpr int AGG_BYTES = ROWS * D * (int)sizeof(AggT);
  static constexpr int STAGE = X_BYTES + AGG_BYTES;
  static constexpr int STAGES0 = 3 * W_BYTES;
  static constexpr int BYTES = STAGES0 + WGS * STAGE + 1024;  // + alignment
};
static_assert(Smem<float>::BYTES <= 227 * 1024, "shared memory");

__device__ __forceinline__ float2 agg_pair(const unsigned char* tile, int row, int col,
                                           const __nv_bfloat16*) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + bf16_off(row, col)));
}
__device__ __forceinline__ float2 agg_pair(const unsigned char* tile, int row, int col,
                                           const float*) {
  return *reinterpret_cast<const float2*>(tile + f32_off(row, col));
}

// Re-pack accumulators (64 f32) as the bf16 A fragments of the next product.
__device__ __forceinline__ void to_a(uint32_t (&a)[8][4], const float (&h)[64]) {
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {
    a[kt][0] = pack_bf16(h[8 * kt + 0], h[8 * kt + 1]);
    a[kt][1] = pack_bf16(h[8 * kt + 2], h[8 * kt + 3]);
    a[kt][2] = pack_bf16(h[8 * kt + 4], h[8 * kt + 5]);
    a[kt][3] = pack_bf16(h[8 * kt + 6], h[8 * kt + 7]);
  }
}

// acc = A (registers) x weight l (N-major, in the weights at wbase).
__device__ __forceinline__ void product(float (&acc)[64], const uint32_t (&a)[8][4],
                                        uint32_t wbase, int l) {
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) wgmma_rs(acc, a[kt], wbase, weight_n(l, kt), kt > 0);
  wgmma_commit();
  wgmma_wait_all();
}

template <typename AggT>
__global__ void __launch_bounds__(THREADS, 1) fused_tail_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap agg_map,
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ wf, const float* __restrict__ bf,
    const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    float* __restrict__ out, int n) {
  using S = Smem<AggT>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * WGS];  // x_full[wg], agg_full[wg]

  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t smem0 = (raw0 + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (smem0 - raw0);

  const int wg = threadIdx.x >> 7, wtid = threadIdx.x & 127;
  const int warp = wtid >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int num_tiles = (n + ROWS - 1) / ROWS;
  const uint32_t x_full = smem_addr(&bars[wg]), agg_full = smem_addr(&bars[WGS + wg]);
  const int agg_box = 128 / (int)sizeof(AggT);
  const unsigned char* x_tile = smem + S::STAGES0 + wg * S::STAGE;
  const unsigned char* agg_tile = x_tile + X_BYTES;
  const uint32_t x_dst = smem0 + S::STAGES0 + wg * S::STAGE, agg_dst = x_dst + X_BYTES;

  // Warpgroup wg walks tiles 2 p + wg, p = blockIdx.x, + gridDim.x, ...
  int tile = 2 * blockIdx.x + wg;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * WGS; ++i) mbar_init(smem_addr(&bars[i]), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (wtid == 0 && tile < num_tiles) {
    tma_tile(x_dst, &x_map, 32, tile * ROWS, x_full, X_BYTES);
    tma_tile(agg_dst, &agg_map, agg_box, tile * ROWS, agg_full, S::AGG_BYTES);
  }
  load_weights(smem, w0, w1, wf, threadIdx.x, THREADS);
  fence_async_smem();
  __syncthreads();

  const uint32_t wt = smem0;
  const int r0 = 16 * warp + gid, r1 = r0 + 8;  // the thread's two rows of a tile
  for (uint32_t it = 0; tile < num_tiles; ++it) {
    const uint32_t par = it & 1;
    const int next = tile + 2 * gridDim.x;

    // x: the residual in f32 and the first product's A fragments.
    mbar_wait(x_full, par);
    float xr[64];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * tig;
      const float2 u = *reinterpret_cast<const float2*>(x_tile + f32_off(r0, c));
      const float2 v = *reinterpret_cast<const float2*>(x_tile + f32_off(r1, c));
      xr[4 * j] = u.x; xr[4 * j + 1] = u.y; xr[4 * j + 2] = v.x; xr[4 * j + 3] = v.y;
    }
    named_barrier(1 + wg, 128);  // the warpgroup is done reading x
    if (wtid == 0 && next < num_tiles) tma_tile(x_dst, &x_map, 32, next * ROWS, x_full, X_BYTES);

    uint32_t a[8][4];
    to_a(a, xr);
    float h[64];
    product(h, a, wt, 0);

    mbar_wait(agg_full, par);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * tig;
      const float2 bb = ld_vec2(b0 + c);
      const float2 e0 = agg_pair(agg_tile, r0, c, (const AggT*)nullptr);
      const float2 e1 = agg_pair(agg_tile, r1, c, (const AggT*)nullptr);
      h[4 * j] = fmaxf(h[4 * j] + e0.x + bb.x, 0.f);
      h[4 * j + 1] = fmaxf(h[4 * j + 1] + e0.y + bb.y, 0.f);
      h[4 * j + 2] = fmaxf(h[4 * j + 2] + e1.x + bb.x, 0.f);
      h[4 * j + 3] = fmaxf(h[4 * j + 3] + e1.y + bb.y, 0.f);
    }
    named_barrier(1 + wg, 128);  // the warpgroup is done reading agg
    if (wtid == 0 && next < num_tiles)
      tma_tile(agg_dst, &agg_map, agg_box, next * ROWS, agg_full, S::AGG_BYTES);

    to_a(a, h);
    product(h, a, wt, 1);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bb = ld_vec2(b1 + 8 * j + 2 * tig);
      h[4 * j] = fmaxf(h[4 * j] + bb.x, 0.f);
      h[4 * j + 1] = fmaxf(h[4 * j + 1] + bb.y, 0.f);
      h[4 * j + 2] = fmaxf(h[4 * j + 2] + bb.x, 0.f);
      h[4 * j + 3] = fmaxf(h[4 * j + 3] + bb.y, 0.f);
    }
    to_a(a, h);
    product(h, a, wt, 2);

    // y = h + bf; LayerNorm over each row (two passes: mean, then variance).
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bb = ld_vec2(bf + 8 * j + 2 * tig);
      h[4 * j] += bb.x;
      h[4 * j + 1] += bb.y;
      h[4 * j + 2] += bb.x;
      h[4 * j + 3] += bb.y;
      s0 += h[4 * j] + h[4 * j + 1];
      s1 += h[4 * j + 2] + h[4 * j + 3];
    }
    const float mean0 = quad_sum(s0) / D, mean1 = quad_sum(s1) / D;
    float q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      h[4 * j] -= mean0;
      h[4 * j + 1] -= mean0;
      h[4 * j + 2] -= mean1;
      h[4 * j + 3] -= mean1;
      q0 += h[4 * j] * h[4 * j] + h[4 * j + 1] * h[4 * j + 1];
      q1 += h[4 * j + 2] * h[4 * j + 2] + h[4 * j + 3] * h[4 * j + 3];
    }
    const float rstd0 = rsqrtf(quad_sum(q0) / D + LN_EPS);
    const float rstd1 = rsqrtf(quad_sum(q1) / D + LN_EPS);

    const int g0 = tile * ROWS + r0, g1 = g0 + 8;
    float* o0 = out + (size_t)g0 * D;
    float* o1 = out + (size_t)g1 * D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * tig;
      const float2 sc = ld_vec2(ln_scale + c);
      const float2 bb = ld_vec2(ln_bias + c);
      if (g0 < n)
        *reinterpret_cast<float2*>(o0 + c) =
            make_float2(xr[4 * j] + (h[4 * j] * rstd0 * sc.x + bb.x),
                        xr[4 * j + 1] + (h[4 * j + 1] * rstd0 * sc.y + bb.y));
      if (g1 < n)
        *reinterpret_cast<float2*>(o1 + c) =
            make_float2(xr[4 * j + 2] + (h[4 * j + 2] * rstd1 * sc.x + bb.x),
                        xr[4 * j + 3] + (h[4 * j + 3] * rstd1 * sc.y + bb.y));
    }
    tile = next;
  }
}

template <typename AggT>
int launch(const float* x, const AggT* agg, const float* w0, const float* b0,
           const float* w1, const float* b1, const float* wf, const float* bf,
           const float* ln_scale, const float* ln_bias, float* out, int n,
           void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  CUtensorMap x_map = {}, agg_map = {};
  if (!tile_map(&x_map, x, n, 4) || !tile_map(&agg_map, agg, n, (int)sizeof(AggT)))
    return (int)cudaErrorInvalidValue;
  const int smem = Smem<AggT>::BYTES;
  int sms = 0;
  const cudaError_t err = launch_setup<fused_tail_kernel<AggT>>(smem, 0, &sms);
  if (err != cudaSuccess) return (int)err;
  const int pairs = ((n + ROWS - 1) / ROWS + WGS - 1) / WGS;
  const int blocks = pairs < sms ? pairs : sms;
  fused_tail_kernel<AggT><<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x_map, agg_map, w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). x, out: [n, 128] f32; agg:
// [n, 128] bf16 (fused_tail_launch) or f32 (fused_tail_f32agg_launch); w0,
// w1, wf: [128, 128] f32 in the JAX [in, out] layout; b0, b1, bf, ln_scale,
// ln_bias: [128] f32. All contiguous, x and agg 16-byte aligned, out not
// aliasing x. Launch on `stream`, do not synchronize, return the
// cudaError_t.
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
