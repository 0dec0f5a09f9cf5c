// K6: fused recompute-backward of the message-passing step tail.
//
// Replaces the JAX package's TPU kernel ops/fused_step.py::
// _tail_bwd_kernel (pallas_call in _tail_core_bwd), for K5's layout
// (latent = hidden = 128, one hidden Linear, bf16 operands). Per row, from
// the forward's inputs (x, agg) and the output's cotangent g:
//   pre0 = x W0 + agg + b0, h0 = relu(pre0); pre1 = h0 W1 + b1,
//   h1 = relu(pre1); y = h1 Wf + bf; yn = LN(y)          (recomputed)
//   dyn = g * scale; dy = rstd (dyn - mean(dyn) - yn mean(dyn yn))
//   dpre1 = [pre1 > 0] dy Wf^T;  dpre0 = [pre0 > 0] dpre1 W1^T
//   dx = g + dpre0 W0^T;  dagg = dpre0
// and, summed over all rows, dWf = h1^T dy, dW1 = h0^T dpre1,
// dW0 = x^T dpre0, db0, db1, dbf (column sums of dpre0, dpre1, dy),
// dscale = sum g * yn, dbias = sum g. Every product takes bf16 operands
// into f32 sums, as the TPU kernel does; dx and the sums are f32, dagg
// keeps agg's type (bf16 on the gather path, f32 on the cell-block path).
//
// Bound on the H100: bytes. At N = 65,536 it must read x (33.5 MB), agg
// (16.8 or 33.5 MB) and g (33.5 MB) and write dx (33.5 MB) and dagg: 134 to
// 168 MB, 40 to 50 us; its nine 128 x 128 products per row are 19.3 GFLOP
// of bf16, 20 us. Design: the TPU kernel sums the weight gradients across
// a sequential grid in VMEM; here blocks run in parallel and in no order.
// A persistent grid (one block of 8 warps per SM) walks 128-row tiles; each
// warp owns 16 rows and keeps them in registers through the recomputed
// forward and the backward chain (C fragments re-packed as the next
// product's A fragments, as in K5). The block stages the tile's bf16
// activations and row gradients (h0, h1 or x, and dy, dpre1, dpre0) in
// shared memory, and for each weight each warp adds its 16-row slab of
// A^T D (a contraction over the tile's rows on mma.sync) into the block's
// own f32 partial in device memory (L2-resident; read, added, written by
// the same warp each tile, so no atomics). The column sums (bias and LN
// gradients) reduce over a warp's rows with shuffles into a per-warp
// shared-memory row. A second small kernel sums the blocks' partials in a
// fixed order, so the result is the same from run to run. The three weights
// sit in shared memory once per block as bf16 in their [in, out] layout:
// the backward products read B fragments as 32-bit pairs, the forward ones
// as two 16-bit halves. wgmma, TMA and ldmatrix wait for a later PR.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;             // latent = hidden width
constexpr int LDW = D + 8;         // bf16 row stride of weights and activations
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE_ROWS = WARPS * 16;
constexpr int NT = D / 8;          // n-tiles of 8 columns
constexpr int KT = D / 16;         // k-tiles of 16
constexpr int NVEC = 5;            // db0, db1, dbf, dscale, dbias
constexpr int WGRAD = 3 * D * D;   // dW0, dW1, dWf
constexpr int PART = WGRAD + NVEC * D;  // floats of one block's partial
constexpr size_t kSmemBytes = 6 * (size_t)D * LDW * sizeof(__nv_bfloat16) +
                              (5 + WARPS * NVEC) * D * sizeof(float);

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

__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  }
}

// acc = A (16 x 128, fragments a) @ W, W in shared memory as [k][n] = [in][out].
__device__ __forceinline__ void gemm_fwd(float (&acc)[NT][4], const uint32_t (&a)[KT][4],
                                         const uint16_t* __restrict__ w, int gid, int tig) {
  zero(acc);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint16_t* p = w + (kt * 16 + 2 * tig) * LDW + nt * 8 + gid;
      const uint32_t b0 = (uint32_t)p[0] | ((uint32_t)p[LDW] << 16);
      const uint32_t b1 = (uint32_t)p[8 * LDW] | ((uint32_t)p[9 * LDW] << 16);
      mma_bf16(acc[nt], a[kt], b0, b1);
    }
  }
}

// acc = A (16 x 128, fragments a) @ W^T, W in shared memory as [in][out]:
// B[k][n] = W[n][k], whose k pairs are contiguous.
__device__ __forceinline__ void gemm_bwd(float (&acc)[NT][4], const uint32_t (&a)[KT][4],
                                         const uint16_t* __restrict__ w, int gid, int tig) {
  zero(acc);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint16_t* p = w + (nt * 8 + gid) * LDW + kt * 16 + 2 * tig;
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

// Write a warp's 16 rows of bf16 A fragments to a [row][LDW] tile.
__device__ __forceinline__ void stage(uint16_t* __restrict__ act, const uint32_t (&a)[KT][4],
                                      int warp, int gid, int tig) {
  uint16_t* r0 = act + (warp * 16 + gid) * LDW + 2 * tig;
  uint16_t* r1 = r0 + 8 * LDW;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    *reinterpret_cast<uint32_t*>(r0 + kt * 16) = a[kt][0];
    *reinterpret_cast<uint32_t*>(r1 + kt * 16) = a[kt][1];
    *reinterpret_cast<uint32_t*>(r0 + kt * 16 + 8) = a[kt][2];
    *reinterpret_cast<uint32_t*>(r1 + kt * 16 + 8) = a[kt][3];
  }
}

// Sum over the 8 rows (gid) a quad column holds; all lanes get the sum.
__device__ __forceinline__ float col_reduce(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 8);
  s += __shfl_xor_sync(0xffffffffu, s, 16);
  return s;
}

// Sum over the 4 lanes of a quad (a row's 128 columns); all lanes get it.
__device__ __forceinline__ float row_reduce(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// dst[c] += sum over the warp's 16 rows of v[row][c].
__device__ __forceinline__ void col_sums(float* __restrict__ dst, const float (&v)[NT][4],
                                         int gid, int tig) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float s0 = col_reduce(v[nt][0] + v[nt][2]);
    const float s1 = col_reduce(v[nt][1] + v[nt][3]);
    if (gid == 0) {
      dst[nt * 8 + 2 * tig] += s0;
      dst[nt * 8 + 2 * tig + 1] += s1;
    }
  }
}

// The block's partial dW[in][out] slab rows [16 warp, 16 warp + 16) +=
// A^T Dm over the tile's rows, A = act_a [row][in], Dm = act_d [row][out].
__device__ __forceinline__ void weight_grad(float* __restrict__ part,
                                            const uint16_t* __restrict__ act_a,
                                            const uint16_t* __restrict__ act_d, bool first,
                                            int warp, int gid, int tig) {
  const int m0 = warp * 16;
  float acc[NT][4];
  float* p0 = part + (size_t)(m0 + gid) * D + 2 * tig;
  float* p1 = p0 + 8 * D;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (first) {
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    } else {
      const float2 u = *reinterpret_cast<const float2*>(p0 + nt * 8);
      const float2 v = *reinterpret_cast<const float2*>(p1 + nt * 8);
      acc[nt][0] = u.x; acc[nt][1] = u.y; acc[nt][2] = v.x; acc[nt][3] = v.y;
    }
  }
#pragma unroll
  for (int ks = 0; ks < TILE_ROWS / 16; ++ks) {
    const uint16_t* pa = act_a + (ks * 16 + 2 * tig) * LDW + m0 + gid;
    uint32_t a[4];
    a[0] = (uint32_t)pa[0] | ((uint32_t)pa[LDW] << 16);
    a[1] = (uint32_t)pa[8] | ((uint32_t)pa[LDW + 8] << 16);
    a[2] = (uint32_t)pa[8 * LDW] | ((uint32_t)pa[9 * LDW] << 16);
    a[3] = (uint32_t)pa[8 * LDW + 8] | ((uint32_t)pa[9 * LDW + 8] << 16);
    const uint16_t* pd = act_d + (ks * 16 + 2 * tig) * LDW + gid;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint16_t* q = pd + nt * 8;
      const uint32_t b0 = (uint32_t)q[0] | ((uint32_t)q[LDW] << 16);
      const uint32_t b1 = (uint32_t)q[8 * LDW] | ((uint32_t)q[9 * LDW] << 16);
      mma_bf16(acc[nt], a, b0, b1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<float2*>(p0 + nt * 8) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(p1 + nt * 8) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

__device__ __forceinline__ float2 load2(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float2*>(p) : make_float2(0.f, 0.f);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p, bool ok) {
  return ok ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p))
            : make_float2(0.f, 0.f);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Load a warp's 16 rows of f32 x as bf16 A fragments (zero past n).
__device__ __forceinline__ void load_x(uint32_t (&a)[KT][4], const float* x0, const float* x1,
                                       bool ok0, bool ok1, int tig) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const int c = kt * 16 + 2 * tig;
    const float2 v0 = load2(x0 + c, ok0), v1 = load2(x1 + c, ok1);
    const float2 v2 = load2(x0 + c + 8, ok0), v3 = load2(x1 + c + 8, ok1);
    a[kt][0] = pack_bf16(v0.x, v0.y);
    a[kt][1] = pack_bf16(v1.x, v1.y);
    a[kt][2] = pack_bf16(v2.x, v2.y);
    a[kt][3] = pack_bf16(v3.x, v3.y);
  }
}

template <typename AggT>
__global__ void __launch_bounds__(THREADS, 1) fused_tail_bwd_kernel(
    const float* __restrict__ x, const AggT* __restrict__ agg, const float* __restrict__ g,
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ wf, const float* __restrict__ bf,
    const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    float* __restrict__ dx, AggT* __restrict__ dagg, float* __restrict__ partials, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* wt = reinterpret_cast<uint16_t*>(smem_raw);  // W0, W1, Wf: [in][out] bf16
  uint16_t* act = wt + 3 * D * LDW;                      // 3 activation tiles
  uint16_t* act_h0 = act;
  uint16_t* act_a = act + D * LDW;   // h1, then x
  uint16_t* act_d = act + 2 * D * LDW;  // dy, then dpre1, then dpre0
  float* vec = reinterpret_cast<float*>(act + 3 * D * LDW);  // b0 b1 bf scale bias
  float* vacc = vec + 5 * D;  // [WARPS][NVEC][D] per-warp column sums

  const float* ws[3] = {w0, w1, wf};
  for (int l = 0; l < 3; ++l) {
    for (int i = threadIdx.x; i < D * D; i += THREADS) {
      const __nv_bfloat16 v = __float2bfloat16_rn(ws[l][i]);
      wt[l * D * LDW + (i / D) * LDW + i % D] = *reinterpret_cast<const uint16_t*>(&v);
    }
  }
  const float* vs[5] = {b0, b1, bf, ln_scale, ln_bias};
  for (int i = threadIdx.x; i < 5 * D; i += THREADS) vec[i] = vs[i / D][i % D];
  for (int i = threadIdx.x; i < WARPS * NVEC * D; i += THREADS) vacc[i] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float* my_acc = vacc + warp * NVEC * D;  // rows: db0, db1, dbf, dscale, dbias
  float* part = partials + (size_t)blockIdx.x * PART;
  const int num_tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int r0 = tile * TILE_ROWS + warp * 16 + gid;  // and r0 + 8
    const bool ok0 = r0 < n, ok1 = r0 + 8 < n;
    const size_t o0 = (size_t)r0 * D, o1 = o0 + 8 * D;

    // ---- recompute the forward --------------------------------------
    uint32_t a[KT][4];
    load_x(a, x + o0, x + o1, ok0, ok1, tig);
    float h[NT][4];
    gemm_fwd(h, a, wt, gid, tig);
    uint64_t mask0 = 0, mask1 = 0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tig;
      const float2 e0 = load2(agg + o0 + c, ok0), e1 = load2(agg + o1 + c, ok1);
      const float e[4] = {e0.x, e0.y, e1.x, e1.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pre = h[nt][i] + e[i] + vec[c + (i & 1)];
        if (pre > 0.f) mask0 |= 1ull << (nt * 4 + i);
        h[nt][i] = fmaxf(pre, 0.f);
      }
    }
    to_a(a, h);
    __syncthreads();  // the previous tile's last weight gradient is done
    stage(act_h0, a, warp, gid, tig);
    gemm_fwd(h, a, wt + D * LDW, gid, tig);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tig;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pre = h[nt][i] + vec[D + c + (i & 1)];
        if (pre > 0.f) mask1 |= 1ull << (nt * 4 + i);
        h[nt][i] = fmaxf(pre, 0.f);
      }
    }
    to_a(a, h);
    stage(act_a, a, warp, gid, tig);
    gemm_fwd(h, a, wt + 2 * D * LDW, gid, tig);

    // y = h + bf; LayerNorm statistics per row (two passes), h <- yn.
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
    const float mean0 = row_reduce(s0) / D, mean1 = row_reduce(s1) / D;
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
    const float rstd0 = rsqrtf(row_reduce(q0) / D + 1e-5f);
    const float rstd1 = rsqrtf(row_reduce(q1) / D + 1e-5f);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      h[nt][0] *= rstd0;
      h[nt][1] *= rstd0;
      h[nt][2] *= rstd1;
      h[nt][3] *= rstd1;
    }

    // ---- LayerNorm backward -----------------------------------------
    float gv[NT][4];
    float m10 = 0.f, m11 = 0.f, m20 = 0.f, m21 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tig;
      const float2 u = load2(g + o0 + c, ok0), v = load2(g + o1 + c, ok1);
      gv[nt][0] = u.x; gv[nt][1] = u.y; gv[nt][2] = v.x; gv[nt][3] = v.y;
      const float sc0 = vec[3 * D + c], sc1 = vec[3 * D + c + 1];
      const float d0 = u.x * sc0, d1 = u.y * sc1, d2 = v.x * sc0, d3 = v.y * sc1;
      m10 += d0 + d1;
      m11 += d2 + d3;
      m20 += d0 * h[nt][0] + d1 * h[nt][1];
      m21 += d2 * h[nt][2] + d3 * h[nt][3];
      const float ds0 = col_reduce(u.x * h[nt][0] + v.x * h[nt][2]);
      const float ds1 = col_reduce(u.y * h[nt][1] + v.y * h[nt][3]);
      const float gs0 = col_reduce(u.x + v.x), gs1 = col_reduce(u.y + v.y);
      if (gid == 0) {
        my_acc[3 * D + c] += ds0;
        my_acc[3 * D + c + 1] += ds1;
        my_acc[4 * D + c] += gs0;
        my_acc[4 * D + c + 1] += gs1;
      }
    }
    m10 = row_reduce(m10) / D;
    m11 = row_reduce(m11) / D;
    m20 = row_reduce(m20) / D;
    m21 = row_reduce(m21) / D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tig;
      const float sc0 = vec[3 * D + c], sc1 = vec[3 * D + c + 1];
      h[nt][0] = rstd0 * (gv[nt][0] * sc0 - m10 - h[nt][0] * m20);
      h[nt][1] = rstd0 * (gv[nt][1] * sc1 - m10 - h[nt][1] * m20);
      h[nt][2] = rstd1 * (gv[nt][2] * sc0 - m11 - h[nt][2] * m21);
      h[nt][3] = rstd1 * (gv[nt][3] * sc1 - m11 - h[nt][3] * m21);
    }
    col_sums(my_acc + 2 * D, h, gid, tig);  // dbf
    to_a(a, h);
    stage(act_d, a, warp, gid, tig);
    __syncthreads();  // h1 and dy staged
    weight_grad(part + 2 * D * D, act_a, act_d, first, warp, gid, tig);  // dWf

    // ---- back through the hidden Linear -----------------------------
    gemm_bwd(h, a, wt + 2 * D * LDW, gid, tig);  // dh1 = dy Wf^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (!((mask1 >> (nt * 4 + i)) & 1ull)) h[nt][i] = 0.f;
    }
    col_sums(my_acc + D, h, gid, tig);  // db1
    to_a(a, h);
    __syncthreads();  // every warp is done reading dy
    stage(act_d, a, warp, gid, tig);
    __syncthreads();  // dpre1 staged
    weight_grad(part + D * D, act_h0, act_d, first, warp, gid, tig);  // dW1

    // ---- back through the first Linear -------------------------------
    gemm_bwd(h, a, wt + D * LDW, gid, tig);  // dh0 = dpre1 W1^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (!((mask0 >> (nt * 4 + i)) & 1ull)) h[nt][i] = 0.f;
    }
    col_sums(my_acc, h, gid, tig);  // db0
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tig;
      if (ok0) store2(dagg + o0 + c, h[nt][0], h[nt][1]);
      if (ok1) store2(dagg + o1 + c, h[nt][2], h[nt][3]);
    }
    to_a(a, h);
    gemm_bwd(h, a, wt, gid, tig);  // dpre0 W0^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tig;
      if (ok0) {
        const float2 u = load2(g + o0 + c, true);
        store2(dx + o0 + c, u.x + h[nt][0], u.y + h[nt][1]);
      }
      if (ok1) {
        const float2 v = load2(g + o1 + c, true);
        store2(dx + o1 + c, v.x + h[nt][2], v.y + h[nt][3]);
      }
    }
    __syncthreads();  // every warp is done reading dpre1 and h0
    stage(act_d, a, warp, gid, tig);
    load_x(a, x + o0, x + o1, ok0, ok1, tig);
    stage(act_a, a, warp, gid, tig);
    __syncthreads();  // x and dpre0 staged
    weight_grad(part, act_a, act_d, first, warp, gid, tig);  // dW0
  }

  // The block's column sums, over its warps in a fixed order.
  __syncthreads();
  if (blockIdx.x < num_tiles) {
    for (int i = threadIdx.x; i < NVEC * D; i += THREADS) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += vacc[w * NVEC * D + i];
      part[WGRAD + i] = s;
    }
  }
}

// out[i] = sum over blocks b (in order) of partials[b][i].
__global__ void reduce_partials_kernel(const float* __restrict__ partials, int blocks,
                                       float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= PART) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partials[(size_t)b * PART + i];
  out[i] = s;
}

template <typename AggT>
int launch(const float* x, const AggT* agg, const float* g, const float* w0,
           const float* b0, const float* w1, const float* b1, const float* wf,
           const float* bf, const float* ln_scale, const float* ln_bias, float* dx,
           AggT* dagg, float* partials, int max_blocks, float* grads, int n,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(fused_tail_bwd_kernel<AggT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_tail_bwd_kernel<AggT>, THREADS, kSmemBytes)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int num_tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  int blocks = sms * per_sm;
  if (blocks > num_tiles) blocks = num_tiles;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) {
    if ((err = cudaMemsetAsync(grads, 0, PART * sizeof(float), s)) != cudaSuccess)
      return (int)err;
    return (int)cudaGetLastError();
  }
  fused_tail_bwd_kernel<AggT><<<blocks, THREADS, kSmemBytes, s>>>(
      x, agg, g, w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, dx, dagg, partials, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<(PART + 255) / 256, 256, 0, s>>>(partials, blocks, grads);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). x, g, dx: [n, 128] f32; agg,
// dagg: [n, 128] bf16 (fused_tail_bwd_launch) or f32
// (fused_tail_bwd_f32agg_launch); w0, w1, wf: [128, 128] f32 in the JAX
// [in, out] layout; b0, b1, bf, ln_scale, ln_bias: [128] f32; partials:
// scratch of max_blocks * fused_tail_bwd_partial_floats() f32; grads: out,
// fused_tail_bwd_partial_floats() f32 = dW0, dW1, dWf ([128, 128] each),
// db0, db1, dbf, dscale, dbias ([128] each). All contiguous. Launch on
// `stream`, do not synchronize, return the cudaError_t.
extern "C" int fused_tail_bwd_partial_floats() { return PART; }

extern "C" int fused_tail_bwd_launch(const float* x, const void* agg, const float* g,
                                     const float* w0, const float* b0, const float* w1,
                                     const float* b1, const float* wf, const float* bf,
                                     const float* ln_scale, const float* ln_bias,
                                     float* dx, void* dagg, float* partials,
                                     int max_blocks, float* grads, int n, void* stream) {
  return launch(x, static_cast<const __nv_bfloat16*>(agg), g, w0, b0, w1, b1, wf, bf,
                ln_scale, ln_bias, dx, static_cast<__nv_bfloat16*>(dagg), partials,
                max_blocks, grads, n, stream);
}

extern "C" int fused_tail_bwd_f32agg_launch(const float* x, const void* agg, const float* g,
                                            const float* w0, const float* b0,
                                            const float* w1, const float* b1,
                                            const float* wf, const float* bf,
                                            const float* ln_scale, const float* ln_bias,
                                            float* dx, void* dagg, float* partials,
                                            int max_blocks, float* grads, int n,
                                            void* stream) {
  return launch(x, static_cast<const float*>(agg), g, w0, b0, w1, b1, wf, bf, ln_scale,
                ln_bias, dx, static_cast<float*>(dagg), partials, max_blocks, grads, n,
                stream);
}
