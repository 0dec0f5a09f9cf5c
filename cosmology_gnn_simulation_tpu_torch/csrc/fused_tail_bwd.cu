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
// of bf16, 20 us.
//
// Design. The TPU kernel sums the weight gradients across a sequential
// grid in VMEM; here blocks run in parallel and in no order, so each block
// keeps its own f32 partial of the three weight gradients on chip for its
// whole life and writes it to device memory once; a second small kernel
// sums the blocks' partials in a fixed order (two launches give bit-equal
// gradients). The partial is 3 x 64 KB of f32 and an SM has 256 KB of
// registers and 227 KB of shared memory, so a persistent block (one an SM)
// splits it: dWf and dW1 in the registers of two gradient warpgroups, dW0
// in shared memory. Three warpgroups with split roles (setmaxnreg, the
// block's 3 x 168 registers a thread redistributed):
// - the row warpgroup (184 registers) walks 64-row tiles through the
//   recomputed forward and the backward chain: six wgmma m64n128k16
//   products, A (the tile's bf16 activations) and B (a weight, read N-major
//   as W or K-major as W^T, one bf16 copy) from shared memory by
//   descriptors. After each product it applies the bias, ReLU mask or
//   LayerNorm to its f32 accumulators and stores the result as the next
//   bf16 activation tile (x, h0, h1, dy, dpre1, dpre0), which is also a
//   weight gradient's operand. It adds x^T dpre0 to the dW0 partial in
//   shared memory itself (the partial loaded as the accumulators of one
//   wgmma chain a 64-row half, stored back). Its loads run ahead of the
//   math into registers: agg under the first product, g under the third,
//   the next tile's x under the last (g is read again, from L2, for dx).
//   Column sums (the bias and LayerNorm gradients) reduce over a warp's
//   rows in batches of eight by reduce-scatter shuffles, into four running
//   sums per lane and vector.
// - two gradient warpgroups (160 registers) hold dWf and dW1, 128 f32
//   accumulators a thread, and add each tile's h1^T dy and h0^T dpre1 as
//   soon as the row warpgroup has staged the pair (wgmma with A M-major and
//   B N-major, both from shared memory); mbarriers hand the tiles back and
//   forth.
// Rows past n read as zero, which makes their every gradient term zero.
// Built without FMA contraction (kernels.EXTRA_FLAGS): the row warpgroup
// then spills less and the kernel runs faster; what it still spills is
// mostly the running column sums, touched a few times a tile.
//
// Width 256, and a bf16 carry at either width, take the width-general
// variant in fused_tail_wide_bwd.cu.
#include "tail_common.cuh"

namespace {

using namespace tail;

constexpr int THREADS = 3 * 128;   // the row warpgroup, two gradient warpgroups
// setmaxnreg moves registers only within the block's allocation at launch,
// LAUNCH_REGS a thread (65,536 / 384 rounded down to a multiple of 8): if
// the roles asked for more, the growing role would wait forever, so
// launch() refuses a build that does not run at LAUNCH_REGS.
constexpr int LAUNCH_REGS = 168;
constexpr int ROW_REGS = 184, GRAD_REGS = 160;
static_assert(ROW_REGS + 2 * GRAD_REGS == 3 * LAUNCH_REGS, "the block's registers at launch");
constexpr int NVEC = 5;            // db0, db1, dbf, dscale, dbias
constexpr int WGRAD = 3 * D * D;   // dW0, dW1, dWf
constexpr int PART = WGRAD + NVEC * D;  // floats of one block's partial

// Shared memory, from a 1024-byte aligned base.
constexpr int OFF_W = 0;                          // W0, W1, Wf (bf16)
constexpr int OFF_ACT = OFF_W + 3 * W_BYTES;      // 4 bf16 tiles:
constexpr int SLOT_X = 0, SLOT_H0 = 1, SLOT_H1 = 2, SLOT_DY = 3;  // dpre1 in H1, dpre0 in DY
constexpr int OFF_DW0 = OFF_ACT + 4 * ACT_BYTES;  // dW0 partial, f32, thread-major
constexpr int OFF_BAR = OFF_DW0 + D * D * 4;
constexpr int NBARS = 4;
constexpr int SMEM_BYTES = OFF_BAR + NBARS * 8 + 1024;  // + alignment
static_assert(SMEM_BYTES <= 227 * 1024, "shared memory");
// Row -> gradient warpgroups (one arrival), gradient -> row (each of the
// warpgroup's threads arrives).
enum { DY_READY, DP1_READY, DWF_DONE, DW1_DONE };

// The row warpgroup takes registers the gradient warpgroups give up.
__device__ __forceinline__ void setmaxnreg_row() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(ROW_REGS));
}
__device__ __forceinline__ void setmaxnreg_grad() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(GRAD_REGS));
}

// A ReLU mask (bit i: accumulator i's pre-activation > 0) the compiler
// cannot see through: otherwise it traces each bit test back to its own
// comparison and keeps 64 booleans a mask alive from the forward to the
// backward, which spills.
__device__ __forceinline__ uint64_t opaque(uint64_t m) {
  asm volatile("" : "+l"(m));
  return m;
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A thread's 64 values of a [n, 128] array in the accumulator layout
// (rows r, r + 8 of the tile at row0; zero past n), and the converse store.
template <typename T>
__device__ __forceinline__ void load_rows(float (&v)[64], const T* __restrict__ src, int row0,
                                          int r, int tig, int n) {
  const bool ok0 = row0 + r < n, ok1 = row0 + r + 8 < n;
  const T* p0 = src + (size_t)(row0 + r) * D + 2 * tig;
  const T* p1 = p0 + 8 * D;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 u = ok0 ? load_pair(p0 + 8 * j) : make_float2(0.f, 0.f);
    const float2 w = ok1 ? load_pair(p1 + 8 * j) : make_float2(0.f, 0.f);
    v[4 * j] = u.x; v[4 * j + 1] = u.y; v[4 * j + 2] = w.x; v[4 * j + 3] = w.y;
  }
}
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float (&v)[64], int row0,
                                           int r, int tig, int n) {
  T* p0 = dst + (size_t)(row0 + r) * D + 2 * tig;
  T* p1 = p0 + 8 * D;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (row0 + r < n) store_pair(p0 + 8 * j, v[4 * j], v[4 * j + 1]);
    if (row0 + r + 8 < n) store_pair(p1 + 8 * j, v[4 * j + 2], v[4 * j + 3]);
  }
}

// Thread tid's share of the x tile at row0 (a warp reads whole rows):
// float4 i is row (tid + 128 i) / 32, columns 4 ((tid + 128 i) % 32) + 0..3.
__device__ __forceinline__ void load_x(float4 (&xv)[16], const float* __restrict__ x, int row0,
                                       int tid, int n) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int q = tid + 128 * i, r = row0 + (q >> 5);
    xv[i] = r < n ? __ldg(reinterpret_cast<const float4*>(x + (size_t)r * D) + (q & 31))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// acc = A (the bf16 tile at shared offset a_tile, K-major) x B (weight l,
// N-major: W; else K-major: W^T), plus acc if scale_d; every operand
// addressed from the shared base s0. Returns with the products in flight.
template <int TB>
__device__ __forceinline__ void row_product(float (&acc)[64], uint32_t s0, uint32_t a_tile,
                                            int l, int scale_d) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    wgmma_ss<0, TB>(acc, s0, at(tile_k(ks), a_tile), s0,
                    at(TB ? weight_n(l, ks) : weight_k(l, ks), OFF_W), scale_d || ks > 0);
  wgmma_commit();
}

// acc += A^T D over a tile's 64 rows: A's columns [64 half, + 64) (M-major)
// against all of D's columns (N-major), the tiles at shared offsets a_tile
// and d_tile from s0. Returns with the products in flight.
__device__ __forceinline__ void grad_product(float (&acc)[64], uint32_t s0, uint32_t a_tile,
                                             int half, uint32_t d_tile) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_ss<1, 1>(acc, s0, at(tile_mn(half, ks), a_tile), s0, at(tile_mn(0, ks), d_tile), 1);
}

// Store the accumulators (rows r, r + 8 of the tile) as a bf16 tile.
__device__ __forceinline__ void stage(unsigned char* tile, const float (&v)[64], int r, int tig) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * tig;
    *reinterpret_cast<uint32_t*>(tile + bf16_off(r, c)) = pack_bf16(v[4 * j], v[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(tile + bf16_off(r + 8, c)) =
        pack_bf16(v[4 * j + 2], v[4 * j + 3]);
  }
}

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

// Running column sums of one vector: batch k holds j in [4 k, 4 k + 4);
// lane (gid, tig) keeps column 8 (4 k + gid / 2) + 2 tig + gid % 2 of it.
// sum[k] += the warp's sum over its rows of a[i] (times b[i] if b), i the
// thread's accumulator index (d[4 j + e]: e = 0, 1 its two columns of
// group j, + 2 its second row).
__device__ __forceinline__ void col_sums(float (&sum)[4], int gid, const float (&a)[64],
                                         const float (*b)[64] = nullptr) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 4 * (4 * k + (i >> 1)) + (i & 1);
      t[i] = b ? a[c] * (*b)[c] + a[c + 2] * (*b)[c + 2] : a[c] + a[c + 2];
    }
    sum[k] += reduce8(t, gid);
  }
}

// The row warpgroup: the chain of one tile after another.
template <typename AggT>
__device__ __forceinline__ void row_role(const float* __restrict__ x,
                                         const AggT* __restrict__ agg,
                                         const float* __restrict__ g,
                                         const float* __restrict__ b0,
                                         const float* __restrict__ b1,
                                         const float* __restrict__ bf,
                                         const float* __restrict__ ln_scale,
                                         float* __restrict__ dx, AggT* __restrict__ dagg,
                                         float* __restrict__ part, unsigned char* smem,
                                         uint32_t smem0, int n) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = 16 * warp + gid;  // and r0 + 8
  const int num_tiles = (n + ROWS - 1) / ROWS;
  const uint32_t bar0 = smem0 + OFF_BAR;
  auto bar = [&](int i) { return bar0 + 8 * i; };
  auto slot = [&](int s) { return smem + OFF_ACT + s * ACT_BYTES; };
  auto tile_at = [](int s) { return (uint32_t)(OFF_ACT + s * ACT_BYTES); };
  float4* dw0 = reinterpret_cast<float4*>(smem + OFF_DW0);  // [half][16][128 threads]
  float cs[NVEC][4] = {};  // running column sums: db0, db1, dbf, dscale, dbias
  float4 xv[16];           // the next tile's x
  load_x(xv, x, blockIdx.x * ROWS, tid, n);

  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, ++it) {
    const uint32_t par = it & 1, prev = par ^ 1;
    const int row0 = tile * ROWS, next = tile + gridDim.x;

    // ---- x (loaded during the last tile) -> bf16 tile ------------------
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int q = tid + 128 * i;
      *reinterpret_cast<uint2*>(slot(SLOT_X) + bf16_off(q >> 5, 4 * (q & 31))) =
          make_uint2(pack_bf16(xv[i].x, xv[i].y), pack_bf16(xv[i].z, xv[i].w));
    }
    fence_async_smem();
    named_barrier(1, 128);

    // ---- recompute the forward, agg loading under the first product ----
    float h[64], v[64];
    row_product<1>(h, smem0, tile_at(SLOT_X), 0, 0);
    load_rows(v, agg, row0, r0, tig, n);
    wgmma_wait_all();
    uint64_t mask0 = 0, mask1 = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bb = ld_vec2(b0 + 8 * j + 2 * tig);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pre = h[4 * j + e] + v[4 * j + e] + (e & 1 ? bb.y : bb.x);
        if (pre > 0.f) mask0 |= 1ull << (4 * j + e);
        h[4 * j + e] = fmaxf(pre, 0.f);
      }
    }
    mask0 = opaque(mask0);
    if (it > 0) mbar_wait(bar(DW1_DONE), prev);  // h0 and dpre1 of the last tile read
    stage(slot(SLOT_H0), h, r0, tig);
    fence_async_smem();
    named_barrier(1, 128);

    row_product<1>(h, smem0, tile_at(SLOT_H0), 1, 0);
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bb = ld_vec2(b1 + 8 * j + 2 * tig);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pre = h[4 * j + e] + (e & 1 ? bb.y : bb.x);
        if (pre > 0.f) mask1 |= 1ull << (4 * j + e);
        h[4 * j + e] = fmaxf(pre, 0.f);
      }
    }
    mask1 = opaque(mask1);
    stage(slot(SLOT_H1), h, r0, tig);
    fence_async_smem();
    named_barrier(1, 128);

    row_product<1>(h, smem0, tile_at(SLOT_H1), 2, 0);
    load_rows(v, g, row0, r0, tig, n);  // g, under the third product
    wgmma_wait_all();
    // y = h + bf; LayerNorm statistics per row (two passes), h <- yn.
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
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      h[4 * j] *= rstd0;
      h[4 * j + 1] *= rstd0;
      h[4 * j + 2] *= rstd1;
      h[4 * j + 3] *= rstd1;
    }

    // ---- LayerNorm backward (v = g) ------------------------------------
    col_sums(cs[3], gid, v, &h);  // dscale
    col_sums(cs[4], gid, v);      // dbias
    float m10 = 0.f, m11 = 0.f, m20 = 0.f, m21 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 sc = ld_vec2(ln_scale + 8 * j + 2 * tig);
      const float d0 = v[4 * j] * sc.x, d1 = v[4 * j + 1] * sc.y;
      const float d2 = v[4 * j + 2] * sc.x, d3 = v[4 * j + 3] * sc.y;
      m10 += d0 + d1;
      m11 += d2 + d3;
      m20 += d0 * h[4 * j] + d1 * h[4 * j + 1];
      m21 += d2 * h[4 * j + 2] + d3 * h[4 * j + 3];
    }
    m10 = quad_sum(m10) / D;
    m11 = quad_sum(m11) / D;
    m20 = quad_sum(m20) / D;
    m21 = quad_sum(m21) / D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 sc = ld_vec2(ln_scale + 8 * j + 2 * tig);
      h[4 * j] = rstd0 * (v[4 * j] * sc.x - m10 - h[4 * j] * m20);
      h[4 * j + 1] = rstd0 * (v[4 * j + 1] * sc.y - m10 - h[4 * j + 1] * m20);
      h[4 * j + 2] = rstd1 * (v[4 * j + 2] * sc.x - m11 - h[4 * j + 2] * m21);
      h[4 * j + 3] = rstd1 * (v[4 * j + 3] * sc.y - m11 - h[4 * j + 3] * m21);
    }
    stage(slot(SLOT_DY), h, r0, tig);
    fence_async_smem();
    named_barrier(1, 128);
    if (tid == 0) mbar_arrive(bar(DY_READY));
    col_sums(cs[2], gid, h);  // dbf

    // ---- back through the hidden Linear ---------------------------------
    row_product<0>(h, smem0, tile_at(SLOT_DY), 2, 0);  // dh1 = dy Wf^T
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (!((mask1 >> i) & 1ull)) h[i] = 0.f;
    mbar_wait(bar(DWF_DONE), par);  // h1 read: its slot takes dpre1
    stage(slot(SLOT_H1), h, r0, tig);
    fence_async_smem();
    named_barrier(1, 128);
    if (tid == 0) mbar_arrive(bar(DP1_READY));
    col_sums(cs[1], gid, h);  // db1

    // ---- back through the first Linear ----------------------------------
    row_product<0>(h, smem0, tile_at(SLOT_H1), 1, 0);  // dh0 = dpre1 W1^T
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (!((mask0 >> i) & 1ull)) h[i] = 0.f;
    store_rows(dagg, h, row0, r0, tig, n);
    stage(slot(SLOT_DY), h, r0, tig);  // dy was read by dWf and dh1
    fence_async_smem();
    named_barrier(1, 128);
    col_sums(cs[0], gid, h);  // db0

    // dx = dpre0 W0^T + g, g read again (from L2: holding it from the
    // LayerNorm backward to here would take 64 registers the row
    // warpgroup does not have); the next tile's x loads under the product,
    // unconditionally (zeros past n), so no older x has to survive the
    // loop's back edge beside it.
    row_product<0>(h, smem0, tile_at(SLOT_DY), 0, 0);
    load_x(xv, x, next * ROWS, tid, n);
    wgmma_wait_all();
    load_rows(v, g, row0, r0, tig, n);
#pragma unroll
    for (int i = 0; i < 64; ++i) h[i] += v[i];
    store_rows(dx, h, row0, r0, tig, n);

    // dW0 += x^T dpre0, a 64-row half at a time through the accumulators.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float4* p = dw0 + half * 16 * 128 + tid;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float4 u = p[e * 128];
        h[4 * e] = u.x; h[4 * e + 1] = u.y; h[4 * e + 2] = u.z; h[4 * e + 3] = u.w;
      }
      wgmma_fence();
      grad_product(h, smem0, tile_at(SLOT_X), half, tile_at(SLOT_DY));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < 16; ++e)
        p[e * 128] = make_float4(h[4 * e], h[4 * e + 1], h[4 * e + 2], h[4 * e + 3]);
    }
  }

  // The block's partials: dW0 from shared memory (accumulator d[4 j + e] of
  // half m is row 64 m + r0 + 8 (e >> 1), column 8 j + 2 tig + (e & 1));
  // the column sums over the warps in a fixed order, through slot X.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float h[64];
    const float4* p = dw0 + half * 16 * 128 + tid;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float4 u = p[e * 128];
      h[4 * e] = u.x; h[4 * e + 1] = u.y; h[4 * e + 2] = u.z; h[4 * e + 3] = u.w;
    }
    store_rows(part, h, 64 * half, r0, tig, D);
  }
  named_barrier(1, 128);  // slot X read by the last dW0 product
  float* sums = reinterpret_cast<float*>(slot(SLOT_X));  // [4 warps][NVEC][D]
#pragma unroll
  for (int vec = 0; vec < NVEC; ++vec)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sums[(warp * NVEC + vec) * D + 8 * (4 * k + (gid >> 1)) + 2 * tig + (gid & 1)] =
          cs[vec][k];
  named_barrier(1, 128);
  for (int i = tid; i < NVEC * D; i += 128) {
    float s = 0.f;
    for (int w = 0; w < 4; ++w) s += sums[w * NVEC * D + i];
    part[WGRAD + i] = s;
  }
}

// A gradient warpgroup: dW1 (which = 0: h0^T dpre1) or dWf (which = 1:
// h1^T dy), both 64-row halves.
__device__ __forceinline__ void grad_role(int which, float* __restrict__ part, uint32_t smem0,
                                          int n) {
  const int wtid = threadIdx.x & 127, warp = wtid >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int num_tiles = (n + ROWS - 1) / ROWS;
  const uint32_t bar0 = smem0 + OFF_BAR;
  const uint32_t ready = bar0 + 8 * (which ? DY_READY : DP1_READY);
  const uint32_t done = bar0 + 8 * (which ? DWF_DONE : DW1_DONE);
  const uint32_t a_tile = OFF_ACT + (which ? SLOT_H1 : SLOT_H0) * ACT_BYTES;
  const uint32_t d_tile = OFF_ACT + (which ? SLOT_DY : SLOT_H1) * ACT_BYTES;
  float lo[64], hi[64];  // gradient rows [0, 64) and [64, 128)
#pragma unroll
  for (int i = 0; i < 64; ++i) lo[i] = hi[i] = 0.f;

  uint32_t par = 0;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, par ^= 1) {
    mbar_wait(ready, par);
    wgmma_fence();
    grad_product(lo, smem0, a_tile, 0, d_tile);
    grad_product(hi, smem0, a_tile, 1, d_tile);
    wgmma_commit();
    wgmma_wait_all();
    mbar_arrive(done);
  }
  float* dst = part + (which ? 2 : 1) * D * D;
  const int r = 16 * warp + gid;
  store_rows(dst, lo, 0, r, tig, D);
  store_rows(dst, hi, 64, r, tig, D);
}

template <typename AggT>
__global__ void __launch_bounds__(THREADS, 1) fused_tail_bwd_kernel(
    const float* __restrict__ x, const AggT* __restrict__ agg, const float* __restrict__ g,
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ wf, const float* __restrict__ bf,
    const float* __restrict__ ln_scale, float* __restrict__ dx, AggT* __restrict__ dagg,
    float* __restrict__ partials, int n) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t smem0 = (raw0 + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (smem0 - raw0);
  const uint32_t bar0 = smem0 + OFF_BAR;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NBARS; ++i) mbar_init(bar0 + 8 * i, i >= DWF_DONE ? 128 : 1);
    mbar_init_fence();
  }
  load_weights(smem + OFF_W, w0, w1, wf, threadIdx.x, THREADS);
  float4* dw0 = reinterpret_cast<float4*>(smem + OFF_DW0);
  for (int i = threadIdx.x; i < D * D / 4; i += THREADS) dw0[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  fence_async_smem();
  __syncthreads();

  float* part = partials + (size_t)blockIdx.x * PART;
  if (threadIdx.x < 128) {
    setmaxnreg_row();
    row_role<AggT>(x, agg, g, b0, b1, bf, ln_scale, dx, dagg, part, smem, smem0, n);
  } else {
    setmaxnreg_grad();
    grad_role((threadIdx.x >> 7) - 1, part, smem0, n);
  }
}

template <typename AggT>
int launch(const float* x, const AggT* agg, const float* g, const float* w0,
           const float* b0, const float* w1, const float* b1, const float* wf,
           const float* bf, const float* ln_scale, float* dx, AggT* dagg, float* partials,
           int max_blocks, float* grads, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int num_tiles = (n + ROWS - 1) / ROWS;
  int sms = 0;
  cudaError_t err = launch_setup<fused_tail_bwd_kernel<AggT>>(SMEM_BYTES, LAUNCH_REGS, &sms);
  if (err != cudaSuccess) return (int)err;
  int blocks = sms < num_tiles ? sms : num_tiles;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) {
    if ((err = cudaMemsetAsync(grads, 0, PART * sizeof(float), s)) != cudaSuccess)
      return (int)err;
    return (int)cudaGetLastError();
  }
  fused_tail_bwd_kernel<AggT><<<blocks, THREADS, SMEM_BYTES, s>>>(
      x, agg, g, w0, b0, w1, b1, wf, bf, ln_scale, dx, dagg, partials, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<(PART + 255) / 256, 256, 0, s>>>(partials, blocks, PART, grads);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). x, g, dx: [n, 128] f32; agg,
// dagg: [n, 128] bf16 (fused_tail_bwd_launch) or f32
// (fused_tail_bwd_f32agg_launch); w0, w1, wf: [128, 128] f32 in the JAX
// [in, out] layout; b0, b1, bf, ln_scale: [128] f32 (the LayerNorm bias
// takes no part in the backward: dbias is the sum of g); partials:
// scratch of max_blocks * fused_tail_bwd_partial_floats() f32; grads: out,
// fused_tail_bwd_partial_floats() f32 = dW0, dW1, dWf ([128, 128] each),
// db0, db1, dbf, dscale, dbias ([128] each). All contiguous, x 16-byte
// aligned. Launch on `stream`, do not synchronize, return the
// cudaError_t.
extern "C" int fused_tail_bwd_partial_floats() { return PART; }

extern "C" int fused_tail_bwd_launch(const float* x, const void* agg, const float* g,
                                     const float* w0, const float* b0, const float* w1,
                                     const float* b1, const float* wf, const float* bf,
                                     const float* ln_scale, float* dx, void* dagg,
                                     float* partials, int max_blocks, float* grads, int n,
                                     void* stream) {
  return launch(x, static_cast<const __nv_bfloat16*>(agg), g, w0, b0, w1, b1, wf, bf,
                ln_scale, dx, static_cast<__nv_bfloat16*>(dagg), partials, max_blocks,
                grads, n, stream);
}

extern "C" int fused_tail_bwd_f32agg_launch(const float* x, const void* agg, const float* g,
                                            const float* w0, const float* b0,
                                            const float* w1, const float* b1,
                                            const float* wf, const float* bf,
                                            const float* ln_scale, float* dx, void* dagg,
                                            float* partials, int max_blocks, float* grads,
                                            int n, void* stream) {
  return launch(x, static_cast<const float*>(agg), g, w0, b0, w1, b1, wf, bf, ln_scale, dx,
                static_cast<float*>(dagg), partials, max_blocks, grads, n, stream);
}
