// K6, width-general: the recompute-backward of the step tail at latent =
// hidden = 256 (an f32 or a bf16 carry) or 128 (a bf16 carry; the f32
// carry at 128 is fused_tail_bwd.cu's tuned kernel).
//
// Replaces the JAX package's TPU kernel ops/fused_step.py::_tail_bwd_kernel
// (pallas_call in _tail_core_bwd), at these widths. Per row, from the
// forward's inputs (x, agg) and the output's cotangent g:
//   pre0 = x W0 + agg + b0, h0 = relu(pre0); pre1 = h0 W1 + b1,
//   h1 = relu(pre1); y = h1 Wf + bf; yn = LN(y)          (recomputed)
//   dyn = g * scale; dy = rstd (dyn - mean(dyn) - yn mean(dyn yn))
//   dpre1 = [pre1 > 0] dy Wf^T;  dpre0 = [pre0 > 0] dpre1 W1^T
//   dx = g + dpre0 W0^T;  dagg = dpre0
// and, summed over all rows, dWf = h1^T dy, dW1 = h0^T dpre1,
// dW0 = x^T dpre0, db0, db1, dbf (column sums of dpre0, dpre1, dy),
// dscale = sum g * yn, dbias = sum g. Products on bf16 operands into f32
// sums; dx in x's type, dagg in agg's. The TPU kernel sums the weight
// gradients over its sequential grid in VMEM.
//
// Three f32 [256, 256] weight gradients (768 KB) do not fit on an SM, so
// the work runs in three stages after the weights' bf16 conversion:
// - the chain (fused_tail_wide_chain_kernel): tail_wide.cuh's persistent
//   block of two warpgroups over 128-row tiles. Six products a tile, the
//   weights streamed from L2 by TMA through a ring of 64-row slabs (three
//   of 32 KB at width 256): forward slabs (B = W, N-major) for the
//   recomputed forward, backward slabs of the same bf16 weights (W^T,
//   K-major) for the chain back. A warpgroup's row data moves through its
//   two tiles by TMA, each copy issued as soon as its tile is free:
//     A: x -> agg's second half (f32) -> g -> dx (written over g, stored)
//        -> the next tile's x;
//     B: agg's first half (issued during the last tile) -> h0 -> h1 -> dy
//        -> dpre1 -> dpre0, each the next product's A and stored by TMA as
//        a bf16 [n, d] operand of the weight gradients (and bf16(x) for an
//        f32 x, from A).
//   An f32 carry's g and dx go to and from L2 in the accumulator layout;
//   dagg is stored from the accumulators. A tile's column sums (the bias
//   and LayerNorm gradients), summed over a warp's rows by shuffles, go to
//   the warp's slot of a per-tile array; the block sums its slots in a
//   fixed order at its end into a per-block partial.
// - the weight gradients (fused_tail_wide_dw_kernel): block (slice, weight,
//   split) computes rows [128 slice, + 128) of one dW over a run of rows
//   (a multiple of 64) with two warpgroups on wgmma (A^T M-major, B
//   N-major, both from TMA-fed stages); its f32 partial is written once.
//   The two slices of a width-256 weight read the same B rows side by side
//   (adjacent blocks), the second time from L2.
// - the reduction of both kinds of partial in a fixed order
//   (tail::reduce_partials_kernel, the tuned kernel's): two launches give
//   bit-equal gradients, and no float is added by an atomic.
//
// Bound on the H100: bytes. At width 256 and a bf16 carry the chain reads
// x, g (512 B a row each) and agg (1 KB f32) and writes dx (512 B), dagg
// (1 KB) and five operands (2.5 KB): 6 KB a row against 6 * 2 * 256^2 =
// 786 kFLOP; the weight gradients read the six operands once more (3 KB a
// row) against 3 * 2 * 256^2 = 393 kFLOP.
#include <climits>

#include "tail_wide.cuh"

namespace {

using namespace tailw;

constexpr int NVEC = 5;  // db0, db1, dbf, dscale, dbias
// The operand arrays in the scratch: h0, h1, dy, dpre1, dpre0, then (an
// f32 x only) bf16(x).
enum { OP_H0, OP_H1, OP_DY, OP_DP1, OP_DP0, OP_X, NOPS };
struct OpMaps {
  CUtensorMap m[NOPS];
};

template <int D>
struct ChainSmem {
  using W = Wide<D>;
  // Two tiles a warpgroup (A, B), then the ring.
  static constexpr int OFF_RING = CONSUMERS * 2 * W::TILE_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - OFF_RING) / W::SLAB_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int BYTES = OFF_RING + STAGES * W::SLAB_BYTES + 1024;  // + alignment
  static_assert(STAGES >= 2 && BYTES <= SMEM_LIMIT, "shared memory");
};

// Slab q of a block's sequence: for each tile of its walk the forward slabs
// of W0, W1, Wf, then the backward slabs of Wf, W1, W0; nothing past its
// last tile.
template <int D>
struct ChainSlabs {
  const CUtensorMap *fwd, *bwd;
  int num_tiles;
  __device__ __forceinline__ void operator()(uint32_t q, uint32_t dst, uint32_t bar) const {
    constexpr int NS = Wide<D>::NS, PER_TILE = 6 * NS;
    const int pos = q % PER_TILE;
    if (blockIdx.x + (int)(q / PER_TILE) * gridDim.x >= num_tiles) return;
    mbar_expect_tx(bar, Wide<D>::SLAB_BYTES);
    if (pos < 3 * NS)
      load_fwd_slab<D>(dst, fwd, pos / NS, pos % NS, bar);
    else
      load_bwd_slab<D>(dst, bwd, 2 - (pos - 3 * NS) / NS, pos % NS, bar);
  }
};

// The accumulators, rounded, as the warpgroup's tile (once every warp's
// product has read it and the last store has), then stored by TMA (map).
template <int D>
__device__ __forceinline__ void stage_store(unsigned char* tile_p, uint32_t tile_s,
                                            const float (&v)[D / 128][64], const CUtensorMap* map,
                                            int row0, const Frag& f, int wtid, int bar_id) {
  if (wtid == 0) bulk_wait_read<0>();
  named_barrier(bar_id, 128);
  stage<D>(tile_p, v, f);
  fence_async_smem();
  named_barrier(bar_id, 128);
  if (wtid == 0) store_tile<D>(map, row0, tile_s);
}

// g at the thread's columns (hh, j0 + j), j < J, of its rows: from the
// warpgroup's g tile (a bf16 carry), or from g's rows in L2 (f32).
template <int D, int J>
__device__ __forceinline__ void g_pairs(float2 (&u)[J], float2 (&w)[J], const unsigned char* tile,
                                        const bf16*, const RowsAt&, const Frag& f, int hh,
                                        int j0) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    u[j] = bf16_pair(tile, f.b16(hh, j0 + j, 0));
    w[j] = bf16_pair(tile, f.b16(hh, j0 + j, 1));
  }
}
template <int D, int J>
__device__ __forceinline__ void g_pairs(float2 (&u)[J], float2 (&w)[J], const unsigned char*,
                                        const float* g, const RowsAt& r, const Frag&, int hh,
                                        int j0) {
  load_pairs<J>(u, w, g + r.o0, g + r.o1, r.ok0, r.ok1, hh, j0);
}

// A ReLU mask (bit i: accumulator i's pre-activation > 0) the compiler
// cannot see through: otherwise it keeps a boolean an accumulator alive
// from the forward to the backward.
__device__ __forceinline__ uint64_t opaque(uint64_t m) {
  asm volatile("" : "+l"(m));
  return m;
}

// The chain (see the file comment).
template <int D, typename XT, typename AggT>
__global__ void __launch_bounds__(THREADS, 1) fused_tail_wide_chain_kernel(
    const __grid_constant__ CUtensorMap wfwd_map, const __grid_constant__ CUtensorMap wbwd_map,
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap g_map,
    const __grid_constant__ CUtensorMap agg_map, const __grid_constant__ CUtensorMap dx_map,
    const __grid_constant__ OpMaps ops, const XT* __restrict__ x, const AggT* __restrict__ agg,
    const XT* __restrict__ g, const float* __restrict__ b0, const float* __restrict__ b1,
    const float* __restrict__ bf, const float* __restrict__ ln_scale, XT* __restrict__ dx,
    AggT* __restrict__ dagg, float* __restrict__ tilepart, float* __restrict__ vecpart,
    int max_tiles, int n) {
  using S = ChainSmem<D>;
  using W = Wide<D>;
  using AP = AggParts<D, AggT>;
  constexpr int NH = W::NH;
  constexpr bool BF16 = sizeof(XT) == 2;  // x and g in, dx out, by TMA
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[S::STAGES + 4 * CONSUMERS];  // full; x, agg 0, agg 1, g
  __shared__ int counts[S::STAGES];

  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t smem0 = (raw0 + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (smem0 - raw0);
  const uint32_t full0 = smem_addr(&bars[0]), xfull0 = full0 + 8 * S::STAGES;
  const int num_tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  const ChainSlabs<D> load{&wfwd_map, &wbwd_map, num_tiles};
  Ring<S::STAGES, W::SLAB_BYTES> ring(smem0 + S::OFF_RING, full0, counts);
  const int wg = threadIdx.x >> 7;
  const Lane l;
  const int bar_id = 1 + wg;  // the warpgroup's named barrier
  // The warpgroup's tiles A and B (see the file comment).
  unsigned char* tA = smem + wg * 2 * W::TILE_BYTES;
  unsigned char* tB = tA + W::TILE_BYTES;
  const uint32_t sA = smem0 + wg * 2 * W::TILE_BYTES, sB = sA + W::TILE_BYTES;
  const uint32_t xfull = xfull0 + 8 * wg, agg0 = xfull + 8 * CONSUMERS;
  const uint32_t agg1 = agg0 + 8 * CONSUMERS, gfull = agg1 + 8 * CONSUMERS;
  if (threadIdx.x == 0) {
    for (int c = 0; c < 4 * CONSUMERS; ++c) mbar_init(xfull0 + 8 * c, 1);
    ring.init(load);  // fences the barriers' initialisation
  }
  __syncthreads();
  // Each tile's column sums (db0, db1, dbf, dscale, dbias), summed over a
  // warp's rows, go to the warp's own slot of tilepart (rather than
  // running in 5 x 8 registers a thread across the tiles); the block sums
  // its slots in a fixed order at its end. Lane (gid, tig) writes element
  // [hh][k] of a vector to column 128 hh + 8 (4 k + gid / 2) + 2 tig + gid % 2.
  const int warp = threadIdx.x >> 5;
  const int lane_col = 8 * (l.gid >> 1) + 2 * l.tig + (l.gid & 1);

  const Frag f(l);
  int tile = blockIdx.x;
  if (l.wtid == 0 && tile < num_tiles) {
    if (BF16) load_tile<D>(sA, &x_map, tile * TILE_ROWS + wg * ROWS, xfull);
    AP::load(sB, &agg_map, tile * TILE_ROWS + wg * ROWS, 0, agg0);
  }

  for (uint32_t it = 0; tile < num_tiles; ++it, tile += gridDim.x) {
    float* cs = tilepart + (((size_t)blockIdx.x * max_tiles + it) * WARPS + warp) * NVEC * D +
                lane_col;
    const auto col = [](int v, int hh, int k) { return v * D + 128 * hh + 32 * k; };
    const int row0 = tile * TILE_ROWS + wg * ROWS, next = tile + gridDim.x;
    const int row_next = next * TILE_ROWS + wg * ROWS;
    const float *b0t = fresh(b0) + 2 * l.tig, *b1t = fresh(b1) + 2 * l.tig;
    const float *bft = fresh(bf) + 2 * l.tig, *sct = fresh(ln_scale) + 2 * l.tig;
    if (threadIdx.x == 0 && next < num_tiles) {
      prefetch_tile<D>(x, next, n);
      prefetch_tile<D>(agg, next, n);
      prefetch_tile<D>(g, next, n);
    }
    if constexpr (BF16) {
      mbar_wait(xfull, it & 1);
    } else {
      load_tile_f32<D>(tA, reinterpret_cast<const float*>(x), row0, n, l.wtid);
      fence_async_smem();
      named_barrier(bar_id, 128);
      if (l.wtid == 0) store_tile<D>(&ops.m[OP_X], row0, sA);
    }

    // ---- recompute the forward ------------------------------------------
    float acc[NH][64];
    uint64_t mask0[NH], mask1[NH];
    product<D, true>(acc, sA, ring, load);
    if constexpr (AP::PARTS == 2) {
      named_barrier(bar_id, 128);  // every warp's product has read A
      if (l.wtid == 0) {           // and bf16(x)'s store has
        bulk_wait_read<0>();
        AP::load(sA, &agg_map, row0, 1, agg1);
      }
    }
    mbar_wait(agg0, it & 1);
    if constexpr (AP::PARTS == 2) mbar_wait(agg1, it & 1);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      uint64_t m = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb = at2(b0t, hh, j);
        const float2 e0 = AP::pair(tB, tA, f, hh, j, 0), e1 = AP::pair(tB, tA, f, hh, j, 1);
        const float p[4] = {acc[hh][4 * j] + e0.x + bb.x, acc[hh][4 * j + 1] + e0.y + bb.y,
                            acc[hh][4 * j + 2] + e1.x + bb.x, acc[hh][4 * j + 3] + e1.y + bb.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (p[e] > 0.f) m |= 1ull << (4 * j + e);
          acc[hh][4 * j + e] = fmaxf(p[e], 0.f);
        }
      }
      mask0[hh] = opaque(m);
    }
    named_barrier(bar_id, 128);  // agg read: A takes g
    if (BF16 && l.wtid == 0) load_tile<D>(sA, &g_map, row0, gfull);
    stage_store<D>(tB, sB, acc, &ops.m[OP_H0], row0, f, l.wtid, bar_id);

    product<D, true>(acc, sB, ring, load);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      uint64_t m = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb = at2(b1t, hh, j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = acc[hh][4 * j + e] + (e & 1 ? bb.y : bb.x);
          if (p > 0.f) m |= 1ull << (4 * j + e);
          acc[hh][4 * j + e] = fmaxf(p, 0.f);
        }
      }
      mask1[hh] = opaque(m);
    }
    stage_store<D>(tB, sB, acc, &ops.m[OP_H1], row0, f, l.wtid, bar_id);

    product<D, true>(acc, sB, ring, load);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb = at2(bft, hh, j);
        acc[hh][4 * j] += bb.x;
        acc[hh][4 * j + 1] += bb.y;
        acc[hh][4 * j + 2] += bb.x;
        acc[hh][4 * j + 3] += bb.y;
      }
    float rstd[2];
    layer_norm<NH>(acc, rstd, D);  // acc = yn / rstd
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[hh][i] *= rstd[i >> 1 & 1];

    // ---- LayerNorm backward: dy = rstd (dyn - mean(dyn) - yn mean(dyn yn))
    if constexpr (BF16) mbar_wait(gfull, it & 1);
    float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
    {
      const RowsAt r(row0, l, n, D);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // j in [4 k, 4 k + 4)
          float2 u[4], w[4];
          g_pairs<D, 4>(u, w, tA, g, r, f, hh, 4 * k);
          float ts[8], tb[8];  // dscale's and dbias's terms
#pragma unroll
          for (int jq = 0; jq < 4; ++jq) {
            const int j = 4 * k + jq;
            const float2 sc = at2(sct, hh, j);
            const float y0 = acc[hh][4 * j], y1 = acc[hh][4 * j + 1];      // yn, row r0
            const float y2 = acc[hh][4 * j + 2], y3 = acc[hh][4 * j + 3];  // row r0 + 8
            ts[2 * jq] = u[jq].x * y0 + w[jq].x * y2;
            ts[2 * jq + 1] = u[jq].y * y1 + w[jq].y * y3;
            tb[2 * jq] = u[jq].x + w[jq].x;
            tb[2 * jq + 1] = u[jq].y + w[jq].y;
            const float d0 = u[jq].x * sc.x, d1 = u[jq].y * sc.y;
            const float d2 = w[jq].x * sc.x, d3 = w[jq].y * sc.y;
            m1[0] += d0 + d1;
            m1[1] += d2 + d3;
            m2[0] += d0 * y0 + d1 * y1;
            m2[1] += d2 * y2 + d3 * y3;
          }
          cs[col(3, hh, k)] = reduce8(ts, l.gid);
          cs[col(4, hh, k)] = reduce8(tb, l.gid);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m1[h] = quad_sum(m1[h]) / D;
        m2[h] = quad_sum(m2[h]) / D;
      }
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int jb = 0; jb < 16; jb += 8) {
          float2 u[8], w[8];
          g_pairs<D, 8>(u, w, tA, g, r, f, hh, jb);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = jb + jj;
            const float2 sc = at2(sct, hh, j);
            acc[hh][4 * j] = rstd[0] * (u[jj].x * sc.x - m1[0] - acc[hh][4 * j] * m2[0]);
            acc[hh][4 * j + 1] = rstd[0] * (u[jj].y * sc.y - m1[0] - acc[hh][4 * j + 1] * m2[0]);
            acc[hh][4 * j + 2] = rstd[1] * (w[jj].x * sc.x - m1[1] - acc[hh][4 * j + 2] * m2[1]);
            acc[hh][4 * j + 3] = rstd[1] * (w[jj].y * sc.y - m1[1] - acc[hh][4 * j + 3] * m2[1]);
          }
        }
    }
    col_sums<D>(cs + 2 * D, l.gid, acc);  // dbf
    stage_store<D>(tB, sB, acc, &ops.m[OP_DY], row0, f, l.wtid, bar_id);

    // ---- back through the final and the hidden Linear ---------------------
    product<D, false>(acc, sB, ring, load);  // dh1 = dy Wf^T
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (!((mask1[hh] >> i) & 1ull)) acc[hh][i] = 0.f;
    col_sums<D>(cs + D, l.gid, acc);  // db1
    stage_store<D>(tB, sB, acc, &ops.m[OP_DP1], row0, f, l.wtid, bar_id);

    product<D, false>(acc, sB, ring, load);  // dh0 = dpre1 W1^T
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (!((mask0[hh] >> i) & 1ull)) acc[hh][i] = 0.f;
    col_sums<D>(cs, l.gid, acc);  // db0
    {
      const RowsAt r(row0, l, n, D);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (r.ok0) put2(dagg + r.o0, hh, j, acc[hh][4 * j], acc[hh][4 * j + 1]);
          if (r.ok1) put2(dagg + r.o1, hh, j, acc[hh][4 * j + 2], acc[hh][4 * j + 3]);
        }
    }
    stage_store<D>(tB, sB, acc, &ops.m[OP_DP0], row0, f, l.wtid, bar_id);

    // ---- dx = g + dpre0 W0^T ---------------------------------------------
    product<D, false>(acc, sB, ring, load);
    if constexpr (BF16) {  // over g in A, in place, then stored by TMA
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 u = bf16_pair(tA, f.b16(hh, j, 0)), w = bf16_pair(tA, f.b16(hh, j, 1));
          put_bf16_pair(tA, f.b16(hh, j, 0), u.x + acc[hh][4 * j], u.y + acc[hh][4 * j + 1]);
          put_bf16_pair(tA, f.b16(hh, j, 1), w.x + acc[hh][4 * j + 2], w.y + acc[hh][4 * j + 3]);
        }
      fence_async_smem();
      named_barrier(bar_id, 128);
      if (l.wtid == 0) {  // the next tile's agg (part 0) and x, once the stores are done
        store_tile<D>(&dx_map, row0, sA);
        bulk_wait_read<1>();  // dpre0's has read B
        if (next < num_tiles) AP::load(sB, &agg_map, row_next, 0, agg0);
        bulk_wait_read<0>();  // dx's has read A
        if (next < num_tiles) load_tile<D>(sA, &x_map, row_next, xfull);
      }
    } else {
      const RowsAt r(row0, l, n, D);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int jb = 0; jb < 16; jb += 8) {
          float2 u[8], w[8];
          g_pairs<D, 8>(u, w, tA, g, r, f, hh, jb);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = jb + jj;
            if (r.ok0)
              put2(dx + r.o0, hh, j, u[jj].x + acc[hh][4 * j], u[jj].y + acc[hh][4 * j + 1]);
            if (r.ok1)
              put2(dx + r.o1, hh, j, w[jj].x + acc[hh][4 * j + 2], w[jj].y + acc[hh][4 * j + 3]);
          }
        }
      named_barrier(bar_id, 128);  // every warp's product has read B
      if (l.wtid == 0) {           // and dpre0's store: the next tile's agg (part 0)
        bulk_wait_read<0>();
        if (next < num_tiles) AP::load(sB, &agg_map, row_next, 0, agg0);
      }
    }
  }
  if (l.wtid == 0) bulk_wait<0>();

  // The block's column sums: its tiles' slots in order, each over its eight
  // warps in order.
  __syncthreads();
  const int tiles = (num_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const float* mine = tilepart + (size_t)blockIdx.x * max_tiles * WARPS * NVEC * D;
  for (int i = threadIdx.x; i < NVEC * D; i += THREADS) {
    float s = 0.f;
    for (int t = 0; t < tiles * WARPS; ++t) s += mine[(size_t)t * NVEC * D + i];
    vecpart[(size_t)blockIdx.x * NVEC * D + i] = s;
  }
}

// The weight gradients (see the file comment).
struct DwMaps {
  CUtensorMap a[3], b[3];  // dW_l = A_l^T B_l: A = x, h0, h1; B = dpre0, dpre1, dy
};

template <int D>
struct DwSmem {
  static constexpr int A_BYTES = CONSUMERS * CHUNK;  // 64 columns of A a consumer
  static constexpr int STAGE_BYTES = A_BYTES + D * 128;
  static constexpr int FIT = (SMEM_LIMIT - 1024) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int BYTES = STAGES * STAGE_BYTES + 1024;
};

// Stage q of a weight-gradient block: 64 rows of A's two 64-column slices
// (from column a_col) and of all of B's columns, rows from r_begin.
template <int D>
struct DwStages {
  const CUtensorMap *a, *b;
  int a_col, r_begin, chunks;
  __device__ __forceinline__ void operator()(uint32_t q, uint32_t dst, uint32_t bar) const {
    if ((int)q >= chunks) return;
    const int row = r_begin + q * ROWS;
    mbar_expect_tx(bar, DwSmem<D>::STAGE_BYTES);
#pragma unroll
    for (int k = 0; k < CONSUMERS; ++k) tma_load_2d(dst + k * CHUNK, a, a_col + 64 * k, row, bar);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
      tma_load_2d(dst + DwSmem<D>::A_BYTES + cb * CHUNK, b, 64 * cb, row, bar);
  }
};

// Block (slice, l, z), slice fastest: rows [128 slice, + 128) of dW_l over
// rows [z rows_per_split, + rows_per_split) of n into wpart[z][l].
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    fused_tail_wide_dw_kernel(const __grid_constant__ DwMaps maps, float* __restrict__ wpart,
                              int n, int rows_per_split) {
  using S = DwSmem<D>;
  constexpr int NH = D / 128, SLICES = D / 128;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[S::STAGES];
  __shared__ int counts[S::STAGES];
  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t smem0 = (raw0 + 1023u) & ~1023u;
  const int slice = blockIdx.x % SLICES, w = (blockIdx.x / SLICES) % 3;
  const int z = blockIdx.x / (3 * SLICES);
  const int r_begin = z * rows_per_split;
  const int r_end = n < r_begin + rows_per_split ? n : r_begin + rows_per_split;
  const int chunks = r_end > r_begin ? (r_end - r_begin + ROWS - 1) / ROWS : 0;
  const DwStages<D> load{&maps.a[w], &maps.b[w], 128 * slice, r_begin, chunks};
  Ring<S::STAGES, S::STAGE_BYTES> ring(smem0, smem_addr(&bars[0]), counts);
  if (threadIdx.x == 0) ring.init(load);
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const Lane l;
  float acc[NH][64];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[hh][i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    ring.wait_full();
    const uint32_t st = ring.slab();
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < ROWS / 16; ++ks)
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
        tail::wgmma_ss<1, 1>(acc[hh], st, tile_mn(wg, ks), st + S::A_BYTES, tile_mn(2 * hh, ks),
                             1);
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      ring.release(ring.q - 1, load);
    }
    ++ring.q;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) fence_regs(acc[hh]);

  float* out = wpart + ((size_t)z * 3 + w) * D * D;
  const int m = 128 * slice + 64 * wg + l.r0;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = l.col(hh, j);
      st2(out + (size_t)m * D + c, acc[hh][4 * j], acc[hh][4 * j + 1]);
      st2(out + (size_t)(m + 8) * D + c, acc[hh][4 * j + 2], acc[hh][4 * j + 3]);
    }
}

// Where the backward keeps what passes between and within its kernels, in
// one scratch buffer: the bf16 weights, the bf16 [n, d] operand arrays, the
// chain's per-tile column-sum slots ([chain_blocks][max_tiles][8 warps][5]
// [d] f32) and per-block column sums, and the weight gradients' per-split
// partials.
struct Layout {
  size_t wb, ops, tilepart, vec, wpart, total;
  int chain_blocks, max_tiles, splits, rows_per_split;
};

inline size_t align256(size_t v) { return (v + 255) & ~(size_t)255; }

inline Layout layout(int n, int d, int x_bf16, int sms) {
  Layout lay{};
  const int tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  lay.chain_blocks = tiles < sms ? tiles : sms;
  lay.max_tiles = (tiles + lay.chain_blocks - 1) / lay.chain_blocks;
  const int per_split = 3 * (d / 128);  // blocks a split: slices x weights
  int splits = sms / per_split;
  const int chunks = (n + ROWS - 1) / ROWS;
  splits = splits < chunks ? splits : chunks;
  splits = splits < 1 ? 1 : splits;
  lay.rows_per_split = ((n + splits - 1) / splits + ROWS - 1) / ROWS * ROWS;
  lay.splits = (n + lay.rows_per_split - 1) / lay.rows_per_split;
  const int nops = x_bf16 ? OP_X : NOPS;
  lay.wb = 0;
  lay.ops = align256((size_t)3 * d * d * 2);
  lay.tilepart = align256(lay.ops + (size_t)nops * n * d * 2);
  lay.vec =
      align256(lay.tilepart + (size_t)lay.chain_blocks * lay.max_tiles * WARPS * NVEC * d * 4);
  lay.wpart = align256(lay.vec + (size_t)lay.chain_blocks * NVEC * d * 4);
  lay.total = align256(lay.wpart + (size_t)lay.splits * 3 * d * d * 4);
  return lay;
}

struct Args {
  const void *x, *agg, *g;
  const float *w0, *b0, *w1, *b1, *wf, *bf, *ln_scale;
  void *dx, *dagg;
  unsigned char* scratch;
  float* grads;
  int n;
  cudaStream_t s;
};

template <int D, typename XT, typename AggT>
int chain(const Args& a, const Layout& lay) {
  constexpr auto kernel = fused_tail_wide_chain_kernel<D, XT, AggT>;
  constexpr int smem = ChainSmem<D>::BYTES;
  int sms = 0;
  cudaError_t err = tail::launch_setup<kernel>(smem, 0, &sms);
  if (err != cudaSuccess) return (int)err;
  bf16* wb = reinterpret_cast<bf16*>(a.scratch + lay.wb);
  bf16* ops = reinterpret_cast<bf16*>(a.scratch + lay.ops);
  if ((err = convert_weights(a.w0, a.w1, a.wf, wb, D, a.s)) != cudaSuccess) return (int)err;
  CUtensorMap wfwd = {}, wbwd = {}, xm = {}, gm = {}, am = {}, dxm = {};
  OpMaps om = {};
  bool ok = bf16_map(&wfwd, wb, D, 3 * D, 64) && bf16_map(&wbwd, wb, D, 3 * D, D) &&
            row_map<AggT>(&am, a.agg, D, a.n);
  if (sizeof(XT) == 2)
    ok = ok && row_map<XT>(&xm, a.x, D, a.n) && row_map<XT>(&gm, a.g, D, a.n) &&
         row_map<XT>(&dxm, a.dx, D, a.n);
  const int nops = sizeof(XT) == 2 ? OP_X : NOPS;
  for (int k = 0; k < nops; ++k)
    ok = ok && bf16_map(&om.m[k], ops + (size_t)k * a.n * D, D, a.n, ROWS);
  if (!ok) return (int)cudaErrorInvalidValue;
  kernel<<<lay.chain_blocks, THREADS, smem, a.s>>>(
      wfwd, wbwd, xm, gm, am, dxm, om, static_cast<const XT*>(a.x), static_cast<const AggT*>(a.agg),
      static_cast<const XT*>(a.g), a.b0, a.b1, a.bf, a.ln_scale, static_cast<XT*>(a.dx),
      static_cast<AggT*>(a.dagg), reinterpret_cast<float*>(a.scratch + lay.tilepart),
      reinterpret_cast<float*>(a.scratch + lay.vec), lay.max_tiles, a.n);
  return (int)cudaGetLastError();
}

template <int D>
int dw(const void* x, int x_bf16, unsigned char* scratch, const Layout& lay, int n,
       cudaStream_t s) {
  constexpr auto kernel = fused_tail_wide_dw_kernel<D>;
  constexpr int smem = DwSmem<D>::BYTES;
  int sms = 0;
  cudaError_t err = tail::launch_setup<kernel>(smem, 0, &sms);
  if (err != cudaSuccess) return (int)err;
  const bf16* ops = reinterpret_cast<const bf16*>(scratch + lay.ops);
  const size_t nd = (size_t)n * D;
  const void* xa = x_bf16 ? x : ops + OP_X * nd;
  const void* as[3] = {xa, ops + OP_H0 * nd, ops + OP_H1 * nd};
  const void* bs[3] = {ops + OP_DP0 * nd, ops + OP_DP1 * nd, ops + OP_DY * nd};
  DwMaps maps = {};
  for (int k = 0; k < 3; ++k)
    if (!bf16_map(&maps.a[k], as[k], D, n, ROWS) || !bf16_map(&maps.b[k], bs[k], D, n, ROWS))
      return (int)cudaErrorInvalidValue;
  kernel<<<3 * (D / 128) * lay.splits, THREADS, smem, s>>>(
      maps, reinterpret_cast<float*>(scratch + lay.wpart), n, lay.rows_per_split);
  return (int)cudaGetLastError();
}

// grads = [dW0, dW1, dWf (sums of the splits' partials), db0, db1, dbf,
// dscale, dbias (sums of the chain blocks')], each in a fixed order.
int reduce(int d, unsigned char* scratch, const Layout& lay, float* grads, cudaStream_t s) {
  const int wg = 3 * d * d, vg = NVEC * d;
  tail::reduce_partials_kernel<<<(wg + 255) / 256, 256, 0, s>>>(
      reinterpret_cast<const float*>(scratch + lay.wpart), lay.splits, wg, grads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tail::reduce_partials_kernel<<<(vg + 255) / 256, 256, 0, s>>>(
      reinterpret_cast<const float*>(scratch + lay.vec), lay.chain_blocks, vg, grads + wg);
  return (int)cudaGetLastError();
}

template <int D>
int chain_d(const Args& a, int x_bf16, int agg_bf16, const Layout& lay) {
  if (x_bf16) return agg_bf16 ? chain<D, bf16, bf16>(a, lay) : chain<D, bf16, float>(a, lay);
  if constexpr (D == 128) return (int)cudaErrorInvalidValue;  // the tuned kernel's layout
  else
    return agg_bf16 ? chain<D, float, bf16>(a, lay) : chain<D, float, float>(a, lay);
}

// The layout for these arguments, or false where they are refused.
bool checked_layout(int n, int d, int x_bf16, int sms, long long scratch_bytes, Layout* lay) {
  if ((d != 128 && d != 256) || sms < 1 || n < 1 || (d == 128 && !x_bf16)) return false;
  *lay = layout(n, d, x_bf16, sms);
  return (long long)lay->total <= scratch_bytes;
}

}  // namespace

// The backward's scratch layout for n rows of width d on a device of `sms`
// SMs: out[0..7] = the byte offsets of the bf16 weights, the operand
// arrays (h0, h1, dy, dpre1, dpre0 and, for an f32 x, bf16(x); [n, d]
// each), the chain's column-sum partials ([chain_blocks][5][d] f32) and
// the weight-gradient partials ([splits][3][d][d] f32), the total bytes,
// chain_blocks, splits and rows_per_split. Returns 0, or
// cudaErrorInvalidValue for a width it does not take.
extern "C" int fused_tail_wide_bwd_layout(int n, int d, int x_bf16, int sms, long long* out) {
  Layout lay;
  if (!checked_layout(n, d, x_bf16, sms, LLONG_MAX, &lay)) return (int)cudaErrorInvalidValue;
  const long long v[8] = {(long long)lay.wb,    (long long)lay.ops,   (long long)lay.vec,
                          (long long)lay.wpart, (long long)lay.total, lay.chain_blocks,
                          lay.splits,           lay.rows_per_split};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// The backward's stages, each on `stream` and into the scratch of
// fused_tail_wide_bwd_layout: the chain (the weights' conversion, then dx,
// dagg, the operand arrays and the column-sum partials), the weight
// gradients' partials (after the chain), and the fixed-order reduction of
// both into grads (after both). fused_tail_wide_bwd_launch runs the three.
extern "C" int fused_tail_wide_bwd_chain_launch(
    const void* x, const void* agg, const void* g, int x_bf16, int agg_bf16, int d,
    const float* w0, const float* b0, const float* w1, const float* b1, const float* wf,
    const float* bf, const float* ln_scale, void* dx, void* dagg, void* scratch,
    long long scratch_bytes, int sms, int n, void* stream) {
  Layout lay;
  if (!checked_layout(n, d, x_bf16, sms, scratch_bytes, &lay)) return (int)cudaErrorInvalidValue;
  const Args a{x,  agg, g,  w0, b0, w1, b1, wf, bf, ln_scale, dx, dagg,
               static_cast<unsigned char*>(scratch), nullptr, n, static_cast<cudaStream_t>(stream)};
  return d == 128 ? chain_d<128>(a, x_bf16, agg_bf16, lay) : chain_d<256>(a, x_bf16, agg_bf16, lay);
}

extern "C" int fused_tail_wide_bwd_dw_launch(const void* x, int x_bf16, int d, void* scratch,
                                             long long scratch_bytes, int sms, int n,
                                             void* stream) {
  Layout lay;
  if (!checked_layout(n, d, x_bf16, sms, scratch_bytes, &lay)) return (int)cudaErrorInvalidValue;
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 128 ? dw<128>(x, x_bf16, sc, lay, n, s) : dw<256>(x, x_bf16, sc, lay, n, s);
}

extern "C" int fused_tail_wide_bwd_reduce_launch(int x_bf16, int d, void* scratch,
                                                 long long scratch_bytes, int sms, float* grads,
                                                 int n, void* stream) {
  Layout lay;
  if (!checked_layout(n, d, x_bf16, sms, scratch_bytes, &lay)) return (int)cudaErrorInvalidValue;
  return reduce(d, static_cast<unsigned char*>(scratch), lay, grads,
                static_cast<cudaStream_t>(stream));
}

// The width-general backward. x, g, dx: [n, d] f32 (x_bf16 = 0) or bf16;
// agg, dagg: [n, d] f32 (agg_bf16 = 0) or bf16; w0, w1, wf: [d, d] f32
// ([in, out]); b0, b1, bf, ln_scale: [d] f32; scratch: at least the
// layout's total bytes, 256-byte aligned; grads: out, 3 d^2 + 5 d f32 =
// dW0, dW1, dWf, db0, db1, dbf, dscale, dbias. d = 256, or 128 with a bf16
// x (an f32 x at 128 is the tuned kernel's); all contiguous and 16-byte
// aligned. Launches on `stream`, does not synchronize, returns the
// cudaError_t.
extern "C" int fused_tail_wide_bwd_launch(const void* x, const void* agg, const void* g,
                                          int x_bf16, int agg_bf16, int d, const float* w0,
                                          const float* b0, const float* w1, const float* b1,
                                          const float* wf, const float* bf,
                                          const float* ln_scale, void* dx, void* dagg,
                                          void* scratch, long long scratch_bytes, int sms,
                                          float* grads, int n, void* stream) {
  if (n <= 0) {
    if ((d != 128 && d != 256) || sms < 1) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaMemsetAsync(grads, 0, (3 * d * d + NVEC * d) * sizeof(float),
                                            static_cast<cudaStream_t>(stream));
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  int err = fused_tail_wide_bwd_chain_launch(x, agg, g, x_bf16, agg_bf16, d, w0, b0, w1, b1, wf,
                                             bf, ln_scale, dx, dagg, scratch, scratch_bytes, sms,
                                             n, stream);
  if (err == 0) err = fused_tail_wide_bwd_dw_launch(x, x_bf16, d, scratch, scratch_bytes, sms, n,
                                                    stream);
  if (err == 0)
    err = fused_tail_wide_bwd_reduce_launch(x_bf16, d, scratch, scratch_bytes, sms, grads, n,
                                            stream);
  return err;
}
