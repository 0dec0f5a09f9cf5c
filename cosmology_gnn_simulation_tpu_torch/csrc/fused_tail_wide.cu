// K5, width-general: the message-passing step tail's forward at
// latent = hidden = 256 (an f32 or a bf16 carry) or 128 (a bf16 carry; the
// f32 carry at 128 is fused_tail.cu's tuned kernel).
//
// Replaces the JAX package's TPU kernel ops/fused_step.py::_tail_kernel
// (pallas_call in _tail_core), at these widths:
//   h   = relu(bf16(x) @ bf16(W0) + agg + b0)
//   h   = relu(bf16(h) @ bf16(W1) + b1)
//   y   = bf16(h) @ bf16(Wf) + bf
//   out = x + LayerNorm(y) * scale + bias          (f32, eps 1e-5)
// rounded once to x's type; agg f32 (K4's sums) or bf16.
//
// Bound on the H100: bytes. At width 256 a row reads x (512 B bf16) and agg
// (1 KB f32) and writes 512 B against 3 * 2 * 256 * 256 = 393 kFLOP: 192
// FLOP/B, under the card's ~295 FLOP/B ridge. The weights (3 x 128 KB bf16)
// do not fit in shared memory beside the tiles, so they are streamed from
// L2, once a 128-row tile (3 KB a row, more than the row's own 2 KB).
//
// Design (tail_wide.cuh): a persistent block of two warpgroups walks
// 128-row tiles, the weights streamed by TMA through a ring of 64-row slabs
// (three of 32 KB at width 256) that both warpgroups multiply by (wgmma,
// A a tile of theirs, B the slab). A warpgroup's row data moves through its
// two tiles by TMA, each copy issued as soon as its tile is free:
//   A: x (the first product's A) -> agg's second half (f32) -> x again
//      (the residual) -> the next tile's x;
//   B: agg's first half (issued during the last tile) -> h0 -> h1 -> the
//      output, stored by TMA.
// Bias, agg and ReLU act on the accumulators; each layer's output is
// rounded into B as the next product's A; LayerNorm reduces a row across
// the four lanes of a quad. An f32 carry is rounded into A by the threads,
// and its residual and output go to and from L2 in the accumulator layout.
#include "tail_wide.cuh"

namespace {

using namespace tailw;

// Slab q of a block's sequence: the forward slabs of W0, W1 and Wf for each
// tile of its walk, nothing past its last tile.
template <int D>
struct Slabs {
  const CUtensorMap* map;
  int num_tiles;
  __device__ __forceinline__ void operator()(uint32_t q, uint32_t dst, uint32_t bar) const {
    constexpr int PER_TILE = 3 * Wide<D>::NS;
    const int pos = q % PER_TILE;
    if (blockIdx.x + (int)(q / PER_TILE) * gridDim.x >= num_tiles) return;
    mbar_expect_tx(bar, Wide<D>::SLAB_BYTES);
    load_fwd_slab<D>(dst, map, pos / Wide<D>::NS, pos % Wide<D>::NS, bar);
  }
};

template <int D>
struct Smem {
  using W = Wide<D>;
  // Two tiles a warpgroup (A, B), then the ring.
  static constexpr int OFF_RING = CONSUMERS * 2 * W::TILE_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - OFF_RING) / W::SLAB_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int BYTES = OFF_RING + STAGES * W::SLAB_BYTES + 1024;  // + alignment
  static_assert(STAGES >= 2 && BYTES <= SMEM_LIMIT, "shared memory");
};

template <int D, typename XT, typename AggT>
__global__ void __launch_bounds__(THREADS, 1) fused_tail_wide_kernel(
    const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap x_map,
    const __grid_constant__ CUtensorMap agg_map, const __grid_constant__ CUtensorMap out_map,
    const XT* __restrict__ x, const float* __restrict__ b0, const float* __restrict__ b1,
    const float* __restrict__ bf, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, XT* __restrict__ out, const AggT* __restrict__ agg,
    int n) {
  using S = Smem<D>;
  using W = Wide<D>;
  using AP = AggParts<D, AggT>;
  constexpr int NH = W::NH;
  constexpr bool BF16 = sizeof(XT) == 2;  // x in and out through TMA
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[S::STAGES + 4 * CONSUMERS];  // full; x, agg 0, agg 1, res
  __shared__ int counts[S::STAGES];

  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t smem0 = (raw0 + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (smem0 - raw0);
  const uint32_t full0 = smem_addr(&bars[0]), xfull0 = full0 + 8 * S::STAGES;
  const int num_tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  const Slabs<D> load{&w_map, num_tiles};
  Ring<S::STAGES, W::SLAB_BYTES> ring(smem0 + S::OFF_RING, full0, counts);
  const int wg = threadIdx.x >> 7;
  const Lane l;
  const int bar_id = 1 + wg;  // the warpgroup's named barrier
  // The warpgroup's tiles A and B (see the file comment).
  unsigned char* tA = smem + wg * 2 * W::TILE_BYTES;
  unsigned char* tB = tA + W::TILE_BYTES;
  const uint32_t sA = smem0 + wg * 2 * W::TILE_BYTES, sB = sA + W::TILE_BYTES;
  const uint32_t xfull = xfull0 + 8 * wg, agg0 = xfull + 8 * CONSUMERS;
  const uint32_t agg1 = agg0 + 8 * CONSUMERS, resfull = agg1 + 8 * CONSUMERS;
  if (threadIdx.x == 0) {
    for (int c = 0; c < 4 * CONSUMERS; ++c) mbar_init(xfull0 + 8 * c, 1);
    ring.init(load);  // fences the barriers' initialisation
  }
  __syncthreads();
  const Frag f(l);
  int tile = blockIdx.x;
  if (l.wtid == 0 && tile < num_tiles) {
    if (BF16) load_tile<D>(sA, &x_map, tile * TILE_ROWS + wg * ROWS, xfull);
    AP::load(sB, &agg_map, tile * TILE_ROWS + wg * ROWS, 0, agg0);
  }

  for (uint32_t it = 0; tile < num_tiles; ++it, tile += gridDim.x) {
    const int row0 = tile * TILE_ROWS + wg * ROWS, next = tile + gridDim.x;
    const int row_next = next * TILE_ROWS + wg * ROWS;
    const float *b0t = fresh(b0) + 2 * l.tig, *b1t = fresh(b1) + 2 * l.tig;
    const float *bft = fresh(bf) + 2 * l.tig, *sct = fresh(ln_scale) + 2 * l.tig;
    const float* bbt = fresh(ln_bias) + 2 * l.tig;
    if (threadIdx.x == 0 && next < num_tiles) {
      prefetch_tile<D>(x, next, n);
      prefetch_tile<D>(agg, next, n);
    }
    if constexpr (BF16) {
      mbar_wait(xfull, it & 1);
    } else {
      load_tile_f32<D>(tA, reinterpret_cast<const float*>(x), row0, n, l.wtid);
      fence_async_smem();
      named_barrier(bar_id, 128);
    }

    // h0 = relu(x W0 + agg + b0).
    float acc[NH][64];
    product<D, true>(acc, sA, ring, load);
    if constexpr (AP::PARTS == 2) {
      named_barrier(bar_id, 128);  // every warp's product has read A
      if (l.wtid == 0) AP::load(sA, &agg_map, row0, 1, agg1);
    }
    mbar_wait(agg0, it & 1);
    if constexpr (AP::PARTS == 2) mbar_wait(agg1, it & 1);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb = at2(b0t, hh, j);
        const float2 e0 = AP::pair(tB, tA, f, hh, j, 0), e1 = AP::pair(tB, tA, f, hh, j, 1);
        acc[hh][4 * j] = fmaxf(acc[hh][4 * j] + e0.x + bb.x, 0.f);
        acc[hh][4 * j + 1] = fmaxf(acc[hh][4 * j + 1] + e0.y + bb.y, 0.f);
        acc[hh][4 * j + 2] = fmaxf(acc[hh][4 * j + 2] + e1.x + bb.x, 0.f);
        acc[hh][4 * j + 3] = fmaxf(acc[hh][4 * j + 3] + e1.y + bb.y, 0.f);
      }
    named_barrier(bar_id, 128);  // agg read: A takes the residual's x, B h0
    if (BF16 && l.wtid == 0) load_tile<D>(sA, &x_map, row0, resfull);
    stage<D>(tB, acc, f);
    fence_async_smem();
    named_barrier(bar_id, 128);

    product<D, true>(acc, sB, ring, load);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb = at2(b1t, hh, j);
        acc[hh][4 * j] = fmaxf(acc[hh][4 * j] + bb.x, 0.f);
        acc[hh][4 * j + 1] = fmaxf(acc[hh][4 * j + 1] + bb.y, 0.f);
        acc[hh][4 * j + 2] = fmaxf(acc[hh][4 * j + 2] + bb.x, 0.f);
        acc[hh][4 * j + 3] = fmaxf(acc[hh][4 * j + 3] + bb.y, 0.f);
      }
    named_barrier(bar_id, 128);
    stage<D>(tB, acc, f);
    fence_async_smem();
    named_barrier(bar_id, 128);

    // y = h1 Wf + bf; out = x + LN(y) * scale + bias.
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
    layer_norm<NH>(acc, rstd, D);
    named_barrier(bar_id, 128);  // every warp's product has read B
    if constexpr (BF16) {  // the residual from A, the output through B
      mbar_wait(resfull, it & 1);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 sc = at2(sct, hh, j), bb = at2(bbt, hh, j);
          const float2 x0 = bf16_pair(tA, f.b16(hh, j, 0)), x1 = bf16_pair(tA, f.b16(hh, j, 1));
          put_bf16_pair(tB, f.b16(hh, j, 0), x0.x + (acc[hh][4 * j] * rstd[0] * sc.x + bb.x),
                        x0.y + (acc[hh][4 * j + 1] * rstd[0] * sc.y + bb.y));
          put_bf16_pair(tB, f.b16(hh, j, 1), x1.x + (acc[hh][4 * j + 2] * rstd[1] * sc.x + bb.x),
                        x1.y + (acc[hh][4 * j + 3] * rstd[1] * sc.y + bb.y));
        }
      fence_async_smem();
      named_barrier(bar_id, 128);
      if (l.wtid == 0) {  // the next tile's x, and its agg once the store has read B
        store_tile<D>(&out_map, row0, sB);
        if (next < num_tiles) {
          load_tile<D>(sA, &x_map, row_next, xfull);
          bulk_wait_read<0>();
          AP::load(sB, &agg_map, row_next, 0, agg0);
        }
      }
    } else {  // f32: the residual from L2, the output stored from registers
      if (l.wtid == 0 && next < num_tiles) AP::load(sB, &agg_map, row_next, 0, agg0);
      const RowsAt r(row0, l, n, D);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        float2 x0[16], x1[16];
        load_pairs<16>(x0, x1, x + r.o0, x + r.o1, r.ok0, r.ok1, hh, 0);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 sc = at2(sct, hh, j), bb = at2(bbt, hh, j);
          if (r.ok0)
            put2(out + r.o0, hh, j, x0[j].x + (acc[hh][4 * j] * rstd[0] * sc.x + bb.x),
                 x0[j].y + (acc[hh][4 * j + 1] * rstd[0] * sc.y + bb.y));
          if (r.ok1)
            put2(out + r.o1, hh, j, x1[j].x + (acc[hh][4 * j + 2] * rstd[1] * sc.x + bb.x),
                 x1[j].y + (acc[hh][4 * j + 3] * rstd[1] * sc.y + bb.y));
        }
      }
    }
  }
  if (l.wtid == 0) bulk_wait<0>();
}

template <int D, typename XT, typename AggT>
int launch(const void* x, const void* agg, const float* w0, const float* b0, const float* w1,
           const float* b1, const float* wf, const float* bf, const float* ln_scale,
           const float* ln_bias, void* wb, void* out, int n, cudaStream_t stream) {
  constexpr auto kernel = fused_tail_wide_kernel<D, XT, AggT>;
  constexpr int smem = Smem<D>::BYTES;
  int sms = 0;
  cudaError_t err = tail::launch_setup<kernel>(smem, 0, &sms);
  if (err != cudaSuccess) return (int)err;
  bf16* w = static_cast<bf16*>(wb);
  if ((err = convert_weights(w0, w1, wf, w, D, stream)) != cudaSuccess) return (int)err;
  CUtensorMap w_map = {}, x_map = {}, agg_map = {}, out_map = {};
  if (!bf16_map(&w_map, w, D, 3 * D, 64) || !row_map<AggT>(&agg_map, agg, D, n) ||
      (sizeof(XT) == 2 && (!row_map<XT>(&x_map, x, D, n) || !row_map<XT>(&out_map, out, D, n))))
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  kernel<<<tiles < sms ? tiles : sms, THREADS, smem, stream>>>(
      w_map, x_map, agg_map, out_map, static_cast<const XT*>(x), b0, b1, bf, ln_scale, ln_bias,
      static_cast<XT*>(out), static_cast<const AggT*>(agg), n);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* x, const void* agg, int x_bf16, int agg_bf16, const float* w0,
             const float* b0, const float* w1, const float* b1, const float* wf, const float* bf,
             const float* ln_scale, const float* ln_bias, void* wb, void* out, int n,
             cudaStream_t s) {
#define WIDE_ARGS x, agg, w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, wb, out, n, s
  if (x_bf16)
    return agg_bf16 ? launch<D, bf16, bf16>(WIDE_ARGS) : launch<D, bf16, float>(WIDE_ARGS);
  if constexpr (D == 128) return (int)cudaErrorInvalidValue;  // the tuned kernel's layout
  else
    return agg_bf16 ? launch<D, float, bf16>(WIDE_ARGS) : launch<D, float, float>(WIDE_ARGS);
#undef WIDE_ARGS
}

}  // namespace

// The width-general forward. x, out: [n, d] f32 (x_bf16 = 0) or bf16; agg:
// [n, d] f32 (agg_bf16 = 0) or bf16; w0, w1, wf: [d, d] f32 in the JAX
// [in, out] layout; b0, b1, bf, ln_scale, ln_bias: [d] f32; wb: scratch of
// 3 * d * d bf16 (the converted weights). d = 256, or 128 with a bf16 x
// (an f32 x at 128 is the tuned kernel's); all contiguous and 16-byte
// aligned, out not aliasing x. Launches on `stream`, does not synchronize,
// returns the cudaError_t.
extern "C" int fused_tail_wide_launch(const void* x, const void* agg, int x_bf16, int agg_bf16,
                                      int d, const float* w0, const float* b0, const float* w1,
                                      const float* b1, const float* wf, const float* bf,
                                      const float* ln_scale, const float* ln_bias, void* wb,
                                      void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return launch_d<128>(x, agg, x_bf16, agg_bf16, w0, b0, w1, b1, wf, bf, ln_scale, ln_bias,
                         wb, out, n, s);
  if (d == 256)
    return launch_d<256>(x, agg, x_bf16, agg_bf16, w0, b0, w1, b1, wf, bf, ln_scale, ln_bias,
                         wb, out, n, s);
  return (int)cudaErrorInvalidValue;
}
