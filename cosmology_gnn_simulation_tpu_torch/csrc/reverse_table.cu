// K7: the cell-block plan's reverse selection table and its edge total.
//
// Replaces the JAX package's TPU kernel ops/cellblock.py::
// _reverse_table_kernel (pallas_call in the same function) and the
// packed_pad gather that feeds it (_build_reverse_table). For sender tile t,
// ring column j and window row p (padded-image row start[t, j] + p, a
// candidate RECEIVER image of slot s = pad_src[row]):
//   S_rev[t, j*W + p, q] = #{kk < k : packs[s, kk] == t*QB + q}
// if the row speaks for its particle, else 0. A row speaks for its particle
// iff it IS the particle's main image or the main image lies outside this
// window (a particle counts once per window). The main image of pack s of
// the window's column is main_base[t, j] + s, the tile's first pack is
// tile_base[t], and rows p >= lims[t, j] never speak; pad_src == num_slots
// marks an unused row (no senders). Lanes q in [QB, rev_lanes) are never
// set. int8 counts: k <= 127. `total` (zeroed by the caller) gains the
// number of counted edges, the sum of the table, for the transpose
// certificate reverse_mismatch.
//
// Bound on the H100: bytes — the table it writes (rev_lanes bytes a row,
// 213 MB at the flagship spec) against k ints a row read. The earlier
// design gave each row one warp, a 64-bit division, three dependent global
// loads, a zeroed shared row with byte atomics and two __syncwarps: bound by
// latency at ~98 serial rows a warp. Design: one block of 128 threads a
// work item of 64 consecutive rows of one (tile, ring column) window (16 KB
// of output at the flagship; a window is W / 64 items). The block loads the
// item's pad_src entries, then every sender of every row, as flat coalesced
// loads independent of each other, into a shared [64, k] table of tile
// ranks (-1 where the edge does not count). Then ROW_LANES lanes own a row,
// 16 output bytes each: they vote (ballot) on which of the row's senders
// count, walk the few set bits, and each lane adds the ones in its 16 bytes
// in registers; no shared atomics, no zero pass. rev_lanes 128, 256 and 512
// give 8, 16 and 32 lanes a row; any other multiple of 16 (QB past 256 and
// not a multiple of 128) takes the generic instantiation: a warp a row, in
// as many 512-byte passes as the row needs, lanes past its end idle. Rows leave by 16-byte
// streaming stores (__stcs: S_rev is larger than L2 and not read back here).
// The total is a warp reduce and one atomicAdd a block.
//
// The per-window main_base and lims and the per-tile tile_base come from the
// layout, uniform or variable: in the variable one, columns pack their
// padded rows at data-dependent 16-aligned prefixes, so none of them follows
// from strides; a window can reach into the next column's rows, which never
// speak, and reserve tiles get a base past every sender. Small items on many
// small blocks let the block scheduler keep stores in flight while other
// blocks wait on their loads; whole windows a block, and a persistent grid
// that pipelines the next item's loads under the current one's stores, both
// ran slower.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // rows a block

// ROW_LANES = 8, 16, 32: rows of exactly ROW_LANES * 16 bytes. ROW_LANES = 0:
// the generic rows of row_chunks 16-byte chunks (any count), a warp a row.
template <int ROW_LANES>
__global__ void __launch_bounds__(kThreads)
    reverse_table_kernel(const int* __restrict__ packs, const long long* __restrict__ pad_src,
                         const int* __restrict__ starts, const int* __restrict__ tile_base,
                         const int* __restrict__ lims, const int* __restrict__ main_bases,
                         uint8_t* __restrict__ out, int* __restrict__ total, int num_slots,
                         int qb, int w, int k, int per_win, int row_chunks) {
  constexpr int kLanes = ROW_LANES ? ROW_LANES : 32;  // lanes a row
  constexpr int kGroups = 32 / kLanes;                // rows a warp writes at once
  const int chunks = ROW_LANES ? ROW_LANES : row_chunks;
  const size_t row_bytes = (size_t)chunks * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  int* src = reinterpret_cast<int*>(smem);                  // [kChunk] slot, or -1
  int16_t* rank = reinterpret_cast<int16_t*>(src + kChunk);  // [kChunk, k] tile rank, or -1
  __shared__ int warp_sums[kWarps];

  const int win = blockIdx.x / per_win;  // t * 9 + j
  const int r0 = (blockIdx.x - win * per_win) * kChunk;
  const int rows = min(kChunk, w - r0);
  const int start = starts[win];
  const int base = tile_base[win / 9], main_base = main_bases[win], lim = lims[win];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int p = threadIdx.x; p < rows; p += kThreads) {
    const int row = start + r0 + p;
    const int s = (int)pad_src[row];
    const int main_row = main_base + s;
    const bool speaks = (main_row == row || main_row < start || main_row >= start + w) &&
                        r0 + p < lim;
    src[p] = (s < num_slots && speaks) ? s : -1;
  }
  __syncthreads();

  // Flat walk of the [rows, k] senders; (p, kk) advance without a division.
  int count = 0;
  {
    const int dp = kThreads / k, dk = kThreads % k;
    int p = threadIdx.x / k, kk = threadIdx.x % k;
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * k; e += kThreads) {
      const int s = src[p];
      int q = -1;
      if (s >= 0) {
        const int l = packs[(size_t)s * k + kk] - base;
        if (l >= 0 && l < qb) q = l;
      }
      rank[e] = (int16_t)q;
      count += q >= 0;
      kk += dk;
      p += dp;
      if (kk >= k) {
        kk -= k;
        ++p;
      }
    }
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int i = 0; i < kWarps; ++i) sum += warp_sums[i];
    if (sum) atomicAdd(total, sum);
  }

  const int grp = lane / kLanes, rl = lane % kLanes;
  unsigned grp_mask = 0xffffffffu;
  if constexpr (kLanes < 32) grp_mask = ((1u << kLanes) - 1u) << (grp * kLanes);
  uint8_t* out_rows = out + ((size_t)win * w + r0) * row_bytes;
  for (int p0 = warp * kGroups; p0 < rows; p0 += kWarps * kGroups) {
    const int p = p0 + grp;
    const bool live = p < rows;
    const int16_t* row = rank + (size_t)(live ? p : 0) * k;
    // One pass for the fixed widths; the generic width walks the row's
    // senders once for every 32 chunks (512 bytes) of it.
    for (int c0 = 0; c0 < chunks; c0 += kLanes) {
      const int chunk = c0 + rl;
      uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
      for (int c = 0; c < k; c += kLanes) {
        const int kk = c + rl;
        const bool hit = live && kk < k && row[kk] >= 0;
        unsigned bits = __ballot_sync(0xffffffffu, hit) & grp_mask;
        bits >>= grp * kLanes;
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          const int q = row[c + b];
          if ((q >> 4) == chunk) {
            const uint32_t inc = 1u << ((q & 3) * 8);
            const int word = (q >> 2) & 3;
            a0 += word == 0 ? inc : 0u;
            a1 += word == 1 ? inc : 0u;
            a2 += word == 2 ? inc : 0u;
            a3 += word == 3 ? inc : 0u;
          }
        }
      }
      if (live && (ROW_LANES || chunk < chunks)) {
        int4* dst = reinterpret_cast<int4*>(out_rows + (size_t)p * row_bytes) + chunk;
        __stcs(dst, make_int4((int)a0, (int)a1, (int)a2, (int)a3));
      }
    }
  }
}

template <int ROW_LANES>
int launch(const int* packs, const long long* pad_src, const int* starts,
           const int* tile_base, const int* lims, const int* main_bases, void* out, int* total,
           int num_tiles, int num_slots, int qb, int w, int k, int row_chunks,
           cudaStream_t stream) {
  const int per_win = (w + kChunk - 1) / kChunk;
  const size_t smem = (size_t)kChunk * (4 + 2 * k);  // <= 16.5 KB at k = 127
  reverse_table_kernel<ROW_LANES><<<(unsigned)num_tiles * 9 * per_win, kThreads, smem, stream>>>(
      packs, pad_src, starts, tile_base, lims, main_bases, static_cast<uint8_t*>(out), total,
      num_slots, qb, w, k, per_win, row_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). packs [num_slots, k] int32;
// pad_src [num_padded] int64 (the layout's padded-image map, num_slots for
// unused rows); starts [num_tiles, 9] int32 (each window starting in its
// ring column's span); tile_base [num_tiles], lims and main_bases
// [num_tiles, 9] int32 (the layout's tile_pack_base, window_lims and
// main_base); out
// [num_tiles, 9 * w, rev_lanes] int8; total one int32, zeroed by the
// caller; all contiguous. rev_lanes % 16 == 0, qb <= rev_lanes,
// 1 <= k <= 127. Launches on `stream`, does not synchronize, returns the
// cudaError_t.
extern "C" int reverse_table_launch(const int* packs, const long long* pad_src,
                                    const int* starts, const int* tile_base, const int* lims,
                                    const int* main_bases, void* out, int* total,
                                    int num_tiles, int num_slots, int qb, int w, int k,
                                    int rev_lanes, void* stream) {
  if (qb <= 0 || qb > rev_lanes || rev_lanes % 16 || w <= 0 || k < 1 || k > 127 ||
      total == nullptr || tile_base == nullptr || lims == nullptr || main_bases == nullptr)
    return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = rev_lanes / 16;
#define REVERSE_TABLE_ARGS                                                                   \
  packs, pad_src, starts, tile_base, lims, main_bases, out, total, num_tiles, num_slots, \
      qb, w, k, chunks, s
  switch (rev_lanes) {
    case 128:
      return launch<8>(REVERSE_TABLE_ARGS);
    case 256:
      return launch<16>(REVERSE_TABLE_ARGS);
    case 512:
      return launch<32>(REVERSE_TABLE_ARGS);
    default:
      return launch<0>(REVERSE_TABLE_ARGS);
  }
#undef REVERSE_TABLE_ARGS
}
