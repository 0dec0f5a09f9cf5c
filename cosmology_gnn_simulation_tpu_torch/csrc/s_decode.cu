// K2: the k-NN candidate codes -> S-lane offsets of the cell-block plan,
// with the count of dropped edges.
//
// Replaces the JAX package's TPU kernel ops/cellblock.py::
// _s_from_codes_fused (its decode body; pallas_call in the same function)
// and the XLA code around it that moves the codes to their slots, resolves
// the spill codes and pre-normalizes them. Per slot s of query tile t and
// pick p, with the slot's sorted particle (particle_of_slot) and its z-cell
// qz, the slot's codes row is rows[particle]: below num_rows a row of
// `codes` (the particle-order codes [N, k], rows = the sort order; or K1''s
// cell-table output [G^3 * cap, k], rows = cell * cap + rank), past it a row
// of `picks` (the spilled queries' solved picks, table layout only). The two
// sources are read in place, not copied into one array. An empty slot has
// no edge. A pick at or past the valid lanes (27 * cap + spill_len: an
// exhausted pick, as K1' writes it) repeats its row's first code (the
// particle layout's k-NN wrapper has already done so).
//   * ring codes (< 27 * cap) are j27 * cap + rank, j27 = (dx+1) * 9 +
//     (dy+1) * 3 + (dz+1): the sender's column rank is the compact start of
//     z-cell (qz + dz) mod G in ring column jring = (dx+1) * 3 + (dy+1) of
//     the tile's column (cstart_rel), plus rank;
//   * spill codes 27 * cap + i (i < spill_len) name spilled particle i:
//     its cell and in-cell rank (spill_cells, spill_ranks) give its column
//     and rank; past its column's capacity it is no edge, outside the tile
//     column's 3x3 ring a dropped edge;
//   * anything else is no edge;
//   * with the tile's window constants (w_loc, cP, m, cA, cstart_g1) of the
//     sender's ring column, the sender sits in the window's main image, its
//     z-wrap prefix copy or its append copy at offset off; the output is
//     jring * W + off, 9W + 1 for a dropped edge (a real sender that no
//     window row holds) and 9W for no edge, as int16.
// Integer arithmetic only: bit-equal to the plain PyTorch version (the
// torch slot scatter, normalization and 27-roll start table, then the
// decode). `dropped` (zeroed by the caller) gains the number of 9W + 1
// offsets.
//
// Bound on the H100: bytes (codes read, offsets written; ~9 MB at the
// flagship). The earlier kernel ran one thread a (slot, pick) on codes that
// torch had scattered to slots and normalized (dozens of small launches),
// with a 64-bit division and about nine 32-bit divisions a thread and
// per-element gathers of a 27-roll start table and the tile constants: bound
// by integer-division issue. Design: one block a query tile (its slots share
// one column, so its 3x3 ring and window constants). The block stages the
// tile's 45 constants and its 9 ring columns' G compact starts in shared
// memory, and each slot's particle and z-cell once; then each thread decodes
// 8 picks of one slot from two 16-byte code loads and writes one 16-byte
// vector of offsets (k = 8, 16, 32, 64; other k one pick a thread). 32-bit
// index arithmetic; the one runtime division a ring pick needs is by cap.
// Dropped edges: a warp reduce and one atomicAdd a block.
//
// Each tile's column comes from tile_col: in the variable layout
// (per-column capacities at data-dependent QB-aligned prefixes) a tile still
// lies in one column, but its column does not follow from slot0 / CC
// (reserve tiles past the last prefix hold empty slots and decode to no
// edge). Senders keep their pack
// ranks (compact rank within the column), and a rank at or past the ring
// column's used rows m names a slot the column does not own: no edge, as in
// the uniform layout, where ranks past m cannot occur.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;

struct Tile {
  const int* consts;   // shared [45]: (w_loc, cP, m, cA, cstart_g1) per ring column
  const int* starts;   // shared [9, G]: compact starts of the ring columns' z-cells
  const int* spill_cells;
  const int* spill_ranks;
  const long long* cstart_rel;
  int spill_len, g, cc, w_cap, cap, cx, cy;
};

__device__ __forceinline__ int wrap_g(int v, int g) {
  return v < 0 ? v + g : (v >= g ? v - g : v);
}

// One pick's S lane (see the file comment).
__device__ __forceinline__ int decode(int code, int qz, const Tile& t) {
  const int width = 9 * t.w_cap;
  const int res_base = 27 * t.cap;
  if (code < 0) return width;
  int r_s, s_cz, jring;
  if (code < res_base) {
    const int j27 = code / t.cap;
    const int rank = code - j27 * t.cap;
    jring = (j27 / 9) * 3 + (j27 / 3) % 3;
    s_cz = wrap_g(qz + j27 % 3 - 1, t.g);
    r_s = t.starts[jring * t.g + s_cz] + rank;
  } else {
    const int i = code - res_base;
    if (i >= t.spill_len) return width;
    const int g3 = t.g * t.g * t.g;
    int cell = t.spill_cells[i];
    cell = cell < 0 ? 0 : (cell >= g3 ? g3 - 1 : cell);
    const long long rs = t.cstart_rel[cell] + (long long)t.spill_ranks[i];
    if (rs >= t.cc) return width;  // no slot: not a real sender
    const int col = cell / t.g;
    s_cz = cell - col * t.g;
    const int sx = col / t.g, sy = col - sx * t.g;
    const int dx = wrap_g(sx - t.cx + 1, t.g), dy = wrap_g(sy - t.cy + 1, t.g);
    if (dx >= 3 || dy >= 3) return width + 1;  // real, outside the 3x3 ring
    jring = dx * 3 + dy;
    r_s = (int)rs;
  }
  const int* c = t.consts + jring * 5;
  const int w_s = c[0], cp_s = c[1], m_s = c[2], ca_s = c[3], cg1_s = c[4];
  if (r_s >= m_s) return width;
  const int rel_main = cp_s + r_s - w_s;
  if (rel_main >= 0 && rel_main < t.w_cap) return jring * t.w_cap + rel_main;
  const int rank_pre = r_s - cg1_s;
  const int rel_pre = rank_pre - w_s;
  if (s_cz == t.g - 1 && rank_pre < cp_s && rel_pre >= 0 && rel_pre < t.w_cap)
    return jring * t.w_cap + rel_pre;
  const int rel_app = cp_s + m_s + r_s - w_s;
  if (s_cz == 0 && r_s < ca_s && rel_app >= 0 && rel_app < t.w_cap)
    return jring * t.w_cap + rel_app;
  return width + 1;
}

// K: picks a row, 8, 16, 32 or 64 (8 picks a thread, 16-byte vectors), or
// 0 for any k (one pick a thread).
// A slot's codes row: a row of `codes` below num_rows, else of `picks`;
// null for an empty slot (row -1) or a row past both.
__device__ __forceinline__ const int* codes_row(int row, const int* codes, int num_rows,
                                                const int* picks, int num_picks, int k) {
  if (row < 0) return nullptr;
  if (row < num_rows) return codes + (size_t)row * k;
  row -= num_rows;
  return row < num_picks ? picks + (size_t)row * k : nullptr;
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
    s_decode_kernel(const int* __restrict__ codes, const int* __restrict__ picks,
                    const int* __restrict__ spill_cells,
                    const int* __restrict__ spill_ranks, const long long* __restrict__ pos_slot,
                    const long long* __restrict__ rows, const long long* __restrict__ sorted_cz,
                    const long long* __restrict__ cstart_rel, const int* __restrict__ tile_const,
                    const int* __restrict__ tile_col, int16_t* __restrict__ out,
                    int* __restrict__ dropped, int n, int k_rt, int num_rows, int num_picks,
                    int spill_len, int g, int cc, int qb, int w_cap, int cap) {
  const int k = K ? K : k_rt;
  extern __shared__ int smem[];
  int* s_starts = smem;             // [9 * g]
  int* s_row = s_starts + 9 * g;    // [qb] the slot's codes row, -1: empty slot
  int* s_qz = s_row + qb;           // [qb]
  __shared__ int s_const[45];
  __shared__ int warp_sums[kMaxThreads / 32];

  const int tile = blockIdx.x;
  const int slot0 = tile * qb;
  // CC % QB == 0 (uniform) or QB-aligned prefixes (variable): a tile lies
  // in one column.
  const int col = tile_col[tile];
  const int cx = col / g, cy = col - cx * g;
  for (int i = threadIdx.x; i < 45; i += blockDim.x) s_const[i] = tile_const[tile * 45 + i];
  for (int jr = 0; jr < 9; ++jr) {
    const int rc = wrap_g(cx + jr / 3 - 1, g) * g + wrap_g(cy + jr % 3 - 1, g);
    for (int z = threadIdx.x; z < g; z += blockDim.x)
      s_starts[jr * g + z] = (int)cstart_rel[rc * g + z];
  }
  for (int i = threadIdx.x; i < qb; i += blockDim.x) {
    const long long p = pos_slot[slot0 + i];
    s_row[i] = p < n ? (int)rows[p] : -1;
    s_qz[i] = p < n ? (int)sorted_cz[p] : 0;
  }
  __syncthreads();
  const Tile t{s_const, s_starts, spill_cells, spill_ranks, cstart_rel,
               spill_len, g, cc, w_cap, cap, cx, cy};
  const int width = 9 * w_cap;
  const int valid_lanes = 27 * cap + spill_len;
  int drops = 0;
  if constexpr (K != 0) {
    constexpr int kChunks = K / 8;
    for (int it = threadIdx.x; it < qb * kChunks; it += blockDim.x) {
      const int sl = it / kChunks, ch = it % kChunks;
      const int qz = s_qz[sl];
      const int* row = codes_row(s_row[sl], codes, num_rows, picks, num_picks, K);
      int c[8];
      if (row != nullptr) {
        const int4* src = reinterpret_cast<const int4*>(row + ch * 8);
        const int4 lo = __ldg(src), hi = __ldg(src + 1);
        c[0] = lo.x; c[1] = lo.y; c[2] = lo.z; c[3] = lo.w;
        c[4] = hi.x; c[5] = hi.y; c[6] = hi.z; c[7] = hi.w;
        const int first = ch == 0 ? c[0] : __ldg(row);
#pragma unroll
        for (int e = 0; e < 8; ++e) c[e] = c[e] >= valid_lanes ? first : c[e];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) c[e] = -1;
      }
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const int a = decode(c[e], qz, t), b = decode(c[e + 1], qz, t);
        drops += (a == width + 1) + (b == width + 1);
        packed[e / 2] = (uint32_t)(uint16_t)a | ((uint32_t)(uint16_t)b << 16);
      }
      int4* dst = reinterpret_cast<int4*>(out + (size_t)(slot0 + sl) * K + ch * 8);
      *dst = make_int4((int)packed[0], (int)packed[1], (int)packed[2], (int)packed[3]);
    }
  } else {
    for (int it = threadIdx.x; it < qb * k; it += blockDim.x) {
      const int sl = it / k, pk = it - sl * k;
      const int* row = codes_row(s_row[sl], codes, num_rows, picks, num_picks, k);
      int code = row != nullptr ? row[pk] : -1;
      if (code >= valid_lanes) code = row[0];
      const int r = decode(code, s_qz[sl], t);
      drops += r == width + 1;
      out[(size_t)(slot0 + sl) * k + pk] = (int16_t)r;
    }
  }
  drops = __reduce_add_sync(0xffffffffu, drops);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = drops;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) sum += warp_sums[i];
    if (sum) atomicAdd(dropped, sum);
  }
}

template <int K>
int launch(const int* codes, const int* picks, const int* spill_cells, const int* spill_ranks,
           const long long* pos_slot, const long long* rows, const long long* sorted_cz,
           const long long* cstart_rel, const int* tile_const, const int* tile_col, void* out,
           int* dropped, int num_tiles, int n, int k, int num_rows, int num_picks,
           int spill_len, int g, int cc, int qb, int w_cap, int cap, cudaStream_t stream) {
  const int items = qb * (K ? K / 8 : k);
  int threads = (items + 31) / 32 * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  const size_t smem = (size_t)(9 * g + 2 * qb) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        s_decode_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  s_decode_kernel<K><<<(unsigned)num_tiles, threads, smem, stream>>>(
      codes, picks, spill_cells, spill_ranks, pos_slot, rows, sorted_cz, cstart_rel,
      tile_const, tile_col, static_cast<int16_t*>(out), dropped, n, k, num_rows, num_picks,
      spill_len, g, cc, qb, w_cap, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). codes [num_rows, k] int32: in
// particle order (rows = the sort order) or K1''s cell table; picks
// [num_picks, k] int32, the rows past num_rows (null when num_picks is 0);
// spill_cells, spill_ranks [spill_len] int32 (null when spill_len is 0);
// particle_of_slot [num_tiles * qb] int64 (a sorted particle, n for an empty
// slot); rows, sorted_cz [n] int64, each sorted particle's codes row and
// z-cell; cstart_rel [g^2, g] int64; tile_const [num_tiles, 45] int32;
// tile_col [num_tiles] int32, each tile's column; out [num_tiles * qb, k]
// int16; dropped one int32, zeroed by the caller; all contiguous.
// cc % qb == 0, 9 * w_cap + 1 < 2^15. Launches on `stream`, does not
// synchronize, returns the cudaError_t.
extern "C" int s_decode_launch(const int* codes, const int* picks, const int* spill_cells,
                               const int* spill_ranks, const long long* particle_of_slot,
                               const long long* rows, const long long* sorted_cz,
                               const long long* cstart_rel, const int* tile_const,
                               const int* tile_col, void* out, int* dropped, int num_tiles,
                               int n, int k, int num_rows, int num_picks, int spill_len, int g,
                               int cc, int qb, int w_cap, int cap, void* stream) {
  if (9 * w_cap + 2 >= 32768 || k < 1 || qb <= 0 || cc % qb || cap <= 0 || dropped == nullptr ||
      tile_col == nullptr || num_rows < 1 || num_picks < 0 || (num_picks && picks == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((size_t)(9 * g + 2 * qb) * sizeof(int) > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((uintptr_t)codes % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                       ((uintptr_t)picks % 16 == 0);
#define S_DECODE_ARGS                                                                        \
  codes, picks, spill_cells, spill_ranks, particle_of_slot, rows, sorted_cz, cstart_rel,    \
      tile_const, tile_col, out, dropped, num_tiles, n, k, num_rows, num_picks, spill_len, g, \
      cc, qb, w_cap, cap, s
  if (aligned) {
    switch (k) {
      case 8: return launch<8>(S_DECODE_ARGS);
      case 16: return launch<16>(S_DECODE_ARGS);
      case 32: return launch<32>(S_DECODE_ARGS);
      case 64: return launch<64>(S_DECODE_ARGS);
      default: break;
    }
  }
  return launch<0>(S_DECODE_ARGS);
#undef S_DECODE_ARGS
}
