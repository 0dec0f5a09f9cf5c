// K2: candidate codes -> S-lane offsets of the cell-block plan.
//
// Replaces the JAX package's TPU kernel ops/cellblock.py::
// _s_from_codes_fused (its decode body; pallas_call in the same function).
// Per slot s and pick p of the pre-normalized codes [num_slots, k]:
//   * ring codes (< 27 * cap) are j27 * cap + rank: the sender's column rank
//     is cstart27[query cell][j27] + rank, its z-cell qz + dz, its ring
//     column (dx + 1) * 3 + (dy + 1);
//   * resolved spill codes are 27 * cap + jring * (CC * G) + r * G + cz;
//     DROP_MARK (jring 9, remainder 0) is a real sender outside the ring;
//     anything past it is no edge;
//   * with the tile's window constants (w_loc, cP, m, cA, cstart_g1) of the
//     sender's ring column, the sender sits in the window's main image, its
//     z-wrap prefix copy or its append copy at offset off; the output is
//     jring * W + off, 9W + 1 for a dropped edge (a real sender that no
//     window row holds) and 9W for no edge, as int16.
// Integer arithmetic only: bit-equal to the plain PyTorch version.
//
// Bound on the H100: bytes. Per edge it reads one 4-byte code and writes a
// 2-byte offset; the per-slot z-cell, the [G^3, 27] start table and the
// [T, 45] tile constants are small and stay in L1/L2. Design: one thread per
// (slot, pick), consecutive threads on consecutive picks of a slot, so code
// reads and offset writes coalesce. The TPU kernel's transposed
// [k + 73, slots] layout (slots on lanes for full vector registers) and its
// per-slot copies of the start row and tile constants are gone: a thread
// indexes the shared tables directly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void s_decode_kernel(const int* __restrict__ codes,
                                const int* __restrict__ qz_slot,
                                const int* __restrict__ cstart27,
                                const int* __restrict__ tile_const,
                                int16_t* __restrict__ out, int num_slots, int k,
                                int g, int cc, int qb, int w_cap, int cap) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)num_slots * k) return;
  const int slot = (int)(idx / k);
  const int width = 9 * w_cap;
  const int res_base = 27 * cap;
  const int ccg = cc * g;
  const int drop_mark = res_base + 9 * ccg;
  const int code = codes[idx];
  const int qz = qz_slot[slot];

  const bool is_res = code >= res_base;
  int r_s, s_cz, jring;
  bool ok;
  if (is_res) {
    const int v = code - res_base;
    const int jr2 = v / ccg;
    const int rem = v - jr2 * ccg;
    const int r2 = rem / g;
    r_s = r2;
    s_cz = rem - r2 * g;
    ok = jr2 < 9;
    jring = ok ? jr2 : 9;
  } else {
    const int j27 = code / cap;
    const int rank = code - j27 * cap;
    const int cell = (slot / cc) * g + qz;
    r_s = cstart27[cell * 27 + j27] + rank;
    s_cz = (qz + j27 % 3 - 1 + g) % g;
    jring = (j27 / 9) * 3 + (j27 / 3) % 3;
    ok = true;
  }
  int w_s = 0, cp_s = 0, m_s = 0, ca_s = 0, cg1_s = 0;
  if (jring < 9) {
    const int* c = tile_const + (slot / qb) * 45 + jring * 5;
    w_s = c[0];
    cp_s = c[1];
    m_s = c[2];
    ca_s = c[3];
    cg1_s = c[4];
  }
  ok = ok && r_s < m_s;
  const int rel_main = cp_s + r_s - w_s;
  const bool ok_main = ok && rel_main >= 0 && rel_main < w_cap;
  const int rank_pre = r_s - cg1_s;
  const int rel_pre = rank_pre - w_s;
  const bool ok_pre = ok && s_cz == g - 1 && rank_pre < cp_s && rel_pre >= 0 &&
                      rel_pre < w_cap;
  const int rel_app = cp_s + m_s + r_s - w_s;
  const bool ok_app = ok && s_cz == 0 && r_s < ca_s && rel_app >= 0 &&
                      rel_app < w_cap;
  int result;
  if (ok_main) {
    result = jring * w_cap + rel_main;
  } else if (ok_pre) {
    result = jring * w_cap + rel_pre;
  } else if (ok_app) {
    result = jring * w_cap + rel_app;
  } else {
    result = (ok || code == drop_mark) ? width + 1 : width;
  }
  out[idx] = (int16_t)result;
}

}  // namespace

// Plain C entry point (loaded with ctypes). codes [num_slots, k] int32,
// qz_slot [num_slots] int32, cstart27 [g^3, 27] int32, tile_const
// [num_slots / qb, 45] int32, out [num_slots, k] int16; all contiguous.
// Launches on `stream`, does not synchronize, returns the cudaError_t.
extern "C" int s_decode_launch(const int* codes, const int* qz_slot,
                               const int* cstart27, const int* tile_const,
                               void* out, int num_slots, int k, int g, int cc,
                               int qb, int w_cap, int cap, void* stream) {
  const long long total = (long long)num_slots * k;
  if (total == 0) return (int)cudaSuccess;
  if (9 * w_cap + 2 >= 32768) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  s_decode_kernel<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      codes, qz_slot, cstart27, tile_const, static_cast<int16_t*>(out),
      num_slots, k, g, cc, qb, w_cap, cap);
  return (int)cudaGetLastError();
}
