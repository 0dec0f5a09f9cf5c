// The exact warp-level k-selection shared by K1 (knn_select.cu: ids, codes
// and dual modes) and K8 (dense_select.cu).
//
// A key is (d2, payload) packed into 64 bits, d2's bits above the payload.
// d2 is a sum of rounded squares, so it is never negative (+0 at least),
// and the bits of non-negative floats order as the floats do: one unsigned
// compare is the lexicographic (d2, payload) order that the kernels' plain
// versions sort by. Payloads are distinct within a query row (particle ids,
// or candidate lanes), so keys are too, and the k smallest keys are one set
// whatever order the candidates arrive in: a kernel may scan them in any
// order and split them over lanes as it likes.
//
// WarpSelect keeps one query row's running k smallest for a whole warp,
// after FAISS's WarpSelect:
//   * the warp queue: the M = 32 * KW smallest keys merged so far, sorted
//     ascending over the positions q = r * 32 + lane (register r);
//   * per lane a thread queue of T keys, which admits a key only if it is
//     below the threshold, the warp queue's k-th key, held by every lane;
//   * when any lane's thread queue is full (every round while the warp
//     queue has no k-th key yet, and at the end of the scan), each
//     thread-queue register is merged into the warp queue. A register that
//     holds more than kSerialMax keys is bitonic-sorted across the 32 lanes
//     by shuffles and merged: the sorted keys reversed against the warp
//     queue's last register, the smaller of each pair kept (a bitonic
//     sequence that holds the M smallest of both), and a bitonic merge of
//     the M positions. A sparser one (the common case once the threshold
//     has settled) has its keys inserted one at a time: a ballot counts
//     the queue keys below the key, and the queue shifts up by one from
//     there. Both leave the M smallest keys sorted (the first sorted
//     register of an empty queue is simply its first 32 keys). Then the
//     threshold is read again.
// A key at or above the threshold is never among the k smallest, so after
// the last merge the warp queue's first k keys are the row's k smallest.
// A kernel votes on may_admit (d2 <= the threshold's d2) over a round of
// candidates before it offers any key, so once the threshold settles a
// candidate costs one float compare. The kernels use T = 1: measured on
// the H100, a deeper thread queue admits more keys against a staler
// threshold and is slower. A value (an int) may ride beside each key
// (VAL): K1's dual mode's lane where it cannot be packed beside the id.
#pragma once

#include <stdint.h>

namespace select_common {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;
// The empty key: d2 1e30 (bits 0x7149f2ca), the k-th distance of an
// exhausted row, with the largest payload: above every real key.
constexpr uint64_t kEmpty = 0x7149f2caffffffffull;
// A thread-queue register with at most this many keys is merged by
// inserting them one at a time; a fuller one by the bitonic sort.
constexpr int kSerialMax = 16;

__device__ __forceinline__ uint64_t pack(float d2, uint32_t payload) {
  return (static_cast<uint64_t>(__float_as_uint(d2)) << 32) | payload;
}

__device__ __forceinline__ float key_d2(uint64_t key) {
  return __uint_as_float(static_cast<uint32_t>(key >> 32));
}

__device__ __forceinline__ uint32_t key_payload(uint64_t key) {
  return static_cast<uint32_t>(key);
}

template <int KW, int T, bool VAL>
struct WarpSelect {
  static constexpr int M = 32 * KW;
  uint64_t wk[KW];  // warp queue keys, position r * 32 + lane
  int wv[KW];       // their values (VAL)
  uint64_t tk[T];   // thread queue, newest first; kEmpty where unused
  int tv[T];
  int count;        // keys in this lane's thread queue
  uint64_t thr;     // the warp queue's k-th key
  float thr_d2;     // its d2
  int kreg, klane;  // position k - 1: its register and lane
  bool empty;       // the warp queue holds no key yet (warp-uniform)

  __device__ __forceinline__ void init(int k) {
    kreg = (k - 1) >> 5;
    klane = (k - 1) & 31;
#pragma unroll
    for (int r = 0; r < KW; ++r) {
      wk[r] = kEmpty;
      wv[r] = 0;
    }
#pragma unroll
    for (int i = 0; i < T; ++i) {
      tk[i] = kEmpty;
      tv[i] = 0;
    }
    count = 0;
    thr = kEmpty;
    thr_d2 = kBig;
    empty = true;
  }

  // Whether a candidate at d2 could be admitted: a float compare that a
  // scan can run, and vote on, before it builds any key.
  __device__ __forceinline__ bool may_admit(float d2) const { return d2 <= thr_d2; }

  // Offer the key (d2, payload) (at most one a lane between two merge
  // checks). The float compare rejects almost every candidate; the key
  // compare decides the rest.
  __device__ __forceinline__ void add(float d2, uint32_t payload, int val) {
    const uint64_t key = pack(d2, payload);
    if (d2 <= thr_d2 && key < thr) {
#pragma unroll
      for (int i = T - 1; i > 0; --i) {
        tk[i] = tk[i - 1];
        if constexpr (VAL) tv[i] = tv[i - 1];
      }
      tk[0] = key;
      if constexpr (VAL) tv[0] = val;
      ++count;
    }
  }

  // All 32 lanes, after a round of add(): merge if any lane's thread queue
  // is full, or holds a key while the warp queue has no k-th key yet.
  __device__ __forceinline__ void check() {
    if (__any_sync(kFull, count == T || (count > 0 && thr == kEmpty))) merge();
  }

  // All 32 lanes, after the scan: merge what the thread queues hold.
  __device__ __forceinline__ void finish() {
    if (__any_sync(kFull, count > 0)) merge();
  }

  // The key at position k - 1, in every lane.
  __device__ __forceinline__ uint64_t kth_key() const {
    uint64_t key = wk[0];
#pragma unroll
    for (int r = 1; r < KW; ++r)
      if (r == kreg) key = wk[r];
    return __shfl_sync(kFull, key, klane);
  }

  // One compare-exchange of a bitonic network across lanes: partner lane
  // ^ j; this lane keeps the smaller key if keep_min, else the larger.
  __device__ __forceinline__ static void exchange(uint64_t& key, int& val, int j,
                                                  bool keep_min) {
    const uint64_t other = __shfl_xor_sync(kFull, key, j);
    int other_val = 0;
    if constexpr (VAL) other_val = __shfl_xor_sync(kFull, val, j);
    if (keep_min ? other < key : other > key) {
      key = other;
      if constexpr (VAL) val = other_val;
    }
  }

  // Insert the key held by lane `src` into the warp queue.
  __device__ __forceinline__ void insert(uint64_t own, int own_val, int src) {
    const int lane = threadIdx.x & 31;
    const uint64_t key = __shfl_sync(kFull, own, src);
    int val = 0;
    if constexpr (VAL) val = __shfl_sync(kFull, own_val, src);
    int pos = 0;
#pragma unroll
    for (int r = 0; r < KW; ++r) pos += __popc(__ballot_sync(kFull, wk[r] < key));
    // Position q takes q - 1's key from pos + 1 on: the lane below, or the
    // last lane of the register below for lane 0.
    uint64_t prev[KW];
    int prev_val[KW];
#pragma unroll
    for (int r = 0; r < KW; ++r) {
      prev[r] = __shfl_up_sync(kFull, wk[r], 1);
      if constexpr (VAL) prev_val[r] = __shfl_up_sync(kFull, wv[r], 1);
      if (r > 0) {
        const uint64_t top = __shfl_sync(kFull, wk[r - 1], 31);
        int top_val = 0;
        if constexpr (VAL) top_val = __shfl_sync(kFull, wv[r - 1], 31);
        if (lane == 0) {
          prev[r] = top;
          if constexpr (VAL) prev_val[r] = top_val;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < KW; ++r) {
      const int q = r * 32 + lane;
      if (q >= pos) {
        wk[r] = q == pos ? key : prev[r];
        if constexpr (VAL) wv[r] = q == pos ? val : prev_val[r];
      }
    }
  }

  __device__ __forceinline__ void merge() {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      unsigned held = __ballot_sync(kFull, tk[i] != kEmpty);
      if (held != 0 && __popc(held) <= kSerialMax) {
        while (held) {
          const int src = __ffs(held) - 1;
          held &= held - 1;
          insert(tk[i], tv[i], src);
        }
        empty = false;
      } else if (held != 0) {
        uint64_t key = tk[i];
        int val = tv[i];
        // Bitonic sort of the 32 keys, ascending over the lanes.
#pragma unroll
        for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
          for (int j = size >> 1; j > 0; j >>= 1)
            exchange(key, val, j, ((lane & j) == 0) == ((lane & size) == 0));
        }
        if (empty) {  // the sorted keys are the queue's first 32
          wk[0] = key;
          if constexpr (VAL) wv[0] = val;
          empty = false;
          tk[i] = kEmpty;
          continue;
        }
        // Against the warp queue's last register, reversed: the smaller
        // of each pair. The M positions are then bitonic.
        const uint64_t rev = __shfl_xor_sync(kFull, key, 31);
        int rev_val = 0;
        if constexpr (VAL) rev_val = __shfl_xor_sync(kFull, val, 31);
        if (rev < wk[KW - 1]) {
          wk[KW - 1] = rev;
          if constexpr (VAL) wv[KW - 1] = rev_val;
        }
        // Bitonic merge, ascending: across registers, then across lanes.
#pragma unroll
        for (int jr = KW / 2; jr > 0; jr >>= 1) {
#pragma unroll
          for (int r = 0; r < KW; ++r) {
            if ((r & jr) == 0 && wk[r | jr] < wk[r]) {
              const uint64_t t = wk[r];
              wk[r] = wk[r | jr];
              wk[r | jr] = t;
              if constexpr (VAL) {
                const int tvl = wv[r];
                wv[r] = wv[r | jr];
                wv[r | jr] = tvl;
              }
            }
          }
        }
#pragma unroll
        for (int j = 16; j > 0; j >>= 1) {
#pragma unroll
          for (int r = 0; r < KW; ++r) exchange(wk[r], wv[r], j, (lane & j) == 0);
        }
      }
      tk[i] = kEmpty;
    }
    count = 0;
    thr = kth_key();
    thr_d2 = key_d2(thr);
  }
};

}  // namespace select_common
