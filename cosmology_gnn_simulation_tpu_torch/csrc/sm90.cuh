// Hopper (sm_90a) helpers shared by the kernels that stage operands with
// TMA and multiply on the warpgroup tensor cores: window_matmul.cu (K4,
// K4^T) and, through tail_common.cuh, fused_tail.cu (K5), fused_tail_bwd.cu
// (K6) and their width-general variants fused_tail_wide.cu and
// fused_tail_wide_bwd.cu. The PTX of mbarriers, 2-D tensor copies (loads,
// stores, L2 prefetch), the async-proxy fence and wgmma's fence / commit /
// wait, and on the host the encoding of a 2-D tensor map.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and tensor copies --------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Make the initialised barriers visible to the async proxy and the block.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// One box of a 2-D tensor map at coordinates (x, y) into shared memory at
// dst; completion (the box's bytes) is reported to bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// The same for a 3-D tensor map at (x, y, z).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                            int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// Bring a tensor map (a kernel parameter) into the copy engine's
// descriptor cache ahead of its first copy.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Make this thread's shared-memory writes visible to the async proxy
// (wgmma, TMA) before a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One box of a 2-D tensor map at coordinates (x, y) from shared memory at
// src (boxes past the tensor's bounds are clipped), in this thread's bulk
// group; bulk_commit closes the group, bulk_wait_read<N> waits until at
// most N of the thread's groups still read shared memory.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int x, int y, uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(x), "r"(y), "r"(src)
      : "memory");
}
// The same for a 3-D tensor map at (x, y, z).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, int x, int y, int z,
                                             uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(x), "r"(y), "r"(z), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// ... until at most N of them are still in flight (their writes done).
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Bring `bytes` (a multiple of 16) of global memory at p (16-byte aligned)
// into L2, asynchronously.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// ---- warpgroup products ----------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N of the warpgroup's committed product groups are in
// flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---- host: tensor maps --------------------------------------------------

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D tensor map of a row-major [d1][d0] array with rows `stride` bytes
// apart and a [b1][b0] box (out-of-range elements read as 0); false if the
// encoder is missing or refuses it.
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t d0,
                       uint64_t d1, uint64_t stride, uint32_t b0, uint32_t b1,
                       CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {d0, d1};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {b0, b1};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D tensor map of a [d2][d1][d0] array with its d1 and d2 strides in
// bytes and a [b2][b1][b0] box: coordinates past d1 within one d2 index
// read as 0 and are not written, so a box never spills into the next d2
// slice.
inline bool tensor_map_3d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                          uint64_t d0, uint64_t d1, uint64_t d2, uint64_t stride1,
                          uint64_t stride2, uint32_t b0, uint32_t b1,
                          CUtensorMapSwizzle swizzle, uint32_t b2 = 1) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {stride1, stride2};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
