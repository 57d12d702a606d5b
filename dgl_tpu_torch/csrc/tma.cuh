// Hopper's asynchronous copies for the port's kernels: mbarriers, the
// Tensor Memory Accelerator (TMA) loading a 2-D box of a row-major array
// into shared memory, and the 1-D bulk copy.  Used by int8mm.cu (K12's
// column product) and bitmm.cu (K1).
//
// A box load names a CUtensorMap that the host encodes for each call
// (encode_2d), passed to the kernel as a __grid_constant__ parameter.  The
// driver's encoder is found through the runtime's driver entry point, so
// the libraries link no more than the runtime.  Elements of a box that lie
// past the array's edges arrive as zeros, and the barrier counts the whole
// box's bytes.  With a swizzle, the 16-byte chunks of each row of the box
// land in shared memory XORed with bits 7 and up of their offset
// (swizzled below); the box must start on a multiple of 1,024 bytes.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset `off` into a box whose rows are `row_bytes` (32, 64 or 128)
// long, as the swizzle of the same width placed it.
template <int row_bytes>
__device__ __forceinline__ uint32_t swizzled(uint32_t off) {
  return off ^ (((off >> 7) & (row_bytes / 16 - 1)) << 4);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)),
               "r"(count)
               : "memory");
}

// After every bar_init, before any thread uses the barriers.
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem(bar))
               : "memory");
}

// Arrive, and expect `bytes` more from the copies that name this barrier.
__device__ __forceinline__ void arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.  A
// phase that has not completed after 2^26 tries (seconds: a lost copy or
// arrival) traps, so a fault shows as a failed launch, not a hung card.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem(bar);
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// An L2 policy for data read once: evicted first, so that what every
// block re-reads stays in L2.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// The box of `map` at element (x, y) (x the inner coordinate) into `dst`,
// completing on `bar`.
__device__ __forceinline__ void load_2d(void* dst, const CUtensorMap* map,
                                        int x, int y, uint64_t* bar,
                                        uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(
          smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem(bar)),
      "l"(policy)
      : "memory");
}

// `bytes` (a multiple of 16) from `src` to `dst`, both 16-byte aligned,
// completing on `bar`.
__device__ __forceinline__ void load_1d(void* dst, const void* src,
                                        uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of the row-major (outer, inner) array at `base` (rows of
// `row_bytes` bytes, a multiple of 16; `base` 16-byte aligned) read in
// boxes of (box_outer, box_inner) elements.
inline cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type,
                             const void* base, uint64_t inner, uint64_t outer,
                             uint64_t row_bytes, uint32_t box_inner,
                             uint32_t box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides,
                        box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tma
