// What the staged gathers (gather.cu K3, gather_variants.cu S1) share:
// asynchronous copies into shared memory, and cutting 16 output bytes at a
// byte offset out of two aligned 16-byte words.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sa {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async: 16 bytes a thread, global -> shared, past L1

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- the bulk copy (the TMA's linear form): one thread asks for `bytes`
// contiguous bytes, and the hardware reports them to an mbarrier. Source,
// destination and size are multiples of 16.

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also tells the barrier how many copied bytes to await.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- extraction

// Bytes [off, off + 16) of the 32 bytes lo | hi, 0 <= off < 16. With
// off == 0 nothing of hi is used. off >> 2 is the same for every 16 bytes
// of a row, so a warp on one row does not diverge here.
__device__ __forceinline__ uint4 cut16(const uint4 lo, const uint4 hi,
                                       const int off) {
  const int sh = 8 * (off & 3);
  uint4 v;
  switch (off >> 2) {
    case 0:
      v.x = __funnelshift_r(lo.x, lo.y, sh);
      v.y = __funnelshift_r(lo.y, lo.z, sh);
      v.z = __funnelshift_r(lo.z, lo.w, sh);
      v.w = __funnelshift_r(lo.w, hi.x, sh);
      break;
    case 1:
      v.x = __funnelshift_r(lo.y, lo.z, sh);
      v.y = __funnelshift_r(lo.z, lo.w, sh);
      v.z = __funnelshift_r(lo.w, hi.x, sh);
      v.w = __funnelshift_r(hi.x, hi.y, sh);
      break;
    case 2:
      v.x = __funnelshift_r(lo.z, lo.w, sh);
      v.y = __funnelshift_r(lo.w, hi.x, sh);
      v.z = __funnelshift_r(hi.x, hi.y, sh);
      v.w = __funnelshift_r(hi.y, hi.z, sh);
      break;
    default:
      v.x = __funnelshift_r(lo.w, hi.x, sh);
      v.y = __funnelshift_r(hi.x, hi.y, sh);
      v.z = __funnelshift_r(hi.y, hi.z, sh);
      v.w = __funnelshift_r(hi.z, hi.w, sh);
      break;
  }
  return v;
}

// One 16-byte store of an output the kernel does not read again: a
// streaming store, so that the output, which is larger than L2, does not
// push the sequence out of it.
__device__ __forceinline__ void store16(uint4* p, const uint4 v) {
  __stcs(p, v);
}

}  // namespace sa
