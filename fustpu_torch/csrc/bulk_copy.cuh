// The bulk-copy (TMA, cp.async.bulk) and mbarrier helpers of the kernels
// that stream each chunk's G into a ring of shared stages: the z-pencil
// kernel (stiffness_pencil.cuh, structured boxes and extruded stacks) and
// the chunked indexed kernel (indexed_chunk.cu).
//
// A copy moves a span of whole 16 B units between 16 B-aligned addresses;
// the host's span table (ops/cuda_stiffness.py `bulk_spans`) widens each
// chunk's run of G to such a span and cuts it back at G's end, where the
// kernel reads the last bytes itself.  One thread arms a stage's mbarrier
// with the bytes it expects and issues the copy; every thread waits on the
// barrier's phase, which flips once a round of the ring.

#pragma once

#include <cuda_runtime.h>

namespace fustpu {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of transactions.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done = 0;
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

// Bulk copy of `bytes` (a multiple of 16, both addresses 16 B-aligned) from
// global to shared memory, completing on `bar`.  The copied lines are the
// first the L2 evicts: G is streamed once an apply, and the x and y that
// the kernels gather around it are what the L2 should keep.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], pol;\n"
      "}\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's generic-proxy accesses to shared memory before later
// bulk copies into it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The bytes of a chunk's G run [cell0 * cb, (cell0 + n) * cb) that its span
// [off, off + bytes) stopped short of at G's end: read here by the block's
// threads into the stage, past the span, and fenced before the copy's
// barrier is waited on.
template <typename T>
__device__ __forceinline__ void read_span_tail(unsigned char* stage,
                                               const T* G, long long end,
                                               long long off, long long bytes,
                                               int tid, int nthreads) {
  const long long short_by = end - (off + bytes);
  if (short_by <= 0) return;
  for (int e = tid; e < (int)(short_by / sizeof(T)); e += nthreads) {
    const long long at = bytes + e * (long long)sizeof(T);
    *reinterpret_cast<T*>(stage + at) = *reinterpret_cast<const T*>(
        reinterpret_cast<const unsigned char*>(G) + off + at);
  }
  fence_proxy_async();
}

}  // namespace fustpu
