// Loads and stores with cache hints, for the streaming kernels: the
// relayout probe (probes.cu) and the engine's single-field gather
// (engine.cu).
//
// A stream read once (an index array, a copy's input) goes past L1
// (.L1::no_allocate) and, where it would push out data that is read again
// (a field read through an index, whose neighbouring positions come back to
// the same lines), carries an L2 evict-first policy, as does the output it
// is written to; a copy's output is stored as a stream (.cs).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fustpu {

__device__ __forceinline__ unsigned long long l2_evict_first() {
  unsigned long long pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// 16 bytes read once, past L1.
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// 16 bytes written once, streaming (.cs: evict-first in L1 and L2).
__device__ __forceinline__ void st_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n"
               ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Four indices read once, past L1, with the L2 policy `pol`.
__device__ __forceinline__ int4 ld_stream(const int4* p,
                                          unsigned long long pol) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 "
      "{%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(pol));
  return v;
}

// Four consecutive values (16 B-aligned) stored with the L2 policy `pol`:
// one 16 B store in float32, two in float64, one 8 B store in bfloat16.
__device__ __forceinline__ void st_hint4(float* p, float a, float b, float c,
                                         float d, unsigned long long pol) {
  asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;\n"
               ::"l"(p), "f"(a), "f"(b), "f"(c), "f"(d), "l"(pol)
               : "memory");
}

__device__ __forceinline__ void st_hint4(double* p, double a, double b,
                                         double c, double d,
                                         unsigned long long pol) {
  asm volatile("st.global.L2::cache_hint.v2.f64 [%0], {%1, %2}, %3;\n"
               ::"l"(p), "d"(a), "d"(b), "l"(pol)
               : "memory");
  asm volatile("st.global.L2::cache_hint.v2.f64 [%0], {%1, %2}, %3;\n"
               ::"l"(p + 2), "d"(c), "d"(d), "l"(pol)
               : "memory");
}

__device__ __forceinline__ void st_hint4(__nv_bfloat16* p, __nv_bfloat16 a,
                                         __nv_bfloat16 b, __nv_bfloat16 c,
                                         __nv_bfloat16 d,
                                         unsigned long long pol) {
  // the lower address in the lower half of each 32-bit word
  const unsigned lo = (unsigned)__bfloat16_as_ushort(a) |
                      ((unsigned)__bfloat16_as_ushort(b) << 16);
  const unsigned hi = (unsigned)__bfloat16_as_ushort(c) |
                      ((unsigned)__bfloat16_as_ushort(d) << 16);
  asm volatile("st.global.L2::cache_hint.v2.b32 [%0], {%1, %2}, %3;\n"
               ::"l"(p), "r"(lo), "r"(hi), "l"(pol)
               : "memory");
}

}  // namespace fustpu
