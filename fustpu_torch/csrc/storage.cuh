// Storage and arithmetic: a kernel may keep its fields, its geometry
// stream (G, or the corner channels), D and C in a narrower storage type S
// than the type T it computes in (bfloat16 storage, float arithmetic and
// accumulators: the JAX package's --dtype bf16).  `widen` reads a stored
// value into T, exactly; `narrow` rounds a result to S (round to nearest
// even).  With S == T both are the identity, and float32 and float64 keep
// S == T.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fustpu {

template <typename T, typename S>
__device__ __forceinline__ T widen(S v) {
  return static_cast<T>(v);
}
template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename S, typename T>
__device__ __forceinline__ S narrow(T v) {
  return static_cast<S>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace fustpu
