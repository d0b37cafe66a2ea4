// The RK4 update with its coefficient on the card:
//
//   out[i] = y[i] + alpha[0] x[i]                  axpy_kernel<T, A, V>
//
// for the captured solve (fustpu_torch/models/timestepping.py
// `make_solver`).
//
// Replaces no TPU kernel.  The JAX package's RK4 updates (`vec.axpy` in
// fustpu/models/timestepping.py `rk4_step`, and the source terms of the
// models' right-hand sides) are elementwise ops that XLA fuses into its
// scan body; the port ran them as PyTorch's `add` with a Python float
// `alpha`.  A CUDA graph replays the arguments it captured, so a
// coefficient that changes from step to step (a source coefficient, a
// clamped dt) has to be read from device memory at run time.  PyTorch's
// `add` takes `alpha` from the host only, and its tensor forms (`addcmul`
// with a 0-d tensor) round the coefficient to bfloat16 for bfloat16
// fields.  This kernel reads it from a table that the solver fills, and
// computes what PyTorch's `add` computes: in float for float32 and
// bfloat16 fields (one fma, the result rounded to the field's type once),
// in double for float64 fields.
//
// What bounds it on an H100: memory.  It reads x and y and writes out, 12
// bytes a value in float32, 6 in bfloat16, 24 in float64, and does one fma
// a value.  The design: a thread takes kUnroll packs of 16 B of each array
// (4 float32, 2 float64 or 8 bfloat16 values a pack), the block's packs
// strided by its thread count so that a warp's loads are contiguous, and
// issues all its loads before its first store, on a grid that covers the
// arrays; where x, y or out is not 16 B-aligned a pack is one value.  The
// first n % V threads take the values past the last whole pack.  The
// coefficient is read once a thread.  out may be y (the update in place).
// (One pack a thread with its values copied through a local array ran 12%
// slower than PyTorch's add in float32 and 36% in bfloat16 on an H100 80GB
// HBM3 at 700 W: PERF.md, the captured solve's findings.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "storage.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;     // ops/cuda_vector.py THREADS
constexpr int kUnroll = 4;        // ops/cuda_vector.py UNROLL: packs a thread

__device__ __forceinline__ float fma_(float a, float x, float y) {
  return fmaf(a, x, y);
}
__device__ __forceinline__ double fma_(double a, double x, double y) {
  return fma(a, x, y);
}

template <typename T, typename A>
__device__ __forceinline__ T update(A a, T x, T y) {
  return fustpu::narrow<T>(
      fma_(a, fustpu::widen<A>(x), fustpu::widen<A>(y)));
}

// One 16 B pack of each array, its values unpacked from the 32-bit words
// in registers (no local copy): out = y + a x value by value, as `update`.
__device__ __forceinline__ uint4 update_pack(float a, uint4 x, uint4 y) {
  const auto f = [a](unsigned xw, unsigned yw) {
    return __float_as_uint(fma_(a, __uint_as_float(xw), __uint_as_float(yw)));
  };
  return make_uint4(f(x.x, y.x), f(x.y, y.y), f(x.z, y.z), f(x.w, y.w));
}

__device__ __forceinline__ uint4 update_pack(double a, uint4 x, uint4 y) {
  const double r0 = fma_(a, __hiloint2double(x.y, x.x),
                         __hiloint2double(y.y, y.x));
  const double r1 = fma_(a, __hiloint2double(x.w, x.z),
                         __hiloint2double(y.w, y.z));
  return make_uint4(__double2loint(r0), __double2hiint(r0),
                    __double2loint(r1), __double2hiint(r1));
}

// bfloat16: a word holds two values, the lower address in the lower half; a
// value widened to float is its bits in the upper half of a float's
__device__ __forceinline__ unsigned update_bf16x2(float a, unsigned xw,
                                                  unsigned yw) {
  const auto one = [a](unsigned xb, unsigned yb) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(
        fma_(a, __uint_as_float(xb), __uint_as_float(yb))));
  };
  return one(xw << 16, yw << 16) |
         (one(xw & 0xffff0000u, yw & 0xffff0000u) << 16);
}

struct Bf16Pack {};

__device__ __forceinline__ uint4 update_pack(float a, uint4 x, uint4 y,
                                             Bf16Pack) {
  return make_uint4(update_bf16x2(a, x.x, y.x), update_bf16x2(a, x.y, y.y),
                    update_bf16x2(a, x.z, y.z), update_bf16x2(a, x.w, y.w));
}

template <typename T, typename A>
__device__ __forceinline__ uint4 update_any(A a, uint4 x, uint4 y) {
  if constexpr (std::is_same_v<T, bf16>)
    return update_pack(a, x, y, Bf16Pack{});
  else
    return update_pack(a, x, y);
}

// out = y + a x in A, stored as T: packs P of V values (VEC: a 16 B uint4
// whose values are taken from its words in registers; else one value),
// kUnroll packs a thread, pack b kThreads kUnroll + t + j kThreads of
// block b for thread t; then the n % V values past the last whole pack.
template <typename T, typename A, bool VEC>
__global__ void __launch_bounds__(kThreads)
axpy_kernel(const T* x, const T* y, const A* __restrict__ alpha, T* out,
            long long n) {
  constexpr int V = VEC ? 16 / (int)sizeof(T) : 1;
  using P = std::conditional_t<VEC, uint4, T>;
  const A a = *alpha;
  const long long packs = n / V;
  const long long first =
      (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  P xv[kUnroll], yv[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = first + (long long)j * kThreads;
    if (i < packs) {
      xv[j] = reinterpret_cast<const P*>(x)[i];
      yv[j] = reinterpret_cast<const P*>(y)[i];
    }
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = first + (long long)j * kThreads;
    if (i < packs) {
      if constexpr (VEC)
        reinterpret_cast<uint4*>(out)[i] = update_any<T>(a, xv[j], yv[j]);
      else
        out[i] = update(a, xv[j], yv[j]);
    }
  }
  if constexpr (VEC) {
    const long long p = packs * V + (long long)blockIdx.x * kThreads +
                        threadIdx.x;
    if (p < n) out[p] = update(a, x[p], y[p]);
  }
}

template <typename T, typename A>
int axpy(const void* x, const void* y, const void* alpha, void* out,
         long long n, int vec, int blocks, void* stream) {
  if (blocks < 1) return -1;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const A* at = static_cast<const A*>(alpha);
  T* ot = static_cast<T*>(out);
  if (vec)
    axpy_kernel<T, A, true><<<blocks, kThreads, 0, s>>>(xt, yt, at, ot, n);
  else
    axpy_kernel<T, A, false><<<blocks, kThreads, 0, s>>>(xt, yt, at, ot, n);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points: out = y + alpha[0] x over n values, alpha one float
// (float32 and bfloat16 fields) or one double (float64) in device memory;
// vec != 0: x, y and out 16 B-aligned, packs of 16 B (else of one value);
// on `blocks` blocks of 256 threads, kUnroll packs a thread.  Each
// returns 0, -1 for an empty grid, or the cudaError_t of the launch.
extern "C" {

int fustpu_axpy_f32(const void* x, const void* y, const void* alpha,
                    void* out, long long n, int vec, int blocks,
                    void* stream) {
  return axpy<float, float>(x, y, alpha, out, n, vec, blocks, stream);
}

int fustpu_axpy_f64(const void* x, const void* y, const void* alpha,
                    void* out, long long n, int vec, int blocks,
                    void* stream) {
  return axpy<double, double>(x, y, alpha, out, n, vec, blocks, stream);
}

int fustpu_axpy_bf16(const void* x, const void* y, const void* alpha,
                     void* out, long long n, int vec, int blocks,
                     void* stream) {
  return axpy<bf16, float>(x, y, alpha, out, n, vec, blocks, stream);
}

}  // extern "C"
