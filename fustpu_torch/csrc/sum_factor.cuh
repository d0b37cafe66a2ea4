// The per-cell body shared by the structured (stiffness.cuh), extruded
// (extruded.cuh) and indexed (indexed.cu) stiffness kernels: for one GLL
// hexahedron of degree P = N - 1,
//
//   y_cell += D^T (c G) D u_cell,   u_cell = c1 x1_cell (+ c2 x2_cell),
//
// sum-factorised.  The kernels differ in how a cell's nodes map to global
// dofs, the `Line` functor (line(i) is the global index of node (i, j, k)
// for the calling thread's (j, k)), and in where the metric c G comes from,
// the `Metric` functor: read from a precomputed (cells, 6, N^3) stream
// (`GStream`) or evaluated in registers from the cell's Jacobian monomials
// (`Corner`, corner.cuh).
//
// Work split: N^2 threads per cell (threadIdx.x = j * N + k), each owning
// the line of N nodes along i.  The own line of u and the x-gradient stay
// in registers; u and the two cross-line metric-transformed gradients are
// shared (3 N^3 values per cell).  Accumulators take the template type.

#pragma once

#include <cuda_runtime.h>

namespace fustpu {

// Cells per block: enough to fill ~256 threads at small N, bounded by the
// 48 KB static shared memory (Ds and FIXED bytes per block, plus 3 N^3
// values and EXTRA bytes per cell).
template <typename T, int N, int EXTRA = 0, int FIXED = 0>
struct Shape {
  static constexpr int NN = N * N;
  static constexpr int NNN = N * N * N;
  static constexpr int BY_THREADS = 256 / NN > 0 ? 256 / NN : 1;
  static constexpr int BY_SMEM = (48 * 1024 - NN * (int)sizeof(T) - FIXED) /
                                 (3 * NNN * (int)sizeof(T) + EXTRA);
  static constexpr int CPB = BY_THREADS < BY_SMEM ? BY_THREADS : BY_SMEM;
  static_assert(CPB >= 1, "one cell must fit the static shared memory");
};

// The metric read from the G stream: Gc is the cell's 6 x N^3 block,
// components (xx, xy, xz, yy, yz, zz), node n = i N^2 + j N + k.
// metric(i, n, wx, wy, wz, f0, f1, f2) maps the reference gradient at node
// n to (f0, f1, f2) = c G (wx, wy, wz).
template <typename T, int N>
struct GStream {
  const T* __restrict__ Gc;
  __device__ __forceinline__ void operator()(int, int n, T wx, T wy, T wz,
                                             T& f0, T& f1, T& f2) const {
    constexpr int NNN = N * N * N;
    const T g0 = Gc[n], g1 = Gc[NNN + n], g2 = Gc[2 * NNN + n];
    const T g3 = Gc[3 * NNN + n], g4 = Gc[4 * NNN + n];
    const T g5 = Gc[5 * NNN + n];
    f0 = g0 * wx + g1 * wy + g2 * wz;
    f1 = g1 * wx + g3 * wy + g4 * wz;
    f2 = g2 * wx + g4 * wy + g5 * wz;
  }
};

// Must be reached by every thread of the block (it synchronises twice);
// threads of an inactive cell slot (`active` false) touch no memory.
// Ds: D[q * N + i] = l_i'(x_q) in shared memory; metric: the cell's c G
// (GStream or Corner); u, f1, f2: the cell's N^3 shared scratch arrays.
template <typename T, int N, bool PAIR, typename Metric, typename Line>
__device__ __forceinline__ void cell_apply(
    const T* __restrict__ x1, const T* __restrict__ x2, T c1, T c2,
    const Metric& metric, const T* Ds, T* u, T* f1, T* f2,
    T* __restrict__ y, bool active, const Line& line) {
  constexpr int NN = N * N;
  const int t = threadIdx.x;
  const int j = t / N, k = t % N;

  T ul[N];                         // u along this thread's line
  if (active) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T v = x1[line(i)];
      if (PAIR) v = c1 * v + c2 * x2[line(i)];
      ul[i] = v;
      u[i * NN + t] = v;
    }
  }
  __syncthreads();

  T f0[N];                         // metric-transformed x-gradient, own line
  if (active) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T wx = T(0), wy = T(0), wz = T(0);
#pragma unroll
      for (int r = 0; r < N; ++r) {
        wx += Ds[i * N + r] * ul[r];
        wy += Ds[j * N + r] * u[i * NN + r * N + k];
        wz += Ds[k * N + r] * u[i * NN + j * N + r];
      }
      const int n = i * NN + t;
      T a, b, c;
      metric(i, n, wx, wy, wz, a, b, c);
      f0[i] = a;
      f1[n] = b;
      f2[n] = c;
    }
  }
  __syncthreads();

  if (active) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T acc = T(0);
#pragma unroll
      for (int r = 0; r < N; ++r) {
        acc += Ds[r * N + i] * f0[r];
        acc += Ds[r * N + j] * f1[i * NN + r * N + k];
        acc += Ds[r * N + k] * f2[i * NN + j * N + r];
      }
      y[line(i)] += acc;
    }
  }
}

}  // namespace fustpu
