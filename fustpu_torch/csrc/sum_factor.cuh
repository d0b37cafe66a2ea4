// The per-cell body shared by the structured (stiffness_pencil.cuh, and PR
// 1's stiffness.cuh), extruded (extruded.cuh) and indexed (indexed.cu)
// stiffness kernels: for one GLL hexahedron of degree P = N - 1,
//
//   y_cell += D^T (c G) D u_cell,   u_cell = c1 x1_cell (+ c2 x2_cell),
//
// sum-factorised.  The kernels differ in how a cell's nodes map to global
// dofs, the `Line` functor (line(i) is the global index of node (i, j, k)
// for the calling thread's (j, k)), and in where the metric c G comes from,
// the `Metric` functor: read from a precomputed (cells, 6, N^3) stream
// (`GStream`, or `GShared` from a copy in shared memory) or evaluated in
// registers from the cell's Jacobian monomials (`Corner`, corner.cuh).
//
// Work split: N^2 threads per cell (threadIdx.x = j * N + k), each owning
// the line of N nodes along i.  The own line of u and the x-gradient stay
// in registers; u and the two cross-line metric-transformed gradients are
// shared (3 N^3 values per cell).  Accumulators take the template type.
//
// Storage and arithmetic (storage.cuh): the walks (stiffness_pencil.cuh,
// indexed_chunk.cu) and the staged engine's contraction (engine.cu) may
// keep their fields, their geometry stream, D and C in bfloat16 and compute
// in float.

#pragma once

#include <cuda_runtime.h>

#include "storage.cuh"

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
// components (xx, xy, xz, yy, yz, zz), node n = i N^2 + j N + k, stored in
// S and widened to T (the staged engine's bfloat16 contraction, engine.cu).
// metric(i, n, wx, wy, wz, f0, f1, f2) maps the reference gradient at node
// n to (f0, f1, f2) = c G (wx, wy, wz).
template <typename T, int N, typename S = T>
struct GStream {
  const S* __restrict__ Gc;
  __device__ __forceinline__ void operator()(int, int n, T wx, T wy, T wz,
                                             T& f0, T& f1, T& f2) const {
    constexpr int NNN = N * N * N;
    const T g0 = widen<T>(Gc[n]), g1 = widen<T>(Gc[NNN + n]);
    const T g2 = widen<T>(Gc[2 * NNN + n]), g3 = widen<T>(Gc[3 * NNN + n]);
    const T g4 = widen<T>(Gc[4 * NNN + n]);
    const T g5 = widen<T>(Gc[5 * NNN + n]);
    f0 = g0 * wx + g1 * wy + g2 * wz;
    f1 = g1 * wx + g3 * wy + g4 * wz;
    f2 = g2 * wx + g4 * wy + g5 * wz;
  }
};

// The same metric read from the cell's 6 x N^3 block of G as a bulk copy
// left it in shared memory (stiffness_pencil.cuh, indexed_chunk.cu), stored
// in S and widened to T: the numbers and the arithmetic of GStream.  Not
// restrict: with S == T the kernels let the body's f1, f2 overwrite
// components 0 and 1 of a node once the node's six are read (by the one
// thread that reads them), and STAGED_STORE its sum component 2 (`put`).
// In a narrower S a T value does not fit a node's slot, so f1, f2 live
// apart and the sums go, as T, over the cell's first components (T slot n
// spans sizeof(T) / sizeof(S) values of S), once the body's barrier after
// its metric reads has passed: SUM_AT is where the sums start in the
// cell's block and CELL_T the block's length, both in T.
template <typename T, int N, typename S = T>
struct GShared {
  static constexpr int NNN = N * N * N;
  static constexpr bool WIDE = sizeof(S) < sizeof(T);
  static constexpr int SUM_AT = WIDE ? 0 : 2 * NNN;
  static constexpr int CELL_T = 6 * NNN * (int)sizeof(S) / (int)sizeof(T);
  S* Gc;
  __device__ __forceinline__ void put(int n, T v) const {
    reinterpret_cast<T*>(Gc)[SUM_AT + n] = v;
  }
  __device__ __forceinline__ void operator()(int, int n, T wx, T wy, T wz,
                                             T& f0, T& f1, T& f2) const {
    const T g0 = widen<T>(Gc[n]), g1 = widen<T>(Gc[NNN + n]);
    const T g2 = widen<T>(Gc[2 * NNN + n]), g3 = widen<T>(Gc[3 * NNN + n]);
    const T g4 = widen<T>(Gc[4 * NNN + n]);
    const T g5 = widen<T>(Gc[5 * NNN + n]);
    f0 = g0 * wx + g1 * wy + g2 * wz;
    f1 = g1 * wx + g3 * wy + g4 * wz;
    f2 = g2 * wx + g4 * wy + g5 * wz;
  }
};

// What cell_apply computes (a template flag; the pencil kernel takes
// STAGED, the chunked indexed kernel STAGED_STORE, the other production
// kernels FULL, the variants of anatomy.cu the others):
//   FULL       the operator above;
//   STAGED     the same, with u already holding the cell's x, or for a
//              pair c1 x1 + c2 x2 (the caller copied it into shared
//              memory; PAIR false);
//   STAGED_STORE  STAGED, with each node's sum stored into component 2
//              of its metric (`GShared::put`: the stage holding the
//              cell's G, whose component 2 of the node its owner has
//              read) instead of added into y; y and line unused;
//   POINTWISE  the x load, the metric and the scatter only: the 1-D
//              contractions become the identity, w = (u, u, u), and the
//              metric's three outputs are summed into the node;
//   STAGED_POINTWISE  POINTWISE on a staged u, its sums added in turns
//              (the anatomy's `gstream` on the z-pencil walk,
//              anatomy_walk.cuh); no barrier but the turns'.
enum Body {
  FULL = 0,
  STAGED = 1,
  POINTWISE = 2,
  STAGED_STORE = 3,
  STAGED_POINTWISE = 4
};

// Must be reached by every thread of the block (it synchronises twice, or
// not at all for POINTWISE); threads of an inactive cell slot (`active`
// false) touch no memory.  Ds: D[q * N + i] = l_i'(x_q) in shared memory;
// metric: the cell's c G (GStream, GShared or Corner); u, f1, f2: the
// cell's N^3 shared scratch arrays.  turn >= 0: the block's cells share
// nodes, so their adds into y run in `turns` turns, with a barrier between
// turns; this thread's cell adds in turn `turn` (the two cells of a slab
// pair, slab2.cu; a pencil chunk's even and odd cells,
// stiffness_pencil.cuh).  turn < 0: each thread adds as soon as its sum is
// ready.
template <typename T, int N, bool PAIR, int BODY = FULL, typename Metric,
          typename Line>
__device__ __forceinline__ void cell_apply(
    const T* __restrict__ x1, const T* __restrict__ x2, T c1, T c2,
    const Metric& metric, const T* Ds, T* u, T* f1, T* f2,
    T* __restrict__ y, bool active, const Line& line, int turn = -1,
    int turns = 1) {
  constexpr int NN = N * N;
  const int t = threadIdx.x;
  const int j = t / N, k = t % N;

  T ul[N];                         // u along this thread's line
  if (active) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (BODY == STAGED || BODY == STAGED_STORE ||
                    BODY == STAGED_POINTWISE) {
        ul[i] = u[i * NN + t];
      } else {
        T v = x1[line(i)];
        if (PAIR) v = c1 * v + c2 * x2[line(i)];
        ul[i] = v;
        if constexpr (BODY == FULL) u[i * NN + t] = v;
      }
    }
  }
  if constexpr (BODY == STAGED_POINTWISE) {
    T acc[N];
    if (active) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        T a, b, c;
        metric(i, i * NN + t, ul[i], ul[i], ul[i], a, b, c);
        acc[i] = a + b + c;
      }
    }
    for (int s = 0; s < turns; ++s) {
      if (s > 0) __syncthreads();  // the earlier turn's adds are visible
      if (active && s == turn) {
#pragma unroll
        for (int i = 0; i < N; ++i) y[line(i)] += acc[i];
      }
    }
    return;
  }
  if constexpr (BODY == POINTWISE) {
    if (active) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        T a, b, c;
        metric(i, i * NN + t, ul[i], ul[i], ul[i], a, b, c);
        y[line(i)] += a + b + c;
      }
    }
    return;
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

  T acc[N];                        // this line's sums, when added in turns
  if (active) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T s = T(0);
#pragma unroll
      for (int r = 0; r < N; ++r) {
        s += Ds[r * N + i] * f0[r];
        s += Ds[r * N + j] * f1[i * NN + r * N + k];
        s += Ds[r * N + k] * f2[i * NN + j * N + r];
      }
      if constexpr (BODY == STAGED_STORE)
        metric.put(i * NN + t, s);
      else if (turn < 0)
        y[line(i)] += s;
      else
        acc[i] = s;
    }
  }
  if (turn >= 0) {
    for (int s = 0; s < turns; ++s) {
      if (s > 0) __syncthreads();  // the earlier turn's adds are visible
      if (active && s == turn) {
#pragma unroll
        for (int i = 0; i < N; ++i) y[line(i)] += acc[i];
      }
    }
  }
}

}  // namespace fustpu
