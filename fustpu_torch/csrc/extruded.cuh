// Extruded (prismatic-topology) stiffness apply, y = sum_cells P^T D^T
// (c G) D P x, for GLL spectral hexahedra of degree P = 2..10 (N = P + 1)
// on an imported mesh whose cells form stacks of nz layers over a 2D
// unstructured footprint.  Cell (stack s, layer kz), node (i, j, k) holds
//
//   dof = rows2d[s, i*N + j] * gz + kz*P + k,     gz = nz*P + 1,
//
// so the kernel gathers x and scatters y through rows2d itself.  This is
// the kernel template, for the G stream (GD = 0, entry points in
// extruded.cu) and the corner stream of geometry degree GD = 1 or 2
// (entry points in extruded_corner.cu and extruded_corner27.cu).
//
// Replaces the Pallas TPU kernel fustpu/ops/pallas_extruded.py:_mk_kernel
// (:604), via stiffness_apply_extruded_pallas (:841, one field, any
// per-cell coefficient folded into G) -> extruded_kernel, PAIR false, and
// stiffness_apply_extruded_pallas_pair (:860, y = A_c1(x1) + A_c2(x2) with
// a unit G and per-cell (c1, c2)) -> extruded_kernel, PAIR true.  The TPU
// kernel stacks footprint planes on sublanes and z on lanes, runs the
// z-window and z-fold as matmuls against 0/1 matrices, and leaves the row
// gather and scatter to XLA around it; none of that carries over.  Per
// cell the work here is the structured kernel's (sum_factor.cuh); only the
// index map differs.
//
// What bounds it on an H100: memory traffic, as for the structured kernel.
// At P = 4 in float32 a cell reads 3000 B of G for ~1e4 flops; at the
// imported H131 bowl (102,400 cells, 6,661,697 dofs) an apply must move at
// least G 307,200,000 B + x 26,646,788 B + y written 26,646,788 B +
// rows2d 160,000 B = ~360.7 MB, the structured flagship's traffic plus
// the row ids.
//
// What the design does about it:
//   - G is (cells, 6, N^3) in stack order (cell s * nz + kz), so each
//     cell reads 6 contiguous runs, each byte once per apply;
//   - a cell's N^2 row ids are read once into shared memory; all index
//     arithmetic is 64-bit; threads (j, k) with consecutive k touch
//     consecutive dofs;
//   - the scatter is deterministic.  With an unstructured footprint the 8
//     parity classes of the structured kernel no longer separate cells
//     that share nodes, so the host colours the stacks greedily such that
//     no two stacks of one colour share a row of rows2d, and launches one
//     class per (colour, layer parity kz % 2).  Cells of one class share no
//     dof, so each does plain y += without atomics, and an apply is bitwise
//     reproducible run to run (the chosen alternative to one launch with
//     atomicAdd, whose order of additions varies).  A structured footprint
//     takes 4 colours, so 8 launches, as the structured kernel does.

#pragma once

#include <cuda_runtime.h>

#include "corner.cuh"
#include "sum_factor.cuh"

namespace {

// Channels per cell of the geometry stream: none for the G stream.
template <int GD>
__host__ __device__ constexpr int geo_channels() {
  return GD == 0 ? 0 : fustpu::CornerChannels<GD>::COUNT;
}

// Shared memory per cell: the structured kernel's, plus the N^2 row ids
// and, for the corner stream, the cell's channels and the block's GLL
// nodes and weights.
template <typename T, int N, int GD>
using RowShape =
    fustpu::Shape<T, N,
                  N * N * (int)sizeof(int) + geo_channels<GD>() * (int)sizeof(T),
                  GD == 0 ? 0 : 2 * N * (int)sizeof(T)>;

// Global index of node (i, j, k) of an extruded cell: r holds the cell's
// N^2 row ids, z = kz * P + k.
template <int N>
struct RowLine {
  const int* r;
  long long gz, z;
  int j;
  __device__ long long operator()(int i) const {
    return (long long)r[i * N + j] * gz + z;
  }
};

// geo: G (cells, 6, N^3) for GD = 0, or the corner_stream channels
// (cells, 37 or 163) with Q (2, N) the unit GLL nodes and weights; both in
// stack order s * nz + kz.
template <typename T, int N, bool PAIR, int GD>
__global__ void __launch_bounds__(RowShape<T, N, GD>::NN *
                                  RowShape<T, N, GD>::CPB)
extruded_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                const T* __restrict__ C, const T* __restrict__ geo,
                const T* __restrict__ D, const T* __restrict__ Q,
                const int* __restrict__ rows, const int* __restrict__ cells,
                T* __restrict__ y, long long begin, long long count, int nz,
                int gz) {
  using S = RowShape<T, N, GD>;
  constexpr int P = N - 1, NN = S::NN, NNN = S::NNN, CPB = S::CPB;
  constexpr int NCH = GD == 0 ? 1 : geo_channels<GD>();
  __shared__ T Ds[NN];             // D[q * N + i] = l_i'(x_q)
  __shared__ T us[CPB][NNN];       // the cell's field u
  __shared__ T f1s[CPB][NNN];      // metric-transformed gradients
  __shared__ T f2s[CPB][NNN];
  __shared__ int rs[CPB][NN];      // the cell's 2D row ids
  __shared__ T chs[CPB][NCH];      // the cell's channels (corner stream)
  __shared__ T Qs[GD == 0 ? 1 : 2 * N];

  const int t = threadIdx.x;       // this thread owns nodes (., j, k)
  const int lc = threadIdx.y;      // cell within the block
  const int j = t / N, k = t % N;
  for (int s = lc * NN + t; s < NN; s += NN * CPB) Ds[s] = D[s];
  if constexpr (GD != 0)
    for (int s = lc * NN + t; s < 2 * N; s += NN * CPB) Qs[s] = Q[s];

  const long long q = (long long)blockIdx.x * CPB + lc;
  const bool active = q < count;
  long long cell = 0;
  int kz = 0;
  if (active) {
    cell = cells[begin + q];
    const long long s = cell / nz;
    kz = (int)(cell - s * nz);
    rs[lc][t] = rows[s * NN + t];
    if constexpr (GD != 0)
      for (int m = t; m < NCH; m += NN) chs[lc][m] = geo[cell * NCH + m];
  }
  T c1 = T(1), c2 = T(0);
  if (active && PAIR) {
    c1 = C[2 * cell];
    c2 = C[2 * cell + 1];
  }
  __syncthreads();                 // row ids (and channels) are shared
  const RowLine<N> line{rs[lc], gz, (long long)kz * P + k, j};
  if constexpr (GD == 0) {
    fustpu::cell_apply<T, N, PAIR>(
        x1, x2, c1, c2, fustpu::GStream<T, N>{geo + cell * 6 * NNN}, Ds,
        us[lc], f1s[lc], f2s[lc], y, active, line);
  } else {
    fustpu::cell_apply<T, N, PAIR>(
        x1, x2, c1, c2,
        fustpu::Corner<T, N, GD, false>(chs[lc], Qs, Qs + N, j, k), Ds,
        us[lc], f1s[lc], f2s[lc], y, active, line);
  }
}

template <typename T, bool PAIR, int GD, int N>
int launch_n(const void* x1, const void* x2, const void* C, const void* geo,
             const void* D, const void* Q, const void* rows,
             const void* cells, const long long* bounds, int nclass, void* y,
             int nz, int gz, cudaStream_t stream) {
  using S = RowShape<T, N, GD>;
  const dim3 block(S::NN, S::CPB);
  for (int c = 0; c < nclass; ++c) {
    const long long begin = bounds[c], count = bounds[c + 1] - bounds[c];
    if (count <= 0) continue;
    const unsigned blocks = (unsigned)((count + S::CPB - 1) / S::CPB);
    extruded_kernel<T, N, PAIR, GD><<<blocks, block, 0, stream>>>(
        static_cast<const T*>(x1), static_cast<const T*>(x2),
        static_cast<const T*>(C), static_cast<const T*>(geo),
        static_cast<const T*>(D), static_cast<const T*>(Q),
        static_cast<const int*>(rows), static_cast<const int*>(cells),
        static_cast<T*>(y), begin, count, nz, gz);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, bool PAIR, int GD>
int launch(int P, const void* x1, const void* x2, const void* C,
           const void* geo, const void* D, const void* Q, const void* rows,
           const void* cells, const long long* bounds, int nclass, void* y,
           int nz, int gz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSTPU_CASE(P_)                                                     \
  case P_:                                                                  \
    return launch_n<T, PAIR, GD, P_ + 1>(x1, x2, C, geo, D, Q, rows, cells, \
                                         bounds, nclass, y, nz, gz, s);
  switch (P) {
    FUSTPU_CASE(2)
    FUSTPU_CASE(3)
    FUSTPU_CASE(4)
    FUSTPU_CASE(5)
    FUSTPU_CASE(6)
    FUSTPU_CASE(7)
    FUSTPU_CASE(8)
    FUSTPU_CASE(9)
    FUSTPU_CASE(10)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

}  // namespace
