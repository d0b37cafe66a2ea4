// Extruded (prismatic-topology) stiffness apply, y = sum_cells P^T D^T
// (c G) D P x, for GLL spectral hexahedra of degree P = 2..10 (N = P + 1)
// on an imported mesh whose cells form stacks of nz layers over a 2D
// unstructured footprint.  Cell (stack s, layer kz), node (i, j, k) holds
//
//   dof = rows2d[s, i*N + j] * gz + kz*P + k,     gz = nz*P + 1,
//
// so the kernel gathers x and scatters y through rows2d itself.
//
// Replaces the Pallas TPU kernel fustpu/ops/pallas_extruded.py:_mk_kernel
// (:604), via stiffness_apply_extruded_pallas (:841, one field, any
// per-cell coefficient folded into G) -> extruded_kernel<.., false>, and
// stiffness_apply_extruded_pallas_pair (:860, y = A_c1(x1) + A_c2(x2) with
// a unit G and per-cell (c1, c2)) -> extruded_kernel<.., true>.  The TPU
// kernel stacks footprint planes on sublanes and z on lanes, runs the
// z-window and z-fold as matmuls against 0/1 matrices, and leaves the row
// gather and scatter to XLA around it; none of that carries over.  Per
// cell the work here is the structured kernel's (sum_factor.cuh); only the
// index map differs.
//
// What bounds it on an H100: memory traffic, as for the structured kernel.
// At P = 4 in float32 a cell reads 3000 B of G for ~1e4 flops; at the
// imported H131 bowl (102,400 cells, 6,661,697 dofs) an apply must move at
// least G 307,200,000 B + x 26,646,788 B + y read and written 53,293,576 B
// + rows2d 160,000 B = ~387.3 MB, the structured flagship's traffic plus
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

#include <cuda_runtime.h>

#include "sum_factor.cuh"

namespace {

// Shared memory per cell: the structured kernel's, plus the N^2 row ids.
template <typename T, int N>
using RowShape = fustpu::Shape<T, N, N * N * (int)sizeof(int)>;

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

template <typename T, int N, bool PAIR>
__global__ void __launch_bounds__(RowShape<T, N>::NN * RowShape<T, N>::CPB)
extruded_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                const T* __restrict__ C, const T* __restrict__ G,
                const T* __restrict__ D, const int* __restrict__ rows,
                const int* __restrict__ cells, T* __restrict__ y,
                long long begin, long long count, int nz, int gz) {
  using S = RowShape<T, N>;
  constexpr int P = N - 1, NN = S::NN, NNN = S::NNN, CPB = S::CPB;
  __shared__ T Ds[NN];             // D[q * N + i] = l_i'(x_q)
  __shared__ T us[CPB][NNN];       // the cell's field u
  __shared__ T f1s[CPB][NNN];      // metric-transformed gradients
  __shared__ T f2s[CPB][NNN];
  __shared__ int rs[CPB][NN];      // the cell's 2D row ids

  const int t = threadIdx.x;       // this thread owns nodes (., j, k)
  const int lc = threadIdx.y;      // cell within the block
  const int j = t / N, k = t % N;
  for (int s = lc * NN + t; s < NN; s += NN * CPB) Ds[s] = D[s];

  const long long q = (long long)blockIdx.x * CPB + lc;
  const bool active = q < count;
  long long cell = 0;
  int kz = 0;
  if (active) {
    cell = cells[begin + q];
    const long long s = cell / nz;
    kz = (int)(cell - s * nz);
    rs[lc][t] = rows[s * NN + t];
  }
  T c1 = T(1), c2 = T(0);
  if (active && PAIR) {
    c1 = C[2 * cell];
    c2 = C[2 * cell + 1];
  }
  __syncthreads();                 // the row ids are shared by the cell
  fustpu::cell_apply<T, N, PAIR>(
      x1, x2, c1, c2, G + cell * 6 * NNN, Ds, us[lc], f1s[lc], f2s[lc], y,
      active, RowLine<N>{rs[lc], gz, (long long)kz * P + k, j});
}

template <typename T, bool PAIR, int N>
int launch_n(const void* x1, const void* x2, const void* C, const void* G,
             const void* D, const void* rows, const void* cells,
             const long long* bounds, int nclass, void* y, int nz, int gz,
             cudaStream_t stream) {
  using S = RowShape<T, N>;
  const dim3 block(S::NN, S::CPB);
  for (int c = 0; c < nclass; ++c) {
    const long long begin = bounds[c], count = bounds[c + 1] - bounds[c];
    if (count <= 0) continue;
    const unsigned blocks = (unsigned)((count + S::CPB - 1) / S::CPB);
    extruded_kernel<T, N, PAIR><<<blocks, block, 0, stream>>>(
        static_cast<const T*>(x1), static_cast<const T*>(x2),
        static_cast<const T*>(C), static_cast<const T*>(G),
        static_cast<const T*>(D), static_cast<const int*>(rows),
        static_cast<const int*>(cells), static_cast<T*>(y), begin, count,
        nz, gz);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, bool PAIR>
int launch(int P, const void* x1, const void* x2, const void* C,
           const void* G, const void* D, const void* rows, const void* cells,
           const long long* bounds, int nclass, void* y, int nz, int gz,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSTPU_CASE(P_)                                                    \
  case P_:                                                                 \
    return launch_n<T, PAIR, P_ + 1>(x1, x2, C, G, D, rows, cells, bounds, \
                                     nclass, y, nz, gz, s);
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

// C entry points.  Each returns 0, -1 for an unsupported degree, or the
// cudaError_t of the first failed launch.  y must be zeroed by the caller.
// rows: (nstacks, N^2) int32; cells: stack-order cell ids (s * nz + kz),
// int32, grouped by scatter class; bounds: nclass + 1 host offsets into
// cells.
extern "C" {

int fustpu_extruded_f32(const void* x, const void* G, const void* D,
                        const void* rows, const void* cells,
                        const long long* bounds, int nclass, void* y, int P,
                        int nz, int gz, void* stream) {
  return launch<float, false>(P, x, nullptr, nullptr, G, D, rows, cells,
                              bounds, nclass, y, nz, gz, stream);
}

int fustpu_extruded_f64(const void* x, const void* G, const void* D,
                        const void* rows, const void* cells,
                        const long long* bounds, int nclass, void* y, int P,
                        int nz, int gz, void* stream) {
  return launch<double, false>(P, x, nullptr, nullptr, G, D, rows, cells,
                               bounds, nclass, y, nz, gz, stream);
}

int fustpu_extruded_pair_f32(const void* x1, const void* x2, const void* C,
                             const void* G, const void* D, const void* rows,
                             const void* cells, const long long* bounds,
                             int nclass, void* y, int P, int nz, int gz,
                             void* stream) {
  return launch<float, true>(P, x1, x2, C, G, D, rows, cells, bounds, nclass,
                             y, nz, gz, stream);
}

int fustpu_extruded_pair_f64(const void* x1, const void* x2, const void* C,
                             const void* G, const void* D, const void* rows,
                             const void* cells, const long long* bounds,
                             int nclass, void* y, int P, int nz, int gz,
                             void* stream) {
  return launch<double, true>(P, x1, x2, C, G, D, rows, cells, bounds,
                              nclass, y, nz, gz, stream);
}

}  // extern "C"
