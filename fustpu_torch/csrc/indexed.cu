// Indexed stiffness apply, y = sum_cells P_c^T D^T (c G) D P_c x, for GLL
// spectral hexahedra of degree P = 2..10 (N = P + 1) on any conforming hex
// mesh: cell c's node (i, j, k) holds dof dofmap[c, i*N*N + j*N + k], so
// the kernel gathers x and scatters y through the dofmap itself.
//
// Replaces the Pallas TPU kernel fustpu/ops/pallas_gather.py:
// _mk_fused_kernel (:1417), called by _fused_call (:1485) through
// fused_apply (:1546; modes 'plain' and 'coeff') and fused_apply_pair
// (:1560; mode 'pair').  Here:
//   - 'coeff' (the linear model's per-cell coefficient): folded into G on
//     the host -> indexed_kernel<.., false>;
//   - 'plain' (the uniform Westervelt fold, one field) -> the same kernel
//     with a unit-coefficient G;
//   - 'pair' (y = A_c1(x1) + A_c2(x2), unit G, per-cell (c1, c2), folded
//     u = c1 x1 + c2 x2 before one contraction) -> indexed_kernel<.., true>.
// The TPU kernel is shaped by its machine: one-hot windowed matmuls for
// the gather and scatter (the TPU has no fast gather and no atomics),
// 128-lane cell rows, supertiles, a VMEM-resident output and dense
// (N^3 x N^3) derivative operators; it only fits N^3 <= 128 (P <= 4).
// None of that carries over.  Per cell the work here is the structured
// kernel's sum-factorised body (sum_factor.cuh); only the index map
// differs, and every P = 2..10 runs.
//
// What bounds it on an H100: memory traffic.  At the bodyfit H131 bowl
// (102,400 cells, 6,661,697 dofs, P = 4, float32) an apply must move at
// least G 307,200,000 B + x 26,646,788 B + y written 26,646,788 B +
// dofmap 51,200,000 B = 411,693,576 B (the pair form adds x2 and C:
// 439,159,564 B), for ~1e4 flops per cell.  Unlike the structured and
// extruded kernels, every node's address is an indirect load, and the
// cells of one scatter class are spread through the mesh.
//
// What the design does about it:
//   - G is (cells, 6, N^3) in mesh cell order and the dofmap (cells, N^3)
//     int32, so each cell reads 7 contiguous runs, each byte once per
//     apply; the cell's N^3 dof ids are read once into shared memory (each
//     thread reads the N ids of its own line, coalesced across threads)
//     and serve both the gather and the scatter; G and dofmap offsets are
//     64-bit;
//   - the scatter is deterministic.  Cells that share a node (across a
//     face, an edge or a vertex) must not add into y at once, and an
//     unstructured mesh has no parity or stack structure to separate them.
//     The host colours the cells greedily in cell order so that no two
//     cells of a colour share a dof, and launches one class per colour,
//     each class's cell ids in ascending order so that a block's cells
//     stay near each other in memory.  Cells of one class do plain y +=
//     without atomics, so an apply is bitwise reproducible run to run (the
//     chosen alternative to one launch with atomicAdd, whose order of
//     additions varies).  An interior vertex is shared by 8 cells, so
//     there are at least 8 colours.

#include <cuda_runtime.h>

#include "sum_factor.cuh"

namespace {

// Shared memory per cell: the structured kernel's, plus the N^3 dof ids.
template <typename T, int N>
using IdShape = fustpu::Shape<T, N, N * N * N * (int)sizeof(int)>;

// Global index of node (i, j, k) of the cell: ids holds its N^3 dof ids,
// t = j * N + k.
template <int N>
struct IdLine {
  const int* ids;
  int t;
  __device__ long long operator()(int i) const {
    return (long long)ids[i * N * N + t];
  }
};

template <typename T, int N, bool PAIR>
__global__ void __launch_bounds__(IdShape<T, N>::NN * IdShape<T, N>::CPB)
indexed_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
               const T* __restrict__ C, const T* __restrict__ G,
               const T* __restrict__ D, const int* __restrict__ dofmap,
               const int* __restrict__ cells, T* __restrict__ y,
               long long begin, long long count) {
  using S = IdShape<T, N>;
  constexpr int NN = S::NN, NNN = S::NNN, CPB = S::CPB;
  __shared__ T Ds[NN];             // D[q * N + i] = l_i'(x_q)
  __shared__ T us[CPB][NNN];       // the cell's field u
  __shared__ T f1s[CPB][NNN];      // metric-transformed gradients
  __shared__ T f2s[CPB][NNN];
  __shared__ int ids[CPB][NNN];    // the cell's dof ids

  const int t = threadIdx.x;       // this thread owns nodes (., j, k)
  const int lc = threadIdx.y;      // cell within the block
  for (int s = lc * NN + t; s < NN; s += NN * CPB) Ds[s] = D[s];

  const long long q = (long long)blockIdx.x * CPB + lc;
  const bool active = q < count;
  long long cell = 0;
  if (active) {
    cell = cells[begin + q];
    const int* dm = dofmap + cell * NNN;
    // each thread loads the ids of its own line: no barrier needed
#pragma unroll
    for (int i = 0; i < N; ++i) ids[lc][i * NN + t] = dm[i * NN + t];
  }
  T c1 = T(1), c2 = T(0);
  if (active && PAIR) {
    c1 = C[2 * cell];
    c2 = C[2 * cell + 1];
  }
  fustpu::cell_apply<T, N, PAIR>(
      x1, x2, c1, c2, fustpu::GStream<T, N>{G + cell * 6 * NNN}, Ds, us[lc],
      f1s[lc], f2s[lc], y, active, IdLine<N>{ids[lc], t});
}

template <typename T, bool PAIR, int N>
int launch_n(const void* x1, const void* x2, const void* C, const void* G,
             const void* D, const void* dofmap, const void* cells,
             const long long* bounds, int nclass, void* y,
             cudaStream_t stream) {
  using S = IdShape<T, N>;
  const dim3 block(S::NN, S::CPB);
  for (int c = 0; c < nclass; ++c) {
    const long long begin = bounds[c], count = bounds[c + 1] - bounds[c];
    if (count <= 0) continue;
    const unsigned blocks = (unsigned)((count + S::CPB - 1) / S::CPB);
    indexed_kernel<T, N, PAIR><<<blocks, block, 0, stream>>>(
        static_cast<const T*>(x1), static_cast<const T*>(x2),
        static_cast<const T*>(C), static_cast<const T*>(G),
        static_cast<const T*>(D), static_cast<const int*>(dofmap),
        static_cast<const int*>(cells), static_cast<T*>(y), begin, count);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, bool PAIR>
int launch(int P, const void* x1, const void* x2, const void* C,
           const void* G, const void* D, const void* dofmap,
           const void* cells, const long long* bounds, int nclass, void* y,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSTPU_CASE(P_)                                                   \
  case P_:                                                                \
    return launch_n<T, PAIR, P_ + 1>(x1, x2, C, G, D, dofmap, cells,      \
                                     bounds, nclass, y, s);
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
// dofmap: (cells, N^3) int32; cells: cell ids, int32, grouped by scatter
// class; bounds: nclass + 1 host offsets into cells.
extern "C" {

int fustpu_indexed_f32(const void* x, const void* G, const void* D,
                       const void* dofmap, const void* cells,
                       const long long* bounds, int nclass, void* y, int P,
                       void* stream) {
  return launch<float, false>(P, x, nullptr, nullptr, G, D, dofmap, cells,
                              bounds, nclass, y, stream);
}

int fustpu_indexed_f64(const void* x, const void* G, const void* D,
                       const void* dofmap, const void* cells,
                       const long long* bounds, int nclass, void* y, int P,
                       void* stream) {
  return launch<double, false>(P, x, nullptr, nullptr, G, D, dofmap, cells,
                               bounds, nclass, y, stream);
}

int fustpu_indexed_pair_f32(const void* x1, const void* x2, const void* C,
                            const void* G, const void* D, const void* dofmap,
                            const void* cells, const long long* bounds,
                            int nclass, void* y, int P, void* stream) {
  return launch<float, true>(P, x1, x2, C, G, D, dofmap, cells, bounds,
                             nclass, y, stream);
}

int fustpu_indexed_pair_f64(const void* x1, const void* x2, const void* C,
                            const void* G, const void* D, const void* dofmap,
                            const void* cells, const long long* bounds,
                            int nclass, void* y, int P, void* stream) {
  return launch<double, true>(P, x1, x2, C, G, D, dofmap, cells, bounds,
                              nclass, y, stream);
}

}  // extern "C"
