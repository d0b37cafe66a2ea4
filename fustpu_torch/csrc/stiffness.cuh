// Structured-box stiffness apply, y = sum_cells P^T D^T (c G) D P x, for
// GLL spectral hexahedra of degree P = 2..10 (N = P + 1 nodes per axis):
// the kernel template, for the G stream (entry points in stiffness.cu) and
// the corner stream (CORNER, entry points in corner.cu).
//
// Replaces the two Pallas TPU kernels of fustpu/ops/pallas_stiffness.py:
//   - _mk_kernel (via _apply_single / stiffness_apply_pallas): one field,
//     any per-cell coefficient folded into G      -> stiffness_kernel, PAIR false
//   - _mk_kernel_pair (via stiffness_apply_pallas_pair): y = A_c1(x1) + A_c2(x2)
//     with a unit G and a per-cell (c1, c2)       -> stiffness_kernel, PAIR true
// and, with CORNER, _mk_kernel_corner (see corner.cu).
// The TPU kernels stream x-slabs in order and carry the x overlap in VMEM;
// here the operator is computed cell by cell, the way the reference CUDA
// kernel does it (one cell per block row, shared-memory sum factorisation).
//
// What bounds it on an H100: the geometry stream.  G holds 6 values per
// node, so at P = 4 in float32 a cell reads 6 * 125 * 4 = 3000 B of G (plus
// ~500 B of x and ~1000 B of y read-modify-write) for ~1e4 flops, about
// 2 flop/B: far below the card's float32 ridge (~20 flop/B), so the kernel
// is memory-bound and its floor is the bytes it moves.
//
// What the design does about it:
//   - every byte of G is read exactly once per apply, as 6 contiguous runs
//     per cell (G layout (cells, 6, N^3)); the x line and the partial sums
//     live in registers and the two cross-line operands in shared memory,
//     so nothing but x, G and y touches device memory (the per-cell body,
//     shared with the extruded kernel, is in sum_factor.cuh);
//   - a block holds N^2 threads per cell, each owning one line in i of the
//     cell's N^3 nodes (N^3 = 1331 > 1024 threads at P = 10), and packs
//     several cells per block (up to ~256 threads) so small degrees still
//     fill warps; shared memory is 3 N^3 values per cell (31.9 KB for one
//     float64 cell at N = 11), and the cells per block are chosen to stay
//     under the 48 KB static limit;
//   - the scatter is deterministic: cells sharing a node differ by one in
//     some cell index, so the 8 parity classes (a%2, b%2, c%2) are launched
//     one after another on the stream and each does plain y += with no
//     races.  The result is bitwise reproducible run to run, as the JAX
//     package's is, at the cost of 8 launches per apply instead of atomics.
//   - accumulators take the template type (no float literal in a double
//     kernel), and the card computes in native float32 / float64 (no TPU
//     bf16x3 split).

#pragma once

#include <cuda_runtime.h>

#include "corner.cuh"
#include "sum_factor.cuh"

namespace {

// Shared memory per cell: the per-cell body's, plus, for the corner
// stream, the cell's 37 channels and the block's GLL nodes and weights.
template <typename T, int N, bool CORNER>
using GridShape =
    fustpu::Shape<T, N, CORNER ? 37 * (int)sizeof(T) : 0,
                  CORNER ? 2 * N * (int)sizeof(T) : 0>;

// Cells of one parity class (px, py, pz): (a, b, c) = 2 (qa, qb, qc) + p.
inline __host__ __device__ int half_count(int n, int p) {
  return (n - p + 1) / 2;
}

// Global index of node (i, j, k) of a grid cell: the thread's (j, k) line
// starts at `base` and steps by the grid stride in i.
struct GridLine {
  long long base, sx;
  __device__ long long operator()(int i) const { return base + i * sx; }
};

// geo: G (cells, 6, N^3), or for CORNER the channels (cells, 37) of
// jacobian_coefficients with Q (2, N) the unit GLL nodes and weights.
template <typename T, int N, bool PAIR, bool CORNER>
__global__ void __launch_bounds__(GridShape<T, N, CORNER>::NN *
                                  GridShape<T, N, CORNER>::CPB)
stiffness_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                 const T* __restrict__ C, const T* __restrict__ geo,
                 const T* __restrict__ D, const T* __restrict__ Q,
                 T* __restrict__ y, int ncx, int ncy, int ncz, int px,
                 int py, int pz) {
  using S = GridShape<T, N, CORNER>;
  constexpr int P = N - 1, NN = S::NN, NNN = S::NNN, CPB = S::CPB;
  constexpr int NCH = CORNER ? 37 : 1;
  __shared__ T Ds[NN];             // D[q * N + i] = l_i'(x_q)
  __shared__ T us[CPB][NNN];       // the cell's field u
  __shared__ T f1s[CPB][NNN];      // metric-transformed y-gradient
  __shared__ T f2s[CPB][NNN];      // metric-transformed z-gradient
  __shared__ T chs[CPB][NCH];      // the cell's channels (CORNER)
  __shared__ T Qs[CORNER ? 2 * N : 1];

  const int t = threadIdx.x;       // this thread owns nodes (., j, k)
  const int lc = threadIdx.y;      // cell within the block
  const int j = t / N, k = t % N;
  for (int s = lc * NN + t; s < NN; s += NN * CPB) Ds[s] = D[s];

  const int hy = half_count(ncy, py), hz = half_count(ncz, pz);
  const long long q = (long long)blockIdx.x * CPB + lc;
  const bool active =
      q < (long long)half_count(ncx, px) * hy * (long long)hz;
  int a = 0, b = 0, c = 0;
  if (active) {
    const long long r = q / hz;
    a = 2 * (int)(r / hy) + px;
    b = 2 * (int)(r % hy) + py;
    c = 2 * (int)(q % hz) + pz;
  }
  const long long gz = (long long)ncz * P + 1;
  const long long sx = ((long long)ncy * P + 1) * gz;   // grid stride in i
  const long long base = (long long)a * P * sx + ((long long)b * P + j) * gz +
                         ((long long)c * P + k);
  const long long cell = ((long long)a * ncy + b) * ncz + c;
  T c1 = T(1), c2 = T(0);
  if (active && PAIR) {
    c1 = C[2 * cell];
    c2 = C[2 * cell + 1];
  }
  if constexpr (CORNER) {
    for (int s = lc * NN + t; s < 2 * N; s += NN * CPB) Qs[s] = Q[s];
    if (active)
      for (int s = t; s < NCH; s += NN) chs[lc][s] = geo[cell * NCH + s];
    __syncthreads();               // channels, nodes and weights are shared
    fustpu::cell_apply<T, N, PAIR>(
        x1, x2, c1, c2, fustpu::Corner<T, N, 1, true>(chs[lc], Qs, Qs + N, j, k),
        Ds, us[lc], f1s[lc], f2s[lc], y, active, GridLine{base, sx});
  } else {
    fustpu::cell_apply<T, N, PAIR>(
        x1, x2, c1, c2, fustpu::GStream<T, N>{geo + cell * 6 * NNN}, Ds,
        us[lc], f1s[lc], f2s[lc], y, active, GridLine{base, sx});
  }
}

template <typename T, bool PAIR, bool CORNER, int N>
int launch_n(const void* x1, const void* x2, const void* C, const void* geo,
             const void* D, const void* Q, void* y, int ncx, int ncy,
             int ncz, cudaStream_t stream) {
  using S = GridShape<T, N, CORNER>;
  const dim3 block(S::NN, S::CPB);
  for (int p = 0; p < 8; ++p) {
    const int px = p >> 2, py = (p >> 1) & 1, pz = p & 1;
    const long long cells = (long long)half_count(ncx, px) *
                            half_count(ncy, py) * half_count(ncz, pz);
    if (cells == 0) continue;
    const unsigned blocks = (unsigned)((cells + S::CPB - 1) / S::CPB);
    stiffness_kernel<T, N, PAIR, CORNER><<<blocks, block, 0, stream>>>(
        static_cast<const T*>(x1), static_cast<const T*>(x2),
        static_cast<const T*>(C), static_cast<const T*>(geo),
        static_cast<const T*>(D), static_cast<const T*>(Q),
        static_cast<T*>(y), ncx, ncy, ncz, px, py, pz);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, bool PAIR, bool CORNER>
int launch(int P, const void* x1, const void* x2, const void* C,
           const void* geo, const void* D, const void* Q, void* y, int ncx,
           int ncy, int ncz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSTPU_CASE(P_)                                                    \
  case P_:                                                                 \
    return launch_n<T, PAIR, CORNER, P_ + 1>(x1, x2, C, geo, D, Q, y, ncx, \
                                             ncy, ncz, s);
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
