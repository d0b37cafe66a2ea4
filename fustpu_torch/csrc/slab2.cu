// Two-slab structured stiffness apply: the operator of stiffness.cuh (any
// per-cell coefficient folded into G) with the cells taken in pairs of
// x-slabs, one pair of cells per block.
//
// Replaces the two experimental Pallas TPU kernels of
// fustpu/ops/pallas_stiffness.py:
//   - _mk_kernel_slab2 (:314), via _apply_slab2 (:404): adjacent pairing,
//     slabs (2q, 2q + 1) share one grid step;
//   - _mk_kernel_slab2w (:528), via _apply_slab2w (:609): far pairing,
//     slab i shares with slab ncx2 + i, and the two sweeps meet at a seam
//     that is overlap-added.
// Both pad ncx to even with a zero-G ghost slab.  On the TPU the pair
// shares the lanes of one block, so that the y contractions run once at
// double width.  Here a block takes the two cells (a, b, c) of a pair:
// 2 N^2 threads, each owning an i-line of one cell (threadIdx.y is the
// cell), so the pair shares the block's copy of D and runs its y / z
// contraction passes together, between the same barriers.  Which cells
// pair is the host's table (ops/slab2.py: the block -> (cell a, cell b)
// map, -1 for the ghost), so one kernel serves both pairings: the two
// TPU kernels differ only in their tables.
//
// What bounds it on an H100: the G stream, as for the production kernel
// (the same bytes: G, x and y once each); at P = 4 float32 about 2 flop
// per byte, far below the ridge.
//
// What the design does about it:
//   - the per-cell body is sum_factor.cuh's cell_apply with GStream, so
//     every byte of G is read once as 6 contiguous runs per cell;
//   - the scatter is deterministic without atomics: the host colours the
//     pairs so that no two blocks of a class share a node (adjacent
//     pairing: the slab pair's parity and the cell's (b, c) parities, 8
//     classes; far pairing: the slab pairs form a cycle through the seam,
//     cell ncx2 - 1 touching cell ncx2, so an odd count takes a third
//     colour), one launch per class; inside a block the two cells can
//     share a face (always with adjacent pairing, and with far pairing
//     when ncx = 2), so they add into y in two turns with a barrier
//     between (cell_apply's `turn`);
//   - shared memory is D and 3 N^3 values per cell, 6 N^3 + N^2 values a
//     block (64.9 KB for float64 at N = 11), dynamic above the 48 KB
//     static limit.

#include <cuda_runtime.h>

#include "stiffness.cuh"

namespace {

// pairs: (blocks, 2) int32 cell ids, cell = (a ncy + b) ncz + c, -1 for the
// ghost; the class's blocks start at `first`.
template <typename T, int N>
__global__ void __launch_bounds__(2 * N * N)
slab2_kernel(const T* __restrict__ x, const T* __restrict__ G,
             const T* __restrict__ D, const int* __restrict__ pairs,
             long long first, T* __restrict__ y, int ncy, int ncz) {
  constexpr int P = N - 1, NN = N * N, NNN = N * N * N;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ds = reinterpret_cast<T*>(smem);      // D[q * N + i] = l_i'(x_q)
  T* u = Ds + NN;                          // per cell: u, f1, f2
  const int t = threadIdx.x, h = threadIdx.y;
  const int j = t / N, k = t % N;
  for (int s = h * NN + t; s < NN; s += 2 * NN) Ds[s] = D[s];

  const int cell = pairs[2 * (first + blockIdx.x) + h];
  const bool active = cell >= 0;
  const long long cc = active ? cell : 0;
  const long long a = cc / ((long long)ncy * ncz);
  const long long b = (cc / ncz) % ncy, c = cc % ncz;
  const long long gz = (long long)ncz * P + 1;
  const long long sx = ((long long)ncy * P + 1) * gz;   // grid stride in i
  const long long base = a * P * sx + (b * P + j) * gz + (c * P + k);
  T* us = u + h * 3 * NNN;
  fustpu::cell_apply<T, N, false>(
      x, nullptr, T(1), T(0), fustpu::GStream<T, N>{G + cc * 6 * NNN}, Ds,
      us, us + NNN, us + 2 * NNN, y, active, GridLine{base, sx}, h, 2);
}

template <typename T, int N>
int slab2_launch_n(const void* x, const void* G, const void* D,
                   const void* pairs, const long long* bounds, int nclass,
                   void* y, int ncy, int ncz, cudaStream_t stream) {
  constexpr int bytes = (N * N + 6 * N * N * N) * (int)sizeof(T);
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        slab2_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const dim3 block(N * N, 2);
  for (int c = 0; c < nclass; ++c) {
    const long long count = bounds[c + 1] - bounds[c];
    if (count <= 0) continue;
    slab2_kernel<T, N><<<(unsigned)count, block, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(G),
        static_cast<const T*>(D), static_cast<const int*>(pairs), bounds[c],
        static_cast<T*>(y), ncy, ncz);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
int launch_slab2(int P, const void* x, const void* G, const void* D,
                 const void* pairs, const long long* bounds, int nclass,
                 void* y, int ncy, int ncz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSTPU_CASE(P_)                                                    \
  case P_:                                                                 \
    return slab2_launch_n<T, P_ + 1>(x, G, D, pairs, bounds, nclass, y,  \
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

// C entry points.  Each returns 0, -1 for an unsupported degree, or the
// cudaError_t of the first failed call.  y must be zeroed by the caller.
// G: (cells, 6, N^3); pairs: (blocks, 2) int32 grouped by scatter class;
// bounds: nclass + 1 host offsets into the blocks.
extern "C" {

int fustpu_slab2_f32(const void* x, const void* G, const void* D,
                     const void* pairs, const long long* bounds, int nclass,
                     void* y, int P, int ncy, int ncz, void* stream) {
  return launch_slab2<float>(P, x, G, D, pairs, bounds, nclass, y, ncy, ncz,
                             stream);
}

int fustpu_slab2_f64(const void* x, const void* G, const void* D,
                     const void* pairs, const long long* bounds, int nclass,
                     void* y, int P, int ncy, int ncz, void* stream) {
  return launch_slab2<double>(P, x, G, D, pairs, bounds, nclass, y, ncy,
                              ncz, stream);
}

}  // extern "C"
