// Two-slab structured stiffness apply: the operator of the z-pencil kernel
// (any per-cell coefficient folded into G) with the x-slabs of cells taken
// in pairs, in two designs.
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
// double width.  On an H100 that has no meaning: what is left of a pair is
// which pencils a block walks together.
//
// What bounds it on an H100: the G stream, as for #1 (the same bytes: G,
// x and y once each); at P = 4 float32 about 2 flop per byte, far below
// the ridge.
//
// The walk (fustpu_slab2_pencil_*): the z-pencil kernel of
// stiffness_pencil.cuh (the TMA G ring, the persistent grid, staged x and
// the chunk's y buffer), whose work item is a slab pair's two pencils
// (a, b) and (a', b), walked one after the other (SlabRows), the ring
// carrying the next chunk whether it is the second pencil's first or the
// next pair's (ops/cuda_slab2.py `slab2_schedule` builds the chunk table).
// An adjacent pair's pencils share their x-face: where the first pencil's
// last chunk and the second's first share nodes (a pencil of at most two
// chunks), the last one's y goes out before the next one's is fetched (the
// walk's drain); otherwise the walk's one-chunk lag already orders them.
// Classes: (the pair's colour, b % 2), the colours of ops/slab2.py
// `slab_colours` (two pairs of a colour hold no slabs within one of each
// other), so two work items of a class share no node: 4 classes, or 6 for
// far pairing with an odd pair count; a class's ghost pairs are a class
// entry of their own.  The far pairing's seam is then the grid plane ncx2 P,
// where slabs ncx2 - 1 and ncx2, of differently coloured pairs, meet.  The
// scatter is deterministic without atomics: the class order, the work
// items of a class (disjoint), the chunk order and the turn order fix
// every node's order of adds.
//
// The class-launch design (the first CUDA design, fustpu_slab2_classes_*,
// kept as the
// comparison): one pair of cells a block, 2 N^2 threads each owning an
// i-line of one cell (threadIdx.y is the cell), so the pair shares the
// block's copy of D and runs its y / z contraction passes together,
// between the same barriers; the host's block -> (cell a, cell b) table
// (ops/slab2.py `pair_table`, -1 for the ghost) in 8 classes (adjacent:
// the pair's colour, b % 2, c % 2) or up to 12 (far), one launch each;
// per-cell body sum_factor.cuh's cell_apply with GStream (each byte of G
// read once, 4 B at a time by the threads); two turns inside a block;
// shared memory D and 3 N^3 values a cell.

#include <cuda_runtime.h>

#include "stiffness.cuh"
#include "stiffness_pencil.cuh"

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
#define FUSTPU_CASE(P_)                                                      \
  case P_:                                                                   \
    return slab2_launch_n<T, P_ + 1>(x, G, D, pairs, bounds, nclass, y,      \
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

// ---- the walk ----

using fustpu::pencil::GRing;

// A work item's `sub` chunks of its first pencil, then (but for the
// ghost's pair) as many of its second, whose first chunk follows the first
// pencil's last after a drain where `drain`.
struct SlabRows {
  static constexpr bool IDS = false, XBULK = false;
  int gz, sx;
  const int* ids;                      // unused
  int sub, drain;
  template <int N>
  __device__ int base(const long long* r, const int*, int rr) const {
    return (int)r[4] + (rr / N) * sx + (rr % N) * gz;
  }
  __device__ bool starts(int qi) const { return qi % sub == 0; }
  __device__ bool drains(int qi) const { return drain && qi % sub == 0; }
};

template <typename T>
int launch_walk(int P, const void* x, const void* G, const void* D, void* y,
                const void* chunks, const long long* classes, int nclass,
                int blocks, int cpb, int stages, int stage_bytes, int smem,
                int ncy, int ncz, int drain, int sub, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gz = ncz * P + 1, sx = (ncy * P + 1) * gz;
  const SlabRows lines{gz, sx, nullptr, sub, drain};
#define FUSTPU_CASE(P_)                                                      \
  case P_:                                                                   \
    return fustpu::pencil::launch_classes<T, P_ + 1, false,                  \
                                          GRing<T, P_ + 1>>(                 \
        x, nullptr, nullptr, G, D, nullptr, y, chunks, classes, nclass,      \
        blocks, cpb, stages, stage_bytes, smem, lines, s);
  switch (P) {
    FUSTPU_DEGREES(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

template <typename T>
int occupancy_walk(int P, int cpb, int smem) {
#define FUSTPU_CASE(P_)                                                      \
  case P_:                                                                   \
    return fustpu::pencil::occupancy<T, P_ + 1, false, GRing<T, P_ + 1>,     \
                                     SlabRows>(cpb, smem);
  switch (P) {
    FUSTPU_DEGREES(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

}  // namespace

// C entry points.  Each returns 0, -1 for an unsupported degree, or the
// cudaError_t of the first failed call.  y must be zeroed by the caller.
// G: (cells, 6, N^3).  classes: pairs (blocks, 2) int32 grouped by scatter
// class; bounds: nclass + 1 host offsets into the blocks.  pencil: the
// walk's schedule after P as stiffness.cu's takes it (chunks (rows, 5)
// int64 on the device; classes nclass x 3 int64 on the host: first row,
// work items, chunks an item), cpb the cells a pencil a chunk; drain: 1
// where a pair's pencils share nodes; sub: the chunks of one pencil.
extern "C" {

int fustpu_slab2_classes_f32(const void* x, const void* G, const void* D,
                     const void* pairs, const long long* bounds, int nclass,
                     void* y, int P, int ncy, int ncz, void* stream) {
  return launch_slab2<float>(P, x, G, D, pairs, bounds, nclass, y, ncy, ncz,
                             stream);
}

int fustpu_slab2_classes_f64(const void* x, const void* G, const void* D,
                     const void* pairs, const long long* bounds, int nclass,
                     void* y, int P, int ncy, int ncz, void* stream) {
  return launch_slab2<double>(P, x, G, D, pairs, bounds, nclass, y, ncy,
                              ncz, stream);
}

#define FUSTPU_SLAB2_PENCIL(SUF, T)                                          \
  int fustpu_slab2_pencil_##SUF(                                             \
      const void* x, const void* G, const void* D, void* y, int P,           \
      const void* chunks, const long long* classes, int nclass, int blocks,  \
      int cpb, int stages, int stage_bytes, int smem, int ncy, int ncz,      \
      int drain, int sub, void* stream) {                                    \
    return launch_walk<T>(P, x, G, D, y, chunks, classes, nclass, blocks,    \
                          cpb, stages, stage_bytes, smem, ncy, ncz, drain,   \
                          sub, stream);                                      \
  }

FUSTPU_SLAB2_PENCIL(f32, float)
FUSTPU_SLAB2_PENCIL(f64, double)
#undef FUSTPU_SLAB2_PENCIL

// Blocks of the walk for (P, float64?) with cpb cells a pencil and smem
// dynamic shared bytes that one SM holds at once (0 beyond the kernel's
// launch bounds); -1 for an unsupported degree, minus the cudaError_t of a
// failed query.
int fustpu_slab2_pencil_occupancy(int P, int f64, int cpb, int smem) {
  return f64 ? occupancy_walk<double>(P, cpb, smem)
             : occupancy_walk<float>(P, cpb, smem);
}

}  // extern "C"
