// Entry points of the structured stiffness apply on the main path: the
// z-pencil kernel of stiffness_pencil.cuh, single field and pair.
//
// Replaces fustpu/ops/pallas_stiffness.py's _mk_kernel (:170, one field,
// via stiffness_apply_pallas) and _mk_kernel_pair (:726, y = A_c1(x1) +
// A_c2(x2), via stiffness_apply_pallas_pair).  Bound on an H100 by its
// bytes (G, read once, is ~80% of them at P = 4); what the design does
// about that, and why it uses no tensor cores, is in stiffness_pencil.cuh.
// The parity-class design of the same kernels (stiffness.cuh, eight parity
// classes of cells) is reached through anatomy.cu's `full` variant.
//
// The host (ops/cuda_stiffness.py `pencil_schedule`) decides the launch:
// the chunk table (device), the classes (host: first row, pencils, chunks
// a pencil), the persistent grid, the cells a chunk, the ring's stages and
// bytes a stage, and the dynamic shared bytes; `fustpu_stiffness_occupancy`
// answers its question of how many blocks of a shape an SM holds.

#include <cuda_runtime.h>

#include "stiffness_pencil.cuh"

namespace {

constexpr int MAX_SMEM = 232448;   // one block's shared memory on Hopper

// Lets the kernel take all the dynamic shared memory that its static D
// leaves of a block's.
template <typename T, int N, bool PAIR>
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, fustpu::pencil::pencil_kernel<T, N, PAIR>);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fustpu::pencil::pencil_kernel<T, N, PAIR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM - (int)attr.sharedSizeBytes);
  done = err == cudaSuccess;
  return err;
}

template <typename T, bool PAIR, int N>
int pencil_launch_n(const void* x1, const void* x2, const void* C,
                    const void* G, const void* D, void* y,
                    const void* chunks, const long long* classes, int nclass,
                    int blocks, int cpb, int stages, int stage_bytes,
                    int smem, int ncy, int ncz, cudaStream_t stream) {
  cudaError_t err = allow_smem<T, N, PAIR>();
  if (err != cudaSuccess) return (int)err;
  const dim3 block(N * N, cpb);
  for (int c = 0; c < nclass; ++c) {
    const long long first = classes[3 * c], pencils = classes[3 * c + 1];
    const int per_pencil = (int)classes[3 * c + 2];
    if (pencils <= 0) continue;
    const unsigned grid = (unsigned)(pencils < blocks ? pencils : blocks);
    fustpu::pencil::pencil_kernel<T, N, PAIR><<<grid, block, smem, stream>>>(
        static_cast<const T*>(x1), static_cast<const T*>(x2),
        static_cast<const T*>(C), static_cast<const T*>(G),
        static_cast<const T*>(D), static_cast<T*>(y),
        static_cast<const long long*>(chunks), first, (int)pencils, per_pencil,
        stages, stage_bytes, ncy, ncz);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, bool PAIR, int N>
int occupancy_n(int cpb, int smem) {
  cudaError_t err = allow_smem<T, N, PAIR>();
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fustpu::pencil::pencil_kernel<T, N, PAIR>, N * N * cpb, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

#define FUSTPU_DEGREES(M) \
  M(2) M(3) M(4) M(5) M(6) M(7) M(8) M(9) M(10)

template <typename T, bool PAIR>
int launch(int P, const void* x1, const void* x2, const void* C,
           const void* G, const void* D, void* y, const void* chunks,
           const long long* classes, int nclass, int blocks, int cpb,
           int stages, int stage_bytes, int smem, int ncy, int ncz,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSTPU_CASE(P_)                                                    \
  case P_:                                                                 \
    return pencil_launch_n<T, PAIR, P_ + 1>(                               \
        x1, x2, C, G, D, y, chunks, classes, nclass, blocks, cpb, stages,  \
        stage_bytes, smem, ncy, ncz, s);
  switch (P) {
    FUSTPU_DEGREES(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

template <typename T, bool PAIR>
int occupancy(int P, int cpb, int smem) {
#define FUSTPU_CASE(P_) \
  case P_:              \
    return occupancy_n<T, PAIR, P_ + 1>(cpb, smem);
  switch (P) {
    FUSTPU_DEGREES(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

}  // namespace

// C entry points.  Each launcher returns 0, -1 for an unsupported degree,
// or the cudaError_t of the first failed call; y must be zeroed by the
// caller.  chunks: (rows, 5) int64 on the device; classes: nclass x 3 int64
// on the host.
extern "C" {

#define FUSTPU_SINGLE(SUF, T)                                                \
  int fustpu_stiffness_##SUF(                                                \
      const void* x, const void* G, const void* D, void* y, int P,           \
      const void* chunks, const long long* classes, int nclass, int blocks,  \
      int cpb, int stages, int stage_bytes, int smem, int ncy, int ncz,      \
      void* stream) {                                                        \
    return launch<T, false>(P, x, nullptr, nullptr, G, D, y, chunks,         \
                            classes, nclass, blocks, cpb, stages,            \
                            stage_bytes, smem, ncy, ncz, stream);            \
  }                                                                          \
  int fustpu_stiffness_pair_##SUF(                                           \
      const void* x1, const void* x2, const void* C, const void* G,          \
      const void* D, void* y, int P, const void* chunks,                     \
      const long long* classes, int nclass, int blocks, int cpb, int stages, \
      int stage_bytes, int smem, int ncy, int ncz, void* stream) {           \
    return launch<T, true>(P, x1, x2, C, G, D, y, chunks, classes, nclass,   \
                           blocks, cpb, stages, stage_bytes, smem, ncy, ncz, \
                           stream);                                          \
  }

FUSTPU_SINGLE(f32, float)
FUSTPU_SINGLE(f64, double)
#undef FUSTPU_SINGLE

// Blocks of the kernel for (P, float64?, pair?) with cpb cells and smem
// dynamic shared bytes that one SM holds at once; -1 for an unsupported
// degree, minus the cudaError_t of a failed query.
int fustpu_stiffness_occupancy(int P, int f64, int pair, int cpb, int smem) {
  if (f64)
    return pair ? occupancy<double, true>(P, cpb, smem)
                : occupancy<double, false>(P, cpb, smem);
  return pair ? occupancy<float, true>(P, cpb, smem)
              : occupancy<float, false>(P, cpb, smem);
}

}  // extern "C"
