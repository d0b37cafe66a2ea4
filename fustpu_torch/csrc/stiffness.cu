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
// Each comes in float32, float64 and bfloat16 (stored in bfloat16,
// computed in float: stiffness_pencil.cuh).
//
// The host (ops/cuda_stiffness.py `pencil_schedule`) decides the launch:
// the chunk table (device), the classes (host: first row, pencils, chunks
// a pencil), the persistent grid, the cells a chunk, the ring's stages and
// bytes a stage, and the dynamic shared bytes; `fustpu_stiffness_occupancy`
// answers its question of how many blocks of a shape an SM holds.

#include <cuda_runtime.h>

#include "stiffness_pencil.cuh"

namespace {

using fustpu::pencil::BoxRows;
using fustpu::pencil::GRing;

template <typename T, typename S, bool PAIR>
int launch(int P, const void* x1, const void* x2, const void* C,
           const void* G, const void* D, void* y, const void* chunks,
           const long long* classes, int nclass, int blocks, int cpb,
           int stages, int stage_bytes, int smem, int ncy, int ncz,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gz = ncz * P + 1;
  const BoxRows lines{gz, (ncy * P + 1) * gz, nullptr};
#define FUSTPU_CASE(P_)                                                    \
  case P_:                                                                 \
    return fustpu::pencil::launch_classes<T, P_ + 1, PAIR,               \
                                          GRing<T, P_ + 1, S>>(            \
        x1, x2, C, G, D, nullptr, y, chunks, classes, nclass, blocks, cpb, \
        stages, stage_bytes, smem, lines, s);
  switch (P) {
    FUSTPU_DEGREES(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

template <typename T, typename S, bool PAIR>
int occupancy(int P, int cpb, int smem) {
#define FUSTPU_CASE(P_)                                            \
  case P_:                                                         \
    return fustpu::pencil::occupancy<T, P_ + 1, PAIR,              \
                                     GRing<T, P_ + 1, S>, BoxRows>( \
        cpb, smem);
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

#define FUSTPU_SINGLE(SUF, T, S)                                             \
  int fustpu_stiffness_##SUF(                                                \
      const void* x, const void* G, const void* D, void* y, int P,           \
      const void* chunks, const long long* classes, int nclass, int blocks,  \
      int cpb, int stages, int stage_bytes, int smem, int ncy, int ncz,      \
      void* stream) {                                                        \
    return launch<T, S, false>(P, x, nullptr, nullptr, G, D, y, chunks,      \
                               classes, nclass, blocks, cpb, stages,         \
                               stage_bytes, smem, ncy, ncz, stream);         \
  }                                                                          \
  int fustpu_stiffness_pair_##SUF(                                           \
      const void* x1, const void* x2, const void* C, const void* G,          \
      const void* D, void* y, int P, const void* chunks,                     \
      const long long* classes, int nclass, int blocks, int cpb, int stages, \
      int stage_bytes, int smem, int ncy, int ncz, void* stream) {           \
    return launch<T, S, true>(P, x1, x2, C, G, D, y, chunks, classes,        \
                              nclass, blocks, cpb, stages, stage_bytes,      \
                              smem, ncy, ncz, stream);                       \
  }

FUSTPU_SINGLE(f32, float, float)
FUSTPU_SINGLE(f64, double, double)
FUSTPU_SINGLE(bf16, float, __nv_bfloat16)
#undef FUSTPU_SINGLE

// Blocks of the kernel for (P, type, pair?) with cpb cells and smem dynamic
// shared bytes that one SM holds at once; type 0 float32, 1 float64, 2
// bfloat16; -1 for an unsupported degree, minus the cudaError_t of a
// failed query.
int fustpu_stiffness_occupancy(int P, int type, int pair, int cpb,
                               int smem) {
  using B = __nv_bfloat16;
  if (type == 1)
    return pair ? occupancy<double, double, true>(P, cpb, smem)
                : occupancy<double, double, false>(P, cpb, smem);
  if (type == 2)
    return pair ? occupancy<float, B, true>(P, cpb, smem)
                : occupancy<float, B, false>(P, cpb, smem);
  return pair ? occupancy<float, float, true>(P, cpb, smem)
              : occupancy<float, float, false>(P, cpb, smem);
}

}  // extern "C"
