// Entry points of the structured stiffness apply on a bfloat16 operator on
// the main path: the lean walk of pencil_lean.cuh on box pencils, single
// field and pair.  stiffness.cu keeps the first bfloat16 walk
// (`fustpu_stiffness_bf16`, `fustpu_stiffness_pair_bf16`) as the
// comparison, and the float32 and float64 walks.
//
// Replaces, in bfloat16, fustpu/ops/pallas_stiffness.py's _mk_kernel
// (:170, one field, via stiffness_apply_pallas) and _mk_kernel_pair (:726,
// y = A_c1(x1) + A_c2(x2), via stiffness_apply_pallas_pair).  What bounds
// it and what the design does about it: pencil_lean.cuh.
//
// The host (ops/cuda_stiffness.py `pencil_schedule`, design "lean")
// decides the launch as for the first design: the chunk table, the
// classes, the persistent grid, the cells a chunk, the ring and the
// dynamic shared bytes; D comes as N^2 host floats and rides in the kernel
// parameters.  The walk is instantiated only at the degrees that run it
// (FUSTPU_LEAN_SINGLE, FUSTPU_LEAN_PAIR: those outside
// ops/cuda_stiffness.py FIRST_DESIGN_BF16); at the others the entry points
// return -1.

#include <cuda_runtime.h>

#include "pencil_lean.cuh"

// The degrees at which a box apply runs the lean walk, single field and
// pair (ops/cuda_stiffness.py `lean_runs`).
#define FUSTPU_LEAN_SINGLE(M) M(2) M(3) M(4) M(5) M(6) M(8)
#define FUSTPU_LEAN_PAIR(M) M(2) M(3) M(4) M(5)

namespace {

namespace lean = fustpu::pencil::lean;
using fustpu::pencil::BoxRows;

template <bool PAIR>
int launch(int P, const void* x1, const void* x2, const void* C,
           const void* G, const float* D, void* y, const void* chunks,
           const long long* classes, int nclass, int blocks, int cpb,
           int stages, int stage_bytes, int smem, int ncy, int ncz,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gz = ncz * P + 1;
  const BoxRows lines{gz, (ncy * P + 1) * gz, nullptr};
#define FUSTPU_CASE(P_)                                                   \
  case P_:                                                                \
    return lean::launch<P_ + 1, PAIR>(x1, x2, C, G, D, y, chunks, classes, \
                                      nclass, blocks, cpb, stages,        \
                                      stage_bytes, smem, lines, s);
  if constexpr (PAIR) {
    switch (P) {
      FUSTPU_LEAN_PAIR(FUSTPU_CASE)
      default:
        return -1;
    }
  } else {
    switch (P) {
      FUSTPU_LEAN_SINGLE(FUSTPU_CASE)
      default:
        return -1;
    }
  }
#undef FUSTPU_CASE
}

template <bool PAIR>
int occupancy(int P, int cpb, int smem) {
#define FUSTPU_CASE(P_) \
  case P_:              \
    return lean::occupancy<P_ + 1, PAIR, BoxRows>(cpb, smem);
  if constexpr (PAIR) {
    switch (P) {
      FUSTPU_LEAN_PAIR(FUSTPU_CASE)
      default:
        return -1;
    }
  } else {
    switch (P) {
      FUSTPU_LEAN_SINGLE(FUSTPU_CASE)
      default:
        return -1;
    }
  }
#undef FUSTPU_CASE
}

}  // namespace

// C entry points.  Each launcher returns 0, -1 for a degree without the
// lean walk, or the cudaError_t of the first failed call; y must be zeroed
// by the caller.  D: N^2 floats on the host; chunks: (rows, 5) int64 on
// the device; classes: nclass x 3 int64 on the host.
extern "C" {

int fustpu_stiffness_lean_bf16(const void* x, const void* G, const float* D,
                               void* y, int P, const void* chunks,
                               const long long* classes, int nclass,
                               int blocks, int cpb, int stages,
                               int stage_bytes, int smem, int ncy, int ncz,
                               void* stream) {
  return launch<false>(P, x, nullptr, nullptr, G, D, y, chunks, classes,
                       nclass, blocks, cpb, stages, stage_bytes, smem, ncy,
                       ncz, stream);
}

int fustpu_stiffness_pair_lean_bf16(const void* x1, const void* x2,
                                    const void* C, const void* G,
                                    const float* D, void* y, int P,
                                    const void* chunks,
                                    const long long* classes, int nclass,
                                    int blocks, int cpb, int stages,
                                    int stage_bytes, int smem, int ncy,
                                    int ncz, void* stream) {
  return launch<true>(P, x1, x2, C, G, D, y, chunks, classes, nclass,
                      blocks, cpb, stages, stage_bytes, smem, ncy, ncz,
                      stream);
}

// Blocks of the lean walk on box pencils for (P, pair?) with cpb cells and
// smem dynamic shared bytes that one SM holds at once; -1 for a degree
// without the lean walk, minus the cudaError_t of a failed query.
int fustpu_stiffness_lean_occupancy(int P, int pair, int cpb, int smem) {
  return pair ? occupancy<true>(P, cpb, smem) : occupancy<false>(P, cpb, smem);
}

}  // extern "C"
