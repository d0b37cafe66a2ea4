// Entry points of the extruded stiffness apply on a bfloat16 operator on
// the main path: the lean walk of pencil_lean.cuh on the stacks of an
// extruded mesh (StackRows), single field and pair.  extruded_stack.cu
// keeps the first bfloat16 walk (`fustpu_extruded_stack_bf16`,
// `fustpu_extruded_stack_pair_bf16`) as the comparison, and the float32
// and float64 walks.
//
// Replaces, in bfloat16, fustpu/ops/pallas_extruded.py:_mk_kernel (:604),
// via stiffness_apply_extruded_pallas (:841, one field) and
// stiffness_apply_extruded_pallas_pair (:860, y = A_c1(x1) + A_c2(x2)).
// What bounds it and what the design does about it: pencil_lean.cuh; the
// stacks' walk (classes of stack colours and segment parities, the row
// ids): extruded_stack.cu.  The host (ops/cuda_extruded.py
// `stack_schedule`, design "lean", at the first design's segments) decides
// the launch; D comes as N^2 host floats.  The walk is instantiated only at
// the degree that runs it on stacks (ops/cuda_extruded.py
// LEAN_STACK_DEGREES, P = 4, where the two designs were timed in turns on
// the imported bowl); at the others the entry points return -1.

#include <cuda_runtime.h>

#include "pencil_lean.cuh"

// The degrees at which a stack apply runs the lean walk, single and pair.
#define FUSTPU_LEAN_STACKS(M) M(4)

namespace {

namespace lean = fustpu::pencil::lean;
using fustpu::pencil::StackRows;

template <bool PAIR>
int launch(int P, const void* x1, const void* x2, const void* C,
           const void* G, const float* D, void* y, const void* chunks,
           const void* ids, const long long* classes, int nclass, int blocks,
           int cpb, int stages, int stage_bytes, int smem, int nz,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StackRows lines{nz * P + 1, 0, static_cast<const int*>(ids)};
#define FUSTPU_CASE(P_)                                                   \
  case P_:                                                                \
    return lean::launch<P_ + 1, PAIR>(x1, x2, C, G, D, y, chunks, classes, \
                                      nclass, blocks, cpb, stages,        \
                                      stage_bytes, smem, lines, s);
  switch (P) {
    FUSTPU_LEAN_STACKS(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

template <bool PAIR>
int occupancy(int P, int cpb, int smem) {
#define FUSTPU_CASE(P_) \
  case P_:              \
    return lean::occupancy<P_ + 1, PAIR, StackRows>(cpb, smem);
  switch (P) {
    FUSTPU_LEAN_STACKS(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

}  // namespace

// C entry points.  Each launcher returns 0, -1 for a degree without the
// lean walk, or the cudaError_t of the first failed call; y must be zeroed
// by the caller.  D: N^2 floats on the host; chunks: (rows, 5) int64 and
// ids: (segments, N^2) int32 on the device; classes: nclass x 3 int64 on
// the host.
extern "C" {

int fustpu_extruded_stack_lean_bf16(const void* x, const void* G,
                                    const float* D, void* y, int P,
                                    const void* chunks, const void* ids,
                                    const long long* classes, int nclass,
                                    int blocks, int cpb, int stages,
                                    int stage_bytes, int smem, int nz,
                                    void* stream) {
  return launch<false>(P, x, nullptr, nullptr, G, D, y, chunks, ids, classes,
                       nclass, blocks, cpb, stages, stage_bytes, smem, nz,
                       stream);
}

int fustpu_extruded_stack_pair_lean_bf16(
    const void* x1, const void* x2, const void* C, const void* G,
    const float* D, void* y, int P, const void* chunks, const void* ids,
    const long long* classes, int nclass, int blocks, int cpb, int stages,
    int stage_bytes, int smem, int nz, void* stream) {
  return launch<true>(P, x1, x2, C, G, D, y, chunks, ids, classes, nclass,
                      blocks, cpb, stages, stage_bytes, smem, nz, stream);
}

// Blocks of the lean walk on stacks for (P, pair?) with cpb cells and smem
// dynamic shared bytes that one SM holds at once; -1 for a degree without
// the lean walk, minus the cudaError_t of a failed query.
int fustpu_extruded_stack_lean_occupancy(int P, int pair, int cpb,
                                         int smem) {
  return pair ? occupancy<true>(P, cpb, smem) : occupancy<false>(P, cpb, smem);
}

}  // extern "C"
