// Entry points of the extruded stiffness apply on the main path: the
// z-pencil kernel of stiffness_pencil.cuh walking the stacks of an
// extruded mesh, single field and pair.
//
// Replaces the Pallas TPU kernel fustpu/ops/pallas_extruded.py:_mk_kernel
// (:604), via stiffness_apply_extruded_pallas (:841, one field, any
// per-cell coefficient folded into G) and stiffness_apply_extruded_pallas_pair
// (:860, y = A_c1(x1) + A_c2(x2) with a unit G and per-cell (c1, c2)).
// The class-launch design of the same kernels (extruded.cuh: scattered
// cells in one launch per (stack colour, layer parity), G read by the
// threads themselves) keeps its entry points in extruded.cu.  The stack
// kernel comes in float32, float64 and bfloat16 (stored in bfloat16,
// computed in float: stiffness_pencil.cuh); the class-launch design in
// float32 and float64.
//
// An extruded cell s * nz + kz is a z-pencil cell whose N^2 z-lines are not
// on a grid: node (i, j, k) holds dof rows2d[s, i N + j] gz + kz P + k, so
// each of a stack's N^2 rows is a contiguous z-line, and a stack's G (in
// stack order) is one contiguous run.  The pencil kernel walks a stack as
// it walks a box pencil, with the lines' bases taken from the stack's row
// ids (StackRows) instead of the box's strides; everything else is the
// pencil kernel's: the persistent grid, chunks of consecutive layers added
// in two turns, the bulk-copied G ring, the next chunk's inputs through
// registers, the top face carried to the next chunk, the pair fold.
//
// What bounds it on an H100: its bytes, as for the box.  At the imported
// H131 bowl (1,600 stacks of 64 layers, 6,661,697 dofs, P = 4, float32) an
// apply must move at least G 307,200,000 B, x 26,646,788 B, y read and
// written 53,293,576 B and rows2d 160,000 B: 387,300,364 B, 0.1156 ms at
// 3.35 TB/s.
//
// The host (ops/cuda_extruded.py `stack_schedule`) decides the launch: the
// classes are stack colours (no two stacks of a colour share a footprint
// row), and, where a colour's stacks are too few to fill the card, stacks
// cut into z-segments whose parity joins the colour in the class
// (segments of one stack share a face); the chunk table, the segments' row
// ids, the persistent grid, cells a chunk, stages and shared bytes.

#include <cuda_runtime.h>

#include "stiffness_pencil.cuh"

namespace {

using fustpu::pencil::StackRows;
using fustpu::pencil::GRing;

template <typename T, typename S, bool PAIR>
int launch(int P, const void* x1, const void* x2, const void* C,
           const void* G, const void* D, void* y, const void* chunks,
           const void* ids, const long long* classes, int nclass, int blocks,
           int cpb, int stages, int stage_bytes, int smem, int nz,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StackRows lines{nz * P + 1, 0, static_cast<const int*>(ids)};
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
#define FUSTPU_CASE(P_) \
  case P_:              \
    return fustpu::pencil::occupancy<T, P_ + 1, PAIR,                   \
                                     GRing<T, P_ + 1, S>, StackRows>(   \
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
// caller.  chunks: (rows, 5) int64 and ids: (segments, N^2) int32 on the
// device; classes: nclass x 3 int64 on the host.
extern "C" {

#define FUSTPU_STACK(SUF, T, S)                                              \
  int fustpu_extruded_stack_##SUF(                                           \
      const void* x, const void* G, const void* D, void* y, int P,           \
      const void* chunks, const void* ids, const long long* classes,         \
      int nclass, int blocks, int cpb, int stages, int stage_bytes,          \
      int smem, int nz, void* stream) {                                      \
    return launch<T, S, false>(P, x, nullptr, nullptr, G, D, y, chunks, ids, \
                               classes, nclass, blocks, cpb, stages,         \
                               stage_bytes, smem, nz, stream);               \
  }                                                                          \
  int fustpu_extruded_stack_pair_##SUF(                                      \
      const void* x1, const void* x2, const void* C, const void* G,          \
      const void* D, void* y, int P, const void* chunks, const void* ids,    \
      const long long* classes, int nclass, int blocks, int cpb, int stages, \
      int stage_bytes, int smem, int nz, void* stream) {                     \
    return launch<T, S, true>(P, x1, x2, C, G, D, y, chunks, ids, classes,   \
                              nclass, blocks, cpb, stages, stage_bytes,      \
                              smem, nz, stream);                             \
  }

FUSTPU_STACK(f32, float, float)
FUSTPU_STACK(f64, double, double)
FUSTPU_STACK(bf16, float, __nv_bfloat16)
#undef FUSTPU_STACK

// Blocks of the kernel for (P, type, pair?) with cpb cells and smem dynamic
// shared bytes that one SM holds at once; type 0 float32, 1 float64, 2
// bfloat16; -1 for an unsupported degree, minus the cudaError_t of a
// failed query.
int fustpu_extruded_stack_occupancy(int P, int type, int pair, int cpb,
                                    int smem) {
  if (type == 1)
    return pair ? occupancy<double, double, true>(P, cpb, smem)
                : occupancy<double, double, false>(P, cpb, smem);
  if (type == 2)
    return pair ? occupancy<float, __nv_bfloat16, true>(P, cpb, smem)
                : occupancy<float, __nv_bfloat16, false>(P, cpb, smem);
  return pair ? occupancy<float, float, true>(P, cpb, smem)
              : occupancy<float, float, false>(P, cpb, smem);
}

}  // extern "C"
