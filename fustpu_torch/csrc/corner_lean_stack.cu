// Entry points of the extruded corner apply for trilinear (hex8) cells
// (#6c, the capacity mode) on a bfloat16 operator on the main path: the
// lean corner walk of corner_lean.cuh on the stacks of an extruded mesh
// (StackRows), single field and pair:
// fustpu_extruded_corner_stack_lean_bf16, its _pair_ form and
// fustpu_extruded_corner_stack_lean_occupancy.  corner_stack.cu keeps the
// first bfloat16 corner walk as the comparison.  What bounds it and what
// the design does about it: corner_lean.cuh; the schedule: the first
// design's (ops/cuda_extruded.py `stack_schedule` with the corner's
// channels, its cells a chunk and segments), its blocks an SM from this
// walk's occupancy query.  Instantiated only at the degrees of Hex8Single
// and Hex8Pair (ops/cuda_corner.py LEAN_CORNER_BF16, geometry "hex8").

#include <cuda_runtime.h>

#include "corner_lean.cuh"

// none for the single field: the first design ran as fast at every degree
using Hex8Single = fustpu::pencil::lean_corner::Degrees<>;
using Hex8Pair = fustpu::pencil::lean_corner::Degrees<4, 7>;

FUSTPU_LEAN_CORNER_STACK(extruded_corner_stack, 1, Hex8Single, Hex8Pair)
