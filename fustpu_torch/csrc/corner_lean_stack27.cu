// Entry points of the extruded corner apply for curved triquadratic
// (hex27) prisms (#6c, the capacity mode) on a bfloat16 operator on the
// main path: the lean corner walk of corner_lean.cuh on the stacks, each
// cell's metric rebuilt from its 163 channels, single field and pair:
// fustpu_extruded_corner_hex27_stack_lean_bf16, its _pair_ form and
// fustpu_extruded_corner_hex27_stack_lean_occupancy.  corner_stack27.cu
// keeps the first bfloat16 corner walk as the comparison.  What bounds it
// and what the design does about it: corner_lean.cuh.  Instantiated only
// at the degrees of Hex27Single and Hex27Pair (ops/cuda_corner.py
// LEAN_CORNER_BF16, geometry "hex27").

#include <cuda_runtime.h>

#include "corner_lean.cuh"

using Hex27Single = fustpu::pencil::lean_corner::Degrees<4, 6, 7>;
using Hex27Pair = fustpu::pencil::lean_corner::Degrees<5, 7, 8>;

FUSTPU_LEAN_CORNER_STACK(extruded_corner_hex27_stack, 2, Hex27Single,
                         Hex27Pair)
