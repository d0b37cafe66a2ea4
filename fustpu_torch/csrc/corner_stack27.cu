// Entry points of the extruded corner apply for curved triquadratic
// (hex27) prisms (#6c, the capacity mode) on the stack walk of the
// z-pencil kernel, each cell's metric rebuilt from its 163 channels
// (corner_stream's layout, stack order s * nz + kz), single field and
// pair: fustpu_extruded_corner_hex27_stack_{f32,f64,bf16}, its _pair_
// forms and fustpu_extruded_corner_hex27_stack_occupancy.  The design and
// what bounds it: corner_walk.cuh.  The class-launch design it replaced keeps
// its entry points in extruded_corner27.cu.

#include "corner_walk.cuh"

FUSTPU_CORNER_STACK(extruded_corner_hex27_stack, 2)
