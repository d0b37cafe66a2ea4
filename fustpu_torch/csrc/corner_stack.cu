// Entry points of the extruded corner apply for trilinear (hex8) cells
// (#6c, the capacity mode) on the stack walk of the z-pencil kernel: the
// stacks of an extruded mesh walked as box pencils are, each cell's metric
// rebuilt from its 37 channels (corner_stream's layout, stack order
// s * nz + kz), single field and pair:
// fustpu_extruded_corner_stack_{f32,f64,bf16}, its _pair_ forms and
// fustpu_extruded_corner_stack_occupancy.  The design and what bounds it:
// corner_walk.cuh; the schedule: ops/cuda_extruded.py `stack_schedule`
// with the corner's channels.  The class-launch design it replaced keeps
// its entry points in extruded_corner.cu.

#include "corner_walk.cuh"

FUSTPU_CORNER_STACK(extruded_corner_stack, 1)
