// Entry points of the structured corner apply (#3, the capacity mode) on
// the walk of the z-pencil kernel: box pencils of cells whose metric is
// rebuilt from 37 channels a cell (jacobian_coefficients' layout, box
// order cx*ncy*ncz + cy*ncz + cz), single field and pair, in float32,
// float64 and bfloat16 (stored in bfloat16, computed in float).  The
// design and what bounds it: corner_walk.cuh.  The class-launch design it replaced
// keeps its entry points in corner.cu.
//
// The host (ops/cuda_corner.py, through cuda_stiffness.py
// `pencil_schedule` with the corner's channels) decides the launch as for
// the G stream: the chunk table with each chunk's 16 B-aligned span of
// channels, the four colour classes, the persistent grid, the cells a
// chunk, the stages and the shared bytes.

#include <cuda_runtime.h>

#include "corner_walk.cuh"

namespace {

fustpu::pencil::BoxRows box_rows(int P, int ncy, int ncz) {
  const int gz = ncz * P + 1;
  return {gz, (ncy * P + 1) * gz, nullptr};
}

}  // namespace

// C entry points.  Each launcher returns 0, -1 for an unsupported degree,
// or the cudaError_t of the first failed call; y must be zeroed by the
// caller.  chunks: (rows, 5) int64 on the device; classes: nclass x 3
// int64 on the host.
extern "C" {

#define FUSTPU_CORNER_PENCIL(SUF, T, S)                                       \
  int fustpu_corner_pencil_##SUF(                                             \
      const void* x, const void* Tch, const void* D, const void* Q, void* y,  \
      int P, const void* chunks, const long long* classes, int nclass,        \
      int blocks, int cpb, int stages, int stage_bytes, int smem, int ncy,    \
      int ncz, void* stream) {                                                \
    return fustpu::corner_walk::launch<T, S, false, 1, true>(                 \
        P, x, nullptr, nullptr, Tch, D, Q, y, chunks, classes, nclass,        \
        blocks, cpb, stages, stage_bytes, smem, box_rows(P, ncy, ncz),        \
        stream);                                                              \
  }                                                                           \
  int fustpu_corner_pencil_pair_##SUF(                                        \
      const void* x1, const void* x2, const void* C, const void* Tch,         \
      const void* D, const void* Q, void* y, int P, const void* chunks,       \
      const long long* classes, int nclass, int blocks, int cpb, int stages,  \
      int stage_bytes, int smem, int ncy, int ncz, void* stream) {            \
    return fustpu::corner_walk::launch<T, S, true, 1, true>(                  \
        P, x1, x2, C, Tch, D, Q, y, chunks, classes, nclass, blocks, cpb,     \
        stages, stage_bytes, smem, box_rows(P, ncy, ncz), stream);            \
  }

FUSTPU_CORNER_PENCIL(f32, float, float)
FUSTPU_CORNER_PENCIL(f64, double, double)
FUSTPU_CORNER_PENCIL(bf16, float, __nv_bfloat16)
#undef FUSTPU_CORNER_PENCIL

// type 0 float32, 1 float64, 2 bfloat16
int fustpu_corner_pencil_occupancy(int P, int type, int pair, int cpb,
                                   int smem) {
  return fustpu::corner_walk::occupancy<1, true, fustpu::pencil::BoxRows>(
      P, type, pair, cpb, smem);
}

}  // extern "C"
