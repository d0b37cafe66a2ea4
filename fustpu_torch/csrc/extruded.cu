// Entry points of the extruded stiffness kernel for the G stream; the
// kernel, what bounds it and its design are in extruded.cuh.

#include "extruded.cuh"

// C entry points.  Each returns 0, -1 for an unsupported degree, or the
// cudaError_t of the first failed launch.  y must be zeroed by the caller.
// rows: (nstacks, N^2) int32; cells: stack-order cell ids (s * nz + kz),
// int32, grouped by scatter class; bounds: nclass + 1 host offsets into
// cells.
extern "C" {

int fustpu_extruded_f32(const void* x, const void* G, const void* D,
                        const void* rows, const void* cells,
                        const long long* bounds, int nclass, void* y, int P,
                        int nz, int gz, void* stream) {
  return launch<float, false, 0>(P, x, nullptr, nullptr, G, D, nullptr, rows,
                                 cells, bounds, nclass, y, nz, gz, stream);
}

int fustpu_extruded_f64(const void* x, const void* G, const void* D,
                        const void* rows, const void* cells,
                        const long long* bounds, int nclass, void* y, int P,
                        int nz, int gz, void* stream) {
  return launch<double, false, 0>(P, x, nullptr, nullptr, G, D, nullptr,
                                  rows, cells, bounds, nclass, y, nz, gz,
                                  stream);
}

int fustpu_extruded_pair_f32(const void* x1, const void* x2, const void* C,
                             const void* G, const void* D, const void* rows,
                             const void* cells, const long long* bounds,
                             int nclass, void* y, int P, int nz, int gz,
                             void* stream) {
  return launch<float, true, 0>(P, x1, x2, C, G, D, nullptr, rows, cells,
                                bounds, nclass, y, nz, gz, stream);
}

int fustpu_extruded_pair_f64(const void* x1, const void* x2, const void* C,
                             const void* G, const void* D, const void* rows,
                             const void* cells, const long long* bounds,
                             int nclass, void* y, int P, int nz, int gz,
                             void* stream) {
  return launch<double, true, 0>(P, x1, x2, C, G, D, nullptr, rows, cells,
                                 bounds, nclass, y, nz, gz, stream);
}

}  // extern "C"
