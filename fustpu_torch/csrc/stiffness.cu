// Entry points of the structured stiffness kernel for the G stream; the
// kernel, what bounds it and its design are in stiffness.cuh.

#include "stiffness.cuh"

// C entry points.  Each returns 0, -1 for an unsupported degree, or the
// cudaError_t of the first failed launch.  y must be zeroed by the caller.
extern "C" {

int fustpu_stiffness_f32(const void* x, const void* G, const void* D, void* y,
                         int P, int ncx, int ncy, int ncz, void* stream) {
  return launch<float, false, false>(P, x, nullptr, nullptr, G, D, nullptr,
                                     y, ncx, ncy, ncz, stream);
}

int fustpu_stiffness_f64(const void* x, const void* G, const void* D, void* y,
                         int P, int ncx, int ncy, int ncz, void* stream) {
  return launch<double, false, false>(P, x, nullptr, nullptr, G, D, nullptr,
                                      y, ncx, ncy, ncz, stream);
}

int fustpu_stiffness_pair_f32(const void* x1, const void* x2, const void* C,
                              const void* G, const void* D, void* y, int P,
                              int ncx, int ncy, int ncz, void* stream) {
  return launch<float, true, false>(P, x1, x2, C, G, D, nullptr, y, ncx, ncy,
                                    ncz, stream);
}

int fustpu_stiffness_pair_f64(const void* x1, const void* x2, const void* C,
                              const void* G, const void* D, void* y, int P,
                              int ncx, int ncy, int ncz, void* stream) {
  return launch<double, true, false>(P, x1, x2, C, G, D, nullptr, y, ncx,
                                     ncy, ncz, stream);
}

}  // extern "C"
