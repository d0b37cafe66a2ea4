// Structured-box stiffness apply in the corner-streamed capacity mode: the
// kernel of stiffness.cuh with CORNER set, so that each cell's metric c G is
// evaluated in registers from its 37 channels (jacobian_coefficients: the
// trilinear Jacobian's 36 monomial coefficients and the material
// coefficient; corner.cuh) instead of read from a (cells, 6, N^3) stream.
//
// Replaces the Pallas TPU kernel fustpu/ops/pallas_stiffness.py:
// _mk_kernel_corner (:963), called by _apply_corner (:1081) through
// stiffness_apply_pallas -> stiffness_kernel<.., PAIR false, CORNER true>.
// The JAX package has no corner pair kernel (its heterogeneous Westervelt
// model runs two folded corner operators); here PAIR true applies
// A_c1(x1) + A_c2(x2) in one pass with the coefficient channel set to 1,
// the same operator in one launch set.  The TPU kernel expands the
// channels into 16 per-slab geometry planes and evaluates adj(J) / det(J)
// plane by plane on the VPU; none of that layout carries over.
//
// What bounds it on an H100: arithmetic, not bytes.  At the flagship
// (102,400 cells, 6,661,697 dofs, P = 4, float32) an apply must move x
// 26.6 MB, y read and written 53.3 MB and the channels 15.2 MB, ~95 MB
// against the G stream's 387 MB, but per node it rebuilds J, adj(J), det
// and the factored metric (~60 flops and one division on top of the
// ~12 N + 16 of the sum factorisation).
//
// What the design does about it:
//   - a cell's 37 channels are read once into shared memory, and each
//     thread folds its line's (y, z) into 15 coefficients plus the scaled
//     weight once per cell, so a node costs 6 FMAs of J before the adjugate
//     (corner.cuh);
//   - everything else is the G-stream kernel's: the sum-factorised body,
//     the 8 parity-class launches and their deterministic scatter,
//     accumulators of the template type.

#include "stiffness.cuh"

// C entry points.  Each returns 0, -1 for an unsupported degree, or the
// cudaError_t of the first failed launch.  y must be zeroed by the caller.
// T: (cells, 37) channels in cell order cx*ncy*ncz + cy*ncz + cz; Q: (2, N)
// unit GLL nodes, then weights.
extern "C" {

int fustpu_corner_f32(const void* x, const void* T, const void* D,
                      const void* Q, void* y, int P, int ncx, int ncy,
                      int ncz, void* stream) {
  return launch<float, false, true>(P, x, nullptr, nullptr, T, D, Q, y, ncx,
                                    ncy, ncz, stream);
}

int fustpu_corner_f64(const void* x, const void* T, const void* D,
                      const void* Q, void* y, int P, int ncx, int ncy,
                      int ncz, void* stream) {
  return launch<double, false, true>(P, x, nullptr, nullptr, T, D, Q, y, ncx,
                                     ncy, ncz, stream);
}

int fustpu_corner_pair_f32(const void* x1, const void* x2, const void* C,
                           const void* T, const void* D, const void* Q,
                           void* y, int P, int ncx, int ncy, int ncz,
                           void* stream) {
  return launch<float, true, true>(P, x1, x2, C, T, D, Q, y, ncx, ncy, ncz,
                                   stream);
}

int fustpu_corner_pair_f64(const void* x1, const void* x2, const void* C,
                           const void* T, const void* D, const void* Q,
                           void* y, int P, int ncx, int ncy, int ncz,
                           void* stream) {
  return launch<double, true, true>(P, x1, x2, C, T, D, Q, y, ncx, ncy, ncz,
                                    stream);
}

}  // extern "C"
