// Extruded stiffness apply in the corner-streamed capacity mode for
// trilinear (hex8) cells: the kernel of extruded.cuh with GD = 1, so that
// each cell's metric c G is evaluated in registers from its 37 channels
// (corner_stream: the Jacobian's 36 monomial coefficients and the material
// coefficient; corner.cuh) instead of read from a (cells, 6, N^3) stream.
//
// Replaces the Pallas TPU kernel fustpu/ops/pallas_extruded.py:_mk_kernel
// (:604) with `corner` set (built by build_extruded_corner, :556), via
// stiffness_apply_extruded_pallas (:841, one field, any per-cell
// coefficient folded into the last channel) -> PAIR false, and
// stiffness_apply_extruded_pallas_pair (:860, y = A_c1(x1) + A_c2(x2),
// coefficient channel 1, per-cell (c1, c2)) -> PAIR true.  The TPU kernel
// expands the channels into (S, ez) planes per stack batch, pads the stack
// batch with identity geometry and evaluates J from a static table on the
// VPU; here the table is corner_channel and nothing is padded.
//
// What bounds it on an H100: arithmetic rather than bytes.  Per cell it
// reads 37 channels (148 B in float32, against 3000 B of G at P = 4)
// but rebuilds J, adj(J), det and the factored metric at every node.  At
// the imported H131 bowl (102,400 cells, 6,661,697 dofs, P = 4) an apply
// must move x 26.6 MB, y read and written 53.3 MB, the channels 15.2 MB
// and the row ids 0.16 MB.
//
// What the design does about it: a cell's channels are read once into
// shared memory and each thread folds its line's (y, z) into the
// coefficients of J as polynomials in x once per cell (corner.cuh); the
// rest (row ids in shared memory, 64-bit index arithmetic, the
// (colour, layer parity) scatter classes and their deterministic scatter)
// is the G-stream kernel's.

#include "extruded.cuh"

// C entry points.  Each returns 0, -1 for an unsupported degree, or the
// cudaError_t of the first failed launch.  y must be zeroed by the caller.
// T: (cells, 37) channels in stack order s * nz + kz; Q: (2, N) unit GLL
// nodes, then weights; rows, cells, bounds as for the G stream.
extern "C" {

int fustpu_extruded_corner_f32(const void* x, const void* T, const void* D,
                               const void* Q, const void* rows,
                               const void* cells, const long long* bounds,
                               int nclass, void* y, int P, int nz, int gz,
                               void* stream) {
  return launch<float, false, 1>(P, x, nullptr, nullptr, T, D, Q, rows, cells,
                                 bounds, nclass, y, nz, gz, stream);
}

int fustpu_extruded_corner_f64(const void* x, const void* T, const void* D,
                               const void* Q, const void* rows,
                               const void* cells, const long long* bounds,
                               int nclass, void* y, int P, int nz, int gz,
                               void* stream) {
  return launch<double, false, 1>(P, x, nullptr, nullptr, T, D, Q, rows, cells,
                                  bounds, nclass, y, nz, gz, stream);
}

int fustpu_extruded_corner_pair_f32(const void* x1, const void* x2,
                                    const void* C, const void* T,
                                    const void* D, const void* Q,
                                    const void* rows, const void* cells,
                                    const long long* bounds, int nclass,
                                    void* y, int P, int nz, int gz,
                                    void* stream) {
  return launch<float, true, 1>(P, x1, x2, C, T, D, Q, rows, cells, bounds,
                                nclass, y, nz, gz, stream);
}

int fustpu_extruded_corner_pair_f64(const void* x1, const void* x2,
                                    const void* C, const void* T,
                                    const void* D, const void* Q,
                                    const void* rows, const void* cells,
                                    const long long* bounds, int nclass,
                                    void* y, int P, int nz, int gz,
                                    void* stream) {
  return launch<double, true, 1>(P, x1, x2, C, T, D, Q, rows, cells, bounds,
                                 nclass, y, nz, gz, stream);
}

}  // extern "C"
