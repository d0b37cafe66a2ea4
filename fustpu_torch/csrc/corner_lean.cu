// Entry points of the structured corner apply (#3, the capacity mode) on a
// bfloat16 operator on the main path: the lean corner walk of
// corner_lean.cuh on box pencils, single field and pair.  corner_pencil.cu
// keeps the first bfloat16 corner walk (`fustpu_corner_pencil_bf16`,
// `fustpu_corner_pencil_pair_bf16`) as the comparison, and the float32 and
// float64 walks.
//
// Replaces, in bfloat16, fustpu/ops/pallas_stiffness.py _mk_kernel_corner
// (:963, via _apply_corner :1081; the pair form as two folded corner
// operators).  What bounds it and what the design does about it:
// corner_lean.cuh.  The host (ops/cuda_corner.py, the first design's
// `pencil_schedule` with the corner's channels, its blocks an SM from this
// walk's occupancy query and `lean_smem`) decides the launch; D and the
// GLL nodes and weights come as host floats and ride in the kernel
// parameters.  The walk is instantiated only at the degrees that run it
// (BoxSingle, BoxPair: ops/cuda_corner.py LEAN_CORNER_BF16 with geometry
// "box"); at the others the entry points return -1.

#include <cuda_runtime.h>

#include "corner_lean.cuh"

namespace {

namespace lc = fustpu::pencil::lean_corner;
using fustpu::pencil::BoxRows;

// The degrees at which a box apply runs the lean corner walk, single field
// and pair.
using BoxSingle = lc::Degrees<7>;
using BoxPair = lc::Degrees<3, 4, 6, 7, 8>;

template <bool PR>
int launch(int P, const void* x1, const void* x2, const void* C,
           const void* Tch, const float* D, const float* Q, void* y,
           const void* chunks, const long long* classes, int nclass,
           int blocks, int cpb, int stages, int stage_bytes, int smem,
           int ncy, int ncz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gz = ncz * P + 1;
  const BoxRows lines{gz, (ncy * P + 1) * gz, nullptr};
  return lc::dispatch(
      std::conditional_t<PR, BoxPair, BoxSingle>{}, P, [&](auto p) {
        return lc::launch<decltype(p)::value + 1, 1, true, PR>(
            x1, x2, C, Tch, D, Q, y, chunks, classes, nclass, blocks, cpb,
            stages, stage_bytes, smem, lines, s);
      });
}

template <bool PR>
int occupancy(int P, int cpb, int smem) {
  return lc::dispatch(
      std::conditional_t<PR, BoxPair, BoxSingle>{}, P, [&](auto p) {
        return lc::occupancy<decltype(p)::value + 1, 1, true, PR, BoxRows>(
            cpb, smem);
      });
}

}  // namespace

// C entry points.  Each launcher returns 0, -1 for a degree without the
// lean corner walk, or the cudaError_t of the first failed call; y must be
// zeroed by the caller.  D: N^2 and Q: 2 N floats on the host; chunks:
// (rows, 5) int64 on the device; classes: nclass x 3 int64 on the host.
extern "C" {

int fustpu_corner_pencil_lean_bf16(const void* x, const void* Tch,
                                   const float* D, const float* Q, void* y,
                                   int P, const void* chunks,
                                   const long long* classes, int nclass,
                                   int blocks, int cpb, int stages,
                                   int stage_bytes, int smem, int ncy,
                                   int ncz, void* stream) {
  return launch<false>(P, x, nullptr, nullptr, Tch, D, Q, y, chunks,
                       classes, nclass, blocks, cpb, stages, stage_bytes,
                       smem, ncy, ncz, stream);
}

int fustpu_corner_pencil_pair_lean_bf16(
    const void* x1, const void* x2, const void* C, const void* Tch,
    const float* D, const float* Q, void* y, int P, const void* chunks,
    const long long* classes, int nclass, int blocks, int cpb, int stages,
    int stage_bytes, int smem, int ncy, int ncz, void* stream) {
  return launch<true>(P, x1, x2, C, Tch, D, Q, y, chunks, classes, nclass,
                      blocks, cpb, stages, stage_bytes, smem, ncy, ncz,
                      stream);
}

// Blocks of the lean corner walk on box pencils for (P, pair?) with cpb
// cells and smem dynamic shared bytes that one SM holds at once; -1 for a
// degree without the walk, minus the cudaError_t of a failed query.
int fustpu_corner_pencil_lean_occupancy(int P, int pair, int cpb, int smem) {
  return pair ? occupancy<true>(P, cpb, smem) : occupancy<false>(P, cpb, smem);
}

}  // extern "C"
