// Anatomy of the structured stiffness kernel #1 on the z-pencil walk that
// the main path runs: variants of it that keep one part of
// its work, to be timed against it on the same schedule.
//
// Replaces the Pallas TPU kernel of demos/exp_kernel_anatomy.py
// (make_variant, :34, pallas_call :165), whose variants keep one TPU
// unit's work: `vpu` (no matmuls), `mxu` (matmuls only) and `ywin` (the
// y windows as reshapes).  full is #1 itself (its entry passes to
// stiffness.cu's, the same kernel on the same schedule, so that this file
// does not build #1 and #2 again); gstream, contract and ywin are policies
// of its walk, anatomy_walk.cuh, which says what each keeps and what
// bounds it.  They run on #1's schedule (ops/anatomy.py
// `variant_schedule`: #1's chunk table; contract, which reserves no ring
// stage, chooses its own cells a chunk).  The first CUDA design's
// variants, on the parity-class kernel, are anatomy_classes.cu's.

#include <cuda_runtime.h>

#include "anatomy_walk.cuh"
#include "stiffness.cuh"

// #1 and #2 themselves (stiffness.cu): the walk's `full` and `full_pair`.
extern "C" {
int fustpu_stiffness_f32(const void*, const void*, const void*, void*, int,
                         const void*, const long long*, int, int, int, int,
                         int, int, int, int, void*);
int fustpu_stiffness_f64(const void*, const void*, const void*, void*, int,
                         const void*, const long long*, int, int, int, int,
                         int, int, int, int, void*);
int fustpu_stiffness_pair_f32(const void*, const void*, const void*,
                              const void*, const void*, void*, int,
                              const void*, const long long*, int, int, int,
                              int, int, int, int, int, void*);
int fustpu_stiffness_pair_f64(const void*, const void*, const void*,
                              const void*, const void*, void*, int,
                              const void*, const long long*, int, int, int,
                              int, int, int, int, int, void*);
int fustpu_stiffness_occupancy(int, int, int, int, int);
}

namespace {

// ---- the z-pencil walk ----

using fustpu::anatomy::GStreamGeo;
using fustpu::anatomy::UnitGeo;
using fustpu::anatomy::XRows;
using fustpu::pencil::BoxRows;
using fustpu::pencil::GRing;

template <int V>
struct Walk;  // the variant's (Rows, Geo) at degree N, type T
template <>
struct Walk<CONTRACT> {
  template <typename T, int N>
  using Geo = UnitGeo<T, N>;
  using Rows = BoxRows;
};
template <>
struct Walk<GSTREAM> {
  template <typename T, int N>
  using Geo = GStreamGeo<T, N>;
  using Rows = BoxRows;
};
template <>
struct Walk<YWIN> {
  template <typename T, int N>
  using Geo = GRing<T, N>;
  using Rows = XRows;
};

template <typename Rows>
Rows rows_of(int P, int ncx, int ncy, int ncz, long long itemsize) {
  const int gz = ncz * P + 1, sx = (ncy * P + 1) * gz;
  if constexpr (Rows::XBULK)
    return {gz, sx, nullptr, ((long long)ncx * P + 1) * sx * itemsize};
  else
    return {gz, sx, nullptr};
}

template <typename T, int V>
int launch_walk(int P, const void* x, const void* G, const void* D, void* y,
                const void* chunks, const long long* classes, int nclass,
                int blocks, int cpb, int stages, int stage_bytes, int smem,
                int ncx, int ncy, int ncz, void* stream) {
  using Rows = typename Walk<V>::Rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows lines = rows_of<Rows>(P, ncx, ncy, ncz, sizeof(T));
#define FUSTPU_CASE(P_)                                                      \
  case P_:                                                                   \
    return fustpu::pencil::launch_classes<                                   \
        T, P_ + 1, false, typename Walk<V>::template Geo<T, P_ + 1>>(        \
        x, nullptr, nullptr, G, D, nullptr, y, chunks, classes, nclass,      \
        blocks, cpb, stages, stage_bytes, smem, lines, s);
  switch (P) {
    FUSTPU_DEGREES(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

template <typename T, int V>
int occupancy_walk(int P, int cpb, int smem) {
#define FUSTPU_CASE(P_)                                                      \
  case P_:                                                                   \
    return fustpu::pencil::occupancy<                                        \
        T, P_ + 1, false, typename Walk<V>::template Geo<T, P_ + 1>,         \
        typename Walk<V>::Rows>(cpb, smem);
  switch (P) {
    FUSTPU_DEGREES(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

template <typename T>
int launch_pencil(int variant, int P, const void* x, const void* G,
                  const void* D, void* y, const void* chunks,
                  const long long* classes, int nclass, int blocks, int cpb,
                  int stages, int stage_bytes, int smem, int ncx, int ncy,
                  int ncz, void* stream) {
#define FUSTPU_VARIANT(V)                                                    \
  case V:                                                                    \
    return launch_walk<T, V>(P, x, G, D, y, chunks, classes, nclass,         \
                             blocks, cpb, stages, stage_bytes, smem, ncx,     \
                             ncy, ncz, stream);
  switch (variant) {
    case PROD:  // #1 itself, stiffness.cu's kernel
      return sizeof(T) == 4
                 ? fustpu_stiffness_f32(x, G, D, y, P, chunks, classes, nclass,
                                        blocks, cpb, stages, stage_bytes,
                                        smem, ncy, ncz, stream)
                 : fustpu_stiffness_f64(x, G, D, y, P, chunks, classes, nclass,
                                        blocks, cpb, stages, stage_bytes,
                                        smem, ncy, ncz, stream);
    FUSTPU_VARIANT(CONTRACT)
    FUSTPU_VARIANT(GSTREAM)
    FUSTPU_VARIANT(YWIN)
    default:
      return -2;
  }
#undef FUSTPU_VARIANT
}

template <typename T>
int occupancy_pencil(int variant, int P, int cpb, int smem) {
  switch (variant) {
    case PROD:
      return fustpu_stiffness_occupancy(P, sizeof(T) == 8, 0, cpb, smem);
    case CONTRACT:
      return occupancy_walk<T, CONTRACT>(P, cpb, smem);
    case GSTREAM:
      return occupancy_walk<T, GSTREAM>(P, cpb, smem);
    case YWIN:
      return occupancy_walk<T, YWIN>(P, cpb, smem);
    default:
      return -2;
  }
}

}  // namespace

// C entry points.  variant: 0 PROD (full, #1 itself), 1 CONTRACT, 2
// GSTREAM, 3 YWIN (stiffness.cuh's flags); the pair entry is #2 itself.
// Each returns 0, -1 for an unsupported degree, -2 for an unknown variant,
// or the cudaError_t of the first failed call.  y must be zeroed by the
// caller; CONTRACT reads no G.  They take the walk's schedule after P as
// stiffness.cu's do (chunks: (rows, 5) int64 on the device; classes:
// nclass x 3 int64 on the host), then the cells per axis.
extern "C" {

#define FUSTPU_ANATOMY(SUF, T)                                               \
  int fustpu_anatomy_pencil_##SUF(                                           \
      int variant, const void* x, const void* G, const void* D, void* y,     \
      int P, const void* chunks, const long long* classes, int nclass,       \
      int blocks, int cpb, int stages, int stage_bytes, int smem, int ncx,   \
      int ncy, int ncz, void* stream) {                                      \
    return launch_pencil<T>(variant, P, x, G, D, y, chunks, classes, nclass, \
                            blocks, cpb, stages, stage_bytes, smem, ncx, ncy, \
                            ncz, stream);                                    \
  }                                                                          \
  int fustpu_anatomy_pencil_pair_##SUF(                                      \
      const void* x1, const void* x2, const void* C, const void* G,          \
      const void* D, void* y, int P, const void* chunks,                     \
      const long long* classes, int nclass, int blocks, int cpb, int stages, \
      int stage_bytes, int smem, int, int ncy, int ncz, void* stream) {      \
    return fustpu_stiffness_pair_##SUF(x1, x2, C, G, D, y, P, chunks,        \
                                       classes, nclass, blocks, cpb, stages, \
                                       stage_bytes, smem, ncy, ncz, stream); \
  }

FUSTPU_ANATOMY(f32, float)
FUSTPU_ANATOMY(f64, double)
#undef FUSTPU_ANATOMY

// Blocks of the pencil variant for (P, float64?) with cpb cells and smem
// dynamic shared bytes that one SM holds at once (0 beyond the kernel's
// launch bounds); -1 for an unsupported degree, -2 for an unknown variant,
// minus the cudaError_t of a failed query.
int fustpu_anatomy_pencil_occupancy(int variant, int P, int f64, int cpb,
                                    int smem) {
  return f64 ? occupancy_pencil<double>(variant, P, cpb, smem)
             : occupancy_pencil<float>(variant, P, cpb, smem);
}

}  // extern "C"
