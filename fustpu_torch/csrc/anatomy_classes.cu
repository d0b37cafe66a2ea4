// Anatomy of the structured stiffness kernel #1 on its parity-class
// design (stiffness.cuh's stiffness_kernel): the kernel itself (PROD) and
// three variants of it, each keeping one part of its work, to be timed
// against it on the same grid.  The walk's variants, the design that
// replaced it, are anatomy.cu's (anatomy_walk.cuh); the two files build
// apart so that the sources compile in parallel.
//
// Replaces the Pallas TPU kernel of demos/exp_kernel_anatomy.py
// (make_variant, :34, pallas_call :165), whose variants keep one TPU
// unit's work: `vpu` (no matmuls), `mxu` (matmuls only) and `ywin` (the
// y windows as reshapes).  Here:
//   - full:     the parity-class kernel #1 (PROD), single field; its pair
//     form (PROD, PAIR) is fustpu_anatomy_classes_pair_*, its kernel #2;
//   - CONTRACT: the `mxu` counterpart: the sum factorisation with the
//     constant metric (0, 0, 0, 1, 0, 1) and no G read, exactly what
//     `mxu` computes;
//   - GSTREAM:  the `vpu` counterpart: the x and G loads, the pointwise
//     metric and the scatter, with the 1-D contractions replaced by the
//     identity (w = (u, u, u), the metric's three outputs summed into the
//     node);
//   - YWIN:     the operator, with each block's x staged into shared
//     memory by one cooperative copy (the N^2 rows of nodes over the
//     z-range of its cells, consecutive threads on consecutive nodes)
//     instead of each thread reading its own line: on the card the y
//     windows are index arithmetic, so the variant changes how x arrives.
//
// What bounds each on an H100 (P = 4, 32^3 cells, float32): GSTREAM moves
// full's bytes (G, x, y) with a few operations a node, so it is the G
// stream's time alone; CONTRACT moves x and y only (no G) with full's
// sum-factor operations, so it is the contractions' time; YWIN is bound as
// full.  full - gstream - contract shows how far the two overlap.
//
// Design: no copy of the body.  The variants are the Metric functor
// (UnitYZ for CONTRACT), cell_apply's Body flag (POINTWISE, STAGED) and,
// for YWIN, the block -> cells map (one z-row of a parity class per block)
// and the staging copy; the parity classes, launches and deterministic
// scatter are full's.

#include "stiffness.cuh"

namespace {

template <typename T>
int launch_variant(int variant, int P, const void* x, const void* G,
                   const void* D, void* y, int ncx, int ncy, int ncz,
                   void* stream) {
  switch (variant) {
    case PROD:
      return launch<T, false, false, PROD>(P, x, nullptr, nullptr, G, D,
                                           nullptr, y, ncx, ncy, ncz, stream);
    case CONTRACT:
      return launch<T, false, false, CONTRACT>(P, x, nullptr, nullptr, G, D,
                                               nullptr, y, ncx, ncy, ncz,
                                               stream);
    case GSTREAM:
      return launch<T, false, false, GSTREAM>(P, x, nullptr, nullptr, G, D,
                                              nullptr, y, ncx, ncy, ncz,
                                              stream);
    case YWIN:
      return launch<T, false, false, YWIN>(P, x, nullptr, nullptr, G, D,
                                           nullptr, y, ncx, ncy, ncz,
                                           stream);
    default:
      return -2;
  }
}

}  // namespace

// C entry points.  variant: 0 PROD (full), 1 CONTRACT, 2 GSTREAM, 3 YWIN;
// the pair entry is PROD's pair form.  Each returns 0, -1 for an
// unsupported degree, -2 for an unknown variant, or the cudaError_t of the
// first failed launch.  y must be zeroed by the caller; CONTRACT reads no
// G.
extern "C" {

#define FUSTPU_ANATOMY_CLASSES(SUF, T)                                       \
  int fustpu_anatomy_classes_##SUF(int variant, const void* x, const void* G, \
                                   const void* D, void* y, int P, int ncx,   \
                                   int ncy, int ncz, void* stream) {         \
    return launch_variant<T>(variant, P, x, G, D, y, ncx, ncy, ncz, stream); \
  }                                                                          \
  int fustpu_anatomy_classes_pair_##SUF(                                     \
      const void* x1, const void* x2, const void* C, const void* G,          \
      const void* D, void* y, int P, int ncx, int ncy, int ncz,              \
      void* stream) {                                                        \
    return launch<T, true, false>(P, x1, x2, C, G, D, nullptr, y, ncx, ncy,  \
                                  ncz, stream);                              \
  }

FUSTPU_ANATOMY_CLASSES(f32, float)
FUSTPU_ANATOMY_CLASSES(f64, double)
#undef FUSTPU_ANATOMY_CLASSES

}  // extern "C"
