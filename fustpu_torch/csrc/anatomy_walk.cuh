// The anatomy of the z-pencil kernel (#1, stiffness_pencil.cuh): policies
// of its walk that keep one part of its work, so that each part's time can
// be read against the whole on the same schedule (entry points in
// anatomy.cu, `fustpu_anatomy_pencil_*`).
//
// Replaces the Pallas TPU kernel of demos/exp_kernel_anatomy.py
// (make_variant, :34, pallas_call :165), whose variants keep one TPU
// unit's work (`vpu`, `mxu`, `ywin`).  On the walk:
//   - full:     pencil_kernel<T, N, false, BoxRows, GRing> itself, #1 (its
//     pair form, #2, is full_pair);
//   - gstream:  GStreamGeo: the walk's ring copies of G, x staging, the
//     chunk's y buffer and its write-out, with the POINTWISE body (the
//     1-D contractions the identity, w = (u, u, u), the metric's three
//     outputs summed into the node, added in the walk's turns): the walk's
//     bytes with next to no arithmetic;
//   - contract: UnitGeo: no ring, no copy and no wait; the unit metric
//     (0, 0, 0, 1, 0, 1) in registers, f1 and f2 in the block after the
//     chunk buffers, x and y staged as full stages them: the contractions
//     and the x / y traffic;
//   - ywin:     XRows: the operator with x arriving by bulk copies, one 1-D
//     cp.async.bulk a z-line run (its aligned superset, cut back at x's
//     end, where the threads read the last bytes), into one x area after
//     the ring's stages with an mbarrier of its own, issued by the first
//     warp once the last chunk's x has been read there and waited on after
//     the body; the threads then copy each run into the cells' u.  The
//     arithmetic and its order are full's, so ywin is bitwise full.
//
// What bounds each on an H100 (P = 4, float32): gstream and ywin move
// full's bytes (G, x, y once each: 360,493,576 B at 64 x 40 x 40, 0.1076
// ms at 3.35 TB/s); contract moves x and y only (2 values a node) with
// full's sum-factor operations.  full - gstream - contract says whether
// the G stream and the contractions overlap.
//
// The walk, its classes, schedule and deterministic scatter are #1's; the
// variants differ only in the policies below (the geometry policy's BODY
// and RING, the Rows policy's XBULK).

#pragma once

#include "stiffness_pencil.cuh"

namespace fustpu {
namespace anatomy {

// gstream: the G stream with the POINTWISE body.
template <typename T, int N>
struct GStreamGeo : pencil::GRing<T, N> {
  static constexpr int BODY = STAGED_POINTWISE;
  using pencil::GRing<T, N>::GRing;
};

// The metric (0, 0, 0, 1, 0, 1): (f0, f1, f2) = (0, wy, wz).
template <typename T>
struct UnitMetric {
  __device__ __forceinline__ void operator()(int, int, T, T wy, T wz, T& f0,
                                             T& f1, T& f2) const {
    f0 = T(0);
    f1 = wy;
    f2 = wz;
  }
};

// contract: no stream; the cell slots' f1, f2 (2 N^3 values a slot) after
// the chunk buffers.
template <typename T, int N>
struct UnitGeo {
  using Store = T;
  static constexpr int CELL = 0;
  static constexpr bool BARRIERS = true, RING = false;
  static constexpr int MAX_THREADS = 256, MIN_BLOCKS = 0, BODY = STAGED;
  static constexpr int NNN = N * N * N;
  __host__ __device__ static constexpr int after(int slots) {
    return 2 * NNN * slots;
  }
  __device__ static void load(T*, const T*, int, int, int) {}

  T* f;
  __device__ UnitGeo(T* after_, int, int, int) : f(after_) {}

  struct Cell {
    UnitMetric<T> metric;
    T* f1;
    T* f2;
  };
  __device__ __forceinline__ Cell cell(T*, int lc) const {
    T* f1 = f + 2 * NNN * lc;
    return {UnitMetric<T>{}, f1, f1 + NNN};
  }
};

// ywin: box pencils (BoxRows) whose x arrives by bulk copies; xbytes: x's
// bytes, where the last run's aligned span is cut back.
struct XRows {
  static constexpr bool IDS = false, XBULK = true;
  int gz, sx;
  const int* ids;                      // unused
  long long xbytes;
  template <int N>
  __device__ int base(const long long* r, const int*, int rr) const {
    return (int)r[4] + (rr / N) * sx + (rr % N) * gz;
  }
  __device__ bool starts(int qi) const { return qi == 0; }
  __device__ bool drains(int) const { return false; }
};

}  // namespace anatomy
}  // namespace fustpu
