// The corner-streamed metric (the capacity mode): instead of reading c G
// from a (cells, 6, N^3) stream, a cell carries the monomial coefficients
// of its Jacobian, J[p][q] = dX_p / dxi_q as a polynomial in the unit
// reference coordinates (x, y, z) = (xi_0, xi_1, xi_2), plus one material
// coefficient, and c G is evaluated in registers at each GLL node:
//
//   a = adj(J),  det = det(J),  scale = c w_i w_j w_k / |det|,
//   c G = scale a a^T    (applied factored: t = a^T w, f = scale a t).
//
// The geometry degree GD is 1 (trilinear hex8: 36 Jacobian channels) or 2
// (triquadratic hex27: 162); column q of J has degree GD - 1 in xi_q and
// GD in the other two.  The coefficient is the channel after the last.
//
// Work split (that of sum_factor.cuh): a thread owns the line of nodes
// (i, j, k), i = 0..N-1, so y = XQ[j] and z = XQ[k] are fixed along it.
// The constructor folds them in once per cell, leaving each J[p][q] a
// polynomial in x alone (3 + 6 + 6 = 15 coefficients per line at GD = 1,
// 24 at GD = 2); a node then costs the Horner steps in x (6 FMAs at
// GD = 1), the adjugate, the determinant, one division and the factored
// transform.  The powers y^my z^mz of the fold depend on the line alone
// (`LinePowers`): a kernel whose thread keeps its line from one cell to
// the next (the pencil walk, stiffness_pencil.cuh) computes them once.
// RCP (float only) takes the division as one approximate reciprocal
// (__fdividef, 2 ulp) in place of IEEE div.rn.  S: the type the channels
// are stored in (bfloat16 for the walk's bf16 forms, storage.cuh); each
// is widened to T where it is read, so that everything after the load is
// T's arithmetic.

#pragma once

#include <cuda_runtime.h>

#include "storage.cuh"

namespace fustpu {

// Channels per cell: the Jacobian's monomials, then the coefficient.
template <int GD>
struct CornerChannels {
  static constexpr int NCH = 9 * GD * (GD + 1) * (GD + 1);
  static constexpr int COUNT = NCH + 1;
};

// Degree of J[.][q] in reference axis `axis`.
template <int GD>
__host__ __device__ constexpr int corner_degree(int q, int axis) {
  return axis == q ? GD - 1 : GD;
}

// Channel of the coefficient of x^mx y^my z^mz in J[p][q].
//   BOX (GD = 1): the layout of jacobian_coefficients (the structured
//     kernel's), [12 q + 4 p + m] with m = ma + 2 mb over the two free axes
//     a < b of column q;
//   else: the monomial table of corner_stream (the extruded kernel's),
//     block 3 q + p of GD (GD + 1)^2 channels, x major and z minor.
template <int GD, bool BOX>
__host__ __device__ constexpr int corner_channel(int q, int p, int mx,
                                                 int my, int mz) {
  if (BOX) {
    const int ma = q == 0 ? my : mx;
    const int mb = q == 2 ? my : mz;
    return 12 * q + 4 * p + ma + 2 * mb;
  }
  const int dy = corner_degree<GD>(q, 1), dz = corner_degree<GD>(q, 2);
  return (3 * q + p) * GD * (GD + 1) * (GD + 1) +
         (mx * (dy + 1) + my) * (dz + 1) + mz;
}

// y^my z^mz at line (j, k): xq, the N unit GLL nodes.
template <typename T, int GD>
struct LinePowers {
  T yz[GD + 1][GD + 1];

  __device__ __forceinline__ LinePowers(const T* xq, int j, int k) {
    const T y = xq[j], z = xq[k];
    T yp[GD + 1], zp[GD + 1];
    yp[0] = zp[0] = T(1);
#pragma unroll
    for (int m = 1; m <= GD; ++m) {
      yp[m] = yp[m - 1] * y;
      zp[m] = zp[m - 1] * z;
    }
#pragma unroll
    for (int my = 0; my <= GD; ++my)
#pragma unroll
      for (int mz = 0; mz <= GD; ++mz) yz[my][mz] = yp[my] * zp[mz];
  }
};

// a / b: IEEE, or for float with `fast` one approximate reciprocal
__device__ __forceinline__ double corner_div(double a, double b, bool) {
  return a / b;
}
__device__ __forceinline__ float corner_div(float a, float b, bool fast) {
  return fast ? __fdividef(a, b) : a / b;
}

// The Metric functor of cell_apply for one cell's line (j, k).  ch: the
// cell's channels in shared memory; xq, wq: the N unit GLL nodes and
// weights in shared memory; pw: the line's powers, when the caller keeps
// them (the fold's products are the same either way).
template <typename T, int N, int GD, bool BOX, bool RCP = false,
          typename S = T>
struct Corner {
  static_assert(GD == 1 || GD == 2, "geometry degree 1 or 2");
  static_assert(!BOX || GD == 1, "the structured layout is trilinear");

  T c[3][3][GD + 1];   // J[p][q] along the line = sum_m c[q][p][m] x^m
  T s;                 // coefficient * w_j * w_k
  const T* xq;
  const T* wq;

  __device__ __forceinline__ Corner(const S* ch, const T* xq_, const T* wq_,
                                    int j, int k)
      : Corner(ch, xq_, wq_, j, k, LinePowers<T, GD>(xq_, j, k)) {}

  __device__ __forceinline__ Corner(const S* ch, const T* xq_, const T* wq_,
                                    int j, int k,
                                    const LinePowers<T, GD>& pw)
      : xq(xq_), wq(wq_) {
    // fixed trip counts (GD + 1), so that every loop unrolls and c stays in
    // registers; the degree tests fold at compile time
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int mx = 0; mx <= GD; ++mx) {
          T acc = T(0);
#pragma unroll
          for (int my = 0; my <= GD; ++my) {
#pragma unroll
            for (int mz = 0; mz <= GD; ++mz) {
              if (mx <= corner_degree<GD>(q, 0) &&
                  my <= corner_degree<GD>(q, 1) &&
                  mz <= corner_degree<GD>(q, 2))
                acc += widen<T>(ch[corner_channel<GD, BOX>(q, p, mx, my,
                                                            mz)]) *
                       pw.yz[my][mz];
            }
          }
          c[q][p][mx] = acc;
        }
      }
    }
    s = widen<T>(ch[CornerChannels<GD>::NCH]) * wq[j] * wq[k];
  }

  __device__ __forceinline__ void operator()(int i, int, T wx, T wy, T wz,
                                             T& f0, T& f1, T& f2) const {
    const T x = xq[i];
    T J[3][3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        // Horner from the column's degree in x
        const int dx = corner_degree<GD>(q, 0);
        T v = c[q][p][dx];
#pragma unroll
        for (int m = GD - 1; m >= 0; --m)
          if (m < dx) v = v * x + c[q][p][m];
        J[p][q] = v;
      }
    }
    // adjugate: J^{-1}[r][p] = a_rp / det
    const T a00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
    const T a01 = J[0][2] * J[2][1] - J[0][1] * J[2][2];
    const T a02 = J[0][1] * J[1][2] - J[0][2] * J[1][1];
    const T a10 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
    const T a11 = J[0][0] * J[2][2] - J[0][2] * J[2][0];
    const T a12 = J[0][2] * J[1][0] - J[0][0] * J[1][2];
    const T a20 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
    const T a21 = J[0][1] * J[2][0] - J[0][0] * J[2][1];
    const T a22 = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    const T det = J[0][0] * a00 + J[0][1] * a10 + J[0][2] * a20;
    // |det|: imported cells may be left-handed
    const T scale = corner_div(wq[i] * s, det < T(0) ? -det : det, RCP);
    const T t0 = a00 * wx + a10 * wy + a20 * wz;
    const T t1 = a01 * wx + a11 * wy + a21 * wz;
    const T t2 = a02 * wx + a12 * wy + a22 * wz;
    f0 = scale * (a00 * t0 + a01 * t1 + a02 * t2);
    f1 = scale * (a10 * t0 + a11 * t1 + a12 * t2);
    f2 = scale * (a20 * t0 + a21 * t1 + a22 * t2);
  }
};

}  // namespace fustpu
