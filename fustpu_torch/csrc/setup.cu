// The set-up kernels: a model's geometry, facet geometry, box dofmap rows
// and assembled mass diagonals, computed on the card in float64.
//
//   cell_geometry<NG, WITH_G>  detJ[c, q] = w_q |det J|,
//                              G[c, q, :] = w_q |det J| uppertri(J^-1 J^-T)
//   facet_geometry<NG>         detJ_f[f, q] = w_q |t_s x t_t|
//   box_dofmap                 the dofmap rows of given cells of a box
//   mass_diagonal_box          m[d] = sum of detJ[c, q] coeff[c] over the
//                              (c, q) pairs of box node d
//   mass_diagonal_map          m[d] = sum of v[p] coeff[p / nq] over the
//                              positions p of dof d (an inverse map)
//
// Replaces no TPU kernel: the JAX package computes these on the host, in
// its native C++ / OpenMP set-up runtime (native/fustpu_native.cpp:
// fustpu_cell_geometry :76, fustpu_facet_geometry :111, fustpu_box_dofmap
// :140, fustpu_mass_diagonal :163; bound in fustpu/native_bindings.py) or
// in numpy.  The port ran them in numpy on one host core, 5-19 s of
// geometry per model at 6.7M-22M DOF; on the card they are the set-up's
// parallel work, one thread per (cell, point), per (facet, point) or per
// dof.  The arithmetic is the native runtime's: J as a sum over the
// geometry dofs in their order, the cofactor determinant, J^-1 as the
// adjugate times 1 / det, K[r][s] = sum_p Ji[r][p] Ji[s][p].  NG is 8
// (trilinear cells) or 27 (the isoparametric hex27 map of curved imports),
// which the native runtime does not serve.
//
// What bounds them on an H100: memory traffic.  At the flagship bowl
// (102,400 cells, 125 points) cell_geometry writes 0.61 GB of G and 0.10 GB
// of detJ and reads 20 MB of corners (~0.22 ms at 3.35 TB/s); its ~250
// float64 operations a point take ~0.09 ms at the 34 TFLOP/s float64 rate.
//
// What the design does about it:
//   - cell_geometry: one thread a (cell, point), the points of a cell
//     consecutive, so a warp's stores of detJ and of G are contiguous runs
//     (32 and 6 x 32 values) and its loads of a cell's geometry dofs are
//     broadcasts; the reference gradients (24 KB at P = 4 for trilinear
//     cells, 222 KB at P = 6 for hex27) come transposed, (NG x 3, nq), so
//     that a warp's 32 points read each of them as one coalesced run,
//     through the read-only data cache rather than staged in shared
//     memory, where a block would take a tile of points and wait at a
//     barrier for each tile and chunk of cells (that design, tiles of 8
//     points and 32 cells a block, took 0.99 ms for G at the flagship on
//     an H100, 4.5x its bound);
//   - facet_geometry: one thread a (facet, point); the facets are few
//     (~10^4 x n^2 points), so the gradient table stays in global memory
//     (read through the read-only cache);
//   - the mass diagonals are deterministic and use no atomics: one thread
//     a dof sums its contributions in a fixed order.  On a box, a node has
//     at most 2 (cell, local index) pairs per axis, and the thread takes
//     them in the order of the plain version's strided adds
//     (ops/spectral_mm.py mass_diagonal: local index (i, j, k) ascending);
//     through an inverse map (ops/cuda_setup.py inverse_map, the layout of
//     engine_scatter) it takes the positions in ascending order, the order
//     of numpy's bincount / add.at.  Products and sums are rounded one at
//     a time (__dmul_rn, __dadd_rn: no fused multiply-add), so the
//     diagonals equal the plain version's bitwise on equal inputs;
//   - every cell, position and dof index is 64-bit where it is multiplied
//     (2,082,304 cells x 125 points x 6 at the capacity box passes 2^31).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1 << 16;

__device__ __forceinline__ double det3(const double J[3][3]) {
  return J[0][0] * (J[1][1] * J[2][2] - J[1][2] * J[2][1]) -
         J[0][1] * (J[1][0] * J[2][2] - J[1][2] * J[2][0]) +
         J[0][2] * (J[1][0] * J[2][1] - J[1][1] * J[2][0]);
}

template <int NG, bool WITH_G>
__global__ void __launch_bounds__(kThreads)
cell_geometry(const double* __restrict__ gdofs,
              const double* __restrict__ grads,
              const double* __restrict__ wts, long long ncells, int nq,
              double* __restrict__ detJ, double* __restrict__ G) {
  const long long n = ncells * nq;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    // n < 2^32 at every mesh one card holds (2,082,304 cells x 125 points
    // at the capacity box): 32-bit division, not the 64-bit emulation
    const long long c = n < (1LL << 32) ? (unsigned)i / (unsigned)nq
                                        : i / nq;
    const int q = (int)(i - c * nq);
    const double* x = gdofs + c * NG * 3;
    double J[3][3];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        double s = 0.0;
#pragma unroll
        for (int v = 0; v < NG; ++v)
          s += __ldg(x + 3 * v + p) * __ldg(grads + (3 * v + r) * nq + q);
        J[p][r] = s;
      }
    const double det = det3(J);
    const double sd = fabs(det) * __ldg(wts + q);
    detJ[i] = sd;
    if (WITH_G) {
      const double id = 1.0 / det;
      double Ji[3][3];
      Ji[0][0] = (J[1][1] * J[2][2] - J[1][2] * J[2][1]) * id;
      Ji[0][1] = (J[0][2] * J[2][1] - J[0][1] * J[2][2]) * id;
      Ji[0][2] = (J[0][1] * J[1][2] - J[0][2] * J[1][1]) * id;
      Ji[1][0] = (J[1][2] * J[2][0] - J[1][0] * J[2][2]) * id;
      Ji[1][1] = (J[0][0] * J[2][2] - J[0][2] * J[2][0]) * id;
      Ji[1][2] = (J[0][2] * J[1][0] - J[0][0] * J[1][2]) * id;
      Ji[2][0] = (J[1][0] * J[2][1] - J[1][1] * J[2][0]) * id;
      Ji[2][1] = (J[0][1] * J[2][0] - J[0][0] * J[2][1]) * id;
      Ji[2][2] = (J[0][0] * J[1][1] - J[0][1] * J[1][0]) * id;
      double* out = G + i * 6;
      int k = 0;
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int s = r; s < 3; ++s)
          out[k++] = (Ji[r][0] * Ji[s][0] + Ji[r][1] * Ji[s][1] +
                      Ji[r][2] * Ji[s][2]) * sd;
    }
  }
}

// fgrads: (6, nq, NG, 3), the reference gradients at each local facet's
// points; bd: (nf, 2) int64 (cell, local facet); the free axes of local
// facet lf are those other than lf / 2 (x-, x+, y-, y+, z-, z+).
template <int NG>
__global__ void __launch_bounds__(kThreads)
facet_geometry(const double* __restrict__ gdofs,
               const double* __restrict__ fgrads,
               const double* __restrict__ wts,
               const long long* __restrict__ bd, long long nf, int nq,
               double* __restrict__ detJ_f) {
  const long long n = nf * nq;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const long long f = i / nq;
    const int q = (int)(i % nq);
    const long long cell = bd[2 * f];
    const int lf = (int)bd[2 * f + 1];
    const int axis = lf / 2;
    const int a0 = axis == 0 ? 1 : 0, a1 = axis == 2 ? 1 : 2;
    const double* x = gdofs + cell * NG * 3;
    const double* g = fgrads + ((long long)lf * nq + q) * NG * 3;
    double t0[3], t1[3];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      double s0 = 0.0, s1 = 0.0;
#pragma unroll
      for (int v = 0; v < NG; ++v) {
        s0 += x[3 * v + p] * __ldg(g + 3 * v + a0);
        s1 += x[3 * v + p] * __ldg(g + 3 * v + a1);
      }
      t0[p] = s0;
      t1[p] = s1;
    }
    const double cx = t0[1] * t1[2] - t0[2] * t1[1];
    const double cy = t0[2] * t1[0] - t0[0] * t1[2];
    const double cz = t0[0] * t1[1] - t0[1] * t1[0];
    detJ_f[i] = sqrt(cx * cx + cy * cy + cz * cz) * wts[q];
  }
}

// out[r, (i, j, k)] = (cx P + i) gy gz + (cy P + j) gz + (cz P + k) for
// the cell cells[r] = (cx ncy + cy) ncz + cz.
__global__ void __launch_bounds__(kThreads)
box_dofmap(const long long* __restrict__ cells, long long m, int ncy,
           int ncz, int P, int* __restrict__ out) {
  const int n = P + 1;
  const long long nd = (long long)n * n * n;
  const long long gy = (long long)ncy * P + 1, gz = (long long)ncz * P + 1;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < m * nd; i += (long long)gridDim.x * kThreads) {
    const long long cell = cells[i / nd];
    const int l = (int)(i % nd);
    const long long cx = cell / ((long long)ncy * ncz);
    const long long cy = (cell / ncz) % ncy, cz = cell % ncz;
    out[i] = (int)((cx * P + l / (n * n)) * gy * gz +
                   (cy * P + (l / n) % n) * gz + (cz * P + l % n));
  }
}

// The (local index, cell) pairs of global node X along one axis of nc
// cells, local index ascending: (X % P, X / P) inside, then (P, X / P - 1)
// on a cell boundary.
__device__ __forceinline__ int axis_pairs(long long X, int P, int nc,
                                          int li[2], long long ci[2]) {
  int k = 0;
  if (X / P < nc) {
    li[k] = (int)(X % P);
    ci[k++] = X / P;
  }
  if (X % P == 0 && X >= P) {
    li[k] = P;
    ci[k++] = X / P - 1;
  }
  return k;
}

__global__ void __launch_bounds__(kThreads)
mass_diagonal_box(const double* __restrict__ detJ,
                  const double* __restrict__ coeff, int ncx, int ncy,
                  int ncz, int P, double* __restrict__ out) {
  const int n = P + 1;
  const long long gy = (long long)ncy * P + 1, gz = (long long)ncz * P + 1;
  const long long ndofs = ((long long)ncx * P + 1) * gy * gz;
  const int nq = n * n * n;
  for (long long d = (long long)blockIdx.x * kThreads + threadIdx.x;
       d < ndofs; d += (long long)gridDim.x * kThreads) {
    int li[2], lj[2], lk[2];
    long long ca[2], cb[2], cc[2];
    const int na = axis_pairs(d / (gy * gz), P, ncx, li, ca);
    const int nb = axis_pairs((d / gz) % gy, P, ncy, lj, cb);
    const int nk = axis_pairs(d % gz, P, ncz, lk, cc);
    double acc = 0.0;
    for (int a = 0; a < na; ++a)
      for (int b = 0; b < nb; ++b)
        for (int e = 0; e < nk; ++e) {
          const long long c = (ca[a] * ncy + cb[b]) * ncz + cc[e];
          double v = detJ[c * nq + (li[a] * n + lj[b]) * n + lk[e]];
          if (coeff) v = __dmul_rn(v, coeff[c]);
          acc = __dadd_rn(acc, v);
        }
    out[d] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
mass_diagonal_map(const double* __restrict__ vals,
                  const double* __restrict__ coeff, int nq,
                  const int* __restrict__ pos, const int* __restrict__ ptr,
                  long long ndofs, double* __restrict__ out) {
  for (long long d = (long long)blockIdx.x * kThreads + threadIdx.x;
       d < ndofs; d += (long long)gridDim.x * kThreads) {
    double acc = 0.0;
    const int end = ptr[d + 1];
    for (int k = ptr[d]; k < end; ++k) {
      const int p = pos[k];
      double v = vals[p];
      if (coeff) v = __dmul_rn(v, coeff[p / nq]);
      acc = __dadd_rn(acc, v);
    }
    out[d] = acc;
  }
}

unsigned blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

template <int NG, bool WITH_G>
int launch_cell(const void* gdofs, const void* grads, const void* wts,
                long long ncells, int nq, void* detJ, void* G,
                cudaStream_t s) {
  cell_geometry<NG, WITH_G><<<blocks_for(ncells * nq), kThreads, 0, s>>>(
      static_cast<const double*>(gdofs), static_cast<const double*>(grads),
      static_cast<const double*>(wts), ncells, nq,
      static_cast<double*>(detJ), static_cast<double*>(G));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// gdofs (ncells, ng, 3), grads (ng x 3, nq) (the reference gradients,
// transposed), wts (nq,): detJ (ncells, nq) and, with with_g, G
// (ncells, nq, 6); ng 8 or 27.
int fustpu_setup_cell_geometry(const void* gdofs, const void* grads,
                               const void* wts, long long ncells, int nq,
                               int ng, int with_g, void* detJ, void* G,
                               void* stream) {
  if (ncells <= 0) return 0;
  if (nq < 1 || (with_g && G == nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ng == 8)
    return with_g ? launch_cell<8, true>(gdofs, grads, wts, ncells, nq,
                                         detJ, G, s)
                  : launch_cell<8, false>(gdofs, grads, wts, ncells, nq,
                                          detJ, G, s);
  if (ng == 27)
    return with_g ? launch_cell<27, true>(gdofs, grads, wts, ncells, nq,
                                          detJ, G, s)
                  : launch_cell<27, false>(gdofs, grads, wts, ncells, nq,
                                           detJ, G, s);
  return -1;
}

int fustpu_setup_facet_geometry(const void* gdofs, const void* fgrads,
                                const void* wts, const void* bd,
                                long long nf, int nq, int ng, void* detJ_f,
                                void* stream) {
  if (nf <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(nf * nq);
  if (ng == 8)
    facet_geometry<8><<<blocks, kThreads, 0, s>>>(
        static_cast<const double*>(gdofs), static_cast<const double*>(fgrads),
        static_cast<const double*>(wts), static_cast<const long long*>(bd),
        nf, nq, static_cast<double*>(detJ_f));
  else if (ng == 27)
    facet_geometry<27><<<blocks, kThreads, 0, s>>>(
        static_cast<const double*>(gdofs), static_cast<const double*>(fgrads),
        static_cast<const double*>(wts), static_cast<const long long*>(bd),
        nf, nq, static_cast<double*>(detJ_f));
  else
    return -1;
  return (int)cudaGetLastError();
}

int fustpu_setup_box_dofmap(const void* cells, long long m, int ncy, int ncz,
                            int P, void* out, void* stream) {
  if (m <= 0) return 0;
  const long long n = P + 1;
  box_dofmap<<<blocks_for(m * n * n * n), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(cells), m, ncy, ncz, P,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// coeff may be null (unit coefficients).
int fustpu_setup_mass_diagonal_box(const void* detJ, const void* coeff,
                                   int ncx, int ncy, int ncz, int P,
                                   void* out, void* stream) {
  const long long ndofs = ((long long)ncx * P + 1) * ((long long)ncy * P + 1) *
                          ((long long)ncz * P + 1);
  mass_diagonal_box<<<blocks_for(ndofs), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(detJ), static_cast<const double*>(coeff),
      ncx, ncy, ncz, P, static_cast<double*>(out));
  return (int)cudaGetLastError();
}

int fustpu_setup_mass_diagonal_map(const void* vals, const void* coeff,
                                   int nq, const void* pos, const void* ptr,
                                   long long ndofs, void* out,
                                   void* stream) {
  if (ndofs <= 0) return 0;
  mass_diagonal_map<<<blocks_for(ndofs), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(vals), static_cast<const double*>(coeff),
      nq, static_cast<const int*>(pos), static_cast<const int*>(ptr), ndofs,
      static_cast<double*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
