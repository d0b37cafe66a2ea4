// The staged gather / contract / scatter engine for GLL spectral hexahedra
// of degree P = 2..10 (N = P + 1) on any conforming hex mesh, as three
// separate passes over the (cells, N^3) element stream:
//
//   u2[p] = x[g[p]]                       engine_gather_quads<T> (one
//                                         field), engine_gather<T, 2> (two)
//   y2[c] = D^T (c G) D u2[c]             engine_contract<T, N, MODE>
//   y[d]  = sum over g[p] == d of y2[p]   engine_scatter<T>
//
// with g = dofmap.ravel() (position p = c N^3 + i N^2 + j N + k).
//
// Replaces the Pallas TPU kernels of fustpu/ops/pallas_gather.py:
//   - gather (:961) -> _mk_gather_kernel (:534), _packed (:736),
//     _packed_staged (:766): engine_gather_quads<T> (the first design,
//     engine_gather<T, 1>, stays as the comparison: `gather_flat`);
//   - gather2 (:1014) -> :566 / :787 / :818: engine_gather<T, 2>;
//   - dense_contract (:1117) -> _mk_contract_kernel (:1078):
//     engine_contract<T, N, PLAIN | COEFF>, and the pair form whose fold
//     c1 u1 + c2 u2 fustpu computes between its kernels
//     (fustpu/ops/operators.py:379-382): engine_contract<T, N, PAIR>;
//   - scatter_add (:1160) -> _mk_scatter_kernel (:610), _packed (:871),
//     _packed_staged (:928): engine_scatter<T>.
// The TPU forms are shaped by their machine: one-hot windowed matmuls on
// the MXU for the gather and the scatter (no fast gather, no atomics),
// bf16x3 splits, 128-lane padding, VMEM-staged residency and spill lists,
// and dense (N^3 x N^3) derivative operators in the contraction.  None of
// that carries over: each kernel here computes the same function in full
// float32 or float64.
//
// What bounds them on an H100: memory traffic.  At the bodyfit H131 bowl
// (102,400 cells, N^3 = 125, 12,800,000 positions, 6,661,697 dofs, float32)
// an apply must move at least: gather g 51.2 MB + x 26.6 MB + u2 51.2 MB;
// contract u2 51.2 MB + G 307.2 MB + y2 51.2 MB; scatter y2 51.2 MB + the
// inverse map 51.2 + 26.6 MB + y 26.6 MB: ~694 MB, against 438 MB for the
// fused indexed kernel (indexed.cu), which keeps u2 and y2 on chip.
//
// What the design does about it:
//   - the single-field gather gives each thread four consecutive positions
//     on a one-wave grid that strides over the array (the host sizes it from
//     the SM count, ops/launch.py `gather_blocks`): one 16 B load of the
//     indices, four independent field loads, one 16 B store (two in
//     float64), and a scalar tail for the last n % 4 positions.  The index
//     and output streams (51.2 MB each at the bowl) are read or written once
//     and carry an L2 evict-first policy, so that they do not push out the
//     field (26.6 MB), whose lines the neighbouring cells read again (the
//     locality order of the mesh keeps a cell's dofs near each other); the
//     field's own loads keep the normal policy (with an evict-last hint on
//     them the kernel ran slower at the bowl).  The first design, one
//     thread a position on a grid that covers them all, stays as
//     engine_gather<T, 1>; the pair form (engine_gather<T, 2>) reads each
//     index once for both fields;
//   - the contraction is the per-cell sum-factorised body of the other
//     stiffness kernels (sum_factor.cuh, GStream metric) with an identity
//     index map: a cell reads its contiguous N^3 row of u2 and its 6 N^3
//     run of G, and writes its row of y2; G is the indexed kernel's
//     (cells, 6, N^3) layout, so one operator drives both kernels;
//   - the scatter is deterministic and needs no float atomics: an inverse
//     map built once on the host lists, for each dof, its positions in
//     ascending order (CSR: ptr[d] .. ptr[d + 1] into pos), and one thread
//     per dof sums them in that fixed order, so an apply is bitwise
//     reproducible;
//   - every position, cell and dof index is 64-bit where it is multiplied
//     (N^3 x cells x 8 bytes passes 2^31 at the P = 6 bowl in float64).
//
// bfloat16 (the JAX package's --dtype bf16, whose engine kernels take any
// dtype): x, x2, u2, y2, G, D, the per-cell coeff and C stored in bfloat16,
// every product and sum in float (storage.cuh).  The gathers copy bfloat16
// values, exactly (a thread's four positions make one 8 B store).  The
// contraction widens the cell's row of u2 (or folds c1 u1 + c2 u2 of the
// two rows in float) into its float shared u and runs the STAGED_STORE
// body on the G stream widened from bfloat16: each node's sum is rounded
// once into its slot of y2, with no zeroed y2 read back.  The scatter
// widens y2, sums each dof's positions in ascending order in float and
// rounds y to bfloat16 once.  At the bodyfit bowl an apply then moves at
// least: gather 51.2 + 13.3 + 25.6 MB; contract 25.6 + 153.6 + 25.6 MB;
// scatter 25.6 + 51.2 + 26.6 + 13.3 MB.  A float32 y2 (y rounded once, not
// y2 too) moves 51.2 MB more an apply: on an H100 80GB HBM3 at 700 W it
// made the apply 4-8% slower (PERF.md, the staged engine's bf16 rows).
// These bfloat16 forms of the contraction and the scatter are the first
// designs, kept as the comparison (entry points *_contract_cells_bf16 and
// *_scatter_dofs_bf16): the main path runs engine_bf16.cu's, redesigned
// for Hopper (bulk-copied chunks on a persistent grid; runs of dofs with
// their inverse-map segment in tiles).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cache_hints.cuh"
#include "sum_factor.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kGatherThreads = 256;   // ops/launch.py GATHER_THREADS

enum Mode { PLAIN = 0, COEFF = 1, PAIR = 2 };

template <typename T, int NF>
__global__ void __launch_bounds__(kThreads)
engine_gather(const T* __restrict__ x1, const T* __restrict__ x2,
              const int* __restrict__ g, T* __restrict__ o1,
              T* __restrict__ o2, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < n; p += stride) {
    const long long d = g[p];
    o1[p] = x1[d];
    if (NF == 2) o2[p] = x2[d];
  }
}

// out[p] = x[g[p]]: thread t of T takes positions 4q .. 4q + 3 for quads
// q = t + k T below n / 4, then position 4 (n / 4) + t if that is below n.
// g and out 16 B-aligned.
template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
engine_gather_quads(const T* __restrict__ x, const int* __restrict__ g,
                    T* __restrict__ out, long long n) {
  const unsigned long long first = fustpu::l2_evict_first();
  const long long nq = n / 4;
  const long long stride = (long long)gridDim.x * kGatherThreads;
  const long long t = (long long)blockIdx.x * kGatherThreads + threadIdx.x;
  const int4* g4 = reinterpret_cast<const int4*>(g);
  for (long long q = t; q < nq; q += stride) {
    const int4 d = fustpu::ld_stream(g4 + q, first);
    const T a = __ldg(x + d.x), b = __ldg(x + d.y);
    const T c = __ldg(x + d.z), e = __ldg(x + d.w);
    fustpu::st_hint4(out + 4 * q, a, b, c, e, first);
  }
  const long long p = 4 * nq + t;
  if (p < n) out[p] = __ldg(x + g[p]);
}

// Node (i, j, k) of cell c sits at position c N^3 + i N^2 + t, t = j N + k.
template <int N>
struct RowLine {
  long long base;
  int t;
  __device__ long long operator()(int i) const { return base + i * N * N + t; }
};

// The G stream scaled by the cell's coefficient: c (G w), as the plain
// contraction orders it.
template <typename T, int N, typename S = T>
struct ScaledGStream {
  fustpu::GStream<T, N, S> g;
  T c;
  __device__ __forceinline__ void operator()(int i, int n, T wx, T wy, T wz,
                                             T& f0, T& f1, T& f2) const {
    g(i, n, wx, wy, wz, f0, f1, f2);
    f0 *= c;
    f1 *= c;
    f2 *= c;
  }
};

template <typename T, int N, int MODE>
__global__ void __launch_bounds__(fustpu::Shape<T, N>::NN *
                                  fustpu::Shape<T, N>::CPB)
engine_contract(const T* __restrict__ u1, const T* __restrict__ u2,
                const T* __restrict__ C, const T* __restrict__ coeff,
                const T* __restrict__ G, const T* __restrict__ D,
                T* __restrict__ y, long long cells) {
  using S = fustpu::Shape<T, N>;
  constexpr int NN = S::NN, NNN = S::NNN, CPB = S::CPB;
  __shared__ T Ds[NN];             // D[q * N + i] = l_i'(x_q)
  __shared__ T us[CPB][NNN];       // the cell's field u
  __shared__ T f1s[CPB][NNN];      // metric-transformed gradients
  __shared__ T f2s[CPB][NNN];

  const int t = threadIdx.x;       // this thread owns nodes (., j, k)
  const int lc = threadIdx.y;      // cell within the block
  for (int s = lc * NN + t; s < NN; s += NN * CPB) Ds[s] = D[s];

  const long long cell = (long long)blockIdx.x * CPB + lc;
  const bool active = cell < cells;
  const long long c0 = active ? cell : 0;
  T c1 = T(1), c2 = T(0);
  if (active && MODE == PAIR) {
    c1 = C[2 * cell];
    c2 = C[2 * cell + 1];
  }
  const fustpu::GStream<T, N> gs{G + c0 * 6 * NNN};
  const RowLine<N> line{c0 * NNN, t};
  if constexpr (MODE == COEFF) {
    const ScaledGStream<T, N> metric{gs, active ? coeff[cell] : T(1)};
    fustpu::cell_apply<T, N, false>(u1, u2, c1, c2, metric, Ds, us[lc],
                                    f1s[lc], f2s[lc], y, active, line);
  } else {
    fustpu::cell_apply<T, N, MODE == PAIR>(u1, u2, c1, c2, gs, Ds, us[lc],
                                           f1s[lc], f2s[lc], y, active,
                                           line);
  }
}

// A metric that stores each node's sum, rounded to bfloat16, into the
// cell's row yc of y2 (the STAGED_STORE body's `put`).
template <typename Metric>
struct RowStore {
  Metric m;
  bf16* __restrict__ yc;
  __device__ __forceinline__ void operator()(int i, int n, float wx,
                                             float wy, float wz, float& f0,
                                             float& f1, float& f2) const {
    m(i, n, wx, wy, wz, f0, f1, f2);
  }
  __device__ __forceinline__ void put(int n, float v) const {
    yc[n] = fustpu::narrow<bf16>(v);
  }
};

// The bfloat16 contraction: u1, u2, C, coeff, G, D and y2 in bfloat16, the
// cell's u, gradients and sums in float.
template <int N, int MODE>
__global__ void __launch_bounds__(fustpu::Shape<float, N>::NN *
                                  fustpu::Shape<float, N>::CPB)
engine_contract_bf16(const bf16* __restrict__ u1, const bf16* __restrict__ u2,
                     const bf16* __restrict__ C,
                     const bf16* __restrict__ coeff,
                     const bf16* __restrict__ G, const bf16* __restrict__ D,
                     bf16* __restrict__ y, long long cells) {
  using S = fustpu::Shape<float, N>;
  constexpr int NN = S::NN, NNN = S::NNN, CPB = S::CPB;
  __shared__ float Ds[NN];         // D[q * N + i] = l_i'(x_q)
  __shared__ float us[CPB][NNN];   // the cell's u, widened (or folded)
  __shared__ float f1s[CPB][NNN];  // metric-transformed gradients
  __shared__ float f2s[CPB][NNN];

  const int t = threadIdx.x;       // this thread owns nodes (., j, k)
  const int lc = threadIdx.y;      // cell within the block
  for (int s = lc * NN + t; s < NN; s += NN * CPB)
    Ds[s] = fustpu::widen<float>(D[s]);

  const long long cell = (long long)blockIdx.x * CPB + lc;
  const bool active = cell < cells;
  const long long c0 = active ? cell : 0;
  if (active) {
    float c1 = 1.0f, c2 = 0.0f;
    if (MODE == PAIR) {
      c1 = fustpu::widen<float>(C[2 * cell]);
      c2 = fustpu::widen<float>(C[2 * cell + 1]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const long long p = c0 * NNN + i * NN + t;
      float v = fustpu::widen<float>(u1[p]);
      if (MODE == PAIR) v = c1 * v + c2 * fustpu::widen<float>(u2[p]);
      us[lc][i * NN + t] = v;
    }
  }
  const fustpu::GStream<float, N, bf16> gs{G + c0 * 6 * NNN};
  const RowLine<N> line{c0 * NNN, t};
  bf16* yc = y + c0 * NNN;
  const float* none = nullptr;
  if constexpr (MODE == COEFF) {
    using Scaled = ScaledGStream<float, N, bf16>;
    const RowStore<Scaled> metric{
        Scaled{gs, active ? fustpu::widen<float>(coeff[cell]) : 1.0f}, yc};
    fustpu::cell_apply<float, N, false, fustpu::STAGED_STORE>(
        none, none, 1.0f, 0.0f, metric, Ds, us[lc], f1s[lc], f2s[lc],
        nullptr, active, line);
  } else {
    const RowStore<fustpu::GStream<float, N, bf16>> metric{gs, yc};
    fustpu::cell_apply<float, N, false, fustpu::STAGED_STORE>(
        none, none, 1.0f, 0.0f, metric, Ds, us[lc], f1s[lc], f2s[lc],
        nullptr, active, line);
  }
}

// y[d] = the sum of v over d's positions pos[ptr[d]] .. pos[ptr[d + 1] - 1]
// in ascending order, accumulated in A, v and y stored in S.
template <typename A, typename S>
__global__ void __launch_bounds__(kThreads)
engine_scatter(const S* __restrict__ v, const int* __restrict__ pos,
               const int* __restrict__ ptr, S* __restrict__ y,
               long long ndofs) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long d = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       d < ndofs; d += stride) {
    A acc = A(0);
    const int end = ptr[d + 1];
    for (int k = ptr[d]; k < end; ++k) acc += fustpu::widen<A>(v[pos[k]]);
    y[d] = fustpu::narrow<S>(acc);
  }
}

unsigned blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < 1 ? 1 : (b > (1LL << 30) ? (1LL << 30) : b));
}

template <typename T, int NF>
int gather(const void* x1, const void* x2, const void* g, void* o1, void* o2,
           long long n, void* stream) {
  if (n <= 0) return 0;
  engine_gather<T, NF><<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2),
      static_cast<const int*>(g), static_cast<T*>(o1), static_cast<T*>(o2),
      n);
  return (int)cudaGetLastError();
}

template <typename T>
int gather_quads(const void* x, const void* g, void* out, long long n,
                 int blocks, void* stream) {
  if (blocks < 1) return -1;
  if (n <= 0) return 0;
  engine_gather_quads<T><<<blocks, kGatherThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(g),
      static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

template <typename T, int MODE, int N>
int contract_n(const void* u1, const void* u2, const void* C,
               const void* coeff, const void* G, const void* D, void* y,
               long long cells, cudaStream_t stream) {
  using S = fustpu::Shape<T, N>;
  if (cells <= 0) return 0;
  const dim3 block(S::NN, S::CPB);
  const unsigned blocks = (unsigned)((cells + S::CPB - 1) / S::CPB);
  engine_contract<T, N, MODE><<<blocks, block, 0, stream>>>(
      static_cast<const T*>(u1), static_cast<const T*>(u2),
      static_cast<const T*>(C), static_cast<const T*>(coeff),
      static_cast<const T*>(G), static_cast<const T*>(D),
      static_cast<T*>(y), cells);
  return (int)cudaGetLastError();
}

// The float32 / float64 forms (T) and the bfloat16 one (BF16 true) of the
// contraction at degree N - 1.
template <typename T, bool BF16, int MODE, int N>
struct ContractN {
  static int run(const void* u1, const void* u2, const void* C,
                 const void* coeff, const void* G, const void* D, void* y,
                 long long cells, cudaStream_t stream) {
    if constexpr (BF16) {
      using S = fustpu::Shape<float, N>;
      if (cells <= 0) return 0;
      const dim3 block(S::NN, S::CPB);
      const unsigned blocks = (unsigned)((cells + S::CPB - 1) / S::CPB);
      engine_contract_bf16<N, MODE><<<blocks, block, 0, stream>>>(
          static_cast<const bf16*>(u1), static_cast<const bf16*>(u2),
          static_cast<const bf16*>(C), static_cast<const bf16*>(coeff),
          static_cast<const bf16*>(G), static_cast<const bf16*>(D),
          static_cast<bf16*>(y), cells);
      return (int)cudaGetLastError();
    } else {
      return contract_n<T, MODE, N>(u1, u2, C, coeff, G, D, y, cells,
                                    stream);
    }
  }
};

template <typename T, bool BF16, int MODE>
int contract_mode(int P, const void* u1, const void* u2, const void* C,
                  const void* coeff, const void* G, const void* D, void* y,
                  long long cells, cudaStream_t s) {
#define FUSTPU_CASE(P_)                                                   \
  case P_:                                                                \
    return ContractN<T, BF16, MODE, P_ + 1>::run(u1, u2, C, coeff, G, D, \
                                                 y, cells, s);
  switch (P) {
    FUSTPU_CASE(2)
    FUSTPU_CASE(3)
    FUSTPU_CASE(4)
    FUSTPU_CASE(5)
    FUSTPU_CASE(6)
    FUSTPU_CASE(7)
    FUSTPU_CASE(8)
    FUSTPU_CASE(9)
    FUSTPU_CASE(10)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

template <typename T, bool BF16 = false>
int contract(int mode, int P, const void* u1, const void* u2, const void* C,
             const void* coeff, const void* G, const void* D, void* y,
             long long cells, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case PLAIN:
      return contract_mode<T, BF16, PLAIN>(P, u1, u2, C, coeff, G, D, y,
                                           cells, s);
    case COEFF:
      return contract_mode<T, BF16, COEFF>(P, u1, u2, C, coeff, G, D, y,
                                           cells, s);
    case PAIR:
      return contract_mode<T, BF16, PAIR>(P, u1, u2, C, coeff, G, D, y,
                                          cells, s);
    default:
      return -2;
  }
}

template <typename A, typename S>
int scatter(const void* v, const void* pos, const void* ptr, void* y,
            long long ndofs, void* stream) {
  if (ndofs <= 0) return 0;
  engine_scatter<A, S><<<blocks_for(ndofs), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(ptr), static_cast<S*>(y), ndofs);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points.  Each returns 0, -1 for an unsupported degree or grid,
// -2 for an unknown contraction mode, or the cudaError_t of the launch.
// g, pos: int32 positions and dofs; ptr: (ndofs + 1) int32 offsets into pos;
// the single-field gather's g and out 16 B-aligned, on `blocks` blocks.
// The float32 / float64 contraction accumulates into y2, which the caller
// zeroes, the bfloat16 one stores y2; mode 0 is unit coefficients, 1 the
// per-cell coeff (cells,), 2 the pair fold with C (cells, 2) and the
// second field u2.  The bfloat16 forms take and give bfloat16 arrays
// throughout (x, x2, u2, y2, y, G, D, coeff, C).
extern "C" {

int fustpu_engine_gather_f32(const void* x, const void* g, void* out,
                             long long n, int blocks, void* stream) {
  return gather_quads<float>(x, g, out, n, blocks, stream);
}

int fustpu_engine_gather_f64(const void* x, const void* g, void* out,
                             long long n, int blocks, void* stream) {
  return gather_quads<double>(x, g, out, n, blocks, stream);
}

int fustpu_engine_gather_bf16(const void* x, const void* g, void* out,
                              long long n, int blocks, void* stream) {
  return gather_quads<bf16>(x, g, out, n, blocks, stream);
}

int fustpu_engine_gather_flat_f32(const void* x, const void* g, void* out,
                                  long long n, void* stream) {
  return gather<float, 1>(x, nullptr, g, out, nullptr, n, stream);
}

int fustpu_engine_gather_flat_f64(const void* x, const void* g, void* out,
                                  long long n, void* stream) {
  return gather<double, 1>(x, nullptr, g, out, nullptr, n, stream);
}

int fustpu_engine_gather2_f32(const void* x1, const void* x2, const void* g,
                              void* o1, void* o2, long long n,
                              void* stream) {
  return gather<float, 2>(x1, x2, g, o1, o2, n, stream);
}

int fustpu_engine_gather2_f64(const void* x1, const void* x2, const void* g,
                              void* o1, void* o2, long long n,
                              void* stream) {
  return gather<double, 2>(x1, x2, g, o1, o2, n, stream);
}

int fustpu_engine_gather2_bf16(const void* x1, const void* x2, const void* g,
                               void* o1, void* o2, long long n,
                               void* stream) {
  return gather<bf16, 2>(x1, x2, g, o1, o2, n, stream);
}

int fustpu_engine_contract_f32(const void* u1, const void* u2, const void* C,
                               const void* coeff, const void* G,
                               const void* D, void* y, long long cells,
                               int P, int mode, void* stream) {
  return contract<float>(mode, P, u1, u2, C, coeff, G, D, y, cells, stream);
}

int fustpu_engine_contract_f64(const void* u1, const void* u2, const void* C,
                               const void* coeff, const void* G,
                               const void* D, void* y, long long cells,
                               int P, int mode, void* stream) {
  return contract<double>(mode, P, u1, u2, C, coeff, G, D, y, cells, stream);
}

// the first bfloat16 designs of the contraction and the scatter, kept as
// the comparison of engine_bf16.cu's (cen.contract_cells, cen.scatter_dofs)
int fustpu_engine_contract_cells_bf16(const void* u1, const void* u2,
                                      const void* C, const void* coeff,
                                      const void* G, const void* D, void* y,
                                      long long cells, int P, int mode,
                                      void* stream) {
  return contract<float, true>(mode, P, u1, u2, C, coeff, G, D, y, cells,
                               stream);
}

int fustpu_engine_scatter_f32(const void* v, const void* pos, const void* ptr,
                              void* y, long long ndofs, void* stream) {
  return scatter<float, float>(v, pos, ptr, y, ndofs, stream);
}

int fustpu_engine_scatter_f64(const void* v, const void* pos, const void* ptr,
                              void* y, long long ndofs, void* stream) {
  return scatter<double, double>(v, pos, ptr, y, ndofs, stream);
}

int fustpu_engine_scatter_dofs_bf16(const void* v, const void* pos,
                                    const void* ptr, void* y,
                                    long long ndofs, void* stream) {
  return scatter<float, bf16>(v, pos, ptr, y, ndofs, stream);
}

}  // extern "C"
