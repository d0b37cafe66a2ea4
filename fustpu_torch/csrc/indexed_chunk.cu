// Indexed stiffness apply on the main path, y = sum_cells P_c^T D^T (c G)
// D P_c x, for GLL spectral hexahedra of degree P = 2..10 (N = P + 1) on
// any conforming hex mesh, walked in chunks of consecutive cells: the
// chunked indexed kernel, single field and pair.
//
// Replaces the Pallas TPU kernel fustpu/ops/pallas_gather.py:
// _mk_fused_kernel (:1417), through fused_apply (:1546; 'plain' and
// 'coeff', the coefficient folded into G on the host) -> PAIR false, and
// fused_apply_pair (:1560; y = A_c1(x1) + A_c2(x2), unit G, per-cell (c1,
// c2)) -> PAIR true.  The class-launch design of the same kernels
// (indexed.cu: scattered cells of a colour class in one launch, G and the
// dofmap read by the threads themselves) keeps its entry points there.
//
// What bounds it on an H100: its bytes.  At the bodyfit H131 bowl
// (102,400 cells, 6,661,697 dofs, P = 4, float32) an apply must move at
// least G 307,200,000 B, x 26,646,788 B, y written 26,646,788 B and the
// dofmap 51,200,000 B: 411,693,576 B (pair 439,159,564 B).
//
// What the design does.  A general mesh has no pencils, but its cells are
// in `locality_order`, so CPB consecutive cells are a compact blob whose G
// ((cells, 6, N^3) in cell order) is one contiguous run.
//   1. Chunks of CPB consecutive cells, coloured as chunks: the host
//      (ops/cuda_indexed.py `chunk_schedule`) colours the chunks greedily
//      so that no two chunks of a class share a dof, and one launch of a
//      persistent grid walks each class's chunks (block b: chunks b, b +
//      gridDim.x, ...).
//   2. G by bulk copy into a ring of STAGES shared stages on mbarriers,
//      with the pencil kernel's 16 B-widened spans (bulk_copy.cuh); the
//      body's f1, f2 of a node overwrite its G components 0 and 1 there.
//      The next chunk's G is in flight while a chunk contracts; the
//      cells' node sums go into component 2 (`GShared::put`), and a
//      stage is refilled once they are summed.
//   3. x and y through a chunk-local table built on the host: the chunk's
//      unique dofs (int32, ascending), and its inverse map, for each
//      unique dof the chunk's (cell, node) positions lc N^3 + node that
//      hold it, in ascending order (int16 positions and int16 ends, the
//      engine's ptr / pos per chunk).  Each thread loads its share of the
//      next chunk's unique dofs' x (x2 for the pair), the y that earlier
//      classes left there, the next chunk's inverse map and the unique
//      ids of the chunk after it into registers before the body, so that
//      their latency hides behind it, and writes them to shared memory
//      after it.  The unique x goes to every position that holds it (for
//      the pair u = c1 x1 + c2 x2 with the position's cell's c), the
//      cells' body stores each node's sum in the stage, and each unique
//      dof then sums its positions in the inverse map's order and stores
//      y[dof] = (y that earlier classes left) + that sum, once.
// The scatter is deterministic without atomics: the chunks of a class are
// dof-disjoint, and the class order and the inverse map's order fix every
// dof's order of adds whichever block runs a chunk, so two applies are
// bitwise equal.  The sum order is not the class-launch kernel's.
//
// No tensor cores, accumulators in the template type (as in the pencil
// kernel: bound by bytes, and TF32 would break the float32 gate of 1e-6).
//
// bfloat16 (the JAX package's --dtype bf16): x, x2, y, G, D and C stored
// in bfloat16 (S), everything else float (T), as in the pencil kernel.  A
// float f1, f2 or node sum does not fit a bfloat16 node's slot of the
// stage, so the cells' f1, f2 take 2 N^3 floats a cell slot of their own
// after the (c1, c2) buffers, and each node's sum goes, as a float, over
// the cell's G components 0 and 1 in the stage (`GShared::put`: free once
// the body's barrier after its metric reads has passed), so that a unique
// dof's positions within a chunk are summed in float and rounded once,
// when y is stored.  Each later class that adds to the dof reads that y
// back as bfloat16 and rounds again: a dof shared by chunks of k classes
// carries k roundings (k up to the class count: 8 on the P = 4 bowls, 9-12
// on small general meshes), a dof inside one chunk one.  The f1, f2 slots cost 8 N^3 B a cell (1,000 B at P = 4) and the
// stage halves (a cell 12 N^3 B in place of 24 N^3), so a chunk's shared
// bytes shrink: the cells a chunk stay bounded by the threads (256 / N^2).
//
// Shared memory per block (the host computes the same, cuda_indexed.py
// `chunk_smem`): D (N^2 values, static), and dynamic: STAGES mbarriers, a
// ring of RING table rows, STAGES stages of stage_bytes (CPB cells of G
// plus 16 B), the cells' u (N^3 values a cell), two buffers of the
// chunk's earlier y (maxu values, maxu the most unique dofs of a chunk),
// for the pair two of the cells' (c1, c2), in bfloat16 the cells' f1, f2
// (2 N^3 values a cell), a ring of three chunks' unique ids (maxu int32),
// and two buffers each of the inverse map's ends (maxu int16) and
// positions (CPB N^3 int16).  Values in the arithmetic type.

#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "sum_factor.cuh"

namespace {

using namespace fustpu;

// The chunk table, one row of ROW int64 a chunk: first cell, cells, byte
// offset of the aligned span in G, span bytes, the chunk's first entry in
// the unique-dof table and its unique dofs.  A class's chunks are `count`
// consecutive rows from `first`.
constexpr int ROW = 6;
// The block's copy of the rows of chunks q - 1 .. q + 2 while it works on
// chunk q, and of the unique ids of chunks q - 1 .. q + 1.
constexpr int RING = 4;
constexpr int ID_RING = 3;
constexpr int STAGES = 2;
constexpr int MAX_SMEM = 232448;   // one block's shared memory on Hopper

__host__ __device__ constexpr int round16(int b) { return (b + 15) / 16 * 16; }
__host__ __device__ constexpr int head_bytes() {
  return round16(8 * STAGES) + round16(8 * RING * ROW);
}

// The body's line functor, which STAGED_STORE does not call (its sums go
// into the stage through GShared::put).
struct NoLine {
  __device__ int operator()(int) const { return 0; }
};

template <typename T, int N, bool PAIR, typename S>
__global__ void __launch_bounds__(256)
chunk_kernel(const S* __restrict__ x1, const S* __restrict__ x2,
             const S* __restrict__ C, const S* __restrict__ G,
             const S* __restrict__ D, S* __restrict__ y,
             const long long* __restrict__ chunks,
             const int* __restrict__ uniq, const short* __restrict__ ends,
             const short* __restrict__ pos, long long first, int count,
             int stage_bytes, int maxu) {
  constexpr int NN = N * N, NNN = N * N * N;
  constexpr long long CB = 6LL * NNN * (long long)sizeof(S);  // G per cell
  using Metric = GShared<T, N, S>;
  __shared__ T Ds[NN];                           // D[q * N + i] = l_i'(x_q)
  extern __shared__ __align__(128) unsigned char smem[];
  const int cpb = blockDim.y;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  long long* rs = reinterpret_cast<long long*>(smem + round16(8 * STAGES));
  unsigned char* ring = smem + head_bytes();
  T* ub = reinterpret_cast<T*>(ring + (long long)STAGES * stage_bytes);
  T* ysb = ub + cpb * NNN;                       // 2 x maxu: earlier y
  T* cb = ysb + 2 * maxu;                        // 2 x 2 cpb: (c1, c2)
  T* fb = cb + (PAIR ? 4 * cpb : 0);             // WIDE: cpb x 2 N^3 f1, f2
  int* uidb = reinterpret_cast<int*>(fb + (Metric::WIDE ? 2 * cpb * NNN : 0));
  short* endb = reinterpret_cast<short*>(uidb + ID_RING * maxu);
  short* posb = endb + 2 * maxu;                 // 2 x cpb N^3
  const int t = threadIdx.x, lc = threadIdx.y;   // node line (j, k), cell
  const int tid = lc * NN + t, nthreads = NN * cpb;

  // chunks this block walks, in order: the q-th is row first + b + q grid
  const int mine = (count - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  auto table = [&](int q) {
    return chunks + ROW * (first + blockIdx.x + (long long)q * gridDim.x);
  };
  auto row = [&](int q) { return rs + (q % RING) * ROW; };
  auto uid = [&](int q) { return uidb + (q % ID_RING) * maxu; };
  auto issue = [&](int q) {                      // thread 0: G of chunk q
    const long long* r = row(q);
    const int s = q % STAGES;
    mbar_expect_tx(&bars[s], (unsigned)r[3]);
    bulk_load(ring + (long long)s * stage_bytes,
              reinterpret_cast<const unsigned char*>(G) + r[2],
              (unsigned)r[3], &bars[s]);
  };

  // A thread's share of a chunk: unique slots and positions tid + e
  // nthreads, e < N (a chunk has at most CPB N^3 of each).  The next
  // chunk's inputs go through these registers: fetched before the body,
  // written to shared memory after it; x (and x2) stay here, as stored,
  // until the chunk's u is built from them.
  S xr[N], x2r[N], yr[N], cr{};
  int idr[N];
  short er[N], pr[N];
  long long rowr = 0;
  auto fetch = [&](int q) {
    const long long* r = row(q);
    const int n = (int)r[1], nu = (int)r[5];
    const long long c0 = r[0], u0 = r[4];
    const int* uq = uid(q);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int s = tid + e * nthreads;
      if (s < nu) {
        const int id = uq[s];
        xr[e] = x1[id];
        if (PAIR) x2r[e] = x2[id];
        yr[e] = y[id];
        er[e] = ends[u0 + s];
      }
      if (s < n * NNN) pr[e] = pos[c0 * NNN + s];
    }
    if (PAIR && tid < 2 * n) cr = C[2 * c0 + tid];
    if (q + 1 < mine) {
      const long long* r1 = row(q + 1);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int s = tid + e * nthreads;
        if (s < (int)r1[5]) idr[e] = uniq[r1[4] + s];
      }
    }
    if (q + 2 < mine && tid < ROW) rowr = table(q + 2)[tid];
  };
  auto put = [&](int q) {
    const long long* r = row(q);
    const int n = (int)r[1], nu = (int)r[5], b = q & 1;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int s = tid + e * nthreads;
      if (s < nu) {
        ysb[b * maxu + s] = widen<T>(yr[e]);
        endb[b * maxu + s] = er[e];
      }
      if (s < n * NNN) posb[b * cpb * NNN + s] = pr[e];
    }
    if (PAIR && tid < 2 * n) cb[b * 2 * cpb + tid] = widen<T>(cr);
    if (q + 1 < mine) {
      const int nu1 = (int)row(q + 1)[5];
      int* uq = uid(q + 1);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int s = tid + e * nthreads;
        if (s < nu1) uq[s] = idr[e];
      }
    }
    if (q + 2 < mine && tid < ROW) row(q + 2)[tid] = rowr;
  };
  // chunk q's u: each unique x into every position that holds it
  auto build_u = [&](int q) {
    const int nu = (int)row(q)[5], b = q & 1;
    const short* en = endb + b * maxu;
    const short* ps = posb + b * cpb * NNN;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int s = tid + e * nthreads;
      if (s < nu) {
        for (int p = s ? en[s - 1] : 0; p < en[s]; ++p) {
          const int at = ps[p];
          if (PAIR) {
            const int c = at / NNN;
            ub[at] = cb[b * 2 * cpb + 2 * c] * widen<T>(xr[e]) +
                     cb[b * 2 * cpb + 2 * c + 1] * widen<T>(x2r[e]);
          } else {
            ub[at] = widen<T>(xr[e]);
          }
        }
      }
    }
  };
  // chunk q's y out: each unique dof's positions summed in the inverse
  // map's order (the node sums the body put over the cells' G in the
  // chunk's stage, Metric::SUM_AT on in each cell's CELL_T values), added
  // once to what earlier classes left
  auto sum = [&](int q) {
    const long long* r = row(q);
    const int nu = (int)r[5], b = q & 1;
    const short* en = endb + b * maxu;
    const short* ps = posb + b * cpb * NNN;
    const int* uq = uid(q);
    const T* y2 = reinterpret_cast<const T*>(
        ring + (long long)(q % STAGES) * stage_bytes + (r[0] * CB - r[2])) +
        Metric::SUM_AT;
    for (int s = tid; s < nu; s += nthreads) {
      T acc = T(0);
      for (int p = s ? en[s - 1] : 0; p < en[s]; ++p) {
        const int at = ps[p];
        acc += y2[(at / NNN) * Metric::CELL_T + at % NNN];
      }
      y[uq[s]] = narrow<S>(ysb[b * maxu + s] + acc);
    }
  };

  for (int s = tid; s < NN; s += nthreads) Ds[s] = widen<T>(D[s]);
  if (tid < ROW) row(0)[tid] = table(0)[tid];
  if (mine > 1 && tid >= ROW && tid < 2 * ROW)
    row(1)[tid - ROW] = table(1)[tid - ROW];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bars[s], 1);
    mbar_init_fence();
  }
  __syncthreads();                   // D, rows 0 and 1, the mbarriers
  for (int s = tid; s < (int)row(0)[5]; s += nthreads)
    uid(0)[s] = uniq[row(0)[4] + s];
  __syncthreads();                   // chunk 0's unique ids
  fetch(0);
  put(0);
  __syncthreads();                   // chunk 0's inputs, row 2, chunk 1's ids
  if (tid == 0)
    for (int q = 0; q < min(STAGES, mine); ++q) issue(q);

  for (int q = 0; q < mine; ++q) {
    const long long* r = row(q);
    const long long cell0 = r[0], off = r[2];
    const int n = (int)r[1];
    const int s = q % STAGES;
    unsigned char* stage = ring + (long long)s * stage_bytes;
    read_span_tail(stage, G, (cell0 + n) * CB, off, r[3], tid, nthreads);
    mbar_wait(&bars[s], (unsigned)((q / STAGES) & 1));
    __syncthreads();                 // the chunk's G arrived, its inputs
                                     // are in place, the last chunk's
                                     // sums are read
    // no one reads or writes the last chunk's stage again (every thread
    // fenced its f1, f2 and node-sum writes there): refill it, STAGES
    // chunks ahead
    if (tid == 0 && q > 0 && q - 1 + STAGES < mine) issue(q - 1 + STAGES);
    build_u(q);
    if (q + 1 < mine) fetch(q + 1);
    __syncthreads();                 // u in place

    S* Gc = reinterpret_cast<S*>(stage + (cell0 * CB - off)) + lc * 6 * NNN;
    T* f1 = Metric::WIDE ? fb + 2 * NNN * lc : reinterpret_cast<T*>(Gc);
    cell_apply<T, N, false, STAGED_STORE>(
        static_cast<const T*>(nullptr), static_cast<const T*>(nullptr), T(1),
        T(0), Metric{Gc}, Ds, ub + lc * NNN, f1, f1 + NNN,
        static_cast<T*>(nullptr), lc < n, NoLine{});
    if (q + 1 < mine) put(q + 1);
    fence_proxy_async();             // f1, f2, the sums before the refill
    __syncthreads();                 // the chunk's sums are complete
    sum(q);
  }
}

template <typename T, int N, bool PAIR, typename S>
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, chunk_kernel<T, N, PAIR, S>);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(chunk_kernel<T, N, PAIR, S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM - (int)attr.sharedSizeBytes);
  done = err == cudaSuccess;
  return err;
}

template <typename T, typename S, bool PAIR, int N>
int launch_n(const void* x1, const void* x2, const void* C, const void* G,
             const void* D, void* y, const void* chunks, const void* uniq,
             const void* ends, const void* pos, const long long* classes,
             int nclass, int blocks, int cpb, int stage_bytes, int smem,
             int maxu, cudaStream_t stream) {
  cudaError_t err = allow_smem<T, N, PAIR, S>();
  if (err != cudaSuccess) return (int)err;
  const dim3 block(N * N, cpb);
  for (int c = 0; c < nclass; ++c) {
    const long long first = classes[2 * c], count = classes[2 * c + 1];
    if (count <= 0) continue;
    const unsigned grid = (unsigned)(count < blocks ? count : blocks);
    chunk_kernel<T, N, PAIR, S><<<grid, block, smem, stream>>>(
        static_cast<const S*>(x1), static_cast<const S*>(x2),
        static_cast<const S*>(C), static_cast<const S*>(G),
        static_cast<const S*>(D), static_cast<S*>(y),
        static_cast<const long long*>(chunks), static_cast<const int*>(uniq),
        static_cast<const short*>(ends), static_cast<const short*>(pos),
        first, (int)count, stage_bytes, maxu);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, typename S, bool PAIR, int N>
int occupancy_n(int cpb, int smem) {
  cudaError_t err = allow_smem<T, N, PAIR, S>();
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, chunk_kernel<T, N, PAIR, S>, N * N * cpb, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

#define FUSTPU_DEGREES(M) \
  M(2) M(3) M(4) M(5) M(6) M(7) M(8) M(9) M(10)

template <typename T, typename S, bool PAIR>
int launch(int P, const void* x1, const void* x2, const void* C,
           const void* G, const void* D, void* y, const void* chunks,
           const void* uniq, const void* ends, const void* pos,
           const long long* classes, int nclass, int blocks, int cpb,
           int stage_bytes, int smem, int maxu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSTPU_CASE(P_)                                                     \
  case P_:                                                                  \
    return launch_n<T, S, PAIR, P_ + 1>(x1, x2, C, G, D, y, chunks, uniq,   \
                                        ends, pos, classes, nclass, blocks, \
                                        cpb, stage_bytes, smem, maxu, s);
  switch (P) {
    FUSTPU_DEGREES(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

template <typename T, typename S, bool PAIR>
int occupancy(int P, int cpb, int smem) {
#define FUSTPU_CASE(P_) \
  case P_:              \
    return occupancy_n<T, S, PAIR, P_ + 1>(cpb, smem);
  switch (P) {
    FUSTPU_DEGREES(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

}  // namespace

// C entry points.  Each launcher returns 0, -1 for an unsupported degree,
// or the cudaError_t of the first failed call; y must be zeroed by the
// caller.  chunks: (rows, 6) int64, uniq: int32, ends: int16 (one per
// unique dof of each chunk), pos: (cells N^3,) int16, all on the device;
// classes: nclass x 2 int64 (first row, chunks) on the host.
extern "C" {

#define FUSTPU_CHUNK(SUF, T, S)                                               \
  int fustpu_indexed_chunk_##SUF(                                             \
      const void* x, const void* G, const void* D, void* y, int P,            \
      const void* chunks, const void* uniq, const void* ends,                 \
      const void* pos, const long long* classes, int nclass, int blocks,      \
      int cpb, int stage_bytes, int smem, int maxu, void* stream) {           \
    return launch<T, S, false>(P, x, nullptr, nullptr, G, D, y, chunks, uniq, \
                               ends, pos, classes, nclass, blocks, cpb,       \
                               stage_bytes, smem, maxu, stream);              \
  }                                                                           \
  int fustpu_indexed_chunk_pair_##SUF(                                        \
      const void* x1, const void* x2, const void* C, const void* G,           \
      const void* D, void* y, int P, const void* chunks, const void* uniq,    \
      const void* ends, const void* pos, const long long* classes,            \
      int nclass, int blocks, int cpb, int stage_bytes, int smem, int maxu,   \
      void* stream) {                                                         \
    return launch<T, S, true>(P, x1, x2, C, G, D, y, chunks, uniq, ends, pos, \
                              classes, nclass, blocks, cpb, stage_bytes,      \
                              smem, maxu, stream);                            \
  }

FUSTPU_CHUNK(f32, float, float)
FUSTPU_CHUNK(f64, double, double)
FUSTPU_CHUNK(bf16, float, __nv_bfloat16)
#undef FUSTPU_CHUNK

// Blocks of the kernel for (P, type, pair?) with cpb cells and smem dynamic
// shared bytes that one SM holds at once; type 0 float32, 1 float64, 2
// bfloat16; -1 for an unsupported degree, minus the cudaError_t of a
// failed query.
int fustpu_indexed_chunk_occupancy(int P, int type, int pair, int cpb,
                                   int smem) {
  if (type == 1)
    return pair ? occupancy<double, double, true>(P, cpb, smem)
                : occupancy<double, double, false>(P, cpb, smem);
  if (type == 2)
    return pair ? occupancy<float, __nv_bfloat16, true>(P, cpb, smem)
                : occupancy<float, __nv_bfloat16, false>(P, cpb, smem);
  return pair ? occupancy<float, float, true>(P, cpb, smem)
              : occupancy<float, float, false>(P, cpb, smem);
}

}  // extern "C"
