// The bfloat16 chunked indexed stiffness apply redesigned for Hopper (the
// "lean chunk kernel"): the main path's kernel of #11 on a bfloat16
// operator, single field and pair, for GLL hexahedra of degree P on any
// conforming hex mesh.  indexed_chunk.cu keeps the float32 and float64
// kernels and the first bfloat16 form, chunk_kernel<float, N, PAIR,
// __nv_bfloat16>, as the comparison (ops/cuda_indexed.py `indexed_first`).
//
// Replaces, in bfloat16, the Pallas TPU kernel fustpu/ops/pallas_gather.py:
// _mk_fused_kernel (:1417), through fused_apply (:1546; 'plain' and
// 'coeff', the coefficient folded into G on the host) -> PAIR false, and
// fused_apply_pair (:1560; y = A_c1(x1) + A_c2(x2), unit G, per-cell (c1,
// c2)) -> PAIR true.
//
// What bounds it on an H100.  At the bodyfit bowl (102,400 cells, 6,661,697
// dofs, P = 4) an apply must move at least 231,446,788 B in bfloat16
// (0.0691 ms at 3.35 TB/s); the first bfloat16 form takes four times that.
// Timed with one part removed (tools/chunk_split.py), its body is a fifth
// of an apply and its bookkeeping (the scatter of u, the sums, the x / y
// loads) a quarter; the rest is latency: each of the 8 colour classes is a
// launch of its own in which a block walks about two chunks, so a class's
// start (the launch, the first G, the rows, ids and tables before any x or
// y) and its drain show in every class.  The lean z-pencil walk's body (D
// by value with rows in registers, rows padded for float4 reads) measured
// slower here: its registers cost the blocks an SM that hide that latency.
//
// What this kernel does, keeping the first design's schedule (its cells a
// chunk, chunk table, unique-dof tables and colour classes, so that each
// dof is rounded as often: ops/cuda_indexed.py `ChunkPlan`) and its body:
//   1. The class launches overlap (programmatic dependent launch): each
//      class's kernel lets the next start at once, and the next issues its
//      first chunks' G and reads its rows, unique ids, x and tables, and
//      waits (griddepcontrol.wait) for the earlier class to end only before
//      it reads y (no class writes x, G or the tables).
//   2. A dof's first class (the lowest colour of the chunks that hold it,
//      the host's flag in bit 15 of `lead_ends`) takes the 0 that the first
//      design reads from the zeroed y without reading y: most dofs lie in
//      one chunk, so most y reads and the zeroing of y go (the wrapper
//      allocates y uninitialised when the cells hold every dof).
//   3. The first chunks' G copies issued before anything else is read, D
//      by value (a kernel parameter, into shared memory without a global
//      read).
//   4. Three barriers a chunk in place of five: u is built before the
//      chunk's arrival barrier (the last body read it before its second
//      barrier), and the body's barrier after its u loads goes (u is
//      complete at the arrival barrier).
//   5. A register cap of 96 (FUSTPU_LEAN_CHUNK_MAXREG): five blocks of 5
//      cells an SM at P = 4, as the first design runs.
//   u is built by the first design's scatter through the inverse map: a
//   gather through a host-built position-to-slot table measured slower
//   (its pair spills under the cap; PERF.md §6).
// Every node's sum is the first design's, term by term and in the same
// order (the body is cell_apply's, the same float D), each unique dof sums
// its positions in the inverse map's order from 0.0f and adds the y that
// earlier classes left (0 in its first class, as the first design reads
// it), rounding once where it stores.  So on the same chunks and classes
// the output is bitwise the first design's, and two applies are bitwise
// equal (no atomics).
//
// Shared memory per block (the first design's: the host computes the same,
// cuda_indexed.py `chunk_smem`, and the launcher checks it): D (N^2 floats,
// static),
// and dynamic: STAGES mbarriers and a ring of RING table rows (each padded
// to 16 B), STAGES stages of stage_bytes (cpb cells of bfloat16 G and 16 B
// for the aligned span; the node sums go over G there), then floats: the
// cells' u, f1 and f2 (N^3 a cell each), two buffers of the y that earlier
// classes left (maxu), for the pair two of the cells' (c1, c2); then a ring
// of ID_RING chunks' unique ids (maxu int32), two buffers of the inverse
// map's ends (maxu int16) and positions (cpb N^3 int16): the first
// design's layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "pencil_lean.cuh"

// The degrees at which a bfloat16 apply on a general mesh runs the lean
// chunk kernel, single field and pair (ops/cuda_indexed.py `LEAN_BF16`:
// where it measured faster than the first design); at the others the entry
// points return -1.
#define FUSTPU_LEAN_CHUNK_SINGLE(M) M(3) M(4)
#define FUSTPU_LEAN_CHUNK_PAIR(M) M(2) M(3) M(4)

namespace {

using namespace fustpu;
using fustpu::pencil::lean::DMat;
using bf16 = __nv_bfloat16;

// The chunk table's rows (ROW int64 a chunk, indexed_chunk.cu's), the ring
// of rows and of unique ids a block keeps, the G ring's stages.
constexpr int ROW = 6;
constexpr int RING = 4;
constexpr int ID_RING = 3;
constexpr int STAGES = 2;
constexpr int MAX_SMEM = 232448;   // one block's shared memory on Hopper
constexpr int MAXT = 256;          // the most threads a schedule's block has
// The register cap: 96 registers a thread, so that at P = 4 five blocks of
// 4 warps share an SM's 65,536 (uncapped, the compiler takes 128).
#define FUSTPU_LEAN_CHUNK_MAXREG 96
constexpr short LEAD = -32768;     // `lead_ends`: the dof's first class

__host__ __device__ constexpr int round16(int b) { return (b + 15) / 16 * 16; }
__host__ __device__ constexpr int head_bytes() {
  return round16(8 * STAGES) + round16(8 * RING * ROW);
}

// The dynamic shared bytes a block of cpb cells needs (the layout above).
template <int N, bool PAIR>
__host__ __device__ constexpr long long smem_bytes(int cpb, int maxu,
                                                   int stage_bytes) {
  constexpr long long NNN = N * N * N;
  return head_bytes() + (long long)STAGES * stage_bytes +
         4LL * (3 * cpb * NNN + 2LL * maxu + (PAIR ? 4LL * cpb : 0)) +
         4LL * ID_RING * maxu + 2LL * 2 * maxu + 2LL * 2 * cpb * NNN;
}

template <int N, bool PAIR>
__global__ void __maxnreg__(FUSTPU_LEAN_CHUNK_MAXREG)
lean_chunk_kernel(const bf16* __restrict__ x1, const bf16* __restrict__ x2,
                  const bf16* __restrict__ C, const bf16* __restrict__ G,
                  const __grid_constant__ DMat<N> D, bf16* __restrict__ y,
                  const long long* __restrict__ chunks,
                  const int* __restrict__ uniq,
                  const short* __restrict__ lead_ends,
                  const short* __restrict__ pos, long long first,
                  int count, int stage_bytes, int maxu) {
  constexpr int NN = N * N, NNN = N * N * N;
  constexpr long long CB = 6LL * NNN * (long long)sizeof(bf16);
  using Metric = GShared<float, N, bf16>;
  // the next class's kernel may start now: it waits for this one to end
  // before it reads y
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  __shared__ float Ds[NN];                       // D[q * N + i] = l_i'(x_q)
  extern __shared__ __align__(128) unsigned char smem[];
  const int cpb = blockDim.y;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  long long* rs = reinterpret_cast<long long*>(smem + round16(8 * STAGES));
  unsigned char* ring = smem + head_bytes();
  float* ub = reinterpret_cast<float*>(ring + (long long)STAGES * stage_bytes);
  float* fb = ub + cpb * NNN;                    // f1, f2: 2 N^3 a cell
  float* ysb = fb + 2 * cpb * NNN;               // 2 x maxu: earlier y
  float* cb = ysb + 2 * maxu;                    // 2 x 2 cpb: (c1, c2)
  int* uidb = reinterpret_cast<int*>(cb + (PAIR ? 4 * cpb : 0));
  short* endb = reinterpret_cast<short*>(uidb + ID_RING * maxu);
  short* posb = endb + 2 * maxu;                 // 2 x cpb N^3
  const int t = threadIdx.x, lc = threadIdx.y;   // node line (j, k), cell
  const int tid = lc * NN + t, nthreads = NN * cpb;
  const int j = t / N, k = t % N;

  // chunks this block walks, in order: the q-th is row first + b + q grid
  const int mine = (count - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  auto table = [&](int q) {
    return chunks + ROW * (first + blockIdx.x + (long long)q * gridDim.x);
  };
  auto row = [&](int q) { return rs + (q % RING) * ROW; };
  auto uid = [&](int q) { return uidb + (q % ID_RING) * maxu; };
  auto issue = [&](int q, const long long* r) {  // thread 0: G of chunk q
    const int s = q % STAGES;
    mbar_expect_tx(&bars[s], (unsigned)r[3]);
    bulk_load(ring + (long long)s * stage_bytes,
              reinterpret_cast<const unsigned char*>(G) + r[2],
              (unsigned)r[3], &bars[s]);
  };

  // A thread's share of a chunk: unique slots and positions tid + e
  // nthreads, e < N (a chunk has at most cpb N^3 of each).  The next
  // chunk's inputs go through these registers: fetched before the body,
  // written to shared memory after it (x, x2 stay here until the scatter).
  bf16 xr[N], x2r[N], yr[N], cr{};
  short er[N], pr[N];
  int idr[N];
  long long rowr = 0;
  // chunk q's inputs (its row r, its unique ids ids), the unique ids of
  // chunk q + 1 and the row of chunk q + 2; a dof's first class reads no
  // y.  `gate`: wait for the earlier class to end before reading y.
  auto fetch = [&](int q, const long long* r, const int* ids, bool gate) {
    const int n = (int)r[1], nu = (int)r[5];
    const long long c0 = r[0], u0 = r[4];
    int idq[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int s = tid + e * nthreads;
      if (s < nu) {
        idq[e] = ids[s];
        xr[e] = x1[idq[e]];
        if (PAIR) x2r[e] = x2[idq[e]];
        er[e] = lead_ends[u0 + s];
      }
      if (s < n * NNN) pr[e] = pos[c0 * NNN + s];
    }
    if (PAIR && tid < 2 * n) cr = C[2 * c0 + tid];
    if (gate) asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int s = tid + e * nthreads;
      if (s < nu)
        yr[e] = er[e] & LEAD ? __ushort_as_bfloat16(0) : y[idq[e]];
    }
    if (q + 1 < mine) {
      const long long* r1 = q == 0 ? table(1) : row(q + 1);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int s = tid + e * nthreads;
        if (s < (int)r1[5]) idr[e] = uniq[r1[4] + s];
      }
    }
    if (q + 2 < mine && tid < ROW) rowr = table(q + 2)[tid];
  };
  auto put = [&](int q, const long long* r) {
    const int n = (int)r[1], nu = (int)r[5], b = q & 1;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int s = tid + e * nthreads;
      if (s < nu) {
        ysb[b * maxu + s] = widen<float>(yr[e]);
        endb[b * maxu + s] = er[e] & ~LEAD;
      }
      if (s < n * NNN) posb[b * cpb * NNN + s] = pr[e];
    }
    if (PAIR && tid < 2 * n) cb[b * 2 * cpb + tid] = widen<float>(cr);
    if (q + 1 < mine) {
      const int nu1 = (int)(q == 0 ? table(1) : row(q + 1))[5];
      int* uq = uid(q + 1);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int s = tid + e * nthreads;
        if (s < nu1) uq[s] = idr[e];
      }
    }
    if (q + 2 < mine && tid < ROW) row(q + 2)[tid] = rowr;
  };
  // chunk q's u: each unique x into every position that holds it (the
  // first design's scatter through the inverse map)
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
            ub[at] = cb[b * 2 * cpb + 2 * c] * widen<float>(xr[e]) +
                     cb[b * 2 * cpb + 2 * c + 1] * widen<float>(x2r[e]);
          } else {
            ub[at] = widen<float>(xr[e]);
          }
        }
      }
    }
  };
  // chunk q's y out: each unique dof's positions summed in the inverse
  // map's order (the node sums the body put over the cells' G in the
  // chunk's stage), added once to what earlier classes left
  auto sum = [&](int q) {
    const long long* r = row(q);
    const int nu = (int)r[5], b = q & 1;
    const short* en = endb + b * maxu;
    const short* ps = posb + b * cpb * NNN;
    const int* uq = uid(q);
    const float* y2 = reinterpret_cast<const float*>(
        ring + (long long)(q % STAGES) * stage_bytes + (r[0] * CB - r[2])) +
        Metric::SUM_AT;
    for (int s = tid; s < nu; s += nthreads) {
      float acc = 0.0f;
      for (int p = s ? en[s - 1] : 0; p < en[s]; ++p) {
        const int at = ps[p];
        acc += y2[(at / NNN) * Metric::CELL_T + at % NNN];
      }
      y[uq[s]] = narrow<bf16>(ysb[b * maxu + s] + acc);
    }
  };

  // the first chunks' G in flight before anything else is read; then D,
  // the rows, the unique ids, x and the tables of chunk 0, and, once the
  // earlier class has ended, its y
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bars[s], 1);
    mbar_init_fence();
    for (int q = 0; q < min(STAGES, mine); ++q) issue(q, table(q));
  }
  for (int s = tid; s < NN; s += nthreads) Ds[s] = D.d[s];
  for (int e = tid; e < min(2, mine) * ROW; e += nthreads)
    row(e / ROW)[e % ROW] = table(e / ROW)[e % ROW];
  const int* ids0 = uniq + table(0)[4];
  for (int s = tid; s < (int)table(0)[5]; s += nthreads) uid(0)[s] = ids0[s];
  fetch(0, table(0), ids0, true);
  put(0, table(0));
  __syncthreads();                   // the mbarriers, D, rows 0-2, chunk
                                     // 0's inputs and ids, chunk 1's ids

  for (int q = 0; q < mine; ++q) {
    const long long* r = row(q);
    const long long cell0 = r[0], off = r[2];
    const int n = (int)r[1];
    const bool active = lc < n;
    const int s = q % STAGES;
    unsigned char* stage = ring + (long long)s * stage_bytes;
    build_u(q);                      // u is free: the last body read it
                                     // before its second barrier
    read_span_tail(stage, G, (cell0 + n) * CB, off, r[3], tid, nthreads);
    mbar_wait(&bars[s], (unsigned)((q / STAGES) & 1));
    __syncthreads();                 // u in place, the chunk's G arrived,
                                     // the last chunk's sums are read
    // no one reads or writes the last chunk's stage again (every thread
    // fenced its node-sum writes there): refill it, STAGES chunks ahead
    if (tid == 0 && q > 0 && q - 1 + STAGES < mine)
      issue(q - 1 + STAGES, row(q - 1 + STAGES));
    if (q + 1 < mine) fetch(q + 1, row(q + 1), uid(q + 1), false);

    // the body (sum_factor.cuh cell_apply, STAGED_STORE, without its
    // barrier after the u loads: u is complete at the one above)
    const float* u = ub + lc * NNN;
    const Metric metric{reinterpret_cast<bf16*>(stage + (cell0 * CB - off)) +
                        lc * 6 * NNN};
    float* f1 = fb + 2 * NNN * lc;
    float* f2 = f1 + NNN;
    float ul[N], f0[N];
    if (active) {
#pragma unroll
      for (int i = 0; i < N; ++i) ul[i] = u[i * NN + t];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float wx = 0.0f, wy = 0.0f, wz = 0.0f;
#pragma unroll
        for (int rr = 0; rr < N; ++rr) {
          wx += Ds[i * N + rr] * ul[rr];
          wy += Ds[j * N + rr] * u[i * NN + rr * N + k];
          wz += Ds[k * N + rr] * u[i * NN + j * N + rr];
        }
        const int nd = i * NN + t;
        float a, b, c;
        metric(i, nd, wx, wy, wz, a, b, c);
        f0[i] = a;
        f1[nd] = b;
        f2[nd] = c;
      }
    }
    __syncthreads();                 // f1, f2 complete, the metric read
    if (active) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int rr = 0; rr < N; ++rr) {
          acc += Ds[rr * N + i] * f0[rr];
          acc += Ds[rr * N + j] * f1[i * NN + rr * N + k];
          acc += Ds[rr * N + k] * f2[i * NN + j * N + rr];
        }
        metric.put(i * NN + t, acc);
      }
    }
    if (q + 1 < mine) put(q + 1, row(q + 1));
    fence_proxy_async();             // the node sums before the refill
    __syncthreads();                 // the chunk's sums are complete
    sum(q);
  }
}

// ---- host side ----

template <int N, bool PAIR>
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, lean_chunk_kernel<N, PAIR>);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lean_chunk_kernel<N, PAIR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM - (int)attr.sharedSizeBytes);
  done = err == cudaSuccess;
  return err;
}

// One launch of a persistent grid per class, as indexed_chunk.cu, each
// after the first a programmatic dependent launch of the one before; D: the
// N^2 float values of D, by value.  Returns 0, -2 if smem is short of the
// layout's bytes or the block is beyond the launch bounds, or the first
// cudaError_t.
template <int N, bool PAIR>
int launch_n(const void* x1, const void* x2, const void* C, const void* G,
             const float* D, void* y, const void* chunks, const void* uniq,
             const void* lead_ends, const void* pos,
             const long long* classes, int nclass, int blocks, int cpb,
             int stage_bytes, int smem, int maxu, cudaStream_t stream) {
  if (smem < smem_bytes<N, PAIR>(cpb, maxu, stage_bytes) ||
      N * N * cpb > MAXT)
    return -2;
  cudaError_t err = allow_smem<N, PAIR>();
  if (err != cudaSuccess) return (int)err;
  DMat<N> dm;
  for (int e = 0; e < N * N; ++e) dm.d[e] = D[e];
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(N * N, cpb);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  bool after = false;                // a class of this apply launched
  for (int c = 0; c < nclass; ++c) {
    const long long first = classes[2 * c], count = classes[2 * c + 1];
    if (count <= 0) continue;
    cfg.gridDim = dim3((unsigned)(count < blocks ? count : blocks));
    cfg.numAttrs = after ? 1 : 0;
    err = cudaLaunchKernelEx(
        &cfg, lean_chunk_kernel<N, PAIR>, static_cast<const bf16*>(x1),
        static_cast<const bf16*>(x2), static_cast<const bf16*>(C),
        static_cast<const bf16*>(G), dm, static_cast<bf16*>(y),
        static_cast<const long long*>(chunks), static_cast<const int*>(uniq),
        static_cast<const short*>(lead_ends), static_cast<const short*>(pos),
        first, (int)count, stage_bytes, maxu);
    if (err != cudaSuccess) return (int)err;
    after = true;
  }
  return 0;
}

// Blocks of N^2 x cpb threads with smem dynamic shared bytes that one SM
// holds: 0 beyond the launch bounds.
template <int N, bool PAIR>
int occupancy_n(int cpb, int smem) {
  cudaError_t err = allow_smem<N, PAIR>();
  if (err != cudaSuccess) return -(int)err;
  if (N * N * cpb > MAXT) return 0;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, lean_chunk_kernel<N, PAIR>, N * N * cpb, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

template <bool PAIR>
int launch(int P, const void* x1, const void* x2, const void* C,
           const void* G, const float* D, void* y, const void* chunks,
           const void* uniq, const void* lead_ends, const void* pos,
           const long long* classes, int nclass,
           int blocks, int cpb, int stage_bytes, int smem, int maxu,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSTPU_CASE(P_)                                                      \
  case P_:                                                                   \
    return launch_n<P_ + 1, PAIR>(x1, x2, C, G, D, y, chunks, uniq,          \
                                  lead_ends, pos, classes, nclass, blocks,   \
                                  cpb, stage_bytes, smem, maxu, s);
  if constexpr (PAIR) {
    switch (P) {
      FUSTPU_LEAN_CHUNK_PAIR(FUSTPU_CASE)
      default:
        return -1;
    }
  } else {
    switch (P) {
      FUSTPU_LEAN_CHUNK_SINGLE(FUSTPU_CASE)
      default:
        return -1;
    }
  }
#undef FUSTPU_CASE
}

template <bool PAIR>
int occupancy(int P, int cpb, int smem) {
#define FUSTPU_CASE(P_) \
  case P_:              \
    return occupancy_n<P_ + 1, PAIR>(cpb, smem);
  if constexpr (PAIR) {
    switch (P) {
      FUSTPU_LEAN_CHUNK_PAIR(FUSTPU_CASE)
      default:
        return -1;
    }
  } else {
    switch (P) {
      FUSTPU_LEAN_CHUNK_SINGLE(FUSTPU_CASE)
      default:
        return -1;
    }
  }
#undef FUSTPU_CASE
}

}  // namespace

// C entry points.  Each launcher returns 0, -1 for a degree without the
// lean chunk kernel, -2 for shared bytes short of its layout or a block
// beyond its launch bounds, or the cudaError_t of the first failed call; y
// needs no zeroing where the cells cover every dof (a dof's first class
// reads none).  D: N^2 floats on the host; chunks: (rows, 6) int64, uniq:
// int32, lead_ends: int16 (one per unique dof of each chunk: its end in
// the inverse map, bit 15 set in the dof's first class), pos: (cells
// N^3,) int16, all on the device; classes: nclass x 2 int64 (first row,
// chunks) on the host.
extern "C" {

int fustpu_indexed_lean_bf16(const void* x, const void* G, const float* D,
                             void* y, int P, const void* chunks,
                             const void* uniq, const void* lead_ends,
                             const void* pos,
                             const long long* classes, int nclass,
                             int blocks, int cpb, int stage_bytes, int smem,
                             int maxu, void* stream) {
  return launch<false>(P, x, nullptr, nullptr, G, D, y, chunks, uniq,
                       lead_ends, pos, classes, nclass, blocks, cpb,
                       stage_bytes, smem, maxu, stream);
}

int fustpu_indexed_lean_pair_bf16(const void* x1, const void* x2,
                                  const void* C, const void* G,
                                  const float* D, void* y, int P,
                                  const void* chunks, const void* uniq,
                                  const void* lead_ends, const void* pos,
                                  const long long* classes, int nclass,
                                  int blocks, int cpb, int stage_bytes,
                                  int smem, int maxu, void* stream) {
  return launch<true>(P, x1, x2, C, G, D, y, chunks, uniq, lead_ends, pos,
                      classes, nclass, blocks, cpb, stage_bytes, smem, maxu,
                      stream);
}

// Blocks of the lean chunk kernel for (P, pair?) with cpb cells and smem
// dynamic shared bytes that one SM holds at once; -1 for a degree without
// the kernel, minus the cudaError_t of a failed query.
int fustpu_indexed_lean_occupancy(int P, int pair, int cpb, int smem) {
  return pair ? occupancy<true>(P, cpb, smem) : occupancy<false>(P, cpb, smem);
}

}  // extern "C"
