// The staged engine's bfloat16 contraction and scatter, designed for
// Hopper: the main path's kernels of `cen.contract` and `cen.scatter` on a
// bfloat16 operator (engine.cu keeps their float32 / float64 forms and the
// first bfloat16 designs, engine_contract_bf16 and
// engine_scatter<float, bf16>, as the comparison).
//
//   y2[c] = D^T (c G) D u[c]   contract_ring<N, MODE>   u = u2, or the pair
//                                                       fold c1 u1 + c2 u2
//   y[d]  = sum of y2[p] over the positions p of dof d, ascending
//                              scatter_runs
//
// Replaces the Pallas TPU kernels of fustpu/ops/pallas_gather.py:
//   - dense_contract (:1117) -> _mk_contract_kernel (:1078), and the pair
//     fold fustpu computes between its kernels (fustpu/ops/operators.py
//     :379-382): contract_ring<N, PLAIN | COEFF | PAIR>;
//   - scatter_add (:1160) -> _mk_scatter_kernel (:610), _packed (:871),
//     _packed_staged (:928): scatter_runs.
// Storage and arithmetic as the first designs: u1, u2, C, coeff, G, D, y2
// and y in bfloat16, every product and sum in float, each stored value
// rounded once (storage.cuh).
//
// What bounds them on an H100: bytes.  At the bodyfit H131 bowl (102,400
// cells, N^3 = 125, 12,800,000 positions, 6,661,697 dofs) the contraction
// moves at least u2 25.6 MB + G 153.6 MB + y2 25.6 MB (0.0611 ms at 3.35
// TB/s; the pair 0.0689), the scatter y2 25.6 MB + pos 51.2 MB + ptr 26.6
// MB + y 13.3 MB (0.0349 ms).  The first designs took 2.3x that: the
// contraction issued 7 N narrow 2 B loads and stores a thread (u2, the six
// G components, y2) and about 250 shared loads a cell line, D among them;
// the scatter made one dependent chain of loads a dof (ptr, pos, y2), with
// one load in flight a thread and its warps diverging over 1-8 entries.
//
// The contraction.  A persistent grid of one wave (the host sizes it from
// the SM count and the card's occupancy answer, ops/launch.py
// `contract_blocks`); block b walks chunks b, b + grid, ... of CH
// consecutive cells.  A chunk's rows of u2 (and u1) and its G blocks are
// contiguous runs, which one thread copies by bulk copy (TMA,
// bulk_copy.cuh) into a ring of two shared stages on mbarriers, widened
// to 16 B spans and cut back at an array's end, where the block reads the
// last bytes itself (CH a multiple of 8 at odd N and any CH at even N make
// every span of the P = 4 and P = 6 bowls exact).  The next chunk's copies
// are in flight while a chunk computes.  The body is sum_factor.cuh's
// STAGED_STORE cell body (N^2 threads a cell, a thread the line of nodes
// (., j, k)) with its own D policy: D comes by value as a kernel parameter
// (the constant bank), so the uniform D[i][r], D[r][i] are operands at
// compile-time offsets, and each thread keeps its rows and columns D[j][.],
// D[k][.], D[.][j], D[.][k] in registers.  The contractions read only u,
// f1 and f2 from shared memory, and G from its stage; the float u, f1, f2
// keep each row (i, j, .) padded to a multiple of 4 values, so that the
// rows a thread sums along k come in float4 loads (at P = 4, 2 loads a row
// in place of 5).  Each node's sum is rounded once to bfloat16 over the
// node's u1 value in the stage, and the chunk's run of y2 leaves by 16 B
// stores from there.  The arithmetic and the order of every sum are the
// first design's: wx, wy, wz over r, the metric (then the coefficient),
// the three-term sum over r.
//
// The scatter.  Block b of 64 threads takes the run of R = 128 dofs
// [128 b, 128 b + 128) and with it the contiguous segment pos[ptr[d0] ..
// ptr[d0 + 128]) of the inverse map.  It stages the run's ptr in shared
// memory, then walks the segment in tiles of 256 entries from a 16 B
// boundary: each thread reads four entries of pos in one 16 B load (past
// L1, L2 evict-first: the map is read once) and issues the four y2 loads
// together, widening them into shared memory in entry order.  Each thread
// then adds its two dofs' entries of the tile in ascending order, from
// 0.0f, carrying the sums across tiles, as the first design adds them (a
// dof of any number of positions spans as many tiles as it needs), and
// stores its two dofs' bfloat16 sums with one 4 B store.  The result is
// bitwise the first design's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "cache_hints.cuh"
#include "storage.cuh"

namespace {

using namespace fustpu;
using bf16 = __nv_bfloat16;

enum Mode { PLAIN = 0, COEFF = 1, PAIR = 2 };

constexpr int MAX_SMEM = 232448;   // one block's shared memory on Hopper

__host__ __device__ constexpr long long round16(long long b) {
  return (b + 15) / 16 * 16;
}

// A stage's room for the span of a run of L bytes: L where every chunk's
// run starts on a 16 B boundary (L a multiple of 16), else room for a
// start up to 15 B into the span and its end rounded up.
__host__ __device__ constexpr long long region(long long L) {
  return L % 16 == 0 ? L : round16(L + 30);
}

// The ring's shape at N = P + 1 for one field or a pair (ops/launch.py
// CONTRACT_CELLS holds CH): CH cells a chunk, CW cells a round
// (blockDim.y; N^2 CW threads; CH a multiple of CW), STAGES stages.  A
// stage holds the chunk's spans of u1 (and u2) and of G.  After the ring
// the float f1, f2 and u of CW cells, each row (i, j, .) padded to KP
// values, a multiple of 4, so that a row is read as float4s.  Chosen at
// P = 4 and 6 on an H100 (PERF.md, the staged engine's bf16 rows) over 2-3
// stages, 4-16 cells a round or a chunk, unpadded rows and u read from its
// stage.
template <int N, bool PAIR>
struct Ring {
  static constexpr int NN = N * N, NNN = N * N * N;
  static constexpr int CH = N == 3 ? 24 : N == 4 ? 16 : N <= 7 ? 8
                            : N <= 9 ? 4 : 2;
  static constexpr int CW = (N == 5 && PAIR) || N == 7 ? 4 : CH;
  static constexpr int STAGES = 2;
  static constexpr int THREADS = NN * CW;
  static constexpr int KP = (N + 3) / 4 * 4;
  static constexpr int CELLF = NN * KP;           // floats a cell a buffer
  static constexpr long long U = region(2LL * NNN * CH);   // u1, u2
  static constexpr long long G = region(12LL * NNN * CH);  // G
  static constexpr long long HEAD = round16(8 * STAGES);
  static constexpr long long STAGE = (PAIR ? 2 : 1) * U + G;
  static constexpr int SMEM =
      (int)(HEAD + STAGES * STAGE + 4LL * 3 * CW * CELLF);
  static_assert(CH % CW == 0, "a chunk is whole rounds");
  static_assert(SMEM <= MAX_SMEM, "a block fits the SM");
};

// D by value: d[q * N + i] = l_i'(x_q), widened to float on the host.
template <int N>
struct DMat {
  float d[N * N];
};

// The 16 B-aligned span [off, off + bytes) of the run [start, end) of an
// array of `total` bytes, cut back to a 16 B boundary where it would pass
// the array's end (read_span_tail reads the rest).
__device__ __forceinline__ unsigned span(long long start, long long end,
                                         long long total, long long& off) {
  off = start & ~15LL;
  long long stop = (end + 15) & ~15LL;
  if (stop > total) stop = end & ~15LL;
  return (unsigned)(stop - off);
}

template <int N, int MODE, typename R = Ring<N, MODE == PAIR>>
__global__ void __launch_bounds__(R::THREADS)
contract_ring(const bf16* __restrict__ u1, const bf16* __restrict__ u2,
              const bf16* __restrict__ C, const bf16* __restrict__ coeff,
              const bf16* __restrict__ G,
              const __grid_constant__ DMat<N> D, bf16* __restrict__ y,
              long long cells) {
  constexpr int NN = N * N, NNN = N * N * N;
  constexpr int CH = R::CH, CW = R::CW, S = R::STAGES;
  constexpr bool TWO = MODE == PAIR;
  constexpr long long UB = 2LL * NNN;     // a cell's row of u1, u2, y2
  constexpr long long GB = 12LL * NNN;    // a cell's G block
  constexpr long long SB = R::STAGE;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  unsigned char* ring = smem + R::HEAD;
  float* work = reinterpret_cast<float*>(ring + S * SB);

  const int t = threadIdx.x, lc = threadIdx.y;   // line (j, k), cell slot
  const int tid = lc * NN + t;
  const int j = t / N, k = t % N;
  constexpr int KP = R::KP, CELLF = R::CELLF;
  float* f1 = work + lc * CELLF;                 // metric-transformed
  float* f2 = work + (CW + lc) * CELLF;          // gradients
  float* u = work + (2 * CW + lc) * CELLF;       // the cell's u, widened
  auto at = [](int i, int jj, int kk) { return (i * N + jj) * KP + kk; };
  // the row (i, jj, .) of a float buffer, as float4s
  auto row = [&](const float* b, int i, int jj, float* out) {
#pragma unroll
    for (int h = 0; h < KP / 4; ++h) {
      const float4 q =
          *reinterpret_cast<const float4*>(b + at(i, jj, 4 * h));
      out[4 * h] = q.x;
      out[4 * h + 1] = q.y;
      out[4 * h + 2] = q.z;
      out[4 * h + 3] = q.w;
    }
  };

  float dj[N], dk[N], dtj[N], dtk[N];            // D[j][.], D[k][.], ...
#pragma unroll
  for (int r = 0; r < N; ++r) {
    dj[r] = D.d[j * N + r];
    dk[r] = D.d[k * N + r];
    dtj[r] = D.d[r * N + j];
    dtk[r] = D.d[r * N + k];
  }

  const long long nchunks = (cells + CH - 1) / CH;
  const int mine =
      (long long)blockIdx.x < nchunks
          ? (int)((nchunks - 1 - blockIdx.x) / gridDim.x + 1)
          : 0;
  auto first_cell = [&](int q) {
    return ((long long)blockIdx.x + (long long)q * gridDim.x) * CH;
  };
  auto field = [&](int s, int f) { return ring + s * SB + f * R::U; };
  auto gstage = [&](int s) { return ring + s * SB + (TWO ? 2 : 1) * R::U; };
  auto issue = [&](int q) {                      // thread 0: chunk q's copies
    const int s = q % S;
    const long long c0 = first_cell(q);
    const long long c1 = c0 + CH < cells ? c0 + CH : cells;
    long long ou, og;
    const unsigned bu = span(c0 * UB, c1 * UB, cells * UB, ou);
    const unsigned bg = span(c0 * GB, c1 * GB, cells * GB, og);
    mbar_expect_tx(&bars[s], (TWO ? 2 : 1) * bu + bg);
    if (bu) {
      bulk_load(field(s, 0), reinterpret_cast<const unsigned char*>(u1) + ou,
                bu, &bars[s]);
      if (TWO)
        bulk_load(field(s, 1),
                  reinterpret_cast<const unsigned char*>(u2) + ou, bu,
                  &bars[s]);
    }
    if (bg)
      bulk_load(gstage(s), reinterpret_cast<const unsigned char*>(G) + og,
                bg, &bars[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bars[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int q = 0; q < min(S, mine); ++q) issue(q);

  for (int q = 0; q < mine; ++q) {
    const int s = q % S;
    const long long c0 = first_cell(q);
    const int n = (int)(c0 + CH < cells ? CH : cells - c0);
    long long ou, og;
    const unsigned bu = span(c0 * UB, (c0 + n) * UB, cells * UB, ou);
    const unsigned bg = span(c0 * GB, (c0 + n) * GB, cells * GB, og);
    read_span_tail(field(s, 0), u1, (c0 + n) * UB, ou, bu, tid, R::THREADS);
    if (TWO)
      read_span_tail(field(s, 1), u2, (c0 + n) * UB, ou, bu, tid,
                     R::THREADS);
    read_span_tail(gstage(s), G, (c0 + n) * GB, og, bg, tid, R::THREADS);
    mbar_wait(&bars[s], (unsigned)((q / S) & 1));
    __syncthreads();                 // the chunk's u and G are in the stage

    // the chunk's first cell in the stage; y2 goes over u1 there
    bf16* yu = reinterpret_cast<bf16*>(field(s, 0) + (c0 * UB - ou));
    const bf16* uv = reinterpret_cast<const bf16*>(field(s, 1) +
                                                   (c0 * UB - ou));
    const bf16* gv = reinterpret_cast<const bf16*>(gstage(s) +
                                                   (c0 * GB - og));
#pragma unroll 1
    for (int w = 0; w < CH / CW; ++w) {
      const int cl = w * CW + lc;                // cell within the chunk
      const bool active = cl < n;
      const long long cell = c0 + cl;
      bf16* yc = yu + cl * NNN;

      float ul[N];                               // u along this line
      float cc = 1.0f;
      if (active) {
        float c1 = 1.0f, c2 = 0.0f;
        if (TWO) {
          c1 = widen<float>(C[2 * cell]);
          c2 = widen<float>(C[2 * cell + 1]);
        }
        if (MODE == COEFF) cc = widen<float>(coeff[cell]);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float v = widen<float>(yc[i * NN + t]);
          if (TWO) v = c1 * v + c2 * widen<float>(uv[cl * NNN + i * NN + t]);
          ul[i] = v;
          u[at(i, j, k)] = v;
        }
      }
      __syncthreads();               // u complete

      float f0[N];                               // own line's x-gradient
      if (active) {
        const bf16* gc = gv + cl * 6 * NNN;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float uz[KP];                          // the row u[i][j][.]
          row(u, i, j, uz);
          float wx = 0.0f, wy = 0.0f, wz = 0.0f;
#pragma unroll
          for (int r = 0; r < N; ++r) {
            wx += D.d[i * N + r] * ul[r];
            wy += dj[r] * u[at(i, r, k)];
            wz += dk[r] * uz[r];
          }
          const int nd = i * NN + t;
          const float g0 = widen<float>(gc[nd]);
          const float g1 = widen<float>(gc[NNN + nd]);
          const float g2 = widen<float>(gc[2 * NNN + nd]);
          const float g3 = widen<float>(gc[3 * NNN + nd]);
          const float g4 = widen<float>(gc[4 * NNN + nd]);
          const float g5 = widen<float>(gc[5 * NNN + nd]);
          float a = g0 * wx + g1 * wy + g2 * wz;
          float b = g1 * wx + g3 * wy + g4 * wz;
          float c = g2 * wx + g4 * wy + g5 * wz;
          if (MODE == COEFF) {
            a *= cc;
            b *= cc;
            c *= cc;
          }
          f0[i] = a;
          f1[at(i, j, k)] = b;
          f2[at(i, j, k)] = c;
        }
      }
      __syncthreads();

      if (active) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float fz[KP];                          // the row f2[i][j][.]
          row(f2, i, j, fz);
          float sum = 0.0f;
#pragma unroll
          for (int r = 0; r < N; ++r) {
            sum += D.d[r * N + i] * f0[r];
            sum += dtj[r] * f1[at(i, r, k)];
            sum += dtk[r] * fz[r];
          }
          yc[i * NN + t] = narrow<bf16>(sum);
        }
      }
    }
    __syncthreads();                 // the chunk's y2 is in the stage

    // the chunk's run of y2 [gs, ge): 16 B stores between the 16 B
    // boundaries a16 <= b16 inside it, 2 B stores at its ends
    const long long gs = c0 * UB, ge = (c0 + n) * UB;
    const long long a16 = min(ge, (gs + 15) & ~15LL);
    const long long b16 = max(a16, ge & ~15LL);
    const unsigned char* from = field(s, 0) - ou;
    unsigned char* to = reinterpret_cast<unsigned char*>(y);
    for (long long g = a16 + 16LL * tid; g < b16; g += 16LL * R::THREADS)
      *reinterpret_cast<uint4*>(to + g) =
          *reinterpret_cast<const uint4*>(from + g);
    for (long long g = gs + 2LL * tid; g < a16; g += 2LL * R::THREADS)
      *reinterpret_cast<bf16*>(to + g) =
          *reinterpret_cast<const bf16*>(from + g);
    for (long long g = b16 + 2LL * tid; g < ge; g += 2LL * R::THREADS)
      *reinterpret_cast<bf16*>(to + g) =
          *reinterpret_cast<const bf16*>(from + g);
    fence_proxy_async();             // this stage's reads and writes
    __syncthreads();                 // before its refill
    if (tid == 0 && q + S < mine) issue(q + S);
  }
}

template <int N, int MODE>
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      contract_ring<N, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<N, MODE == PAIR>::SMEM);
  done = err == cudaSuccess;
  return err;
}

template <int N, int MODE>
int contract_n(const void* u1, const void* u2, const void* C,
               const void* coeff, const void* G, const float* Dh, void* y,
               long long cells, int chunk, int blocks, cudaStream_t stream) {
  using R = Ring<N, MODE == PAIR>;
  if (chunk != R::CH || blocks < 1) return -1;
  if (cells <= 0) return 0;
  cudaError_t err = allow_smem<N, MODE>();
  if (err != cudaSuccess) return (int)err;
  DMat<N> D;
  for (int s = 0; s < N * N; ++s) D.d[s] = Dh[s];
  contract_ring<N, MODE><<<blocks, dim3(N * N, R::CW), R::SMEM, stream>>>(
      static_cast<const bf16*>(u1), static_cast<const bf16*>(u2),
      static_cast<const bf16*>(C), static_cast<const bf16*>(coeff),
      static_cast<const bf16*>(G), D, static_cast<bf16*>(y), cells);
  return (int)cudaGetLastError();
}

template <int N, int MODE>
int occupancy_n() {
  using R = Ring<N, MODE == PAIR>;
  cudaError_t err = allow_smem<N, MODE>();
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, contract_ring<N, MODE>, R::THREADS, R::SMEM);
  return err == cudaSuccess ? blocks : -(int)err;
}

#define FUSTPU_DEGREES(M) M(2) M(3) M(4) M(5) M(6) M(7) M(8) M(9) M(10)

template <int MODE>
int contract_mode(int P, const void* u1, const void* u2, const void* C,
                  const void* coeff, const void* G, const float* D, void* y,
                  long long cells, int chunk, int blocks, cudaStream_t s) {
#define FUSTPU_CASE(P_)                                                   \
  case P_:                                                                \
    return contract_n<P_ + 1, MODE>(u1, u2, C, coeff, G, D, y, cells,     \
                                    chunk, blocks, s);
  switch (P) {
    FUSTPU_DEGREES(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

template <int MODE>
int occupancy_mode(int P) {
#define FUSTPU_CASE(P_) \
  case P_:              \
    return occupancy_n<P_ + 1, MODE>();
  switch (P) {
    FUSTPU_DEGREES(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

constexpr int kRunThreads = 64;   // a block: two dofs a thread
constexpr int kRunDofs = 128;     // ops/launch.py SCATTER_DOFS
constexpr int kTile = 256;        // entries a tile: four a thread

// y[d] for the run of kRunDofs dofs of block b, its inverse-map segment in
// tiles of kTile entries.
__global__ void __launch_bounds__(kRunThreads)
scatter_runs(const bf16* __restrict__ v, const int* __restrict__ pos,
             const int* __restrict__ ptr, bf16* __restrict__ y,
             long long ndofs, long long npos) {
  __shared__ int ps[kRunDofs + 1];                 // the run's ptr
  __shared__ __align__(16) float vs[kTile];        // a tile's y2, widened
  const int t = threadIdx.x;
  const long long d0 = (long long)blockIdx.x * kRunDofs;
  if (d0 >= ndofs) return;
  const int nd = (int)min((long long)kRunDofs, ndofs - d0);
  const unsigned long long first = l2_evict_first();
  for (int i = t; i <= nd; i += kRunThreads) ps[i] = __ldg(ptr + d0 + i);
  __syncthreads();
  const long long e0 = ps[0], e1 = ps[nd];
  // this thread's dofs 2t and 2t + 1: entries [a, b) and [b, c)
  const int da = 2 * t;
  int a = 0, b = 0, c = 0;
  if (da < nd) {
    a = ps[da];
    b = ps[da + 1];
    c = da + 1 < nd ? ps[da + 2] : b;
  }
  float acc0 = 0.0f, acc1 = 0.0f;
  for (long long t0 = e0 & ~3LL; t0 < e1; t0 += kTile) {
    const long long e = t0 + 4 * t;        // this thread's four entries
    int p[4];
    if (e + 3 < npos) {
      const int4 q = ld_stream(reinterpret_cast<const int4*>(pos + e), first);
      p[0] = q.x;
      p[1] = q.y;
      p[2] = q.z;
      p[3] = q.w;
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m) p[m] = e + m < npos ? pos[e + m] : 0;
    }
    float w[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      w[m] = e + m >= e0 && e + m < e1 ? widen<float>(v[p[m]]) : 0.0f;
    *reinterpret_cast<float4*>(vs + 4 * t) = make_float4(w[0], w[1], w[2],
                                                         w[3]);
    __syncthreads();                 // the tile's values are in place
    const long long lo = a > t0 ? a : t0;
    const long long hi = c < t0 + kTile ? c : t0 + kTile;
    for (long long x = lo; x < hi; ++x) {
      const float val = vs[x - t0];
      if (x < b)
        acc0 += val;
      else
        acc1 += val;
    }
    __syncthreads();                 // before the next tile overwrites
  }
  if (da + 1 < nd) {
    const unsigned lo16 = __bfloat16_as_ushort(narrow<bf16>(acc0));
    const unsigned hi16 = __bfloat16_as_ushort(narrow<bf16>(acc1));
    *reinterpret_cast<unsigned*>(y + d0 + da) = lo16 | (hi16 << 16);
  } else if (da < nd) {
    y[d0 + da] = narrow<bf16>(acc0);
  }
}

}  // namespace

// C entry points.  Each returns 0, -1 for an unsupported degree, chunk or
// grid, -2 for an unknown mode, or the cudaError_t of the launch.
extern "C" {

// The contraction: u1, u2 (pair), G and y2 16 B-aligned, bfloat16; C
// (cells, 2), coeff (cells,) bfloat16; D a host array of (P + 1)^2 floats
// (D[q][i] = l_i'(x_q), widened), passed by value; `chunk` the cells a
// chunk (ops/launch.py CONTRACT_CELLS[P], checked), `blocks` the grid;
// mode 0 unit coefficients, 1 the per-cell coeff, 2 the pair fold.
int fustpu_engine_contract_bf16(const void* u1, const void* u2,
                                const void* C, const void* coeff,
                                const void* G, const float* D, void* y,
                                long long cells, int P, int mode, int chunk,
                                int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case PLAIN:
      return contract_mode<PLAIN>(P, u1, u2, C, coeff, G, D, y, cells,
                                  chunk, blocks, s);
    case COEFF:
      return contract_mode<COEFF>(P, u1, u2, C, coeff, G, D, y, cells,
                                  chunk, blocks, s);
    case PAIR:
      return contract_mode<PAIR>(P, u1, u2, C, coeff, G, D, y, cells,
                                 chunk, blocks, s);
    default:
      return -2;
  }
}

// Blocks of the contraction at degree P and mode that one SM holds; -1
// for an unsupported degree, -2 for an unknown mode, minus the
// cudaError_t of a failed query.  *_smem: its dynamic shared bytes a
// block (-1 for an unsupported degree).
int fustpu_engine_contract_bf16_smem(int P, int mode) {
#define FUSTPU_CASE(P_) \
  case P_:              \
    return mode == PAIR ? Ring<P_ + 1, true>::SMEM : Ring<P_ + 1, false>::SMEM;
  switch (P) {
    FUSTPU_DEGREES(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

int fustpu_engine_contract_bf16_occupancy(int P, int mode) {
  switch (mode) {
    case PLAIN:
      return occupancy_mode<PLAIN>(P);
    case COEFF:
      return occupancy_mode<COEFF>(P);
    case PAIR:
      return occupancy_mode<PAIR>(P);
    default:
      return -2;
  }
}

// The scatter: v (npos,) and y (ndofs,) bfloat16, pos (npos,) int32
// 16 B-aligned, ptr (ndofs + 1,) int32; y 4 B-aligned; `blocks` covers
// the dofs in runs of 2 x 64 (ops/launch.py `scatter_blocks`).
int fustpu_engine_scatter_bf16(const void* v, const void* pos,
                               const void* ptr, void* y, long long ndofs,
                               long long npos, int blocks, void* stream) {
  if (blocks < 1 || (long long)blocks * kRunDofs < ndofs) return -1;
  if (ndofs <= 0) return 0;
  scatter_runs<<<blocks, kRunThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(ptr), static_cast<bf16*>(y), ndofs, npos);
  return (int)cudaGetLastError();
}

}  // extern "C"
