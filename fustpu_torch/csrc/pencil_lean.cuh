// The bfloat16 G-stream z-pencil walk redesigned for Hopper (the "lean
// walk"): the main path's kernel of #1 / #2 (box pencils, entry points in
// stiffness_lean.cu) and of #6 (extruded stacks, extruded_lean.cu) on a
// bfloat16 operator.  stiffness_pencil.cuh keeps the walk's float32 and
// float64 forms and the first bfloat16 form, pencil_kernel<float, N, PAIR,
// Rows, GRing<float, N, __nv_bfloat16>>, as the comparison.
//
// Replaces, in bfloat16, the Pallas TPU kernels of
// fustpu/ops/pallas_stiffness.py _mk_kernel (:170, via _apply_single
// :1296), _mk_kernel_pair (:726, via stiffness_apply_pallas_pair :804), and
// fustpu/ops/pallas_extruded.py _mk_kernel (:604, via :841 and :860).
//
// What bounds it on an H100.  Its bytes are half the float32 walk's (G,
// x, y in bfloat16: at the flagship, 64 x 40 x 40 cells at P = 4, at
// least 180,246,788 B, 0.0538 ms at 3.35 TB/s), but the first bfloat16
// form took 89% of the float32 walk's time.  Per cell line (a thread, N
// nodes) its body issued about 215 shared loads at P = 4: 70 of them D
// (the compiler reloads the shared D after each barrier), 30 the six
// bfloat16 G components of each node, the rest u, f1 and f2, five 4 B
// loads a row;
// its blocks of 3 cells (75 threads) left 21 of 96 lanes idle, and a
// 40-cell pencil took 14 chunks, the last of one cell; and each chunk
// passed five barriers.  Shared-load issue at one warp instruction a clock
// an SM, not DRAM, set its pace.
//
// What this walk does about it, keeping the first design's walk (the
// persistent grid, the colour classes, chunks of consecutive cells added
// in two turns, the bulk-copied G ring, the next chunk's inputs through
// registers, the carried top face, y rounded once a chunk where it is
// stored):
//   1. D by value, a kernel parameter (the constant bank), as the staged
//      engine's contract_ring (engine_bf16.cu): the uniform D[i][r],
//      D[r][i] are instruction operands, and each thread keeps its rows
//      and columns D[j][.], D[k][.], D[.][j], D[.][k] in registers for the
//      whole walk (its line (j, k) never changes).  No shared load of D.
//   2. The float u, f1 and f2 keep each row (i, j, .) padded to KP, a
//      multiple of 4 values, so that the row a thread sums along k comes in
//      float4 loads (two in place of five at P = 4).
//   3. Three barriers a chunk (four for the pair) in place of five: the
//      chunk's arrival, the metric's f1, f2 written, the turn between even
//      and odd cells.  u is complete at the arrival barrier (the pair's fold
//      takes one more), and the carried face, written before the metric
//      barrier, is ordered before any turn's adds.
//   4. Launch bounds of its own (Bounds<N>: a register cap), so that the
//      host may run more cells an SM; the host
//      (ops/cuda_stiffness.py `pencil_schedule` with `design="lean"`)
//      chooses the cells a chunk by a cost model fitted to this walk's
//      times, which prefers full warps (5 cells at P = 4: 125 of 128 lanes).
// Every node's sums are the first design's, term by term and in the same
// order (wx, wy, wz over r; the metric; the three-term sum over r), from
// the same float D (bfloat16 D widened on the host), so a cell's
// contribution is bitwise the first design's.  Where the two designs run
// the same cells a chunk the adds into y come in the same order too; where
// they do not, a z-face between two cells of one chunk may take its two
// adds in the other order, which can move the float sum by an ulp and its
// bfloat16 rounding, rarely, by one bfloat16 step.  Two applies are
// bitwise equal: the order is fixed by the schedule, without atomics.
//
// Shared memory per block (the host computes the same, cuda_stiffness.py
// `lean_smem`): the head of stiffness_pencil.cuh (STAGES mbarriers, the
// row ring, the stacks' row ids), STAGES stages of stage_bytes (cpb cells
// of bfloat16 G and 16 B for the aligned span), then floats: two buffers of
// every cell's u (N^2 KP a cell), every cell's f1 and f2 (N^2 KP each),
// two of the chunk's y (N^2 (cpb P + 1)), and for the pair two of x2 and of
// the cells' (c1, c2).  Nothing static.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "stiffness_pencil.cuh"

namespace fustpu {
namespace pencil {
namespace lean {

using bf16 = __nv_bfloat16;

// D by value: d[q * N + i] = l_i'(x_q), widened to float on the host.
template <int N>
struct DMat {
  float d[N * N];
};

template <int N>
struct Shape {
  static constexpr int NN = N * N, NNN = N * N * N;
  static constexpr int KP = (N + 3) / 4 * 4;     // a padded row's floats
  static constexpr int CELLF = NN * KP;          // a cell's padded floats
};

// One class: block b walks pencils b, b + gridDim.x, ... of the class, each
// pencil's chunks in order; the arguments as pencil_walk's
// (stiffness_pencil.cuh), G the bfloat16 (cells, 6, N^3) stream.
template <int N, bool PAIR, typename Rows>
__device__ __forceinline__ void walk(
    const bf16* __restrict__ x1, const bf16* __restrict__ x2,
    const bf16* __restrict__ C, const bf16* __restrict__ G,
    const DMat<N>& D, bf16* __restrict__ y,
    const long long* __restrict__ chunks, long long first, int pencils,
    int per_pencil, int stages, int stage_bytes, long long seg0,
    Rows lines) {
  constexpr int P = N - 1, NN = N * N, NNN = N * N * N;
  constexpr int KP = Shape<N>::KP, CELLF = Shape<N>::CELLF;
  constexpr long long CB = 6LL * NNN * (long long)sizeof(bf16);
  extern __shared__ __align__(128) unsigned char smem[];
  const int cpb = blockDim.y, lmax = cpb * P + 1;  // a row of a chunk's z
  const int rows = NN * lmax;                    // a chunk buffer's values
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  long long* rs = reinterpret_cast<long long*>(smem + bars_bytes(stages));
  int* ids = reinterpret_cast<int*>(smem + bars_bytes(stages) +
                                    ring_bytes());
  unsigned char* ring = smem + head_bytes(stages, Rows::IDS, NN);
  float* ub = reinterpret_cast<float*>(ring + (long long)stages * stage_bytes);
  float* fb = ub + 2 * cpb * CELLF;
  float* yb = fb + 2 * cpb * CELLF;
  float* x2b = yb + 2 * rows;
  float* cb = x2b + 2 * rows;
  const int t = threadIdx.x, lc = threadIdx.y;   // node line (j, k), cell
  const int tid = lc * NN + t, nthreads = NN * cpb;
  const int j = t / N, k = t % N;
  float* f1 = fb + lc * CELLF;
  float* f2 = fb + (cpb + lc) * CELLF;
  auto at = [](int i, int jj, int kk) { return (i * N + jj) * KP + kk; };
  // the row (i, jj, .) of a padded buffer, as float4s
  auto row4 = [](const float* b, int i, int jj, float* out) {
#pragma unroll
    for (int h = 0; h < KP / 4; ++h) {
      const float4 q =
          *reinterpret_cast<const float4*>(b + (i * N + jj) * KP + 4 * h);
      out[4 * h] = q.x;
      out[4 * h + 1] = q.y;
      out[4 * h + 2] = q.z;
      out[4 * h + 3] = q.w;
    }
  };
  // this thread's share of a chunk buffer, as pencil_walk's `each`
  const int rr0 = tid / lmax, z00 = tid - rr0 * lmax;
  const int drr = nthreads / lmax, dz = nthreads - drr * lmax;
  auto each = [&](int len, auto f) {
    int rr = rr0, z = z00;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (rr < NN && z < len) f(e, rr, z);
      rr += drr;
      z += dz;
      if (z >= lmax) {
        z -= lmax;
        ++rr;
      }
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

  const int mine = (pencils - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int total = mine * per_pencil;
  auto pencil = [&](int q) {
    return blockIdx.x + (long long)(q / per_pencil) * gridDim.x;
  };
  auto table = [&](int q) {
    return chunks + ROW * (first + pencil(q) * per_pencil + q % per_pencil);
  };
  auto row = [&](int q) { return rs + (q % RING) * ROW; };
  auto rid = [&](int q) { return ids + (q % RING) * NN; };
  auto table_ids = [&](int q) {
    return lines.ids + (seg0 + pencil(q)) * NN;
  };
  auto issue = [&](int q) {                      // thread 0: G of chunk q
    const long long* r = row(q);
    const int s = q % stages;
    mbar_expect_tx(&bars[s], (unsigned)r[3]);
    bulk_load(ring + (long long)s * stage_bytes,
              reinterpret_cast<const unsigned char*>(G) + r[2],
              (unsigned)r[3], &bars[s]);
  };

  // the next chunk's inputs through registers, as pencil_walk's
  bf16 xr[N], x2r[N], yr[N], cr{};
  long long rowr = 0;
  int idr = 0;
  auto fetch = [&](int q) {
    const long long* r = row(q);
    const int* rq = rid(q);
    const int n = (int)r[1], zy = q % per_pencil == 0 ? 0 : 1;
    each(n * P + 1, [&](int e, int rr, int z) {
      const int g = lines.template base<N>(r, rq, rr) + z;
      xr[e] = x1[g];
      if (PAIR) x2r[e] = x2[g];
      if (z >= zy) yr[e] = y[g];
    });
    if (PAIR && tid < 2 * n) cr = C[2 * r[0] + tid];
    if (q + 1 < total && tid < ROW) rowr = table(q + 1)[tid];
    if (Rows::IDS && q + 1 < total && tid < NN) idr = table_ids(q + 1)[tid];
  };
  auto put = [&](int q) {
    const long long* r = row(q);
    const int b = q & 1, n = (int)r[1], len = n * P + 1;
    const int zy = q % per_pencil == 0 ? 0 : 1;
    float* u = ub + b * cpb * CELLF;
    each(len, [&](int e, int rr, int z) {
      if (PAIR) x2b[b * rows + rr * lmax + z] = widen<float>(x2r[e]);
      if (z >= zy) yb[b * rows + rr * lmax + z] = widen<float>(yr[e]);
      const float v = widen<float>(xr[e]);
      const int cl = z / P, kk = z - cl * P;
      if (cl < n) u[cl * CELLF + rr * KP + kk] = v;
      if (kk == 0 && cl > 0) u[(cl - 1) * CELLF + rr * KP + P] = v;
    });
    if (PAIR && tid < 2 * n) cb[b * 2 * cpb + tid] = widen<float>(cr);
    if (q + 1 < total && tid < ROW) row(q + 1)[tid] = rowr;
    if (Rows::IDS && q + 1 < total && tid < NN) rid(q + 1)[tid] = idr;
  };
  auto store = [&](int q) {                      // chunk q's y out
    const long long* r = row(q);
    const int* rq = rid(q);
    const int b = q & 1, len = (int)r[1] * P + 1;
    const bool more = (q + 1) % per_pencil != 0;
    each(len, [&](int, int rr, int z) {
      const float v = yb[b * rows + rr * lmax + z];
      if (more && z == len - 1)
        yb[(b ^ 1) * rows + rr * lmax] = v;
      else
        y[lines.template base<N>(r, rq, rr) + z] = narrow<bf16>(v);
    });
  };

  if (tid < ROW) row(0)[tid] = table(0)[tid];
  if (Rows::IDS && tid < NN) rid(0)[tid] = table_ids(0)[tid];
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
    mbar_init_fence();
  }
  __syncthreads();                   // the first row, the mbarriers
  fetch(0);
  put(0);
  __syncthreads();                   // the first chunk's inputs, row 1
  if (tid == 0)
    for (int q = 0; q < min(stages, total); ++q) issue(q);

  for (int q = 0; q < total; ++q) {
    const long long* r = row(q);
    const long long cell0 = r[0], off = r[2];
    const int n = (int)r[1], b = q & 1;
    float* u = ub + (b * cpb + lc) * CELLF;
    const int s = q % stages;
    unsigned char* stage = ring + (long long)s * stage_bytes;
    read_span_tail(stage, G, (cell0 + n) * CB, off, r[3], tid, nthreads);
    mbar_wait(&bars[s], (unsigned)((q / stages) & 1));
    __syncthreads();                 // the chunk's G arrived, its inputs
                                     // are in place, the last one's adds
                                     // are done
    if (tid == 0 && q > 0 && q - 1 + stages < total) issue(q - 1 + stages);
    if (q > 0) store(q - 1);         // its face into this chunk's buffer
    const bool active = lc < n;
    float ul[N];                     // u along this thread's line
    if (active) {
      if (PAIR) {
        const float c1 = cb[b * 2 * cpb + 2 * lc];
        const float c2 = cb[b * 2 * cpb + 2 * lc + 1];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          ul[i] = c1 * u[at(i, j, k)] +
                  c2 * x2b[b * rows + (i * N + j) * lmax + lc * P + k];
          u[at(i, j, k)] = ul[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) ul[i] = u[at(i, j, k)];
      }
    }
    if (PAIR) __syncthreads();       // the folded u in place
    if (q + 1 < total) fetch(q + 1);

    // the metric-transformed gradients: f0 of the own line, f1, f2 shared
    const bf16* gc = reinterpret_cast<const bf16*>(stage + (cell0 * CB - off)) +
                     lc * 6 * NNN;
    float f0[N];
    if (active) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float uz[KP];                // the row u[i][j][.]
        row4(u, i, j, uz);
        float wx = 0.0f, wy = 0.0f, wz = 0.0f;
#pragma unroll
        for (int rr = 0; rr < N; ++rr) {
          wx += D.d[i * N + rr] * ul[rr];
          wy += dj[rr] * u[at(i, rr, k)];
          wz += dk[rr] * uz[rr];
        }
        const int nd = i * NN + t;
        const float g0 = widen<float>(gc[nd]);
        const float g1 = widen<float>(gc[NNN + nd]);
        const float g2 = widen<float>(gc[2 * NNN + nd]);
        const float g3 = widen<float>(gc[3 * NNN + nd]);
        const float g4 = widen<float>(gc[4 * NNN + nd]);
        const float g5 = widen<float>(gc[5 * NNN + nd]);
        f0[i] = g0 * wx + g1 * wy + g2 * wz;
        f1[at(i, j, k)] = g1 * wx + g3 * wy + g4 * wz;
        f2[at(i, j, k)] = g2 * wx + g4 * wy + g5 * wz;
      }
    }
    __syncthreads();                 // f1, f2 complete; the carried face in
    float acc[N];                    // this line's sums
    if (active) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float fz[KP];                // the row f2[i][j][.]
        row4(f2, i, j, fz);
        float sum = 0.0f;
#pragma unroll
        for (int rr = 0; rr < N; ++rr) {
          sum += D.d[rr * N + i] * f0[rr];
          sum += dtj[rr] * f1[at(i, rr, k)];
          sum += dtk[rr] * fz[rr];
        }
        acc[i] = sum;
      }
    }
    // the adds into the chunk's y buffer: even cells, then odd
    float* yc = yb + b * rows + j * lmax + lc * P + k;
    const int turns = n > 1 ? 2 : 1, turn = n > 1 ? (lc & 1) : 0;
    for (int tn = 0; tn < turns; ++tn) {
      if (tn > 0) __syncthreads();   // the earlier turn's adds are visible
      if (active && tn == turn) {
#pragma unroll
        for (int i = 0; i < N; ++i) yc[i * N * lmax] += acc[i];
      }
    }
    if (q + 1 < total) put(q + 1);
    fence_proxy_async();             // reads of the stage before its refill
  }
  __syncthreads();                   // the last chunk's adds are done
  store(total - 1);
}

// The launch bounds of the walk by N: (MAXT threads a block, MINB blocks an
// SM), a cap of 65,536 / (MAXT MINB) registers a thread.  Chosen by a sweep
// of five caps (none, 128, 102, 85 and 64 registers) at P = 4 and 6 on an
// H100 (PERF.md, the bf16 rows of #1 / #2): at P = 4 the walk takes 138
// registers unbounded (one block of 10 cells an SM), 96 at (128, 5), which
// holds five blocks of 5 cells (125 of 128 lanes) an SM; at P = 6 the
// single field is fastest at (256, 2), 128 registers.  From P = 7 on that
// cap spills: the entry points instantiate the walk only at the degrees
// where it measured faster than the first design (ops/cuda_stiffness.py
// FIRST_DESIGN_BF16, ops/cuda_extruded.py LEAN_STACK_DEGREES).
template <int N>
struct Bounds {
  static constexpr int MAXT = N <= 5 ? 128 : 256;
  static constexpr int MINB = N <= 5 ? 5 : 2;
};

template <int N, bool PAIR, typename Rows>
__global__ void __launch_bounds__(Bounds<N>::MAXT, Bounds<N>::MINB)
lean_kernel(const bf16* __restrict__ x1, const bf16* __restrict__ x2,
            const bf16* __restrict__ C, const bf16* __restrict__ G,
            const __grid_constant__ DMat<N> D, bf16* __restrict__ y,
            const long long* __restrict__ chunks, long long first,
            int pencils, int per_pencil, int stages, int stage_bytes,
            long long seg0, Rows lines) {
  walk<N, PAIR, Rows>(x1, x2, C, G, D, y, chunks, first, pencils,
                      per_pencil, stages, stage_bytes, seg0, lines);
}

// ---- host side ----

template <int N, bool PAIR, typename Rows>
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(lean_kernel<N, PAIR, Rows>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM);
  done = err == cudaSuccess;
  return err;
}

// One launch per class, as launch_classes (stiffness_pencil.cuh); D: the
// N^2 float values of D, by value.  Returns 0 or the first cudaError_t.
template <int N, bool PAIR, typename Rows>
int launch(const void* x1, const void* x2, const void* C, const void* G,
           const float* D, void* y, const void* chunks,
           const long long* classes, int nclass, int blocks, int cpb,
           int stages, int stage_bytes, int smem, Rows lines,
           cudaStream_t stream) {
  cudaError_t err = allow_smem<N, PAIR, Rows>();
  if (err != cudaSuccess) return (int)err;
  DMat<N> dm;
  for (int e = 0; e < N * N; ++e) dm.d[e] = D[e];
  const dim3 block(N * N, cpb);
  long long seg0 = 0;
  for (int c = 0; c < nclass; ++c) {
    const long long first = classes[3 * c], pencils = classes[3 * c + 1];
    const int per_pencil = (int)classes[3 * c + 2];
    if (pencils <= 0) continue;
    const unsigned grid = (unsigned)(pencils < blocks ? pencils : blocks);
    lean_kernel<N, PAIR, Rows><<<grid, block, smem, stream>>>(
        static_cast<const bf16*>(x1), static_cast<const bf16*>(x2),
        static_cast<const bf16*>(C), static_cast<const bf16*>(G), dm,
        static_cast<bf16*>(y), static_cast<const long long*>(chunks), first,
        (int)pencils, per_pencil, stages, stage_bytes, seg0, lines);
    seg0 += pencils;
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Blocks of N^2 x cpb threads with smem dynamic shared bytes that one SM
// holds, as occupancy (stiffness_pencil.cuh): 0 beyond the launch bounds.
template <int N, bool PAIR, typename Rows>
int occupancy(int cpb, int smem) {
  cudaError_t err = allow_smem<N, PAIR, Rows>();
  if (err != cudaSuccess) return -(int)err;
  if (N * N * cpb > Bounds<N>::MAXT) return 0;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, lean_kernel<N, PAIR, Rows>, N * N * cpb, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace lean
}  // namespace pencil
}  // namespace fustpu
