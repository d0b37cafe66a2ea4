// The bfloat16 corner walk redesigned for Hopper (the "lean corner walk"):
// the main path's kernel of the capacity mode's bf16 forms, #3 on box
// pencils (entry points in corner_lean.cu) and #6c on hex8 and hex27
// stacks (corner_lean_stack.cu, corner_lean_stack27.cu), single field and
// pair, where ops/cuda_corner.py LEAN_CORNER_BF16 routes them.  The first
// bfloat16 corner design, pencil_walk with CornerGeo<float, N, GD, BOX,
// RCP, CAP, __nv_bfloat16> (stiffness_pencil.cuh, corner_walk.cuh), stays
// as the comparison and runs the forms outside that set.
//
// Replaces, in bfloat16, the Pallas TPU kernels of
// fustpu/ops/pallas_stiffness.py _mk_kernel_corner (:963, via
// _apply_corner :1081) and fustpu/ops/pallas_extruded.py _mk_kernel (:604)
// with `corner` set (built by build_extruded_corner :556, reached through
// stiffness_apply_extruded_pallas :841 and its pair form :860).
//
// What bounds it on an H100: the operations (cuda_corner.py apply_cost: at
// the flagship, 102,400 cells at P = 4, 1.99 GFLOP, 0.0298 ms at 67
// TFLOP/s float32, against 34 MB of bytes), but the first bfloat16 design
// ran at 12-16% of that bound: per cell line (a thread, N nodes) it
// issued, beside the sum factorisation's loads, a 2 B shared load for
// every Jacobian channel it folded (36 a line, 162 for hex27), two for
// every node's GLL node and weight, D from the static shared array (which
// the compiler reloads after each barrier), and the u, f1, f2 rows 4 B at a
// time; its pair and hex27 forms held 155-168 registers (float's budget),
// three blocks an SM.
//
// What this walk does about it, keeping the first design's walk (the
// persistent grid, its colour classes, its cells a chunk and, on stacks,
// its segments; chunks of consecutive cells added in two turns; the
// channels' bulk-copied ring; the next chunk's inputs through registers;
// the carried top face; y rounded once a chunk where it is stored):
//   1. D, the GLL nodes and the weights by value, one kernel parameter
//      (the constant bank): D[i][r], D[r][i], x_i and w_i are instruction
//      operands once i and r are unrolled; with DREG each thread keeps its
//      rows and columns D[j][.], D[k][.], D[.][j], D[.][k] in registers for
//      the whole walk (its line (j, k) never changes), else they come from
//      a shared copy of D;
//   2. with WIDE, a chunk's channels are widened once, after its copy
//      arrives and before the chunk's first barrier, into 16 B-aligned
//      float slots a cell (each J[p][q] block of channels padded to a
//      multiple of 4), so that the fold reads float4s: 10 loads a line in
//      place of 37, 46 in place of 163 for hex27; the widening is exact, so
//      the fold reads the same numbers; the bytes past a chunk's aligned
//      span (at the channels' end) are read from the channels themselves;
//   3. the float u, f1 and f2 keep each row (i, j, .) padded to KP, read as
//      float4s where a thread sums along k (pencil_lean.cuh);
//   4. three barriers a chunk (four for the pair, whose fold of c1 x1 + c2
//      x2 takes one more): the arrival, the metric's f1, f2 written, the
//      turn between even and odd cells;
//   5. launch bounds of its own for each form (Plan below).
// Every node's fold, Horner steps, adjugate, determinant, division and
// sums are the first design's (corner.cuh Corner, sum_factor.cuh
// cell_apply), term by term and in order, on the same float values, so a
// cell's contribution is bitwise the first design's; on the same schedule
// (the host gives it the first design's cells a chunk and segments) the
// adds into y come in the same order, so y is bitwise the first design's.
// Two applies are bitwise equal: the order is fixed by the schedule,
// without atomics.
//
// Shared memory per block (the host computes the same, cuda_corner.py
// `lean_smem`): the head of stiffness_pencil.cuh (the STAGES mbarriers,
// the row ring, the stacks' row ids), STAGES stages of stage_bytes (cpb
// cells of bfloat16 channels and 16 B for the aligned span, as the first
// design's), then floats: two buffers of every cell's u (N^2 KP a cell),
// every cell's f1 and f2 (N^2 KP each), every cell's widened channels
// (CSLOT a cell), two of the chunk's y (N^2 (cpb P + 1)), for the pair two
// of x2 and of the cells' (c1, c2), and D (N^2, padded to 4).  Nothing
// static.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "pencil_lean.cuh"

namespace fustpu {
namespace pencil {
namespace lean_corner {

using lean::bf16;
using lean::Shape;

// D, the GLL nodes and the weights by value: d[q * N + i] = l_i'(x_q),
// x[i], w[i]; all widened to (or kept in) float on the host.
template <int N>
struct Consts {
  float d[N * N];
  float x[N];
  float w[N];
};

// The plan of each form at P = 4 (what the walk takes there of the
// candidates above), by form f = 2 g + pair, g the geometry (0 box pencils,
// 1 hex8 stacks, 2 hex27 stacks): D's rows in registers, the widened
// channels, and the blocks an SM of the launch bounds.  Chosen by
// measurement in turns at P = 4 (tools/corner_split; PERF.md, PR 22): D's
// rows in registers cost the 96-register single forms and the hex27 pair
// spills, and the widened channels cost the hex8 pair and the hex27 single
// theirs.  At the other degrees every form takes D's rows in registers and
// the widened channels, the plan that was timed there.  Which forms run
// the walk at all: ops/cuda_corner.py LEAN_CORNER_BF16.
struct PlanP4 {
  // form f:                        box    pair   hex8   pair   hex27  pair
  static constexpr bool DREG[6] = {false, true,  false, true,  true,  false};
  static constexpr bool WIDE[6] = {true,  true,  true,  false, false, true};
  static constexpr int MINB[6] = {5, 2, 5, 2, 2, 2};
};

// A form's choices (PlanP4 at P = 4) and launch bounds.
// MAXT is the first design's (corner_walk.cuh CAP: 128 threads for the
// single-field trilinear walk at N <= 5, else 256), so that the walk runs
// the first design's cells a chunk; MINB the form's PlanP4 entry at N <= 5,
// 1 (no cap below the hardware's 255 registers) above.  RCP: the first
// design's division (approximate on box pencils and on capped stacks).
template <int N, int GD, bool BOX, bool PAIR>
struct Plan {
  static constexpr int F = 2 * (BOX ? 0 : GD) + (PAIR ? 1 : 0);
  static constexpr bool P4 = N == 5;
  static constexpr bool DREG = !P4 || PlanP4::DREG[F];
  static constexpr bool WIDE = !P4 || PlanP4::WIDE[F];
  static constexpr bool FIRST_CAP = GD == 1 && !PAIR && N <= 5;
  static constexpr bool RCP = BOX || FIRST_CAP;
  static constexpr int MAXT = FIRST_CAP ? 128 : 256;
  static constexpr int MINB = N <= 5 ? PlanP4::MINB[F] : 1;
};

// A cell's widened channels: block 3 q + p (the channels of J[p][q], BLOCK
// of them, consecutive in both layouts: corner.cuh corner_channel) at
// PADB floats each, the coefficient after the nine blocks.
template <int GD>
struct Slots {
  static constexpr int NCH = CornerChannels<GD>::NCH;
  static constexpr int COUNT = CornerChannels<GD>::COUNT;
  static constexpr int BLOCK = NCH / 9;          // 4, or 18 for hex27
  static constexpr int PADB = (BLOCK + 3) / 4 * 4;
  static constexpr int CSLOT = (9 * PADB + 1 + 3) / 4 * 4;  // 40, or 184
  __host__ __device__ static constexpr int of(int c) {
    return c < NCH ? (c / BLOCK) * PADB + c % BLOCK : 9 * PADB;
  }
};

// The metric of one cell's line (j, k): corner.cuh Corner's fold and
// per-node metric, the GLL nodes and weights by value.
template <int N, int GD, bool BOX, bool RCP>
struct Metric {
  float c[3][3][GD + 1];
  float s;

  // ch(b, e): channel e of block b (e < BLOCK), or the coefficient (b 9)
  template <typename Ch>
  __device__ __forceinline__ Metric(Ch ch, const LinePowers<float, GD>& pw,
                                    float wj, float wk) {
    constexpr int BLOCK = Slots<GD>::BLOCK;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const auto blk = ch.block(3 * q + p);
#pragma unroll
        for (int mx = 0; mx <= GD; ++mx) {
          float acc = 0.0f;
#pragma unroll
          for (int my = 0; my <= GD; ++my) {
#pragma unroll
            for (int mz = 0; mz <= GD; ++mz) {
              if (mx <= corner_degree<GD>(q, 0) &&
                  my <= corner_degree<GD>(q, 1) &&
                  mz <= corner_degree<GD>(q, 2))
                acc += blk[corner_channel<GD, BOX>(q, p, mx, my, mz) -
                           (3 * q + p) * BLOCK] *
                       pw.yz[my][mz];
            }
          }
          c[q][p][mx] = acc;
        }
      }
    }
    s = ch.coefficient() * wj * wk;
  }

  __device__ __forceinline__ void operator()(const Consts<N>& K, int i,
                                             float wx, float wy, float wz,
                                             float& f0, float& f1,
                                             float& f2) const {
    const float x = K.x[i];
    float J[3][3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int dx = corner_degree<GD>(q, 0);
        float v = c[q][p][dx];
#pragma unroll
        for (int m = GD - 1; m >= 0; --m)
          if (m < dx) v = v * x + c[q][p][m];
        J[p][q] = v;
      }
    }
    const float a00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
    const float a01 = J[0][2] * J[2][1] - J[0][1] * J[2][2];
    const float a02 = J[0][1] * J[1][2] - J[0][2] * J[1][1];
    const float a10 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
    const float a11 = J[0][0] * J[2][2] - J[0][2] * J[2][0];
    const float a12 = J[0][2] * J[1][0] - J[0][0] * J[1][2];
    const float a20 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
    const float a21 = J[0][1] * J[2][0] - J[0][0] * J[2][1];
    const float a22 = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    const float det = J[0][0] * a00 + J[0][1] * a10 + J[0][2] * a20;
    const float scale =
        corner_div(K.w[i] * s, det < 0.0f ? -det : det, RCP);
    const float t0 = a00 * wx + a10 * wy + a20 * wz;
    const float t1 = a01 * wx + a11 * wy + a21 * wz;
    const float t2 = a02 * wx + a12 * wy + a22 * wz;
    f0 = scale * (a00 * t0 + a01 * t1 + a02 * t2);
    f1 = scale * (a10 * t0 + a11 * t1 + a12 * t2);
    f2 = scale * (a20 * t0 + a21 * t1 + a22 * t2);
  }
};

// The fold's channel readers: a block of a cell's widened float slots, read
// as float4s (WIDE), or the bfloat16 channels in the stage, widened where
// each is read (the first design's loads).
template <int GD>
struct WideBlock {
  float v[Slots<GD>::PADB];
  __device__ __forceinline__ float operator[](int e) const { return v[e]; }
};
template <int GD>
struct WideCell {
  const float* slot;
  __device__ __forceinline__ WideBlock<GD> block(int b) const {
    WideBlock<GD> out;
#pragma unroll
    for (int h = 0; h < Slots<GD>::PADB / 4; ++h) {
      const float4 q = *reinterpret_cast<const float4*>(
          slot + b * Slots<GD>::PADB + 4 * h);
      out.v[4 * h] = q.x;
      out.v[4 * h + 1] = q.y;
      out.v[4 * h + 2] = q.z;
      out.v[4 * h + 3] = q.w;
    }
    return out;
  }
  __device__ __forceinline__ float coefficient() const {
    return slot[9 * Slots<GD>::PADB];
  }
};
template <int GD>
struct StageBlock {
  const bf16* at;
  __device__ __forceinline__ float operator[](int e) const {
    return widen<float>(at[e]);
  }
};
template <int GD>
struct StageCell {
  const bf16* ch;
  __device__ __forceinline__ StageBlock<GD> block(int b) const {
    return {ch + b * Slots<GD>::BLOCK};
  }
  __device__ __forceinline__ float coefficient() const {
    return widen<float>(ch[Slots<GD>::NCH]);
  }
};

// One class: block b walks pencils b, b + gridDim.x, ... of the class, each
// pencil's chunks in order; the arguments as pencil_walk's
// (stiffness_pencil.cuh), Tch the bfloat16 (cells, COUNT) channels.
template <int N, int GD, bool BOX, bool PAIR, typename Rows>
__device__ __forceinline__ void walk(
    const bf16* __restrict__ x1, const bf16* __restrict__ x2,
    const bf16* __restrict__ C, const bf16* __restrict__ Tch,
    const Consts<N>& K, bf16* __restrict__ y,
    const long long* __restrict__ chunks, long long first, int pencils,
    int per_pencil, int stages, int stage_bytes, long long seg0,
    Rows lines) {
  using PL = Plan<N, GD, BOX, PAIR>;
  using SL = Slots<GD>;
  constexpr int P = N - 1, NN = N * N;
  constexpr int KP = Shape<N>::KP, CELLF = Shape<N>::CELLF;
  constexpr int COUNT = SL::COUNT, CSLOT = SL::CSLOT;
  constexpr long long CB = (long long)COUNT * (long long)sizeof(bf16);
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
  float* chf = fb + 2 * cpb * CELLF;
  float* yb = chf + cpb * CSLOT;
  float* x2b = yb + 2 * rows;
  float* cb = x2b + (PAIR ? 2 * rows : 0);
  float* Ds = cb + (PAIR ? 4 * cpb : 0);
  const int t = threadIdx.x, lc = threadIdx.y;   // node line (j, k), cell
  const int tid = lc * NN + t, nthreads = NN * cpb;
  const int j = t / N, k = t % N;
  float* f1 = fb + lc * CELLF;
  float* f2 = fb + (cpb + lc) * CELLF;
  auto at = [](int i, int jj, int kk) { return (i * N + jj) * KP + kk; };
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

  // D's rows and columns of this thread's line: in registers (DREG) or in
  // the shared copy
  float dj[N], dk[N], dtj[N], dtk[N];
  if constexpr (PL::DREG) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      dj[r] = K.d[j * N + r];
      dk[r] = K.d[k * N + r];
      dtj[r] = K.d[r * N + j];
      dtk[r] = K.d[r * N + k];
    }
  } else {
    for (int e = tid; e < NN; e += nthreads) Ds[e] = K.d[e];
  }
  auto Dj = [&](int r) { return PL::DREG ? dj[r] : Ds[j * N + r]; };
  auto Dk = [&](int r) { return PL::DREG ? dk[r] : Ds[k * N + r]; };
  auto Dtj = [&](int r) { return PL::DREG ? dtj[r] : Ds[r * N + j]; };
  auto Dtk = [&](int r) { return PL::DREG ? dtk[r] : Ds[r * N + k]; };
  // the line's powers and weights, for the whole walk
  const LinePowers<float, GD> pw(K.x, j, k);
  const float wj = K.w[j], wk = K.w[k];

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
  auto issue = [&](int q) {                      // thread 0: channels of q
    const long long* r = row(q);
    const int s = q % stages;
    mbar_expect_tx(&bars[s], (unsigned)r[3]);
    bulk_load(ring + (long long)s * stage_bytes,
              reinterpret_cast<const unsigned char*>(Tch) + r[2],
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
  // WIDE: chunk q's channels from its stage into the float slots, exactly;
  // past the copy's span (only at the channels' end) from Tch itself
  auto widen_chunk = [&](int q, const unsigned char* stage) {
    const long long* r = row(q);
    const long long cell0 = r[0], off = r[2], stop = r[2] + r[3];
    const int cnt = (int)r[1] * COUNT;
    for (int e = tid; e < cnt; e += nthreads) {
      const int cl = e / COUNT, c = e - cl * COUNT;
      const long long g = (cell0 + cl) * COUNT + c;
      const long long byte = g * (long long)sizeof(bf16);
      const bf16 v =
          byte + (long long)sizeof(bf16) > stop
              ? Tch[g]
              : *reinterpret_cast<const bf16*>(stage + (byte - off));
      chf[cl * CSLOT + SL::of(c)] = widen<float>(v);
    }
  };

  if (tid < ROW) row(0)[tid] = table(0)[tid];
  if (Rows::IDS && tid < NN) rid(0)[tid] = table_ids(0)[tid];
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
    mbar_init_fence();
  }
  __syncthreads();                   // the first row, D, the mbarriers
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
    if constexpr (!PL::WIDE)
      read_span_tail(stage, Tch, (cell0 + n) * CB, off, r[3], tid, nthreads);
    mbar_wait(&bars[s], (unsigned)((q / stages) & 1));
    if constexpr (PL::WIDE) {
      widen_chunk(q, stage);
      fence_proxy_async();           // the stage's reads before its refill
    }
    __syncthreads();                 // the chunk's channels arrived (WIDE:
                                     // widened), its inputs are in place,
                                     // the last one's adds are done
    // no one reads the last chunk's stage again: refill it, `stages`
    // chunks ahead
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

    // the cell's metric along this line, folded from its channels
    float f0[N];
    if (active) {
      const auto metric = [&]() {
        if constexpr (PL::WIDE)
          return Metric<N, GD, BOX, PL::RCP>(WideCell<GD>{chf + lc * CSLOT},
                                              pw, wj, wk);
        else
          return Metric<N, GD, BOX, PL::RCP>(
              StageCell<GD>{reinterpret_cast<const bf16*>(
                                stage + (cell0 * CB - off)) +
                            lc * COUNT},
              pw, wj, wk);
      }();
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float uz[KP];                // the row u[i][j][.]
        row4(u, i, j, uz);
        float wx = 0.0f, wy = 0.0f, wz = 0.0f;
#pragma unroll
        for (int rr = 0; rr < N; ++rr) {
          wx += K.d[i * N + rr] * ul[rr];
          wy += Dj(rr) * u[at(i, rr, k)];
          wz += Dk(rr) * uz[rr];
        }
        float a, bq, cq;
        metric(K, i, wx, wy, wz, a, bq, cq);
        f0[i] = a;
        f1[at(i, j, k)] = bq;
        f2[at(i, j, k)] = cq;
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
          sum += K.d[rr * N + i] * f0[rr];
          sum += Dtj(rr) * f1[at(i, rr, k)];
          sum += Dtk(rr) * fz[rr];
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
    if constexpr (!PL::WIDE)
      fence_proxy_async();           // the stage's reads before its refill
  }
  __syncthreads();                   // the last chunk's adds are done
  store(total - 1);
}

template <int N, int GD, bool BOX, bool PAIR, typename Rows>
__global__ void __launch_bounds__(Plan<N, GD, BOX, PAIR>::MAXT,
                                  Plan<N, GD, BOX, PAIR>::MINB)
lean_corner_kernel(const bf16* __restrict__ x1, const bf16* __restrict__ x2,
                   const bf16* __restrict__ C, const bf16* __restrict__ Tch,
                   const __grid_constant__ Consts<N> K, bf16* __restrict__ y,
                   const long long* __restrict__ chunks, long long first,
                   int pencils, int per_pencil, int stages, int stage_bytes,
                   long long seg0, Rows lines) {
  walk<N, GD, BOX, PAIR, Rows>(x1, x2, C, Tch, K, y, chunks, first, pencils,
                               per_pencil, stages, stage_bytes, seg0, lines);
}

// ---- host side ----

template <int N, int GD, bool BOX, bool PAIR, typename Rows>
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      lean_corner_kernel<N, GD, BOX, PAIR, Rows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  done = err == cudaSuccess;
  return err;
}

// One launch per class, as launch_classes (stiffness_pencil.cuh); D: N^2
// floats, Q: the N GLL nodes then the N weights, both host floats, by
// value.  Returns 0 or the first cudaError_t.
template <int N, int GD, bool BOX, bool PAIR, typename Rows>
int launch(const void* x1, const void* x2, const void* C, const void* Tch,
           const float* D, const float* Q, void* y, const void* chunks,
           const long long* classes, int nclass, int blocks, int cpb,
           int stages, int stage_bytes, int smem, Rows lines,
           cudaStream_t stream) {
  cudaError_t err = allow_smem<N, GD, BOX, PAIR, Rows>();
  if (err != cudaSuccess) return (int)err;
  Consts<N> K;
  for (int e = 0; e < N * N; ++e) K.d[e] = D[e];
  for (int e = 0; e < N; ++e) {
    K.x[e] = Q[e];
    K.w[e] = Q[N + e];
  }
  const dim3 block(N * N, cpb);
  long long seg0 = 0;
  for (int c = 0; c < nclass; ++c) {
    const long long first = classes[3 * c], pencils = classes[3 * c + 1];
    const int per_pencil = (int)classes[3 * c + 2];
    if (pencils <= 0) continue;
    const unsigned grid = (unsigned)(pencils < blocks ? pencils : blocks);
    lean_corner_kernel<N, GD, BOX, PAIR, Rows><<<grid, block, smem, stream>>>(
        static_cast<const bf16*>(x1), static_cast<const bf16*>(x2),
        static_cast<const bf16*>(C), static_cast<const bf16*>(Tch), K,
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
template <int N, int GD, bool BOX, bool PAIR, typename Rows>
int occupancy(int cpb, int smem) {
  cudaError_t err = allow_smem<N, GD, BOX, PAIR, Rows>();
  if (err != cudaSuccess) return -(int)err;
  if (N * N * cpb > Plan<N, GD, BOX, PAIR>::MAXT) return 0;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, lean_corner_kernel<N, GD, BOX, PAIR, Rows>, N * N * cpb, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// The degrees at which an entry point instantiates the walk (its source's
// lists, which ops/cuda_corner.py LEAN_CORNER_BF16 mirrors), and the call
// f(std::integral_constant<int, P>) at the one that P names: -1 at any
// other degree.
template <int... Ps>
struct Degrees {};

template <int... Ps, typename F>
int dispatch(Degrees<Ps...>, int P, F f) {
  int out = -1;
  ((P == Ps ? (out = f(std::integral_constant<int, Ps>{}), 0) : 0), ...);
  return out;
}

}  // namespace lean_corner
}  // namespace pencil
}  // namespace fustpu

// The C entry points of the lean corner walk on the stacks of geometry
// degree GD (corner_lean_stack.cu, corner_lean_stack27.cu):
// fustpu_<NAME>_lean_bf16, fustpu_<NAME>_pair_lean_bf16 and
// fustpu_<NAME>_lean_occupancy, instantiated at the degrees of the
// Degrees types SINGLE and PAIR.  Each launcher returns 0, -1 for a degree
// without the lean walk, or the cudaError_t of the first failed call; y
// must be zeroed by the caller.  D: N^2 and Q: 2 N host floats; chunks:
// (rows, 5) int64 and ids: (segments, N^2) int32 on the device; classes:
// nclass x 3 int64 on the host.
#define FUSTPU_LEAN_CORNER_STACK(NAME, GD, SINGLE, PAIR)                     \
  namespace {                                                                \
  namespace lc = fustpu::pencil::lean_corner;                                \
  template <bool PR>                                                         \
  int NAME##_launch(int P, const void* x1, const void* x2, const void* C,    \
                    const void* Tch, const float* D, const float* Q,         \
                    void* y, const void* chunks, const void* ids,            \
                    const long long* classes, int nclass, int blocks,        \
                    int cpb, int stages, int stage_bytes, int smem, int nz,  \
                    void* stream) {                                          \
    const fustpu::pencil::StackRows lines{nz * P + 1, 0,                     \
                                          static_cast<const int*>(ids)};     \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                      \
    return lc::dispatch(                                                     \
        std::conditional_t<PR, PAIR, SINGLE>{}, P, [&](auto p) {             \
          return lc::launch<decltype(p)::value + 1, GD, false, PR>(          \
              x1, x2, C, Tch, D, Q, y, chunks, classes, nclass, blocks, cpb, \
              stages, stage_bytes, smem, lines, s);                          \
        });                                                                  \
  }                                                                          \
  template <bool PR>                                                         \
  int NAME##_occ(int P, int cpb, int smem) {                                 \
    return lc::dispatch(                                                     \
        std::conditional_t<PR, PAIR, SINGLE>{}, P, [&](auto p) {             \
          return lc::occupancy<decltype(p)::value + 1, GD, false, PR,        \
                               fustpu::pencil::StackRows>(cpb, smem);        \
        });                                                                  \
  }                                                                          \
  }                                                                          \
  extern "C" {                                                               \
  int fustpu_##NAME##_lean_bf16(const void* x, const void* Tch,              \
                                const float* D, const float* Q, void* y,     \
                                int P, const void* chunks, const void* ids,  \
                                const long long* classes, int nclass,        \
                                int blocks, int cpb, int stages,             \
                                int stage_bytes, int smem, int nz,           \
                                void* stream) {                              \
    return NAME##_launch<false>(P, x, nullptr, nullptr, Tch, D, Q, y,        \
                                chunks, ids, classes, nclass, blocks, cpb,   \
                                stages, stage_bytes, smem, nz, stream);      \
  }                                                                          \
  int fustpu_##NAME##_pair_lean_bf16(                                        \
      const void* x1, const void* x2, const void* C, const void* Tch,        \
      const float* D, const float* Q, void* y, int P, const void* chunks,    \
      const void* ids, const long long* classes, int nclass, int blocks,     \
      int cpb, int stages, int stage_bytes, int smem, int nz,                \
      void* stream) {                                                        \
    return NAME##_launch<true>(P, x1, x2, C, Tch, D, Q, y, chunks, ids,      \
                               classes, nclass, blocks, cpb, stages,         \
                               stage_bytes, smem, nz, stream);               \
  }                                                                          \
  int fustpu_##NAME##_lean_occupancy(int P, int pair, int cpb, int smem) {   \
    return pair ? NAME##_occ<true>(P, cpb, smem)                             \
                : NAME##_occ<false>(P, cpb, smem);                           \
  }                                                                          \
  }

