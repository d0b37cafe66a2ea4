// Structured-box stiffness apply on the main path, y = sum_cells P^T D^T
// (c G) D P x, for GLL spectral hexahedra of degree P = 2..10 (N = P + 1
// nodes per axis): the z-pencil kernel (entry points in stiffness.cu).
// The same kernel walks the stacks of an extruded mesh, whose z-lines are
// not on a grid (entry points in extruded_stack.cu): a template functor
// (BoxRows, StackRows) gives each of a chunk's N^2 z-lines its first
// node, and nothing else differs.  A second one, the geometry policy
// (GRing, CornerGeo), says where a chunk's metric comes from: the G
// stream described here, or the corner stream of the capacity mode, each
// cell's metric rebuilt from its Jacobian channels (#3 and #6c; entry
// points in corner_pencil.cu, corner_stack.cu, corner_stack27.cu, through
// corner_walk.cuh).  Two more kernels walk it: the two-slab kernels #4 /
// #5, whose work item is a slab pair (slab2.cu: SlabRows), and the
// anatomy of #1, #13, whose variants are policies of this walk
// (anatomy_walk.cuh: a body, a geometry without a ring, x by bulk
// copies).
//
// Replaces the two Pallas TPU kernels of fustpu/ops/pallas_stiffness.py:
//   - _mk_kernel (:170, via _apply_single / stiffness_apply_pallas): one
//     field, any per-cell coefficient folded into G -> pencil_kernel, PAIR
//     false;
//   - _mk_kernel_pair (:726, via stiffness_apply_pallas_pair): y = A_c1(x1)
//     + A_c2(x2) with a unit G and per-cell (c1, c2)  -> PAIR true.
// The parity-class design of the same two kernels (eight parity classes of
// scattered cells, G read by the threads themselves) stays in
// stiffness.cuh for the class-launch corner kernel (corner.cu), the
// class-launch two-slab kernel and the parity-class anatomy variants
// (slab2.cu, anatomy_classes.cu).
//
// What bounds it on an H100: the bytes.  G holds 6 values per node, so at
// P = 4 in float32 a cell reads 3000 B of G against ~500 B of x and
// writes ~500 B of y, for ~1e4 flops: ~2 flop/B, a tenth of the card's
// float32 ridge.  At the flagship (64 x 40 x 40 cells) the least bytes
// are 360,493,576, 0.1076 ms at 3.35 TB/s.
//
// What the design does, against the four things that held the
// parity-class kernel at a third of that bound:
//   1. Eight serial parity-class launches of scattered cells -> a block
//      owns a z-pencil (a, b): the ncz cells along z, one contiguous run of
//      G (cell = (a ncy + b) ncz + c, G (cells, 6, N^3)).  It walks the
//      pencil in chunks of CPB consecutive cells (N^2 threads a cell, each
//      owning an i-line, as in sum_factor.cuh).  The cells of a chunk share
//      z-faces, so they add in two turns, even cells then odd, with a
//      barrier between (cell_apply's `turn`); chunks of a pencil run in
//      order in one block, and the face between two chunks stays in shared
//      memory from one to the next.  This is the TPU kernel's overlap
//      carried along its streamed axis.
//   2. G loaded by the threads that need it, 4 B at a time, between the
//      two barriers of the body -> one thread issues a 1-D bulk copy (TMA,
//      cp.async.bulk) of each chunk's G run into a ring of STAGES shared
//      stages, completing on an mbarrier; the metric (GShared) reads the
//      stage, and the body's f1, f2 of a node then overwrite its G
//      components 0 and 1 there (the node's owner thread has read all six),
//      which saves 2 N^3 values a cell.  The next chunk, the next pencil's
//      first included, is in flight while a chunk contracts.  A stage is
//      refilled at the next chunk's first barrier, every thread having
//      fenced its writes there (fence.proxy.async), and each stage's
//      mbarrier phase flips once a round.  The copy needs 16 B-aligned
//      spans: the host's chunk table holds, for each chunk, the aligned
//      superset of its run (in float32 with N^3 odd a cell is 8 mod 16 B),
//      cut back at G's end, where the kernel reads the last bytes itself.
//   3. A half-empty second wave per class -> four colour classes of
//      pencils, (a % 2, b % 2): two pencils share nodes only if a and b
//      each differ by at most one.  The grid is persistent (resident blocks
//      per SM x SMs, from the occupancy query) and each block walks the
//      pencils of the class.  (Pencils split into z-halves, 8 classes,
//      for classes of fewer pencils than blocks, measured slower on every
//      shape tried, and the host does not split.)
//   4. x read and y read-modify-written in 20 B pieces per (j, k) line,
//      the loads waited on where they are used -> each thread loads its
//      share of the next chunk's x (N^2 rows of CPB P + 1 values along z,
//      consecutive threads on consecutive z; for the pair x2 and the cells'
//      (c1, c2)), the y that earlier classes left on its nodes, and the
//      table row of the chunk after it into registers before the body, and
//      writes them into shared buffers after it, so that their latency
//      hides behind the body: x into the cells' u (a z-face value into both
//      cells that share it; for the pair each thread then forms u = c1 x1 +
//      c2 x2 on its own line), y into the chunk's y buffer, where the cells
//      add, and one coalesced pass writes it out.  y stays += on a zeroed
//      output (each node: what earlier classes left, then this chunk's
//      adds in turn order): a pencil's side faces are shared with up to
//      three others.  (4-B cp.async copies in place of the registers
//      measured slower for the pair.)
// The scatter stays deterministic without atomics: the class order, the
// pencils of a class (disjoint in their nodes), the chunk order and the
// turn order fix every node's order of adds whichever block runs a
// pencil, so two applies are bitwise equal.  The sum order is not the
// parity-class kernel's: the two differ in the last bits.
//
// No tensor cores: the contractions at N = 5 are 5 x 5 products, the kernel
// is bound by its bytes at ~2 flop/B, and TF32 keeps ~3 digits, which
// would break the float32 gate of 1e-6.  The card computes in native
// float32 / float64, accumulators in the template type.
//
// bfloat16 (the JAX package's --dtype bf16; #1 / #2, #6, and the corner
// forms #3 and #6c): x, x2, y, G or the corner channels, D and C are
// stored in bfloat16 (the geometry policy's Store: GRing<float, N,
// __nv_bfloat16>, CornerGeo<float, ..., __nv_bfloat16>; the GLL nodes and
// weights Q stay float) and everything else is float: the walk
// widens what it loads, and the chunk buffers, the body and its sums are
// float.  G's stage holds bfloat16, where a float f1, f2 does not fit a
// node's slot, so the cells' f1, f2 take 2 N^3 floats a cell slot after the
// chunk buffers (Geo::after).  y rounds to bfloat16 once a chunk, where the
// coalesced pass writes it out: a node on a pencil's side face, shared by
// up to four pencils of the four colour classes, is read back and rounded
// again by each later class that adds to it, so it carries at most four
// roundings (each at most 2^-8 of the partial sum it rounds: bfloat16
// keeps 8 significant bits), an interior node one.  In a quarter of
// the bytes the apply moves in float32 G is half (its stream), and so are
// x and y.
//
// Shared memory per block (the host computes the same, cuda_stiffness.py
// `pencil_smem`): D (N^2 values, static), and dynamic: STAGES mbarriers and
// a ring of RING chunk-table rows (each padded to 16 B), STAGES stages of
// stage_bytes (CPB cells of G plus 16 B for the aligned span), two buffers
// of every cell's u (N^3 values) and of the chunk's y (N^2 (CPB P + 1)
// values), and for the pair two of x2 and of the cells' (c1, c2).

#pragma once

#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "corner.cuh"
#include "sum_factor.cuh"

namespace fustpu {
namespace pencil {

// Index of node (i, j, k) of a cell: the thread's (j, k) line starts at
// `base` and steps by `sx` in i (a chunk buffer's row stride here).
struct ZLine {
  int base, sx;
  __device__ int operator()(int i) const { return base + i * sx; }
};

// The chunk table (cuda_stiffness.py `pencil_schedule`,
// cuda_extruded.py `stack_schedule`), one row of ROW int64 a chunk: first
// cell, cells, byte offset of the aligned span in G, span bytes, and the
// chunk's offset in the field (Rows below).  A class's pencils are
// `per_pencil` consecutive rows each, its first row at `first`.
constexpr int ROW = 5;

// The block's copy of the table rows of chunks q - 1, q and q + 1 while it
// works on chunk q: a ring of RING rows (and, for stacks, of the chunks'
// N^2 row ids).
constexpr int RING = 3;

// Where the N^2 z-lines of a chunk lie in the field: the grid index of
// line rr = i N + j's first node, from the chunk's table row r and (for
// stacks) its row ids rid.
//
// A box pencil: r[4] is the grid index of the chunk's node (0, 0, 0), and
// the lines step by sx in i and gz in j.
struct BoxRows {
  static constexpr bool IDS = false, XBULK = false;
  int gz, sx;
  const int* ids;                      // unused
  template <int N>
  __device__ int base(const long long* r, const int*, int rr) const {
    return (int)r[4] + (rr / N) * sx + (rr % N) * gz;
  }
  __device__ bool starts(int qi) const { return qi == 0; }
  __device__ bool drains(int) const { return false; }
};
// An extruded stack (extruded.cuh): node (i, j, k) of layer kz holds dof
// rows2d[s, i N + j] gz + kz P + k, so line rr starts at rid[rr] gz + r[4],
// r[4] = kz0 P for the chunk's first layer kz0.  ids: (segments, N^2)
// int32, the row ids of each pencil (stack segment), class by class in
// table order; a block copies the chunk's into the row ring with its
// table row.
struct StackRows {
  static constexpr bool IDS = true, XBULK = false;
  int gz, sx;                          // sx unused
  const int* ids;
  template <int N>
  __device__ int base(const long long* r, const int* rid, int rr) const {
    return rid[rr] * gz + (int)r[4];
  }
  __device__ bool starts(int qi) const { return qi == 0; }
  __device__ bool drains(int) const { return false; }
};
// What else a Rows policy says (the two-slab walk of slab2.cu and the
// anatomy's ywin, anatomy_walk.cuh, use it; both kinds above take the
// plain walk):
//   starts(qi)  whether chunk qi of a work item starts a pencil (its first
//            z-face is read from y, not carried from the chunk before);
//   drains(qi)  whether that chunk shares nodes with the work item's
//            chunk before it beyond the carried face, so that the earlier
//            chunk's y must be out before this one's is fetched;
//   XBULK    whether x arrives by bulk copies (one a z-line run, into an
//            x area after the stages with an mbarrier of its own) in place
//            of the threads' loads.

// Where a chunk's metric comes from: the geometry policy.  Each chunk's
// run of the stream (CELL values a cell, in the walk's cell order) arrives
// in a stage of the ring by one bulk copy; `load` fills what the policy
// keeps in the block after the chunk buffers (`after` values for cpb cells
// a chunk) before the first barrier, the constructor takes the thread's
// line (j, k) after it, and `cell` gives the body its metric and its f1,
// f2 scratch for cell slot lc, whose run starts at Gc in the stage.
// BARRIERS: whether a chunk takes the barrier between the last chunk's
// y out and this one's body (the G stream's walk keeps it; without it
// the body's first barrier orders the carried face before its adds, and
// the next chunk's buffers are written only after the body).
// RING: whether the stream arrives in the ring at all (the anatomy's
// `contract` reads none: no stages, no copies, no waits).  BODY: what
// cell_apply computes (STAGED; the anatomy's `gstream` STAGED_POINTWISE).
// MAX_THREADS, MIN_BLOCKS: the launch bounds of corner_kernel, which runs
// the walk for a policy with MIN_BLOCKS > 0 (a register cap of 65,536 /
// (MAX_THREADS MIN_BLOCKS) a thread; `occupancy` answers 0 for a larger
// block, so the schedule keeps within MAX_THREADS); pencil_kernel, with
// the G stream's own bounds, otherwise.
//
// Store: the type the fields, the stream, D and C are stored in (T, or
// bfloat16 for a bf16 form).
//
// GRing: the G stream (#1, #2, #6), c G itself, 6 N^3 values a cell read
// by GShared; with S == T the body's f1, f2 of a node go over its
// components 0 and 1 there (the node's owner thread has read all six),
// which saves 2 N^3 values a cell.  With a narrower S (bfloat16 G, float
// arithmetic) they take 2 N^3 values of T a cell slot after the chunk
// buffers.
template <typename T, int N, typename S = T>
struct GRing {
  using Store = S;
  static constexpr int NNN = N * N * N;
  static constexpr bool WIDE = sizeof(S) < sizeof(T);
  static constexpr int CELL = 6 * NNN;
  static constexpr bool BARRIERS = true, RING = true;
  static constexpr int MAX_THREADS = 256, MIN_BLOCKS = 0, BODY = STAGED;
  __host__ __device__ static constexpr int after(int cpb) {
    return WIDE ? 2 * NNN * cpb : 0;
  }
  __device__ static void load(T*, const T*, int, int, int) {}
  T* f;                       // WIDE: the cell slots' f1, f2
  __device__ GRing(T* after_, int, int, int) : f(after_) {}

  struct Cell {
    GShared<T, N, S> metric;
    T* f1;
    T* f2;
  };
  __device__ __forceinline__ Cell cell(S* Gc, int lc) const {
    if constexpr (WIDE)
      return {GShared<T, N, S>{Gc}, f + 2 * NNN * lc, f + 2 * NNN * lc + NNN};
    else
      return {GShared<T, N, S>{Gc}, Gc, Gc + NNN};
  }
};

// CornerGeo: the corner stream (#3 on box pencils with BOX, #6c on stacks),
// a cell's Jacobian channels (37, or 163 for hex27, corner.cuh) from which
// the Corner metric rebuilds c G in registers at each node.  The block
// keeps the cells' f1, f2 (2 N^3 values a cell slot) and the N GLL nodes
// and weights after the chunk buffers; a thread keeps its line's powers
// y^my z^mz for the whole walk, since its (j, k) never changes.  RCP:
// float's division by one approximate reciprocal (corner.cuh).  CAP > 0:
// corner_kernel's blocks of at most 128 threads, CAP of them an SM; 0:
// pencil_kernel's bounds.  S: the channels' storage type (bfloat16, the
// walk's bf16 forms, with float arithmetic): the stage holds them in S
// and Corner widens each where it reads it; f1, f2 and the nodes and
// weights stay in T after the chunk buffers, so the layout beside the
// stages is T's whatever S.
template <typename T, int N, int GD, bool BOX, bool RCP, int CAP,
          typename S = T>
struct CornerGeo {
  using Store = S;
  static constexpr int CELL = CornerChannels<GD>::COUNT;
  static constexpr bool BARRIERS = false, RING = true;
  static constexpr int BODY = STAGED;
  static constexpr int MAX_THREADS = CAP ? 128 : 256;
  static constexpr int MIN_BLOCKS = CAP;
  static constexpr int NNN = N * N * N;
  __host__ __device__ static constexpr int after(int cpb) {
    return 2 * NNN * cpb + 2 * N;
  }
  __device__ static void load(T* after_, const T* Q, int cpb, int tid,
                              int nthreads) {
    for (int s = tid; s < 2 * N; s += nthreads)
      after_[2 * NNN * cpb + s] = Q[s];
  }

  T* f;                       // the cell slots' f1, f2
  const T* q;                 // nodes, then weights
  int j, k;
  LinePowers<T, GD> pw;

  __device__ CornerGeo(T* after_, int cpb, int j_, int k_)
      : f(after_), q(after_ + 2 * NNN * cpb), j(j_), k(k_),
        pw(after_ + 2 * NNN * cpb, j_, k_) {}

  struct Cell {
    Corner<T, N, GD, BOX, RCP, S> metric;
    T* f1;
    T* f2;
  };
  __device__ __forceinline__ Cell cell(const S* ch, int lc) const {
    T* f1 = f + 2 * NNN * lc;
    return {Corner<T, N, GD, BOX, RCP, S>(ch, q, q + N, j, k, pw), f1,
            f1 + NNN};
  }
};

// Bytes before the stages: the STAGES mbarriers, then the row ring and,
// for stacks, the ring of row ids, each padded to 16.
__host__ __device__ constexpr int bars_bytes(int stages) {
  return (8 * stages + 15) / 16 * 16;
}
__host__ __device__ constexpr int ring_bytes() {
  return (8 * RING * ROW + 15) / 16 * 16;
}
__host__ __device__ constexpr int ids_bytes(bool ids, int nn) {
  return ids ? (4 * RING * nn + 15) / 16 * 16 : 0;
}
__host__ __device__ constexpr int head_bytes(int stages, bool ids, int nn) {
  return bars_bytes(stages) + ring_bytes() + ids_bytes(ids, nn);
}

// One class: block b walks pencils b, b + gridDim.x, ... of the class, and
// each pencil's chunks in order (the host launches at most `pencils`
// blocks).  A work item ("pencil" below and in the host's tables) is one
// pencil for #1, #2, #3 and #6; for the two-slab walk (slab2.cu) the two
// pencils of a slab pair one after the other (SlabRows).  G: the geometry
// stream (Geo); Q: the GLL nodes and weights (CornerGeo).  stage_bytes: one
// stage of the ring.  seg0: the class's first pencil's row of the row ids
// (the pencils of the classes before it).  Grid indices are 32-bit (the
// wrapper refuses grids of 2^31 nodes or more).
template <typename T, int N, bool PAIR, typename Rows, typename Geo,
          typename S = typename Geo::Store>
__device__ __forceinline__ void pencil_walk(
    const S* __restrict__ x1, const S* __restrict__ x2,
    const S* __restrict__ C, const S* __restrict__ G,
    const S* __restrict__ D, const T* __restrict__ Q, S* __restrict__ y,
    const long long* __restrict__ chunks, long long first, int pencils,
    int per_pencil, int stages, int stage_bytes, long long seg0,
    Rows lines) {
  constexpr int P = N - 1, NN = N * N, NNN = N * N * N;
  static_assert(Geo::RING || !Rows::XBULK, "x's copies ride in the ring");
  constexpr long long CB = (long long)Geo::CELL * (long long)sizeof(S);
  // the threads that issue x's z-line runs (XBULK): the first warp
  constexpr int XLANES = 32;
  // D in an array of its own, so that the compiler may keep it in
  // registers across the body's stores into the dynamic block
  __shared__ T Ds[NN];                           // D[q * N + i] = l_i'(x_q)
  extern __shared__ __align__(128) unsigned char smem[];
  const int cpb = blockDim.y, lmax = cpb * P + 1;  // a row of a chunk's z
  const int rows = NN * lmax;                    // a chunk buffer's values
  // the stages' mbarriers, and for XBULK one more, x's
  const int nbars = stages + (Rows::XBULK ? 1 : 0);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  long long* rs = reinterpret_cast<long long*>(smem + bars_bytes(nbars));
  int* ids = reinterpret_cast<int*>(smem + bars_bytes(nbars) +
                                    ring_bytes());
  unsigned char* ring = smem + head_bytes(nbars, Rows::IDS, NN);
  // XBULK: the chunk's N^2 z-line runs of x after the stages, each in a
  // slot of xslot bytes (the run's aligned span)
  const int xslot = (lmax * (int)sizeof(S) + 16 + 15) / 16 * 16;
  unsigned char* xa = ring + (long long)stages * stage_bytes;
  // two buffers each: u of every cell, the chunk's y, and for the pair x2
  // and the cells' (c1, c2); then what the geometry keeps (Geo::after)
  T* ub = reinterpret_cast<T*>(xa + (Rows::XBULK ? NN * xslot : 0));
  T* yb = ub + 2 * cpb * NNN;
  T* x2b = yb + 2 * rows;
  T* cb = x2b + 2 * rows;
  T* gb = PAIR ? cb + 4 * cpb : x2b;
  const int t = threadIdx.x, lc = threadIdx.y;   // node line (j, k), cell
  const int tid = lc * NN + t, nthreads = NN * cpb;
  const int j = t / N, k = t % N;
  // this thread's share of a chunk buffer: positions e = rr lmax + z for
  // e = tid, tid + nthreads, ..., at most N of them (NN lmax <= N
  // nthreads), the same for every chunk; f(slot, rr, z) for z < len
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

  // chunks this block walks, in order: the q-th
  const int mine = (pencils - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int total = mine * per_pencil;
  auto pencil = [&](int q) {                     // chunk q's pencil
    return blockIdx.x + (long long)(q / per_pencil) * gridDim.x;
  };
  auto table = [&](int q) {                      // chunk q's table row
    return chunks + ROW * (first + pencil(q) * per_pencil + q % per_pencil);
  };
  auto row = [&](int q) { return rs + (q % RING) * ROW; };  // its copy
  auto rid = [&](int q) { return ids + (q % RING) * NN; };  // its row ids
  auto table_ids = [&](int q) {                  // chunk q's row ids
    return lines.ids + (seg0 + pencil(q)) * NN;
  };
  // the aligned span of x's z-line run rr of chunk row r (XBULK), cut back
  // at x's end, whose last bytes the threads then read themselves
  auto xspan = [&](const long long* r, int rr, long long& off,
                   long long& stop) {
    if constexpr (Rows::XBULK) {
      const long long s0 =
          (long long)lines.template base<N>(r, nullptr, rr) * sizeof(S);
      const long long e0 = s0 + (r[1] * P + 1) * (long long)sizeof(S);
      off = s0 & ~15LL;
      stop = (e0 + 15) & ~15LL;
      if (stop > lines.xbytes) stop = e0 & ~15LL;
    }
  };
  auto issue = [&](int q) {                      // thread 0: G of chunk q
    const long long* r = row(q);
    const int s = q % stages;
    mbar_expect_tx(&bars[s], (unsigned)r[3]);
    bulk_load(ring + (long long)s * stage_bytes,
              reinterpret_cast<const unsigned char*>(G) + r[2],
              (unsigned)r[3], &bars[s]);
  };
  // XBULK, the first warp: x of chunk q into the x area, completing on
  // x's mbarrier (one phase a chunk), once no thread reads the last
  // chunk's there
  auto issue_x = [&](int q) {
    const long long* r = row(q);
    unsigned long long* bar = &bars[stages];
    const unsigned char* xg = reinterpret_cast<const unsigned char*>(x1);
    const int lanes = nthreads < XLANES ? nthreads : XLANES;
    const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
    if (tid == 0) {
      long long bytes = 0, o, e;
      for (int rr = 0; rr < NN; ++rr) {
        xspan(r, rr, o, e);
        bytes += e - o;
      }
      mbar_expect_tx(bar, (unsigned)bytes);
    }
    __syncwarp(mask);
    for (int rr = tid; rr < NN; rr += lanes) {
      long long o, e;
      xspan(r, rr, o, e);
      if (e > o) bulk_load(xa + rr * xslot, xg + o, (unsigned)(e - o), bar);
    }
  };

  // The next chunk's inputs, loaded into registers before the body and
  // written to its buffers after it, so that their latency hides behind
  // the body: its x (into its cells' u, a z-face value into both cells
  // that share it), for the pair x2 and (c1, c2), the y that earlier
  // classes left on its nodes, and the table row of the chunk after it.
  // Consecutive threads on consecutive z.  The first face of a chunk that
  // continues a pencil is the last one's, carried in shared memory.
  // XBULK: x comes from the x area instead, after its copies arrived.
  // Held as stored, widened where they are put.
  S xr[N], x2r[N], yr[N], cr{};
  long long rowr = 0;
  int idr = 0;
  auto fetch = [&](int q) {
    const long long* r = row(q);
    const int* rq = rid(q);
    const int n = (int)r[1], zy = lines.starts(q % per_pencil) ? 0 : 1;
    each(n * P + 1, [&](int e, int rr, int z) {
      const int g = lines.template base<N>(r, rq, rr) + z;
      if (!Rows::XBULK) xr[e] = x1[g];
      if (PAIR) x2r[e] = x2[g];
      if (z >= zy) yr[e] = y[g];
    });
    if (PAIR && tid < 2 * n) cr = C[2 * r[0] + tid];
    if (q + 1 < total && tid < ROW) rowr = table(q + 1)[tid];
    if (Rows::IDS && q + 1 < total && tid < NN) idr = table_ids(q + 1)[tid];
  };
  // parts of put: x into the cells' u, and the rest (XBULK puts x once
  // the chunk's copies have arrived, the rest with the others)
  constexpr int PUT_X = 1, PUT_REST = 2, PUT_ALL = 3;
  auto put = [&](int q, int part) {
    const long long* r = row(q);
    const int b = q & 1, n = (int)r[1], len = n * P + 1;
    const int zy = lines.starts(q % per_pencil) ? 0 : 1;
    T* u = ub + b * cpb * NNN;
    each(len, [&](int e, int rr, int z) {
      if (part & PUT_REST) {
        if (PAIR) x2b[b * rows + rr * lmax + z] = widen<T>(x2r[e]);
        if (z >= zy) yb[b * rows + rr * lmax + z] = widen<T>(yr[e]);
      }
      if (!(part & PUT_X)) return;
      T v = widen<T>(xr[e]);
      if constexpr (Rows::XBULK) {
        long long o, stop;
        xspan(r, rr, o, stop);
        const long long g = lines.template base<N>(r, nullptr, rr) + z;
        const long long at = g * (long long)sizeof(S);
        v = widen<T>(at + (long long)sizeof(S) > stop
                ? x1[g]
                : *reinterpret_cast<const S*>(xa + rr * xslot + (at - o)));
      }
      const int cl = z / P, kk = z - cl * P;
      if (cl < n) u[cl * NNN + rr * N + kk] = v;
      if (kk == 0 && cl > 0) u[(cl - 1) * NNN + rr * N + P] = v;
    });
    if (!(part & PUT_REST)) return;
    if (PAIR && tid < 2 * n) cb[b * 2 * cpb + tid] = widen<T>(cr);
    if (q + 1 < total && tid < ROW) row(q + 1)[tid] = rowr;
    if (Rows::IDS && q + 1 < total && tid < NN) rid(q + 1)[tid] = idr;
  };
  // chunk q's y out, one coalesced pass; a pencil that goes on keeps its
  // last face for the next chunk's first cell
  auto store = [&](int q) {
    const long long* r = row(q);
    const int* rq = rid(q);
    const int b = q & 1, len = (int)r[1] * P + 1;
    const bool more = (q + 1) % per_pencil != 0 &&
                      !lines.starts((q + 1) % per_pencil);
    each(len, [&](int, int rr, int z) {
      const T v = yb[b * rows + rr * lmax + z];
      if (more && z == len - 1)
        yb[(b ^ 1) * rows + rr * lmax] = v;
      else
        y[lines.template base<N>(r, rq, rr) + z] = narrow<S>(v);
    });
  };

  for (int s = tid; s < NN; s += nthreads) Ds[s] = widen<T>(D[s]);
  Geo::load(gb, Q, cpb, tid, nthreads);
  if (tid < ROW) row(0)[tid] = table(0)[tid];
  if (Rows::IDS && tid < NN) rid(0)[tid] = table_ids(0)[tid];
  if (tid == 0) {
    for (int s = 0; s < nbars; ++s) mbar_init(&bars[s], 1);
    mbar_init_fence();
  }
  __syncthreads();                   // D, the first row, the mbarriers
  const Geo geo(gb, cpb, j, k);
  fetch(0);
  put(0, Rows::XBULK ? PUT_REST : PUT_ALL);
  __syncthreads();                   // the first chunk's inputs, row 1
  if (Geo::RING && tid == 0)
    for (int q = 0; q < min(stages, total); ++q) issue(q);
  if (Rows::XBULK) {                 // its x, once its copies arrived
    if (tid < XLANES) issue_x(0);
    mbar_wait(&bars[stages], 0u);
    put(0, PUT_X);
    fence_proxy_async();             // read before the next copy lands
  }

  bool stored = false;               // chunk q - 1's y already went out
  for (int q = 0; q < total; ++q) {
    const long long* r = row(q);
    const long long cell0 = r[0], off = r[2];
    const int n = (int)r[1], b = q & 1;
    T* u = ub + (b * cpb + lc) * NNN;

    // G of the chunk: the copy's span, and past it (only at G's end) the
    // bytes that the aligned span stopped short of, read here
    const int s = Geo::RING ? q % stages : 0;
    unsigned char* stage = ring + (long long)s * stage_bytes;
    if (Geo::RING) {
      read_span_tail(stage, G, (cell0 + n) * CB, off, r[3], tid, nthreads);
      mbar_wait(&bars[s], (unsigned)((q / stages) & 1));
    }
    __syncthreads();                 // the chunk's G arrived, its inputs
                                     // are in place, the last one's adds
                                     // are done
    // no one reads or writes the last chunk's stage again (every thread
    // fenced its f1, f2 writes there): refill it, `stages` chunks ahead
    if (Geo::RING && tid == 0 && q > 0 && q - 1 + stages < total)
      issue(q - 1 + stages);
    // no one reads this chunk's x in the x area again: the next one's
    if (Rows::XBULK && tid < XLANES && q + 1 < total) issue_x(q + 1);

    // the last chunk's y out (its face carried into this one's buffer),
    // unless it went out before this chunk's inputs were fetched; for the
    // pair, u = c1 x1 + c2 x2 on this thread's own line
    const bool active = lc < n;
    if (q > 0 && !stored) store(q - 1);
    stored = false;
    if (PAIR && active) {
      const T c1 = cb[b * 2 * cpb + 2 * lc], c2 = cb[b * 2 * cpb + 2 * lc + 1];
#pragma unroll
      for (int i = 0; i < N; ++i)
        u[i * NN + t] =
            c1 * u[i * NN + t] + c2 * x2b[b * rows + (i * N + j) * lmax +
                                           lc * P + k];
    }
    if (Geo::BARRIERS)
      __syncthreads();               // the carried face in place; the last
                                     // chunk's buffers are free
    // the next chunk's inputs now, or, where it shares nodes with this one
    // beyond the carried face, after this chunk's y is out
    const bool drain = q + 1 < total && (q + 1) % per_pencil != 0 &&
                       lines.drains((q + 1) % per_pencil);
    if (q + 1 < total && !drain) fetch(q + 1);

    // the body, adding into the chunk's y buffer: even cells, then odd
    S* Gc = reinterpret_cast<S*>(stage + (cell0 * CB - off)) + lc * Geo::CELL;
    const auto cell = geo.cell(Gc, lc);
    cell_apply<T, N, false, Geo::BODY>(
        static_cast<const T*>(nullptr), static_cast<const T*>(nullptr), T(1),
        T(0), cell.metric, Ds, u, cell.f1, cell.f2,
        yb + b * rows, active, ZLine{j * lmax + lc * P + k, N * lmax},
        n > 1 ? (lc & 1) : 0, n > 1 ? 2 : 1);
    if (drain) {
      __syncthreads();               // this chunk's adds are done
      store(q);
      stored = true;
      __syncthreads();               // and out, before the next one reads y
      fetch(q + 1);
    }
    if (q + 1 < total) {
      if (Rows::XBULK)               // the next chunk's x arrived
        mbar_wait(&bars[stages], (unsigned)((q + 1) & 1));
      put(q + 1, PUT_ALL);
    }
    fence_proxy_async();             // f1, f2 (and x's reads) before the
                                     // refills
  }
  __syncthreads();                   // the last chunk's adds are done
  store(total - 1);
}

#define FUSTPU_PENCIL_PARAMS                                                 \
  const typename Geo::Store *__restrict__ x1,                               \
      const typename Geo::Store *__restrict__ x2,                           \
      const typename Geo::Store *__restrict__ C,                            \
      const typename Geo::Store *__restrict__ G,                            \
      const typename Geo::Store *__restrict__ D, const T *__restrict__ Q,   \
      typename Geo::Store *__restrict__ y,                                  \
      const long long *__restrict__ chunks, long long first, int pencils,   \
      int per_pencil, int stages, int stage_bytes, long long seg0,          \
      Rows lines

template <typename T, int N, bool PAIR, typename Rows, typename Geo>
__global__ void __launch_bounds__(256)
pencil_kernel(FUSTPU_PENCIL_PARAMS) {
  pencil_walk<T, N, PAIR, Rows, Geo>(x1, x2, C, G, D, Q, y, chunks, first,
                                     pencils, per_pencil, stages,
                                     stage_bytes, seg0, lines);
}

template <typename T, int N, bool PAIR, typename Rows, typename Geo>
__global__ void __launch_bounds__(Geo::MAX_THREADS, Geo::MIN_BLOCKS)
corner_kernel(FUSTPU_PENCIL_PARAMS) {
  pencil_walk<T, N, PAIR, Rows, Geo>(x1, x2, C, G, D, Q, y, chunks, first,
                                     pencils, per_pencil, stages,
                                     stage_bytes, seg0, lines);
}

#undef FUSTPU_PENCIL_PARAMS

// The kernel that walks for a geometry policy.
template <typename T, int N, bool PAIR, typename Rows, typename Geo>
constexpr auto kernel_of() {
  if constexpr (Geo::MIN_BLOCKS > 0)
    return corner_kernel<T, N, PAIR, Rows, Geo>;
  else
    return pencil_kernel<T, N, PAIR, Rows, Geo>;
}

// ---- host side: the launches of one apply, for both kinds of Rows ----

constexpr int MAX_SMEM = 232448;   // one block's shared memory on Hopper

// Lets the kernel take all the dynamic shared memory that its static D
// leaves of a block's.
template <typename T, int N, bool PAIR, typename Rows, typename Geo>
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, kernel_of<T, N, PAIR, Rows, Geo>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel_of<T, N, PAIR, Rows, Geo>(),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM - (int)attr.sharedSizeBytes);
  done = err == cudaSuccess;
  return err;
}

// One launch per class (classes: nclass x 3 host int64, first row,
// pencils, chunks a pencil) of a persistent grid of at most `blocks`
// blocks of N^2 x cpb threads.  Returns 0 or the first cudaError_t.
template <typename T, int N, bool PAIR, typename Geo, typename Rows>
int launch_classes(const void* x1, const void* x2, const void* C,
                   const void* G, const void* D, const void* Q, void* y,
                   const void* chunks, const long long* classes, int nclass,
                   int blocks, int cpb, int stages, int stage_bytes, int smem,
                   Rows lines, cudaStream_t stream) {
  using S = typename Geo::Store;
  cudaError_t err = allow_smem<T, N, PAIR, Rows, Geo>();
  if (err != cudaSuccess) return (int)err;
  const dim3 block(N * N, cpb);
  long long seg0 = 0;
  for (int c = 0; c < nclass; ++c) {
    const long long first = classes[3 * c], pencils = classes[3 * c + 1];
    const int per_pencil = (int)classes[3 * c + 2];
    if (pencils <= 0) continue;
    const unsigned grid = (unsigned)(pencils < blocks ? pencils : blocks);
    const auto kernel = kernel_of<T, N, PAIR, Rows, Geo>();
    kernel<<<grid, block, smem, stream>>>(
        static_cast<const S*>(x1), static_cast<const S*>(x2),
        static_cast<const S*>(C), static_cast<const S*>(G),
        static_cast<const S*>(D), static_cast<const T*>(Q),
        static_cast<S*>(y),
        static_cast<const long long*>(chunks), first, (int)pencils, per_pencil,
        stages, stage_bytes, seg0, lines);
    seg0 += pencils;
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Blocks of N^2 x cpb threads with smem dynamic shared bytes that one SM
// holds at once, or minus the cudaError_t of a failed query; 0 for a
// block larger than the kernel's launch bounds allow (its
// maxThreadsPerBlock), so that the host's schedules take that limit from
// the kernel itself.
template <typename T, int N, bool PAIR, typename Geo, typename Rows>
int occupancy(int cpb, int smem) {
  cudaError_t err = allow_smem<T, N, PAIR, Rows, Geo>();
  if (err != cudaSuccess) return -(int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel_of<T, N, PAIR, Rows, Geo>());
  if (err != cudaSuccess) return -(int)err;
  if (N * N * cpb > attr.maxThreadsPerBlock) return 0;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel_of<T, N, PAIR, Rows, Geo>(), N * N * cpb, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace pencil
}  // namespace fustpu

// The degrees every kernel is instantiated for.
#define FUSTPU_DEGREES(M) \
  M(2) M(3) M(4) M(5) M(6) M(7) M(8) M(9) M(10)
