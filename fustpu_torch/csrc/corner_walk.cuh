// The corner-streamed stiffness apply of the capacity mode on the walk of
// the z-pencil kernel (stiffness_pencil.cuh with the CornerGeo policy):
// the launch templates and the C entry points shared by corner_pencil.cu
// (box pencils, #3) and corner_stack.cu / corner_stack27.cu (extruded
// stacks, #6c, hex8 and hex27).
//
// Replaces the Pallas TPU kernels fustpu/ops/pallas_stiffness.py
// _mk_kernel_corner (:963, via _apply_corner :1081) and
// fustpu/ops/pallas_extruded.py _mk_kernel (:604) with `corner` set (via
// stiffness_apply_extruded_pallas :841 and its pair form :860).  Their
// first CUDA design, 8 class launches of scattered cells a class-launch
// template (stiffness.cuh with CORNER, extruded.cuh with GD = 1, 2), keeps
// its entry points in corner.cu, extruded_corner.cu and
// extruded_corner27.cu.
//
// What bounds it on an H100: the operations.  At the flagship (102,400
// cells, P = 4, float32) an apply must move ~95 MB (x, y read and
// written, 37 channels a cell: 0.028 ms at 3.35 TB/s) but computes ~2.1
// GFLOP (J, adj(J), det and the factored metric at every node beside the
// sum factorisation; 0.031 ms at 67 TFLOP/s), ~3.3 GFLOP for hex27.
//
// What the design does about the class-launch design's costs:
//   - 8 serial class launches of scattered cells, each with its own tail
//     -> the persistent walk: 4 colour classes of box pencils, or stack
//     colours (with z-segments where a colour has too few stacks), each
//     block walking whole pencils in chunks of consecutive cells;
//   - every cell loading its own N^3 values of x and adding into y 4 B at
//     a time -> x and the y of earlier classes through registers into
//     shared buffers, a chunk's cells adding in two turns there, the face
//     between two chunks carried in shared memory, y written out once per
//     chunk, coalesced;
//   - 148 B (652 B for hex27) of channels read by each cell's threads ->
//     one bulk copy (TMA) of each chunk's run of channels into a ring of
//     shared stages, the next chunk's in flight while a chunk contracts
//     (the box order cx*ncy*ncz + cy*ncz + cz and the stack order s*nz +
//     kz are the orders in which the walk takes a pencil's cells);
//   - the line's powers y^my z^mz rebuilt for every cell -> kept by each
//     thread for the walk (its line never changes); one barrier a chunk
//     fewer than the G stream's walk (CornerGeo::BARRIERS);
//   - the walk holds its state and the next chunk's inputs beside the
//     metric: unbounded, ptxas gives it 128-168 registers a thread (the
//     class-launch design 76-80), 2 to 4 blocks an SM -> a register budget
//     for each form (CAP, RCP below).
// No atomics: the class order, the pencils of a class (disjoint in their
// nodes), the chunk order and the turn order fix every node's order of
// adds, so two applies are bitwise equal.  No tensor cores (5 x 5
// contractions; TF32 would break the float32 gate of 1e-6); accumulators
// in the template type.
//
// bfloat16 (the JAX package's --dtype bf16, the capacity mode at half the
// bytes): the bf16 entry points store x, x2, y, the channels, D and C in
// bfloat16 and compute in float (CornerGeo's storage type S, the walk's
// Store; stiffness_pencil.cuh): the stage holds the chunk's channels in
// bfloat16 (74 B a cell, 326 B for hex27), Corner widens each where it
// folds it, the GLL nodes and weights Q, the chunk buffers, f1, f2 and
// every sum stay float, and y rounds to bfloat16 where it is stored.  The
// register budget and the division are float's (CAP and RCP are keyed on
// the arithmetic type).

#pragma once

#include <cuda_runtime.h>

#include "stiffness_pencil.cuh"

namespace fustpu {
namespace corner_walk {

// The register budget and the division, chosen by measurement at P = 4
// in turns (PERF.md §6):
//   - the single-field trilinear float walk (#3, #6c hex8) at P <= 4 in
//     blocks of at most 128 threads, 5 of them an SM (96 registers a
//     thread, no spills): 18-25% faster than 128 registers at 2 to 4
//     blocks; at P >= 5 that cap spills (36-440 B a thread, ptxas -v), and
//     the walk keeps the G stream's bounds;
//   - the pair and hex27 forms spill under that cap: they keep the G
//     stream's bounds, where ptxas gives them 128 registers or more;
//   - float's division as one approximate reciprocal where that keeps the
//     kernel within its registers (the capped walks and box pencils);
//     stacks otherwise keep IEEE division, whose 144-168 registers give 3
//     blocks an SM and short stack segments, faster than 4 blocks of the
//     reciprocal's 128.  Float64 keeps IEEE division and the G stream's
//     bounds.
template <typename T, int N, int GD, bool PAIR>
constexpr int CAP = sizeof(T) == 4 && GD == 1 && !PAIR && N <= 5 ? 5 : 0;
template <typename T, int N, int GD, bool BOX, bool PAIR>
constexpr bool RCP = sizeof(T) == 4 && (BOX || CAP<T, N, GD, PAIR> > 0);

template <typename T, int N, int GD, bool BOX, bool PAIR, typename S = T>
using Geo = pencil::CornerGeo<T, N, GD, BOX, RCP<T, N, GD, BOX, PAIR>,
                              CAP<T, N, GD, PAIR>, S>;

// One apply: the classes of the schedule (ops/cuda_stiffness.py
// `pencil_schedule`, ops/cuda_extruded.py `stack_schedule`), each one
// launch.  Tch: (cells, 37 or 163) channels in the walk's cell order; Q:
// (2, N) GLL nodes, then weights, in T; the rest in S.
template <typename T, typename S, bool PAIR, int GD, bool BOX, typename Rows>
int launch(int P, const void* x1, const void* x2, const void* C,
           const void* Tch, const void* D, const void* Q, void* y,
           const void* chunks, const long long* classes, int nclass,
           int blocks, int cpb, int stages, int stage_bytes, int smem,
           Rows lines, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSTPU_CASE(P_)                                                     \
  case P_:                                                                  \
    return pencil::launch_classes<T, P_ + 1, PAIR,                          \
                                  Geo<T, P_ + 1, GD, BOX, PAIR, S>>(        \
        x1, x2, C, Tch, D, Q, y, chunks, classes, nclass, blocks, cpb,      \
        stages, stage_bytes, smem, lines, s);
  switch (P) {
    FUSTPU_DEGREES(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

template <typename T, typename S, bool PAIR, int GD, bool BOX, typename Rows>
int occupancy_of(int P, int cpb, int smem) {
#define FUSTPU_CASE(P_)                                                      \
  case P_:                                                                   \
    return pencil::occupancy<T, P_ + 1, PAIR,                                \
                             Geo<T, P_ + 1, GD, BOX, PAIR, S>, Rows>(cpb,    \
                                                                    smem);
  switch (P) {
    FUSTPU_DEGREES(FUSTPU_CASE)
    default:
      return -1;
  }
#undef FUSTPU_CASE
}

// Blocks of the kernel for (P, type, pair?) with cpb cells and smem
// dynamic shared bytes that one SM holds at once; type 0 float32, 1
// float64, 2 bfloat16 (ops/cuda_stiffness.py TYPE_CODE); -1 for an
// unsupported degree, minus the cudaError_t of a failed query.
template <typename T, typename S, int GD, bool BOX, typename Rows>
int occupancy_typed(int P, int pair, int cpb, int smem) {
  return pair ? occupancy_of<T, S, true, GD, BOX, Rows>(P, cpb, smem)
              : occupancy_of<T, S, false, GD, BOX, Rows>(P, cpb, smem);
}

template <int GD, bool BOX, typename Rows>
int occupancy(int P, int type, int pair, int cpb, int smem) {
  if (type == 1)
    return occupancy_typed<double, double, GD, BOX, Rows>(P, pair, cpb,
                                                          smem);
  if (type == 2)
    return occupancy_typed<float, __nv_bfloat16, GD, BOX, Rows>(P, pair,
                                                                cpb, smem);
  return occupancy_typed<float, float, GD, BOX, Rows>(P, pair, cpb, smem);
}

}  // namespace corner_walk
}  // namespace fustpu

// The C entry points of the stack walk of geometry degree GD:
// fustpu_<NAME>_{f32,f64,bf16}, fustpu_<NAME>_pair_{f32,f64,bf16} and
// fustpu_<NAME>_occupancy (bf16: stored in bfloat16, computed in float).
// Each launcher returns 0, -1 for an unsupported degree, or the
// cudaError_t of the first failed call; y must be zeroed by the caller.
// chunks: (rows, 5) int64 and ids: (segments, N^2) int32 on the device;
// classes: nclass x 3 int64 on the host.
#define FUSTPU_CORNER_STACK_ONE(NAME, SUF, T, S, GD)                          \
  int fustpu_##NAME##_##SUF(                                                  \
      const void* x, const void* Tch, const void* D, const void* Q, void* y,  \
      int P, const void* chunks, const void* ids, const long long* classes,   \
      int nclass, int blocks, int cpb, int stages, int stage_bytes,           \
      int smem, int nz, void* stream) {                                       \
    return fustpu::corner_walk::launch<T, S, false, GD, false>(               \
        P, x, nullptr, nullptr, Tch, D, Q, y, chunks, classes, nclass,        \
        blocks, cpb, stages, stage_bytes, smem,                               \
        fustpu::pencil::StackRows{nz * P + 1, 0,                              \
                                  static_cast<const int*>(ids)},              \
        stream);                                                              \
  }                                                                           \
  int fustpu_##NAME##_pair_##SUF(                                             \
      const void* x1, const void* x2, const void* C, const void* Tch,         \
      const void* D, const void* Q, void* y, int P, const void* chunks,       \
      const void* ids, const long long* classes, int nclass, int blocks,      \
      int cpb, int stages, int stage_bytes, int smem, int nz,                 \
      void* stream) {                                                         \
    return fustpu::corner_walk::launch<T, S, true, GD, false>(                \
        P, x1, x2, C, Tch, D, Q, y, chunks, classes, nclass, blocks, cpb,     \
        stages, stage_bytes, smem,                                            \
        fustpu::pencil::StackRows{nz * P + 1, 0,                              \
                                  static_cast<const int*>(ids)},              \
        stream);                                                              \
  }

#define FUSTPU_CORNER_STACK(NAME, GD)                                        \
  extern "C" {                                                               \
  FUSTPU_CORNER_STACK_ONE(NAME, f32, float, float, GD)                       \
  FUSTPU_CORNER_STACK_ONE(NAME, f64, double, double, GD)                     \
  FUSTPU_CORNER_STACK_ONE(NAME, bf16, float, __nv_bfloat16, GD)              \
  int fustpu_##NAME##_occupancy(int P, int type, int pair, int cpb,          \
                                int smem) {                                  \
    return fustpu::corner_walk::occupancy<GD, false,                         \
                                          fustpu::pencil::StackRows>(        \
        P, type, pair, cpb, smem);                                           \
  }                                                                          \
  }
