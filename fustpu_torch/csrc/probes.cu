// Two memory probes of the experiment demos.
//
// 1. g_layout (replaces the Pallas TPU kernel of demos/exp_g_layout.py:
//    _call, :24, via padded_sum :37 and flat_sum :55): a weighted sum of a
//    G-shaped array, out[ey, ez] = c + sum_{a, i, m} (1 + m) G, reading G
//    in two layouts.  The TPU compares a lane-padded 2-D (ey, ez) tile
//    with a flat (ey ez) one; the card pads nothing, so the counterparts
//    are the stiffness kernels' per-cell layout (cells, 6, N^3) and a
//    component-major one (6, cells, N^3), the same values permuted.  Cell
//    (a, b, c) node (i, j, k) lands on out[b N + j, c N + k].
//    Bound: the bytes of G (98.3 MB at P = 4, 32^3 cells, float32), read
//    once; 2 operations a value.  Design: deterministic, no atomics.  A
//    block takes CPB (b, c) columns of cells and one of S fixed chunks of
//    a; each thread owns one (j, k) of a column and sums its chunk's
//    cells, components and i in a fixed order (consecutive threads on
//    consecutive nodes of one cell's component: runs of N^2 values); the
//    S partial planes are then summed in a fixed order with c by a second
//    pass.
//
// 2. relayout (replaces the Pallas TPU kernel of
//    demos/exp_mosaic_relayout.py: probe, :38, pallas_call :43): pure
//    permutations over tiles of (8192, 1) float32.  The TPU probes its
//    sublane -> lane relayout; on the card a row-major reshape (and its
//    reverse, and a copy) moves no element, so those are one copy, and the
//    transpose of each (64, 128) tile to (128, 64) moves its elements
//    through shared memory.  Bound: the bytes, read once and written once
//    (8.4 MB at 2^20 values, 1.07 GB at 2^27).  Design:
//    - relayout_copy: each block copies one contiguous span of 2 x 256
//      16 B vectors, each thread two of them, both loads (past L1) in
//      flight before its streaming (.cs) stores, on a grid that covers the
//      array (ops/launch.py `copy_blocks`): blocks start in address order,
//      so the card sweeps the array (a one-wave grid that strides over it,
//      four or eight vectors a thread, or stores without the .cs hint ran
//      slower at 2^27 values);
//    - relayout_transpose: one block a tile; 16 B loads of the input rows
//      into a shared tile, each 16 B vector at a column group XORed with
//      its row group (a swizzle in place of padding, so the tile's rows
//      stay 16 B-aligned), then 16 B stores of the output rows, each
//      gathered from V = 16 / E values of one column; 4- and 8-byte
//      elements;
//    - the first designs stay as the comparison: relayout_copy_flat (one
//      16 B vector a thread on a grid that covers them all) and
//      relayout_transpose_padded (32 x 32 tiles of single elements, padded
//      to 33 columns against bank conflicts).

#include <cuda_runtime.h>

#include "cache_hints.cuh"

namespace {

// G: cells layout (cells, 6, NNN), or COMP (6, cells, NNN).
// part: (S, ncy N, ncz N), chunk s over a in [s ncx / S, (s + 1) ncx / S).
template <typename T, bool COMP>
__global__ void g_layout_partial(const T* __restrict__ G, T* __restrict__ part,
                                 int n, int ncx, int ncy, int ncz, int S) {
  const int nn = n * n, nnn = nn * n;
  const int t = threadIdx.x;                      // (j, k) = (t / n, t % n)
  const long long col = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const int s = blockIdx.y;
  if (col >= (long long)ncy * ncz) return;
  const long long b = col / ncz, c = col % ncz;
  const long long cells = (long long)ncx * ncy * ncz;
  const int a0 = (int)((long long)s * ncx / S);
  const int a1 = (int)((long long)(s + 1) * ncx / S);
  T acc = T(0);
  for (int a = a0; a < a1; ++a) {
    const long long cell = ((long long)a * ncy + b) * ncz + c;
    for (int m = 0; m < 6; ++m) {
      const T w = T(1 + m);
      const T* g = COMP ? G + ((long long)m * cells + cell) * nnn
                        : G + (cell * 6 + m) * nnn;
      for (int i = 0; i < n; ++i) acc += w * g[i * nn + t];
    }
  }
  const long long ez = (long long)ncz * n;
  part[((long long)s * ncy * n + b * n + t / n) * ez + c * n + t % n] = acc;
}

template <typename T>
__global__ void g_layout_finish(const T* __restrict__ part,
                                const T* __restrict__ c, T* __restrict__ out,
                                long long plane, int S) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= plane) return;
  T acc = c[e];
  for (int s = 0; s < S; ++s) acc += part[s * plane + e];
  out[e] = acc;
}

template <typename T, bool COMP>
int g_layout(const void* G, const void* c, void* part, void* out, int n,
             int ncx, int ncy, int ncz, int S, cudaStream_t stream) {
  const int nn = n * n;
  const int cpb = nn >= 256 ? 1 : 256 / nn;
  const long long cols = (long long)ncy * ncz;
  const dim3 grid((unsigned)((cols + cpb - 1) / cpb), (unsigned)S);
  g_layout_partial<T, COMP><<<grid, dim3(nn, cpb), 0, stream>>>(
      static_cast<const T*>(G), static_cast<T*>(part), n, ncx, ncy, ncz, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long plane = cols * nn;
  g_layout_finish<T><<<(unsigned)((plane + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(part), static_cast<const T*>(c),
      static_cast<T*>(out), plane, S);
  err = cudaGetLastError();
  return err == cudaSuccess ? 0 : (int)err;
}

// nbytes: a multiple of 16; both pointers 16-byte aligned.
__global__ void relayout_copy_flat(const uint4* __restrict__ x,
                                   uint4* __restrict__ y, long long nvec) {
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < nvec; v += (long long)gridDim.x * blockDim.x)
    y[v] = x[v];
}

// x: (B, R, C) -> y: (B, C, R), elements of type E (moved bit for bit).
template <typename E>
__global__ void relayout_transpose_padded(const E* __restrict__ x,
                                          E* __restrict__ y, int R, int C) {
  __shared__ E tile[32][33];
  const long long off = (long long)blockIdx.z * R * C;
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int dr = threadIdx.y; dr < 32; dr += blockDim.y) {
    const int r = r0 + dr, c = c0 + threadIdx.x;
    if (r < R && c < C) tile[dr][threadIdx.x] = x[off + (long long)r * C + c];
  }
  __syncthreads();
  for (int dc = threadIdx.y; dc < 32; dc += blockDim.y) {
    const int c = c0 + dc, r = r0 + threadIdx.x;
    if (r < R && c < C) y[off + (long long)c * R + r] = tile[threadIdx.x][dc];
  }
}

template <typename E>
int transpose_padded(const void* x, void* y, int B, int R, int C,
                     cudaStream_t stream) {
  const dim3 grid((C + 31) / 32, (R + 31) / 32, B);
  relayout_transpose_padded<E><<<grid, dim3(32, 8), 0, stream>>>(
      static_cast<const E*>(x), static_cast<E*>(y), R, C);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : (int)err;
}

constexpr int kCopyThreads = 256;   // ops/launch.py COPY_THREADS
constexpr int kCopyUnroll = 2;      // ops/launch.py COPY_UNROLL

// nvec 16 B vectors; both pointers 16-byte aligned.  Block b copies vectors
// [b U 256, (b + 1) U 256): thread t its vectors b U 256 + u 256 + t, all
// U loads before the stores, where the block's span ends inside the array.
__global__ void __launch_bounds__(kCopyThreads)
relayout_copy(const uint4* __restrict__ x, uint4* __restrict__ y,
              long long nvec) {
  const long long v =
      (long long)blockIdx.x * kCopyThreads * kCopyUnroll + threadIdx.x;
  if (v + (kCopyUnroll - 1) * kCopyThreads < nvec) {
    uint4 r[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u)
      r[u] = fustpu::ld_stream(x + v + u * kCopyThreads);
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u)
      fustpu::st_stream(y + v + u * kCopyThreads, r[u]);
  } else {
    for (int u = 0; u < kCopyUnroll; ++u)
      if (v + u * kCopyThreads < nvec)
        fustpu::st_stream(y + v + u * kCopyThreads,
                          fustpu::ld_stream(x + v + u * kCopyThreads));
  }
}

constexpr int kTileRows = 64, kTileCols = 128;   // the (8192, 1) tile
constexpr int kTileThreads = 256;

// x: (B, 64, 128) -> y: (B, 128, 64), E-byte elements moved bit for bit,
// one block a tile.  V = 16 / E elements a vector; the tile holds input
// row r's vector group cg at r * CV + (cg ^ (r / V) % CV), so that the V
// rows that one output vector reads from one column fall on different
// banks for different row groups.
template <typename E>
__global__ void __launch_bounds__(kTileThreads)
relayout_transpose(const uint4* __restrict__ x, uint4* __restrict__ y) {
  constexpr int V = 16 / sizeof(E);
  constexpr int CV = kTileCols / V, RV = kTileRows / V;
  constexpr int NV = kTileRows * kTileCols / V;    // vectors a tile
  constexpr int PER = NV / kTileThreads;
  extern __shared__ uint4 tile[];                  // NV vectors
  const long long base = (long long)blockIdx.x * NV;
  uint4 r[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k)
    r[k] = fustpu::ld_stream(x + base + k * kTileThreads + threadIdx.x);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = k * kTileThreads + threadIdx.x;
    const int row = i / CV, cg = i % CV;
    tile[row * CV + (cg ^ ((row / V) % CV))] = r[k];
  }
  __syncthreads();
  const E* t = reinterpret_cast<const E*>(tile);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = k * kTileThreads + threadIdx.x;
    const int col = j / RV, rg = j % RV;           // rows rg V .. rg V + V - 1
    const int at = ((col / V) ^ (rg % CV)) * V + col % V;
    alignas(16) E v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = t[(rg * V + e) * kTileCols + at];
    y[base + j] = *reinterpret_cast<const uint4*>(v);
  }
}

template <typename E>
int transpose(const void* x, void* y, int B, cudaStream_t stream) {
  constexpr int bytes = kTileRows * kTileCols * sizeof(E);
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        relayout_transpose<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  relayout_transpose<E><<<B, kTileThreads, bytes, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y));
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : (int)err;
}

}  // namespace

// C entry points.  Each returns 0, -1 for an unsupported argument, or the
// cudaError_t of the first failed launch.  part: (S, ncy N, ncz N)
// scratch; c and out: (ncy N, ncz N).
extern "C" {

int fustpu_g_layout_f32(const void* G, const void* c, void* part, void* out,
                        int comp, int n, int ncx, int ncy, int ncz, int S,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * n > 1024 || S < 1) return -1;
  return comp ? g_layout<float, true>(G, c, part, out, n, ncx, ncy, ncz, S, s)
              : g_layout<float, false>(G, c, part, out, n, ncx, ncy, ncz, S,
                                       s);
}

int fustpu_g_layout_f64(const void* G, const void* c, void* part, void* out,
                        int comp, int n, int ncx, int ncy, int ncz, int S,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * n > 1024 || S < 1) return -1;
  return comp ? g_layout<double, true>(G, c, part, out, n, ncx, ncy, ncz, S,
                                       s)
              : g_layout<double, false>(G, c, part, out, n, ncx, ncy, ncz, S,
                                        s);
}

int fustpu_relayout_copy(const void* x, void* y, long long nbytes,
                         int blocks, void* stream) {
  if (nbytes % 16 != 0 || blocks < 1) return -1;
  if (nbytes > 0)
    relayout_copy<<<blocks, kCopyThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), nbytes / 16);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : (int)err;
}

// B tiles of (64, 128) -> (128, 64).
int fustpu_relayout_transpose(const void* x, void* y, int esize, int B,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return B == 0 ? 0 : -1;
  if (esize == 4) return transpose<unsigned int>(x, y, B, s);
  if (esize == 8) return transpose<unsigned long long>(x, y, B, s);
  return -1;
}

int fustpu_relayout_copy_flat(const void* x, void* y, long long nbytes,
                              void* stream) {
  if (nbytes % 16 != 0) return -1;
  const long long nvec = nbytes / 16;
  const long long blocks = nvec < 4 * 132 * 256 ? (nvec + 255) / 256
                                                 : 4 * 132 * 8;
  if (nvec > 0)
    relayout_copy_flat<<<(unsigned)blocks, 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), nvec);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : (int)err;
}

int fustpu_relayout_transpose_padded(const void* x, void* y, int esize,
                                     int B, int R, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (esize == 4) return transpose_padded<unsigned int>(x, y, B, R, C, s);
  if (esize == 8)
    return transpose_padded<unsigned long long>(x, y, B, R, C, s);
  return -1;
}

}  // extern "C"
