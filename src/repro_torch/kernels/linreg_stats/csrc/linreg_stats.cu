// Fused linear-regression statistics for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/linreg_stats/kernel.py (zt_z /
// _kernel, wrapper ops.py::linreg_stats): G = Z^T Z for Z = [X | y], so
// A = X^T X is G[:d, :d], B = X^T y is G[:d, d] and y^T y is G[d, d], with
// fp32 accumulation for fp32 and bf16 inputs.
//
// What differs from the TPU design.  The TPU kernel pads Z to 128 lanes in a
// copy and accumulates serially into one revisited output block across a
// sequential grid.  Here X (n, d) and y (n,) are read in place, no padded
// copy is made, and the rows are split over many blocks that run in no
// fixed order.  Pass 1 writes one partial G per row split; pass 2
// (ztz_reduce) has one thread per output sum the splits' partials in split
// order 0, 1, 2, ...  Pass 1 has two forms:
//   narrow, D = d + 1 <= 16 (the analytics path's d 10): ztz_rows<D>.  Each
//     thread walks rows r0 + t, r0 + t + 256, ... of its block's split,
//     loads the row's D values into registers and adds the row's outer
//     product into D (D+1) / 2 register sums (the upper triangle).  The
//     block then sums its threads in a fixed order: a butterfly within each
//     warp, then the 8 warps in order.  No shared-memory staging and no
//     barrier in the row loop: the scan streams.
//   wide, any d: ztz_partial.  The output is cut into 32 x 32 tiles (d 130
//     takes 5 x 5); grid (splits, tiles).  A block stages 64 rows of its
//     tile's two column strips in shared memory and each thread adds its 4
//     outputs over those rows in row order.
// No floating-point atomics: every sum has a fixed order, so the same data
// give bitwise the same statistics on every run.  G is bitwise symmetric
// (the narrow form writes the upper triangle to both halves; the wide form
// has fma(a, b, c) == fma(b, a, c)).
//
// Bound.  2 (d+1)^2 FLOPs per row against (d+1) * 4 bytes per row: about
// 5.5 FLOP/byte at d 10, far below the card's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte), so the function is bound by bytes; the full
// 5M x 10 fp32 scan (220 MB) needs 0.066 ms.  Both forms read each byte
// once per block that needs it (the narrow form exactly once) and split the
// rows into enough blocks to keep every SM loading.  The narrow form's
// weakness: a row's scalar loads touch ~10 L1 lines per warp instruction
// (rows are 4 D bytes apart), so L1 traffic, not HBM, may set its pace.
// The wide form's, for a later PR: single-buffered staging (loads do not
// overlap the FMAs), scalar loads with lanes past d + 1 idle, no tensor
// cores.
//
// The launch goes on the caller's stream; the kernel allocates nothing (the
// wrapper picks the form and passes the scratch and output tensors).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr int TILE = 32;      // wide form: output tile edge
constexpr int ROWS = 64;      // wide form: rows staged in shared memory at once
constexpr int NT = 256;       // threads per block (wide: TILE rows x 8 quads)
constexpr int JQ = 4;         // wide form: outputs per thread (a column quad)
constexpr int NARROW_D = 16;  // largest D = d + 1 of the narrow form

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Z = [X | y] at (row r, column c), c <= d
template <typename T>
__device__ __forceinline__ float z_at(const T* __restrict__ X,
                                      const T* __restrict__ y,
                                      size_t r, int c, int d) {
  return c < d ? load(X + r * (size_t)d + c) : load(y + r);
}

template <typename T>
__global__ void __launch_bounds__(NT)
ztz_partial(const T* __restrict__ X, const T* __restrict__ y,
            float* __restrict__ partial, long long n, int d,
            long long rows_per_split, int side) {
  __shared__ float zi[ROWS][TILE];
  __shared__ __align__(16) float zj[ROWS][TILE];
  const int D = d + 1;
  const int tile = blockIdx.y;
  const int ci0 = (tile / side) * TILE, cj0 = (tile % side) * TILE;
  const long long r0 = (long long)blockIdx.x * rows_per_split;
  const long long r1 = min(n, r0 + rows_per_split);
  const int tid = threadIdx.x;
  const int i = tid / (TILE / JQ), j0 = (tid % (TILE / JQ)) * JQ;
  const bool live = ci0 + i < D && cj0 + j0 < D;
  float acc[JQ] = {0.f, 0.f, 0.f, 0.f};

  for (long long rb = r0; rb < r1; rb += ROWS) {
    const int nr = (int)min((long long)ROWS, r1 - rb);
#pragma unroll
    for (int k = 0; k < ROWS * TILE / NT; ++k) {
      const int e = tid + k * NT;
      const int r = e / TILE, c = e % TILE;
      float a = 0.f, b = 0.f;
      if (r < nr) {
        if (ci0 + c < D) a = z_at(X, y, (size_t)(rb + r), ci0 + c, d);
        if (cj0 + c < D) b = z_at(X, y, (size_t)(rb + r), cj0 + c, d);
      }
      zi[r][c] = a;
      zj[r][c] = b;
    }
    __syncthreads();
    if (live) {
      for (int r = 0; r < nr; ++r) {
        const float a = zi[r][i];
        const float4 b = *reinterpret_cast<const float4*>(&zj[r][j0]);
        acc[0] = fmaf(a, b.x, acc[0]);
        acc[1] = fmaf(a, b.y, acc[1]);
        acc[2] = fmaf(a, b.z, acc[2]);
        acc[3] = fmaf(a, b.w, acc[3]);
      }
    }
    __syncthreads();
  }
  float* out = partial + ((size_t)blockIdx.x * gridDim.y + tile) * (TILE * TILE)
               + i * TILE + j0;
#pragma unroll
  for (int k = 0; k < JQ; ++k) out[k] = acc[k];
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
ztz_rows(const T* __restrict__ X, const T* __restrict__ y,
         float* __restrict__ partial, long long n, long long rows_per_split) {
  constexpr int K = D * (D + 1) / 2;         // upper triangle, row-major
  constexpr int d = D - 1;
  __shared__ float red[NT / 32][K];
  const long long r0 = (long long)blockIdx.x * rows_per_split;
  const long long r1 = min(n, r0 + rows_per_split);
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
#pragma unroll 2
  for (long long r = r0 + threadIdx.x; r < r1; r += NT) {
    float z[D];
    const T* row = X + (size_t)r * d;
#pragma unroll
    for (int c = 0; c < d; ++c) z[c] = load(row + c);
    z[d] = load(y + r);
    int k = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = i; j < D; ++j) {
        acc[k] = fmaf(z[i], z[j], acc[k]);
        ++k;
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += NT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += red[w][k];
    partial[(size_t)blockIdx.x * K + k] = s;
  }
}

// out[i][j] = sum over splits of the partials, in split order.  Narrow
// partials hold the upper triangle (side == 0); wide ones 32 x 32 tiles.
__global__ void ztz_reduce(const float* __restrict__ partial,
                           float* __restrict__ out, int d, int splits,
                           int side) {
  const int D = d + 1;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= D * D) return;
  const int i = idx / D, j = idx % D;
  const float* p;
  size_t stride;
  if (side == 0) {
    const int a = i < j ? i : j, b = i < j ? j : i;
    stride = (size_t)D * (D + 1) / 2;
    p = partial + (size_t)a * D - (size_t)a * (a - 1) / 2 + (b - a);
  } else {
    const int tile = (i / TILE) * side + (j / TILE);
    stride = (size_t)side * side * TILE * TILE;
    p = partial + (size_t)tile * TILE * TILE + (i % TILE) * TILE + (j % TILE);
  }
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += p[k * stride];
  out[idx] = s;
}

template <typename T, int D>
int launch_narrow(const void* X, const void* y, float* partial, long long n,
                  int d, int splits, long long rows_per_split, cudaStream_t s) {
  if constexpr (D > 2) {
    if (d + 1 < D)
      return launch_narrow<T, D - 1>(X, y, partial, n, d, splits, rows_per_split, s);
  }
  ztz_rows<T, D><<<splits, NT, 0, s>>>(static_cast<const T*>(X),
                                        static_cast<const T*>(y), partial, n,
                                        rows_per_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* X, const void* y, float* partial, float* out,
           long long n, int d, int splits, long long rows_per_split,
           bool narrow, cudaStream_t s) {
  int side = 0;
  int err;
  if (narrow) {
    err = launch_narrow<T, NARROW_D>(X, y, partial, n, d, splits,
                                     rows_per_split, s);
  } else {
    side = (d + 1 + TILE - 1) / TILE;
    ztz_partial<T><<<dim3(splits, side * side), NT, 0, s>>>(
        static_cast<const T*>(X), static_cast<const T*>(y), partial, n, d,
        rows_per_split, side);
    err = (int)cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const int D2 = (d + 1) * (d + 1);
  ztz_reduce<<<(D2 + 255) / 256, 256, 0, s>>>(partial, out, d, splits, side);
  return (int)cudaGetLastError();
}

}  // namespace

// G = [X | y]^T [X | y] into out ((d+1) x (d+1) fp32, row-major).
// X (n, d) and y (n,) contiguous, both fp32 (dtype 0) or bf16 (dtype 1).
// The caller picks the form (narrow needs d + 1 <= 16) and sizes the
// scratch for it: partial must hold splits * (d+1)(d+2)/2 floats (narrow)
// or splits * ceil((d+1)/32)^2 * 1024 (wide); a smaller one is refused.
// Split k covers rows [k * rows_per_split, min(n, (k+1) * rows_per_split)).
extern "C" int repro_linreg_stats(const void* X, const void* y, void* partial,
                                  long long partial_floats, void* out,
                                  long long n, int d, int splits,
                                  long long rows_per_split, int narrow,
                                  int dtype, void* stream) {
  if (n <= 0 || d <= 0 || splits <= 0 || rows_per_split <= 0 ||
      (long long)splits * rows_per_split < n || (narrow && d + 1 > NARROW_D))
    return (int)cudaErrorInvalidValue;
  const int side = (d + 1 + TILE - 1) / TILE;
  const long long need = narrow ? (long long)splits * (d + 1) * (d + 2) / 2
                                : (long long)splits * side * side * TILE * TILE;
  if (side * side > 65535 || partial_floats < need)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return launch<float>(X, y, p, o, n, d, splits, rows_per_split, narrow != 0, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(X, y, p, o, n, d, splits, rows_per_split,
                                 narrow != 0, s);
  return (int)cudaErrorInvalidValue;
}
