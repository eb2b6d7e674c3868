// Per-class grouped statistics (Gaussian Naive Bayes) for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the TPU kernel repro/kernels/nb_stats/kernel.py (grouped_stats /
// _kernel, wrapper ops.py::nb_stats): for each class c, the row count N_c,
// S_c = sum of x over the class's rows and SS_c = sum of x^2, with fp32
// accumulation.  Rows whose label lies outside [0, C) (the TPU wrapper's
// padding rows carry -1) are ignored.  Output (C, 1 + 2d): [N_c | S_c | SS_c].
//
// What differs from the TPU design.  The TPU kernel builds a one-hot matrix
// per row block and does GROUP BY as an MXU product into one revisited
// accumulator block over a sequential grid.  Here there is no one-hot
// matrix and no padding copy:
//   pass 1 (grouped_partial): grid (splits, column tiles).  A block owns one
//     row split and up to 64 feature columns.  Its threads form G groups of
//     one thread per column; group g walks rows r0 + g, r0 + g + G, ... in
//     order and adds 1, x and x^2 into its own per-class sums in shared
//     memory (no two threads write one address, so no atomics).  The block
//     then sums its G groups in group order and writes one partial per
//     split.
//   pass 2 (grouped_reduce): one thread per output sums the splits' partials
//     in split order.
// Every sum has a fixed order: the same data give bitwise the same
// statistics on every run.
//
// Bound.  About 3d FLOPs per row against 4(d + 1) bytes: bound by bytes; the
// full 5M x 10 scan (X fp32 + y int32, 220 MB) needs 0.066 ms at 3.35 TB/s.
// The design reads each byte once and splits rows over enough blocks to keep
// every SM loading.  Its weakness, for a later PR: each thread's
// read-modify-write of a shared-memory sum waits on the previous one when
// consecutive rows share a class, so a block's walk is latency-bound; more
// groups per block, or register sums per class, would hide it.
//
// The launch goes on the caller's stream; the kernel allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int CW = 64;             // feature columns per block, at most
constexpr int MAX_C = 64;          // classes this build accepts
constexpr int SMEM_FLOATS = 12288; // 48 KB of per-group class sums, at most

// per-group sums: [C][W] with W = 2 * cw + 1 -> S columns, SS columns, count
__host__ __device__ inline int groups_for(int cw, int C) {
  int g = NT / cw;
  const int fit = SMEM_FLOATS / (C * (2 * cw + 1));
  return g < fit ? g : fit;
}

__global__ void __launch_bounds__(NT)
grouped_partial(const float* __restrict__ X, const int* __restrict__ y,
                float* __restrict__ partial, long long n, int d, int C,
                long long rows_per_split) {
  extern __shared__ float acc[];
  const int c0 = blockIdx.y * CW;
  const int cw = min(CW, d - c0);            // this tile's columns
  const int W = 2 * cw + 1;
  const int G = groups_for(min(CW, d), C);   // the same in every tile
  const long long r0 = (long long)blockIdx.x * rows_per_split;
  const long long r1 = min(n, r0 + rows_per_split);
  const int tid = threadIdx.x;
  const int col_stride = min(CW, d);         // threads per group
  const int g = tid / col_stride, c = tid % col_stride;

  for (int e = tid; e < G * C * W; e += NT) acc[e] = 0.f;
  __syncthreads();

  if (g < G && c < cw) {
    float* mine = acc + (size_t)g * C * W;
    const bool counts = (c == 0);
    const float* xc = X + c0 + c;
#pragma unroll 4
    for (long long r = r0 + g; r < r1; r += G) {
      const int cls = __ldg(y + r);
      const float x = __ldg(xc + (size_t)r * d);
      if (cls >= 0 && cls < C) {
        float* row = mine + cls * W;
        row[c] += x;
        row[cw + c] += x * x;
        if (counts) row[2 * cw] += 1.f;
      }
    }
  }
  __syncthreads();

  float* out = partial + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * C * (2 * CW + 1);
  for (int e = tid; e < C * W; e += NT) {
    float s = 0.f;
    for (int k = 0; k < G; ++k) s += acc[(size_t)k * C * W + e];
    const int cls = e / W, j = e % W;
    // partial layout per (split, column tile): [C][2 * CW + 1]
    const int slot = j < cw ? j : (j < 2 * cw ? CW + (j - cw) : 2 * CW);
    out[cls * (2 * CW + 1) + slot] = s;
  }
}

__global__ void grouped_reduce(const float* __restrict__ partial,
                               float* __restrict__ out, int d, int C,
                               int splits, int tiles) {
  const int width = 1 + 2 * d;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= C * width) return;
  const int cls = idx / width, j = idx % width;
  int tile, slot;
  if (j == 0) {
    tile = 0;
    slot = 2 * CW;
  } else if (j <= d) {
    tile = (j - 1) / CW;
    slot = (j - 1) % CW;
  } else {
    tile = (j - 1 - d) / CW;
    slot = CW + (j - 1 - d) % CW;
  }
  const size_t per_tile = (size_t)C * (2 * CW + 1);
  const float* p = partial + (size_t)tile * per_tile + cls * (2 * CW + 1) + slot;
  const size_t stride = (size_t)tiles * per_tile;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += p[k * stride];
  out[idx] = s;
}

}  // namespace

// X (n, d) fp32 and y (n,) int32, contiguous.  out (C, 1 + 2d) fp32.
// partial: splits * ceil(d / 64) * C * 129 floats of scratch (a smaller one
// is refused).
// Split k covers rows [k * rows_per_split, min(n, (k+1) * rows_per_split)).
extern "C" int repro_nb_stats(const void* X, const void* y, void* partial,
                              long long partial_floats, void* out,
                              long long n, int d, int C, int splits,
                              long long rows_per_split, void* stream) {
  const int tiles = (d + CW - 1) / CW;
  if (n <= 0 || d <= 0 || C <= 0 || C > MAX_C || splits <= 0 ||
      rows_per_split <= 0 || (long long)splits * rows_per_split < n ||
      partial_floats < (long long)splits * tiles * C * (2 * CW + 1))
    return (int)cudaErrorInvalidValue;
  const int cw = d < CW ? d : CW;
  const int G = groups_for(cw, C);
  if (G < 1 || tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)G * C * (2 * cw + 1) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  grouped_partial<<<dim3(splits, tiles), NT, smem, s>>>(
      static_cast<const float*>(X), static_cast<const int*>(y), p, n, d, C,
      rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = C * (1 + 2 * d);
  grouped_reduce<<<(total + 255) / 256, 256, 0, s>>>(
      p, static_cast<float*>(out), d, C, splits, tiles);
  return (int)cudaGetLastError();
}
