// Per-class grouped statistics (Gaussian Naive Bayes) for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the TPU kernel repro/kernels/nb_stats/kernel.py (grouped_stats /
// _kernel, wrapper ops.py::nb_stats): for each class c, the row count N_c,
// S_c = sum of x over the class's rows and SS_c = sum of x^2, with fp32
// accumulation.  Rows whose label lies outside [0, C) (the TPU wrapper's
// padding rows carry -1) are ignored.  Output G (C, 1 + 2d), row c =
// [N_c | S_c | SS_c]; entry k = c (1 + 2d) + j below.
//
// Bound.  About 3d FLOPs per row against 4(d + 1) bytes: bound by bytes; the
// full 5M x 10 scan (X fp32 + y int32, 220 MB) needs 0.066 ms at 3.35 TB/s,
// the analytics query's 50K x 10 0.7 us, below the launch itself.  So the
// design works on the loads and the launches.
//
// What differs from the TPU design.  The TPU kernel builds a one-hot matrix
// per row block and does GROUP BY as an MXU product into one revisited
// accumulator block over a sequential grid.  Here there is no one-hot
// matrix and no padding copy: X (n, d) and y (n,) are read in place, at any
// element-aligned address, and the rows are split over blocks that run in
// no fixed order.  ONE LAUNCH in both forms:
//
//   narrow, C (2d + 1) <= 64 sums, d <= 16, C <= 4 (the paper's C 2, d 10:
//     42 sums): nb_narrow<D, C>.  Split k covers rows [k rows_per_split,
//     ...).  The block stages the split's X span and its labels' span into
//     shared memory in chunks of 256 rows through a ring of 2-4 stages,
//     with 16-byte cp.async for every aligned 16-byte unit (a warp moves
//     whole cache lines) and the unaligned head and tail element by
//     element, each span at its own address modulo 16 (the engine's
//     fetches are views at any row offset).  Thread t reads row t of each
//     chunk and adds 1, x and x^2 into its own register sums for the row's
//     class: no shared-memory read-modify-write, so no chain of dependent
//     memory operations (the first form's limit).  The block sums its
//     threads in a fixed order (recursive halving within each warp, then
//     the 8 warps in order) and writes its partial, k-major.
//   wide, any other C <= 64 and d: nb_wide, grid (splits, column tiles of
//     64).  Its threads form G groups of one thread per column; group g
//     walks rows r0 + g, r0 + g + G, ... and adds into its own per-class
//     sums in shared memory (no two threads write one address).  The block
//     sums its G groups in group order and writes its tile's partial.
//
// The cross-block sum is in the same launch, on a ticket, the pattern of
// linreg_stats.cu (the staging, the halving, the ticket and the split sum
// are the helpers both include from kernels/csrc/onepass.cuh): after a
// barrier (the block's partial is written), one
// thread moves an integer ticket with atom.acq_rel.gpu (its release makes
// the partial visible device-wide first).  The block that draws the last
// ticket has, by the same atom's acquire and a barrier, every partial in
// view; it reads them through L2 (__ldcg), sums each entry over the splits
// in split order by a fixed tree (warp w takes entries w, w + 8, ...; lane
// l the splits l, l + 32, ... in order, then a butterfly over the 32
// lanes), writes G and resets the ticket to 0 for the next launch on the
// stream.  The workspace, and so the ticket, belongs to one (device,
// stream).
//
// No floating-point atomics: every sum has a fixed order and the splits are
// a function of the shape alone, so the same data give bitwise the same
// statistics on every run, whatever the alignment of the views.  Counts
// are sums of 1.0 and stay exact below 2^24 rows.  The launch goes on the
// caller's stream; the kernel allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "onepass.cuh"

namespace {

using namespace onepass;

constexpr int NT = 256;            // threads per block
constexpr int NWARP = NT / 32;
constexpr int CW = 64;             // wide form: feature columns per block, at most
constexpr int MAX_C = 64;          // classes this build accepts
constexpr int SMEM_FLOATS = 12288; // wide form: 48 KB of per-group class sums
constexpr int CH = NT;             // narrow form: rows per staged chunk
constexpr int RING_BYTES = 44 * 1024;  // narrow form: the ring's shared memory
constexpr int TICKET_FLOATS = 4;       // workspace: ticket, then the partials
constexpr int MAX_NARROW_SPLITS = 264; // narrow form: splits one launch takes
constexpr int NARROW_SUMS = 64;        // narrow form: a thread's sums, at most
constexpr int NARROW_MAX_D = 16;
constexpr int NARROW_MAX_C = 4;

template <int D, int C>
struct Narrow {
  static constexpr int W = 2 * D + 1;        // count, S, SS of one class
  static constexpr int K = C * W;            // a thread's sums
  // a chunk's X and y spans, each with up to 15 bytes of head offset
  static constexpr int XB = (CH * D * 4 + 16 + 15) / 16 * 16;
  static constexpr int YB = (CH * 4 + 16 + 15) / 16 * 16;
  static constexpr int SB = XB + YB;
  static constexpr int FIT = RING_BYTES / SB;
  static constexpr int STAGES = FIT < 2 ? 2 : (FIT > 4 ? 4 : FIT);
  static constexpr int KH = halved(K, 5);    // a lane's slots after halving
  static constexpr int KW = (K + NWARP - 1) / NWARP;  // last block: entries a warp
};

template <int D, int C>
__global__ void __launch_bounds__(NT)
nb_narrow(const float* __restrict__ X, const int* __restrict__ y,
          unsigned* __restrict__ ticket, float* __restrict__ partial,
          float* __restrict__ out, long long n, long long rows_per_split) {
  using L = Narrow<D, C>;
  constexpr int K = L::K, W = L::W, S = L::STAGES;
  __shared__ __align__(16) char ring[S * L::SB];
  __shared__ float red[NWARP][K];
  const int splits = gridDim.x;
  const long long r0 = (long long)blockIdx.x * rows_per_split;
  const long long r1 = min(n, r0 + rows_per_split);
  const int chunks = (int)((r1 - r0 + CH - 1) / CH);
  const int tid = threadIdx.x;

  auto issue = [&](int c) {
    if (c < chunks) {
      const long long a = r0 + (long long)c * CH;
      const int rows = (int)min((long long)CH, r1 - a);
      char* st = ring + (c % S) * L::SB;
      stage_span<NT>(st, X + a * D, rows * D);
      stage_span<NT>(st + L::XB, y + a, rows);
    }
    cp_async_commit();           // an empty group past the last chunk
  };

  float acc[K + 1];              // one spare slot for the halving
#pragma unroll
  for (int k = 0; k <= K; ++k) acc[k] = 0.f;
#pragma unroll
  for (int c = 0; c < S - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    issue(c + S - 1);            // into the stage read in iteration c - 1
    cp_async_wait<S - 1>();      // this thread's copies of chunk c landed
    __syncthreads();             // and everyone's
    const long long a = r0 + (long long)c * CH;
    if (a + tid < r1) {
      const char* st = ring + (c % S) * L::SB;
      const float* xs = reinterpret_cast<const float*>(
          st + (reinterpret_cast<uintptr_t>(X + a * D) & 15)) + tid * D;
      const int cls = *(reinterpret_cast<const int*>(
          st + L::XB + (reinterpret_cast<uintptr_t>(y + a) & 15)) + tid);
      float x[D];
#pragma unroll
      for (int j = 0; j < D; ++j) x[j] = xs[j];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (cls == k) {          // rows outside [0, C) match no class
          acc[k * W] += 1.f;
#pragma unroll
          for (int j = 0; j < D; ++j) {
            acc[k * W + 1 + j] += x[j];
            acc[k * W + 1 + D + j] = fmaf(x[j], x[j], acc[k * W + 1 + D + j]);
          }
        }
      }
    }
    __syncthreads();             // before the next issue overwrites a stage
  }

  const int lane = tid & 31, warp = tid >> 5;
  int base = 0, end = K;
  halve<K + 1, K, 16>(acc, lane, base, end);
#pragma unroll
  for (int i = 0; i < L::KH; ++i)
    if (base + i < end) red[warp][base + i] = acc[i];
  __syncthreads();
  for (int k = tid; k < K; k += NT) {        // the block's partial, k-major
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) s += red[w][k];
    partial[(size_t)k * splits + blockIdx.x] = s;
  }
  if (!last_block(ticket, splits)) return;
  split_sum<NT, L::KW, (MAX_NARROW_SPLITS + 31) / 32>(partial, out, K, splits);
  if (tid == 0) *ticket = 0u;    // the next launch on this stream starts at 0
}

// wide form: per-group sums [C][2 cw + 1] -> S columns, SS columns, count
__host__ __device__ inline int groups_for(int cw, int C) {
  int g = NT / cw;
  const int fit = SMEM_FLOATS / (C * (2 * cw + 1));
  return g < fit ? g : fit;
}

__global__ void __launch_bounds__(NT)
nb_wide(const float* __restrict__ X, const int* __restrict__ y,
        unsigned* __restrict__ ticket, float* __restrict__ partial,
        float* __restrict__ out, long long n, int d, int C,
        long long rows_per_split) {
  extern __shared__ float acc[];
  const int splits = gridDim.x;
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
        row[cw + c] = fmaf(x, x, row[cw + c]);
        if (counts) row[2 * cw] += 1.f;
      }
    }
  }
  __syncthreads();

  // the tile's partial, k-major: entry k = cls (1 + 2d) + [0 | 1 + j | 1 + d + j];
  // the count is tile 0's
  const int width = 1 + 2 * d;
  for (int e = tid; e < C * W; e += NT) {
    const int cls = e / W, j = e % W;
    if (j == 2 * cw && blockIdx.y != 0) continue;
    float s = 0.f;
    for (int k = 0; k < G; ++k) s += acc[(size_t)k * C * W + e];
    const int col = j < cw ? 1 + c0 + j : (j < 2 * cw ? 1 + d + c0 + (j - cw) : 0);
    partial[(size_t)(cls * width + col) * splits + blockIdx.x] = s;
  }
  if (!last_block(ticket, gridDim.x * gridDim.y)) return;
  split_sum<NT, 0, 0>(partial, out, C * width, splits);
  if (tid == 0) *ticket = 0u;
}

template <int D, int C>
int launch_narrow(const float* X, const int* y, unsigned* ticket,
                  float* partial, float* out, long long n, int d, int splits,
                  long long rows_per_split, cudaStream_t s) {
  if constexpr (D > 1) {
    if (d < D)
      return launch_narrow<D - 1, C>(X, y, ticket, partial, out, n, d, splits,
                                     rows_per_split, s);
  }
  nb_narrow<D, C><<<splits, NT, 0, s>>>(X, y, ticket, partial, out, n,
                                        rows_per_split);
  return (int)cudaGetLastError();
}

// the widest d of the narrow form for C classes: C (2d + 1) <= NARROW_SUMS
constexpr int narrow_d(int C) {
  return (NARROW_SUMS / C - 1) / 2 < NARROW_MAX_D ? (NARROW_SUMS / C - 1) / 2
                                                  : NARROW_MAX_D;
}

}  // namespace

// G (C, 1 + 2d) fp32 into out, row-major.  X (n, d) fp32 and y (n,) int32,
// contiguous, at any element-aligned address.  The caller picks the form
// (narrow needs C <= 4 and C (2d + 1) <= 64, d <= 16) and passes its
// workspace for this stream: 4 floats whose first word is the ticket (0
// between launches; zeroed by the caller when it makes the workspace),
// then C (1 + 2d) * splits floats of partials (a smaller one is refused).
// Split k covers rows [k * rows_per_split, min(n, (k+1) * rows_per_split));
// the wide form also cuts the columns into tiles of 64.
extern "C" int repro_nb_stats(const void* X, const void* y, void* workspace,
                              long long workspace_floats, void* out,
                              long long n, int d, int C, int splits,
                              long long rows_per_split, int narrow,
                              void* stream) {
  const int tiles = (d + CW - 1) / CW;
  if (n <= 0 || d <= 0 || C <= 0 || C > MAX_C || splits <= 0 ||
      rows_per_split <= 0 || (long long)splits * rows_per_split < n ||
      workspace_floats < TICKET_FLOATS + (long long)C * (1 + 2 * d) * splits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Xf = static_cast<const float*>(X);
  const int* yi = static_cast<const int*>(y);
  unsigned* ticket = static_cast<unsigned*>(workspace);
  float* p = static_cast<float*>(workspace) + TICKET_FLOATS;
  float* o = static_cast<float*>(out);
  if (narrow) {
    if (C > NARROW_MAX_C || d > narrow_d(C) || splits > MAX_NARROW_SPLITS)
      return (int)cudaErrorInvalidValue;
    switch (C) {
      case 1: return launch_narrow<narrow_d(1), 1>(Xf, yi, ticket, p, o, n, d, splits, rows_per_split, s);
      case 2: return launch_narrow<narrow_d(2), 2>(Xf, yi, ticket, p, o, n, d, splits, rows_per_split, s);
      case 3: return launch_narrow<narrow_d(3), 3>(Xf, yi, ticket, p, o, n, d, splits, rows_per_split, s);
      default: return launch_narrow<narrow_d(4), 4>(Xf, yi, ticket, p, o, n, d, splits, rows_per_split, s);
    }
  }
  const int cw = d < CW ? d : CW;
  const int G = groups_for(cw, C);
  if (G < 1 || tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)G * C * (2 * cw + 1) * sizeof(float);
  nb_wide<<<dim3(splits, tiles), NT, smem, s>>>(Xf, yi, ticket, p, o, n, d, C,
                                                 rows_per_split);
  return (int)cudaGetLastError();
}
