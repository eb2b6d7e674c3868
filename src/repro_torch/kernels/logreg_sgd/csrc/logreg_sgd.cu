// Chunked logistic-regression SGD for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/logreg_sgd/kernel.py (sgd_chunks /
// _kernel, wrappers ops.py::logreg_sgd and ::logreg_sgd_batched): one
// sequential epoch of minibatch SGD over each chunk of l rows, from w = 0,
// b = 0, with step t (from 0) doing, in the reference's order and arithmetic:
//     z     = xb . w + b
//     g     = sigmoid(z) - yb                      (rows of the batch only)
//     denom = max(rows in the batch, 1)
//     step  = lr / sqrt(t + 1)
//     gw    = (xb^T g) / denom + 2 lam w
//     gb    = sum(g) / denom
//     w    -= step * gw;  b -= step * gb
// The TPU wrapper pads the chunk to a multiple of the batch and masks the
// padding rows out (g = 0, denom = real rows); this kernel stops the last
// batch at row l instead, which adds and counts the same rows.
//
// What differs from the TPU design.  The TPU kernel pins the whole (l, d)
// chunk in VMEM (up to ~6 MB).  A block has at most 227 KB of shared
// memory, so here one block per chunk keeps w (d floats) and the bias on
// chip and streams the minibatches through two shared-memory buffers:
// while step t computes on one, cp.async copies step t + 1's rows and
// labels into the other.  A step is three phases between block barriers:
//   z, g   one thread per row (d <= 32) or one warp per row;
//   parts  P = min(8, 256 / d) row parts per column: thread (p, j) sums
//          x[r][j] g[r] over rows r = p, p + P, ...; warp 0 also sums g;
//   update thread j adds its P parts in order and updates w[j]; thread 0
//          updates b.
// The limit that replaces the VMEM budget is that shared memory:
// (d + 2 batch dp + 3 batch + 8 d) floats, dp = d rounded up to odd (rows
// padded so threads reading rows hit distinct banks), must fit (the
// wrapper raises beyond it), and l * d must index in 32 bits.
//
// Bound.  The bytes are the chunk's rows and labels, read once: 400 KB for a
// 10,000 x 10 chunk, 0.12 us at 3.35 TB/s, and about 8 d FLOPs per row.
// What sets the time is the chain of ceil(l / batch) dependent steps (157
// for l 10,000 and batch 64): each step's z needs the previous step's w.
// The design keeps that chain on one SM with w in shared memory, hides each
// minibatch's load behind the previous step, and cuts each phase's serial
// work to about d or m / P dependent operations; chunks run in parallel as
// blocks (the batched wrapper launches p chunks as p blocks).
//
// Every sum has a fixed order, so a chunk's weights are bitwise the same on
// every run.  The launch goes on the caller's stream; the kernel allocates
// nothing.

#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAX_PARTS = 8;       // row parts of the gradient sum

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ inline int padded(int d) { return d | 1; }

// copy step t's rows (into stride-dp rows) and labels into one buffer
__device__ __forceinline__ void prefetch(float* xbuf, float* ybuf,
                                         const float* __restrict__ Xc,
                                         const float* __restrict__ yc, int t,
                                         int l, int d, int dp, int batch) {
  const int row0 = t * batch;
  const int m = min(batch, l - row0);
  const float* src = Xc + row0 * d;
  for (int e = threadIdx.x; e < m * d; e += NT) {
    const int r = e / d;
    __pipeline_memcpy_async(xbuf + r * dp + (e - r * d), src + e, sizeof(float));
  }
  for (int r = threadIdx.x; r < m; r += NT)
    __pipeline_memcpy_async(ybuf + r, yc + row0 + r, sizeof(float));
  __pipeline_commit();
}

__global__ void __launch_bounds__(NT)
sgd_chunks(const float* __restrict__ X, const float* __restrict__ y,
           float* __restrict__ w_out, float* __restrict__ b_out, int l, int d,
           int batch, float lam, float lr) {
  extern __shared__ float sm[];
  const int dp = padded(d);
  float* w = sm;                          // d
  float* xbuf = w + d;                    // 2 x batch x dp
  float* ybuf = xbuf + 2 * batch * dp;    // 2 x batch
  float* g = ybuf + 2 * batch;            // batch
  float* part = g + batch;                // MAX_PARTS x d
  __shared__ float s_b, s_gsum;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* Xc = X + (size_t)blockIdx.x * l * d;
  const float* yc = y + (size_t)blockIdx.x * l;
  for (int j = tid; j < d; j += NT) w[j] = 0.f;
  if (tid == 0) s_b = 0.f;
  const float two_lam = 2.f * lam;
  const int steps = (l + batch - 1) / batch;
  const int P = max(1, min(MAX_PARTS, NT / d));
  prefetch(xbuf, ybuf, Xc, yc, 0, l, d, dp, batch);

  for (int t = 0; t < steps; ++t) {
    const int m = min(batch, l - t * batch);       // rows in this batch
    const float* xb = xbuf + (t & 1) * batch * dp;
    const float* yb = ybuf + (t & 1) * batch;
    __pipeline_wait_prior(0);
    __syncthreads();               // rows staged; last step's w, b written
    if (t + 1 < steps)
      prefetch(xbuf + ((t + 1) & 1) * batch * dp, ybuf + ((t + 1) & 1) * batch,
               Xc, yc, t + 1, l, d, dp, batch);
    const float b = s_b;
    if (d <= 32) {                                 // z and g, a thread a row
      for (int r = tid; r < m; r += NT) {
        const float* xr = xb + r * dp;
        float s = 0.f;
        for (int j = 0; j < d; ++j) s = fmaf(xr[j], w[j], s);
        g[r] = 1.f / (1.f + expf(-(s + b))) - yb[r];
      }
    } else {                                       // z and g, a warp a row
      for (int r = warp; r < m; r += NWARP) {
        float s = 0.f;
        for (int j = lane; j < d; j += 32) s = fmaf(xb[r * dp + j], w[j], s);
        s = warp_sum(s);
        if (lane == 0) g[r] = 1.f / (1.f + expf(-(s + b))) - yb[r];
      }
    }
    __syncthreads();
    if (warp == 0) {                               // sum(g), fixed order
      float gs = 0.f;
      for (int r = lane; r < m; r += 32) gs += g[r];
      gs = warp_sum(gs);
      if (lane == 0) s_gsum = gs;
    }
    for (int e = tid; e < P * d; e += NT) {        // row parts of x^T g
      const int p = e / d, j = e - p * d;
      float s = 0.f;
      for (int r = p; r < m; r += P) s = fmaf(xb[r * dp + j], g[r], s);
      part[p * d + j] = s;
    }
    __syncthreads();
    const float denom = fmaxf((float)m, 1.f);
    const float step = lr / sqrtf((float)t + 1.f);
    for (int j = tid; j < d; j += NT) {            // gw and w, a thread a column
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += part[p * d + j];
      w[j] = w[j] - step * (s / denom + two_lam * w[j]);
    }
    if (tid == 0) s_b = b - step * (s_gsum / denom);
  }
  __syncthreads();
  for (int j = tid; j < d; j += NT) w_out[(size_t)blockIdx.x * d + j] = w[j];
  if (tid == 0) b_out[blockIdx.x] = s_b;
}

}  // namespace

// X (p, l, d) and y (p, l) fp32, contiguous.  w_out (p, d), b_out (p,).
// Dynamic shared memory (d + 2 batch dp + 3 batch + 8 d) * 4 bytes, checked
// by the wrapper against the block's limit.
extern "C" int repro_logreg_sgd(const void* X, const void* y, void* w_out,
                                void* b_out, int p, int l, int d, int batch,
                                float lam, float lr, void* stream) {
  if (p <= 0 || l <= 0 || d <= 0 || batch <= 0 ||
      (long long)l * d > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)d + 2 * (size_t)batch * padded(d) + 3 * (size_t)batch +
                       (size_t)MAX_PARTS * d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sgd_chunks, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sgd_chunks<<<p, NT, smem, s>>>(
      static_cast<const float*>(X), static_cast<const float*>(y),
      static_cast<float*>(w_out), static_cast<float*>(b_out), l, d, batch,
      lam, lr);
  return (int)cudaGetLastError();
}
