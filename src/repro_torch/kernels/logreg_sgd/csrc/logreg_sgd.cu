// Chunked logistic-regression SGD for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/logreg_sgd/kernel.py (sgd_chunks /
// _kernel, wrappers ops.py::logreg_sgd and ::logreg_sgd_batched): one
// sequential epoch of minibatch SGD over each chunk, from w = 0, b = 0, with
// step t (from 0) doing, in the reference's order:
//     z     = xb . w + b
//     g     = sigmoid(z) - yb                      (rows of the batch only)
//     denom = max(rows in the batch, 1)
//     step  = lr / sqrt(t + 1)
//     gw    = (xb^T g) / denom + 2 lam w
//     gb    = sum(g) / denom
//     w    -= step * gw;  b -= step * gb
//
// One launch fits a whole segment: X (n, d) fp32 and y (n,) (int32 or fp32
// labels, read as they are) in place, at any 4-byte-aligned address (the
// engine's fetches are views at any row offset).  Chunk c covers rows
// [c l, min((c + 1) l, n)); the last chunk may be short and runs its own
// ceil(m / batch) steps, with t and the step size following its own steps,
// as repro's wrapper does when it pads that chunk to a batch multiple and
// masks the padding.  The output is (p, d + 1), the bias last.
//
// Bound.  The bytes are the rows and labels, read once: 440 KB for a
// 10,000 x 10 chunk, 0.13 us at 3.35 TB/s, and about 8 d FLOPs per row.
// What sets the time is the chain of ceil(m / batch) dependent steps (157
// for 10,000 rows at batch 64): each step's z needs the previous step's w.
// So the design shortens each step's chain and runs chunks side by side.
//
// Two forms; the wrapper (kernel.py::warp_form) picks one from (d, batch)
// alone, so a chunk's bits never depend on the segment around it:
//
//   warp form, d <= 32 and batch % 32 == 0 (the analytics path's d 10,
//     batch 64): sgd_warp<D>, ONE WARP PER CHUNK (a block of 32 threads; the
//     grid covers the p chunks, so a segment's chunks run side by side), no
//     block barrier and no shared memory in the dependent chain.  Every lane
//     keeps w and b in registers.  Lane i owns rows i, i + 32, ... of each
//     minibatch: it computes their z from registers and sums x g and g over
//     them in row order; the d + 1 sums are then reduced by an xor butterfly
//     of __shfl_xor_sync (5 levels).  Each level adds a pair in both lanes as
//     a + b and b + a, which fp32 gives bitwise equal, so every lane ends
//     with the same sums and the replicated w stays identical across lanes.
//     The minibatches do not depend on w: each lane copies its own rows
//     STAGES - 1 steps ahead into the warp's ring of shared-memory stages
//     (4-byte cp.async, so any 4-byte-aligned X will do), and reads back
//     only what it copied, so a lane waits on its own copies and never on a
//     barrier.  Rows lie at a stride of d words (d + 1 when d is a multiple
//     of 4), so lanes reading a column, or a half-warp reading a float2
//     (d = 2 mod 4), hit distinct banks.  A step has no branch: the row
//     loops run batch / 32 trips in every lane (the warp stays converged for
//     its shuffles), and a row past a short batch's end reads a copy of the
//     batch's last row with its g set to 0, which adds exactly nothing (the
//     sums never hold -0).  Three choices of arithmetic keep slow-path
//     branches out of the step, each within the plain version's tolerance:
//     the sigmoid's reciprocal is rcp.approx (1 ulp), the step size is
//     lr * rsqrtf(t + 1) (2 ulp), and the update multiplies by one
//     reciprocal of denom per step (a full batch's 1/64 is exact).  A step
//     is then about d / 2 FMAs, one sigmoid, five shuffle levels and the
//     update: 0.10 ms for a 157-step chunk on an H100 (timed by
//     kernels/logreg_sgd/turns.py), against 0.27 ms for the block form
//     below and 0.32-0.34 ms for the first form; the cost of each part, and
//     of the variants tried, is in PERF.md.
//   block form, any other shape (d > 32, a batch that is not a multiple of
//     32, or a warp ring past the shared memory): sgd_block, one 256-thread
//     block per chunk, w in shared memory, a step in three phases between
//     block barriers:
//       z, g   one thread per row (d <= 32) or one warp per row;
//       parts  P = min(8, 256 / d) row parts per column: thread (p, j) sums
//              x[r][j] g[r] over rows r = p, p + P, ...; warp 0 sums g;
//       update thread j adds its P parts in order and updates w[j]; thread
//              0 updates b;
//     in the reference's arithmetic; the next minibatch is copied (4-byte
//     cp.async) into a second buffer during each step.
//
// Every sum has a fixed order, so a chunk's weights are bitwise the same on
// every run, at any row offset and address, with int32 or fp32
// labels, and whether the chunk runs alone or in a segment of any length.
// The launch goes on the caller's stream; the kernel allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "onepass.cuh"

namespace {

using namespace onepass;

constexpr int NT = 256;            // block form: threads per block
constexpr int NWARP = NT / 32;
constexpr int MAX_PARTS = 8;       // block form: row parts of the gradient sum
constexpr int WARP_MAX_D = 32;     // warp form: widest row
constexpr int STAGES = 4;          // warp form: minibatches in each warp's ring
constexpr int SMEM_MAX = 227 * 1024;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float label(const float* p, int y_int) {
  const float v = *p;
  return y_int ? (float)__float_as_int(v) : v;
}

// 1 / x to within 1 ulp, one MUFU instruction and no slow-path branch
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__host__ __device__ inline int padded(int d) { return d | 1; }

// warp form: a row's stride in shared memory, in words, such that the 32
// lanes reading one column (4-byte reads), or the 16 lanes of a half-warp
// reading one pair of columns (8-byte reads, d = 2 mod 4), hit distinct
// banks: d itself when d is odd or 2 mod 4, d + 1 when d is a multiple of 4
__host__ __device__ constexpr int row_stride(int d) { return (d & 3) == 0 ? d + 1 : d; }
// one stage holds a minibatch's rows and labels
__host__ __device__ inline int stage_floats(int d, int batch) {
  return batch * (row_stride(d) + 1);
}

template <int D>
__global__ void __launch_bounds__(32)
sgd_warp(const float* __restrict__ X, const float* __restrict__ y, int y_int,
         float* __restrict__ out, long long n, int l, int batch, float lam,
         float lr) {
  constexpr int DS = row_stride(D);
  constexpr bool PAIRS = (D & 3) == 2;       // rows read as float2
  extern __shared__ __align__(16) float ring[];   // STAGES minibatches
  const int lane = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * l;
  const int rows = (int)min((long long)l, n - row0);
  const int steps = (rows + batch - 1) / batch;
  const int R = batch >> 5;                  // rows a lane owns in a minibatch
  const int sf = stage_floats(D, batch);
  const float* Xc = X + row0 * D;
  const float* yc = y + row0;

  // step s's rows into stage s % STAGES: lane i copies rows i, i + 32, ...,
  // the rows it reads back, so no lane waits on another's copies.  A row
  // past a short batch's end copies the batch's last row (its g is zeroed
  // below), so the loop has no branch.  One commit group per step (empty
  // past the last step, so the wait below always counts STAGES - 1 groups).
  auto issue = [&](int s) {
    if (s < steps) {
      const int last = min(batch, rows - s * batch) - 1;
      float* xs = ring + (s % STAGES) * sf;
      float* ys = xs + batch * DS;
      const float* xsrc = Xc + (size_t)s * batch * D;
      const float* ysrc = yc + (size_t)s * batch;
#pragma unroll 2
      for (int k = 0; k < R; ++k) {
        const int r = lane + 32 * k, rr = min(r, last);
#pragma unroll
        for (int j = 0; j < D; ++j) cp_async4(xs + r * DS + j, xsrc + rr * D + j);
        cp_async4(ys + r, ysrc + rr);
      }
    }
    cp_async_commit();
  };

  float w[D];
#pragma unroll
  for (int j = 0; j < D; ++j) w[j] = 0.f;
  float b = 0.f;
  const float two_lam = 2.f * lam;
  const float inv_batch = 1.f / (float)batch;
  const float inv_last = 1.f / (float)(rows - (steps - 1) * batch);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  for (int t = 0; t < steps; ++t) {
    issue(t + STAGES - 1);       // into the stage this lane read at step t - 1
    cp_async_wait<STAGES - 1>();   // this lane's rows of step t have landed
    const int m = min(batch, rows - t * batch);
    const float* xs = ring + (t % STAGES) * sf;
    const float* ys = xs + batch * DS;
    float part[D + 1];
#pragma unroll
    for (int j = 0; j <= D; ++j) part[j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < R; ++k) {            // this lane's rows, in order
      const int r = lane + 32 * k;
      float x[D];
      if constexpr (PAIRS) {
#pragma unroll
        for (int j = 0; j < D; j += 2) {
          const float2 v = *reinterpret_cast<const float2*>(xs + r * DS + j);
          x[j] = v.x;
          x[j + 1] = v.y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < D; ++j) x[j] = xs[r * DS + j];
      }
      float s0 = 0.f, s1 = 0.f;              // two chains: even and odd j
#pragma unroll
      for (int j = 0; j < D; j += 2) s0 = fmaf(x[j], w[j], s0);
#pragma unroll
      for (int j = 1; j < D; j += 2) s1 = fmaf(x[j], w[j], s1);
      const float e = 1.f + expf(-((s0 + s1) + b));
      const float g = r < m ? rcp_approx(e) - label(ys + r, y_int) : 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) part[j] = fmaf(x[j], g, part[j]);
      part[D] += g;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {       // butterfly: every lane gets the sums
#pragma unroll
      for (int j = 0; j <= D; ++j) part[j] += __shfl_xor_sync(0xffffffffu, part[j], o);
    }
    const float inv = t + 1 < steps ? inv_batch : inv_last;   // 1 / denom
    const float step = lr * rsqrtf((float)t + 1.f);
#pragma unroll
    for (int j = 0; j < D; ++j) w[j] = w[j] - step * (part[j] * inv + two_lam * w[j]);
    b = b - step * (part[D] * inv);
  }
  if (lane == 0) {
    float* o = out + (size_t)blockIdx.x * (D + 1);
#pragma unroll
    for (int j = 0; j < D; ++j) o[j] = w[j];
    o[D] = b;
  }
}

// block form: copy step t's rows (into stride-dp rows) and labels
__device__ __forceinline__ void prefetch(float* xbuf, float* ybuf,
                                         const float* __restrict__ Xc,
                                         const float* __restrict__ yc, int t,
                                         int rows, int d, int dp, int batch) {
  const int row0 = t * batch;
  const int m = min(batch, rows - row0);
  const float* src = Xc + (size_t)row0 * d;
  for (int e = threadIdx.x; e < m * d; e += NT) {
    const int r = e / d;
    cp_async4(xbuf + r * dp + (e - r * d), src + e);
  }
  for (int r = threadIdx.x; r < m; r += NT) cp_async4(ybuf + r, yc + row0 + r);
  cp_async_commit();
}

__global__ void __launch_bounds__(NT)
sgd_block(const float* __restrict__ X, const float* __restrict__ y, int y_int,
          float* __restrict__ out, long long n, int l, int d, int batch,
          float lam, float lr) {
  extern __shared__ float sm[];
  const int dp = padded(d);
  float* w = sm;                          // d
  float* xbuf = w + d;                    // 2 x batch x dp
  float* ybuf = xbuf + 2 * batch * dp;    // 2 x batch
  float* g = ybuf + 2 * batch;            // batch
  float* part = g + batch;                // MAX_PARTS x d
  __shared__ float s_b, s_gsum;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * l;
  const int rows = (int)min((long long)l, n - row0);
  const float* Xc = X + row0 * d;
  const float* yc = y + row0;
  for (int j = tid; j < d; j += NT) w[j] = 0.f;
  if (tid == 0) s_b = 0.f;
  const float two_lam = 2.f * lam;
  const int steps = (rows + batch - 1) / batch;
  const int P = max(1, min(MAX_PARTS, NT / d));
  prefetch(xbuf, ybuf, Xc, yc, 0, rows, d, dp, batch);

  for (int t = 0; t < steps; ++t) {
    const int m = min(batch, rows - t * batch);    // rows in this batch
    const float* xb = xbuf + (t & 1) * batch * dp;
    const float* yb = ybuf + (t & 1) * batch;
    cp_async_wait<0>();
    __syncthreads();               // rows staged; last step's w, b written
    if (t + 1 < steps)
      prefetch(xbuf + ((t + 1) & 1) * batch * dp, ybuf + ((t + 1) & 1) * batch,
               Xc, yc, t + 1, rows, d, dp, batch);
    const float b = s_b;
    if (d <= 32) {                                 // z and g, a thread a row
      for (int r = tid; r < m; r += NT) {
        const float* xr = xb + r * dp;
        float s = 0.f;
        for (int j = 0; j < d; ++j) s = fmaf(xr[j], w[j], s);
        g[r] = 1.f / (1.f + expf(-(s + b))) - label(yb + r, y_int);
      }
    } else {                                       // z and g, a warp a row
      for (int r = warp; r < m; r += NWARP) {
        float s = 0.f;
        for (int j = lane; j < d; j += 32) s = fmaf(xb[r * dp + j], w[j], s);
        s = warp_sum(s);
        if (lane == 0) g[r] = 1.f / (1.f + expf(-(s + b))) - label(yb + r, y_int);
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
      const int q = e / d, j = e - q * d;
      float s = 0.f;
      for (int r = q; r < m; r += P) s = fmaf(xb[r * dp + j], g[r], s);
      part[q * d + j] = s;
    }
    __syncthreads();
    const float denom = fmaxf((float)m, 1.f);
    const float step = lr / sqrtf((float)t + 1.f);
    for (int j = tid; j < d; j += NT) {            // gw and w, a thread a column
      float s = 0.f;
      for (int q = 0; q < P; ++q) s += part[q * d + j];
      w[j] = w[j] - step * (s / denom + two_lam * w[j]);
    }
    if (tid == 0) s_b = b - step * (s_gsum / denom);
  }
  __syncthreads();
  float* o = out + (size_t)blockIdx.x * (d + 1);
  for (int j = tid; j < d; j += NT) o[j] = w[j];
  if (tid == 0) o[d] = s_b;
}

size_t block_smem(int d, int batch) {
  return ((size_t)d + 2 * (size_t)batch * padded(d) + 3 * (size_t)batch +
          (size_t)MAX_PARTS * d) * sizeof(float);
}

cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D>
int launch_warp(const float* X, const float* y, int y_int, float* out,
                long long n, int d, int l, int batch, int p, float lam,
                float lr, cudaStream_t s) {
  if constexpr (D > 1) {
    if (d < D)
      return launch_warp<D - 1>(X, y, y_int, out, n, d, l, batch, p, lam, lr, s);
  }
  const size_t smem = (size_t)STAGES * stage_floats(D, batch) * sizeof(float);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem((const void*)sgd_warp<D>, smem);
  if (err != cudaSuccess) return (int)err;
  sgd_warp<D><<<p, 32, smem, s>>>(X, y, y_int, out, n, l, batch, lam, lr);
  return (int)cudaGetLastError();
}

}  // namespace

// X (n, d) fp32 and y (n,) labels (int32 if y_int, else fp32), each
// contiguous at any 4-byte-aligned address.  out (p, d + 1) fp32, p =
// ceil(n / l): chunk c's weights, bias last.  warp_form 1 takes the warp
// form (d <= 32, batch % 32 == 0), 0 the block form; the caller decides
// (kernel.py::warp_form) and the shared memory each needs is checked here.
extern "C" int repro_logreg_sgd(const void* X, const void* y, int y_int,
                                void* out, long long n, int d, int l,
                                int batch, int warp_form, float lam, float lr,
                                void* stream) {
  if (n <= 0 || d <= 0 || l <= 0 || batch <= 0 ||
      (long long)l * d > 0x7fffffffLL || (n + l - 1) / l > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int p = (int)((n + l - 1) / l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Xf = static_cast<const float*>(X);
  const float* yf = static_cast<const float*>(y);
  float* o = static_cast<float*>(out);
  if (warp_form) {
    if (d > WARP_MAX_D || batch % 32 != 0) return (int)cudaErrorInvalidValue;
    return launch_warp<WARP_MAX_D>(Xf, yf, y_int, o, n, d, l, batch, p, lam, lr, s);
  }
  const size_t smem = block_smem(d, batch);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem((const void*)sgd_block, smem);
  if (err != cudaSuccess) return (int)err;
  sgd_block<<<p, NT, smem, s>>>(Xf, yf, y_int, o, n, l, d, batch, lam, lr);
  return (int)cudaGetLastError();
}
