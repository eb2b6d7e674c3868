// Fused linear-regression statistics for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/linreg_stats/kernel.py (zt_z /
// _kernel, wrapper ops.py::linreg_stats): G = Z^T Z for Z = [X | y], so
// A = X^T X is G[:d, :d], B = X^T y is G[:d, d] and y^T y is G[d, d], with
// fp32 accumulation for fp32 and bf16 inputs.
//
// Bound.  2 (d+1)^2 FLOPs per row against (d+1) * 4 bytes per row: about
// 5.5 FLOP/byte at d 10, far below the card's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte), so the function is bound by bytes, and the
// design works on the loads and the launches, not on the FMAs: it stays on
// the CUDA cores (no tensor cores, whose rate would buy nothing here).  The
// full 5M x 10 fp32 scan (220 MB) needs 0.066 ms; the analytics query's
// 50K x 10 (2.2 MB) needs 0.7 us, below the launch itself.
//
// What differs from the TPU design.  The TPU kernel pads Z to 128 lanes in a
// copy and accumulates serially into one revisited output block across a
// sequential grid.  Here X (n, d) and y (n,) are read in place, no padded
// copy is made, and the rows are split over many blocks that run in no
// fixed order.  Two forms:
//
//   narrow, D = d + 1 <= 16 (the analytics path's d 10): ztz_narrow<D>, ONE
//     launch.  Split k covers rows [k * rows_per_split, ...); a split's X
//     rows are one contiguous span of (r1 - r0) * d elements, its y rows
//     another.  The block stages both spans into shared memory in chunks of
//     256 rows through a ring of 2-4 stages (as many as 44 KB hold), with
//     16-byte cp.async for every aligned 16-byte unit of the span, so a warp
//     moves whole cache lines.  Alignment: the engine's fetches are views
//     at arbitrary row offsets (X[lo:hi] starts on an 8-byte boundary half
//     the time at d 10, y on any 4-byte one), so each span is copied to
//     shared memory at its own address modulo 16: the aligned units in the
//     middle go by 16-byte cp.async, the unaligned head and tail (at most 15
//     bytes each) element by element (4-byte cp.async for fp32, plain loads
//     for bf16).  Nothing about the address changes which rows a thread
//     sums or in what order: splits are a function of (n, d) alone.
//     Thread t then reads row t of each chunk from shared memory (a row
//     stride of d words: at most 2-way bank conflicts at d 10) and adds its
//     outer product into D (D+1) / 2 register sums (the upper triangle), in
//     row order r0 + t, r0 + t + 256, ...  The block sums its threads in a
//     fixed order (recursive halving within each warp, 67 shuffles for the
//     66 sums of d 10 where a butterfly per sum takes 330, then the 8 warps
//     in order) and writes its partial triangle, k-major, to the workspace.
//     The cross-block sum is in the same launch, on a ticket: after a
//     barrier (the block's partial is written), one thread moves an integer
//     ticket with atom.acq_rel.gpu.  Its release makes the partial, ordered
//     before it by the barrier, visible device-wide before the ticket moves
//     (the pattern of CUTLASS's semaphores; it measured 0.5 us faster than
//     a __threadfence in every writer and a relaxed atomicAdd).  The block
//     that draws the last ticket has, by the same atom's acquire and a
//     barrier, every partial in view; it reads them with __ldcg (through
//     L2, never a stale line of the non-coherent L1 path) as float4 (rows
//     of the k-major partials padded to a multiple of 4 splits, the pad
//     zeroed by block 0), all loads at once (at most 264 splits), sums them
//     in split order by a fixed tree (lane l of a warp takes split quads l,
//     l + 32, ... in order, then a butterfly over the 32 lanes), writes both
//     triangles of G and resets the ticket to 0 for the next launch on the
//     stream.  The workspace, and so the ticket, belongs to one (device,
//     stream): two streams never share one.
//   wide, any d: ztz_partial then ztz_reduce, TWO launches (a rare shape on
//     the analytics path; one last block would have to sum (d+1)^2 outputs
//     over every split).  The output is cut into 32 x 32 tiles (d 130 takes
//     5 x 5); grid (splits, tiles).  A block stages 64 rows of its tile's two
//     column strips in shared memory and each thread adds its 4 outputs over
//     those rows in row order; ztz_reduce has one thread per output sum the
//     splits' tiles in split order.  Left for a later PR: single-buffered
//     staging, scalar loads.
//
// No floating-point atomics: every sum has a fixed order, so the same data
// give bitwise the same statistics on every run, whatever the alignment of
// the views.  G is bitwise symmetric (the narrow form writes one sum to
// both halves; the wide form has fma(a, b, c) == fma(b, a, c)).
//
// The launch goes on the caller's stream; the kernel allocates nothing (the
// wrapper passes its per-stream workspace and the output).
//
// The staging, the halving and the ticket are kernels/csrc/onepass.cuh's,
// shared with nb_stats.cu.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "onepass.cuh"

namespace {

using namespace onepass;

constexpr int TILE = 32;      // wide form: output tile edge
constexpr int ROWS = 64;      // wide form: rows staged in shared memory at once
constexpr int NT = 256;       // threads per block
constexpr int JQ = 4;         // wide form: outputs per thread (a column quad)
constexpr int NARROW_D = 16;  // largest D = d + 1 of the narrow form
constexpr int CH = NT;        // narrow form: rows per staged chunk, one a thread
constexpr int RING_BYTES = 44 * 1024;  // narrow form: the ring's shared memory
constexpr int TICKET_FLOATS = 4;       // workspace: ticket, then the partials
constexpr int MAX_NARROW_SPLITS = 264; // narrow form: splits one launch takes

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int D>
struct Narrow {
  static constexpr int d = D - 1;
  static constexpr int K = D * (D + 1) / 2;  // upper triangle, row-major
  // a chunk's X and y spans, each with up to 15 bytes of head offset
  static constexpr int XB = (CH * d * (int)sizeof(T) + 16 + 15) / 16 * 16;
  static constexpr int YB = (CH * (int)sizeof(T) + 16 + 15) / 16 * 16;
  static constexpr int SB = XB + YB;
  static constexpr int FIT = RING_BYTES / SB;
  static constexpr int STAGES = FIT < 2 ? 2 : (FIT > 4 ? 4 : FIT);
  static constexpr int KW = (K + NT / 32 - 1) / (NT / 32);  // last block: sums a warp
  static constexpr int KH = halved(K, 5);    // a lane's slots after halving
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
ztz_narrow(const T* __restrict__ X, const T* __restrict__ y,
           unsigned* __restrict__ ticket, float* __restrict__ partial,
           float* __restrict__ out, long long n, long long rows_per_split) {
  using L = Narrow<T, D>;
  constexpr int d = L::d, K = L::K, S = L::STAGES;
  __shared__ __align__(16) char ring[S * L::SB];
  __shared__ float red[NT / 32][K];
  __shared__ bool last;
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
      stage_span<NT>(st, X + a * d, rows * d);
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
      const T* xs = reinterpret_cast<const T*>(
          st + (reinterpret_cast<uintptr_t>(X + a * d) & 15)) + tid * d;
      const T* ys = reinterpret_cast<const T*>(
          st + L::XB + (reinterpret_cast<uintptr_t>(y + a) & 15)) + tid;
      float z[D];
#pragma unroll
      for (int j = 0; j < d; ++j) z[j] = widen(xs[j]);
      z[d] = widen(*ys);
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
    __syncthreads();             // before the next issue overwrites a stage
  }

  const int lane = tid & 31, warp = tid >> 5;
  int base = 0, end = K;
  halve<K + 1, K, 16>(acc, lane, base, end);
#pragma unroll
  for (int i = 0; i < L::KH; ++i)
    if (base + i < end) red[warp][base + i] = acc[i];
  __syncthreads();
  // partials k-major, rows padded to a whole number of float4 (block 0
  // zeroes the pad), so the last block reads them 16 bytes at a time
  const int stride = (splits + 3) & ~3;
  for (int k = tid; k < K; k += NT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += red[w][k];
    partial[(size_t)k * stride + blockIdx.x] = s;
    if (blockIdx.x == 0)
      for (int c = splits; c < stride; ++c) partial[(size_t)k * stride + c] = 0.f;
  }
  __syncthreads();               // the block's partial is written
  if (tid == 0) last = ticket_add(ticket) == (unsigned)splits - 1;
  __syncthreads();
  if (!last) return;

  // the last block: out[i][j] = out[j][i] = sum over splits, in split
  // order by a fixed tree; warp w takes triangle entries w, w + 8, ...,
  // lane l the split quads l, l + 32, ...  Every load is issued at once
  // (the split count is bounded), through L2.
  float s[L::KW];
#pragma unroll
  for (int q = 0; q < L::KW; ++q) s[q] = 0.f;
#pragma unroll
  for (int it = 0; it < (MAX_NARROW_SPLITS + 127) / 128; ++it) {
    const int c = lane + 32 * it;
    if (c < stride / 4) {
#pragma unroll
      for (int q = 0; q < L::KW; ++q) {
        const int k = warp + q * (NT / 32);
        if (k < K) {
          const float4 v =
              __ldcg(reinterpret_cast<const float4*>(partial + (size_t)k * stride) + c);
          s[q] = s[q] + v.x + v.y + v.z + v.w;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < L::KW; ++q) {
    const int k = warp + q * (NT / 32);
    float v = s[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0 && k < K) {
      int i = 0, r = k;
      while (r >= D - i) {
        r -= D - i;
        ++i;
      }
      const int j = i + r;
      out[i * D + j] = v;
      out[j * D + i] = v;
    }
  }
  if (tid == 0) *ticket = 0u;    // the next launch on this stream starts at 0
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

// out[i][j] = sum over splits of the wide form's 32 x 32 partial tiles, in
// split order
__global__ void ztz_reduce(const float* __restrict__ partial,
                           float* __restrict__ out, int d, int splits,
                           int side) {
  const int D = d + 1;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= D * D) return;
  const int i = idx / D, j = idx % D;
  const int tile = (i / TILE) * side + (j / TILE);
  const size_t stride = (size_t)side * side * TILE * TILE;
  const float* p = partial + (size_t)tile * TILE * TILE + (i % TILE) * TILE + (j % TILE);
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += p[k * stride];
  out[idx] = s;
}

template <typename T, int D>
int launch_narrow(const void* X, const void* y, unsigned* ticket,
                  float* partial, float* out, long long n, int d, int splits,
                  long long rows_per_split, cudaStream_t s) {
  if constexpr (D > 2) {
    if (d + 1 < D)
      return launch_narrow<T, D - 1>(X, y, ticket, partial, out, n, d, splits,
                                     rows_per_split, s);
  }
  ztz_narrow<T, D><<<splits, NT, 0, s>>>(static_cast<const T*>(X),
                                          static_cast<const T*>(y), ticket,
                                          partial, out, n, rows_per_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* X, const void* y, unsigned* ticket, float* partial,
           float* out, long long n, int d, int splits,
           long long rows_per_split, bool narrow, cudaStream_t s) {
  if (narrow)
    return launch_narrow<T, NARROW_D>(X, y, ticket, partial, out, n, d, splits,
                                      rows_per_split, s);
  const int side = (d + 1 + TILE - 1) / TILE;
  ztz_partial<T><<<dim3(splits, side * side), NT, 0, s>>>(
      static_cast<const T*>(X), static_cast<const T*>(y), partial, n, d,
      rows_per_split, side);
  const int err = (int)cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int D2 = (d + 1) * (d + 1);
  ztz_reduce<<<(D2 + 255) / 256, 256, 0, s>>>(partial, out, d, splits, side);
  return (int)cudaGetLastError();
}

}  // namespace

// G = [X | y]^T [X | y] into out ((d+1) x (d+1) fp32, row-major).
// X (n, d) and y (n,) contiguous, both fp32 (dtype 0) or bf16 (dtype 1), at
// any element-aligned address.  The caller picks the form (narrow needs
// d + 1 <= 16) and passes its workspace for this stream: 4 floats whose
// first word is the narrow form's ticket (0 between launches; zeroed by
// the caller when it makes the workspace), then the partials, which need
// round_up(splits, 4) * (d+1)(d+2)/2 floats (narrow, splits <= 264) or
// splits * ceil((d+1)/32)^2 * 1024 (wide); a smaller workspace is refused.  Split k covers rows
// [k * rows_per_split, min(n, (k+1) * rows_per_split)).
extern "C" int repro_linreg_stats(const void* X, const void* y, void* workspace,
                                  long long workspace_floats, void* out,
                                  long long n, int d, int splits,
                                  long long rows_per_split, int narrow,
                                  int dtype, void* stream) {
  if (n <= 0 || d <= 0 || splits <= 0 || rows_per_split <= 0 ||
      (long long)splits * rows_per_split < n ||
      (narrow && (d + 1 > NARROW_D || splits > MAX_NARROW_SPLITS)))
    return (int)cudaErrorInvalidValue;
  const int side = (d + 1 + TILE - 1) / TILE;
  const long long need = narrow ? (long long)((splits + 3) & ~3) * (d + 1) * (d + 2) / 2
                                : (long long)splits * side * side * TILE * TILE;
  if (side * side > 65535 || workspace_floats < TICKET_FLOATS + need)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* ticket = static_cast<unsigned*>(workspace);
  float* p = static_cast<float*>(workspace) + TICKET_FLOATS;
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return launch<float>(X, y, ticket, p, o, n, d, splits, rows_per_split,
                         narrow != 0, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(X, y, ticket, p, o, n, d, splits,
                                 rows_per_split, narrow != 0, s);
  return (int)cudaErrorInvalidValue;
}
