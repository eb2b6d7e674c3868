// Fused block dequantization of int8 KV segments for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the TPU kernel repro/kernels/quant_kv/kernel.py
// (dequant_blocks_streams / _kernel, layout in ops.py::dequantize_leaf):
// out = float(q) * scale[block], where a scale block is one seq-bucket
// chunk x head of a stored cache leaf, written in the model's dtype.
//
// What differs from the TPU design.  The TPU wrapper pads the sequence
// axis to the chunk grid, transposes (chunk, head) together and reshapes
// to (G, rows, cols) so that one grid step streams one scale block through
// VMEM; the kernel writes fp32 and the wrapper slices and casts.  Here the
// stored leaf is read in place:
//   per-head leaves (d0, d1, S, H, cols) int8, scales (d0, d1, nb, H);
//   headless leaves (d0, d1, S, cols) int8, scales (d0, d1, nb) (H = 1).
// Element (d01, s, h, c) takes scale (d01 * nb + s / block) * H + h; rows
// s >= S do not exist, so nothing is padded or sliced.  The output is
// written directly in the model dtype (OutT = float or bf16): one fp32
// multiply, then one round-to-nearest-even conversion, which is bitwise
// (q.float() * s).to(dtype), the JAX package's fp32-then-astype result.
//
// Bound.  One multiply per element against 1 byte in and 2 or 4 out:
// bound by bytes.  A full-width 128-token segment leaf (24, 1, 128, 8, 128)
// is 3.15 MB in, 6.29 MB of bf16 out: 2.8 us at 3.35 TB/s (the launch sets
// the time at that size); a 4096-token leaf moves 302 MB, 0.090 ms (0.150
// ms with fp32 out).  The design: each thread moves 16 int8 values with one
// 16-byte load and writes 16 outputs with 16-byte stores, over a
// grid-stride loop of enough blocks to fill every SM.  With cols % 16 == 0
// a vector never straddles a (row, head), so one scale load serves it;
// other widths take a scalar path (one element per thread).
//
// The launch goes on the caller's stream; the kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr long long MAX_BLOCKS = 132 * 8;

long long grid_for(long long items) {
  const long long b = (items + NT - 1) / NT;
  return b < MAX_BLOCKS ? b : MAX_BLOCKS;
}

__device__ __forceinline__ float scale_of(const float* __restrict__ scales,
                                          long long e, long long cols,
                                          long long S, int H, long long nb,
                                          int block) {
  const long long r = e / cols;     // row over (d01, s, h)
  const int h = (int)(r % H);
  const long long t = r / H;
  const long long s = t % S;
  const long long d = t / S;
  return __ldg(scales + (d * nb + s / block) * H + h);
}

// byte k of w, sign-extended
__device__ __forceinline__ float byte_of(int w, int k) {
  return (float)((int)((unsigned)w << (24 - 8 * k)) >> 24);
}

__device__ __forceinline__ void store16(float* __restrict__ out,
                                        const float (&f)[16]) {
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* __restrict__ out,
                                        const float (&f)[16]) {
  union {
    uint4 u[2];
    __nv_bfloat162 h[8];
  } pk;  // 16-byte aligned through its uint4 member
#pragma unroll
  for (int k = 0; k < 8; ++k) pk.h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = pk.u[0];
  o[1] = pk.u[1];
}

__device__ __forceinline__ void store1(float* out, float x) { *out = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, float x) {
  *out = __float2bfloat16_rn(x);
}

template <typename OutT>
__global__ void __launch_bounds__(NT)
dequant_vec16(const int4* __restrict__ q, const float* __restrict__ scales,
              OutT* __restrict__ out, long long n_vec, long long cols,
              long long S, int H, long long nb, int block) {
  for (long long v = (long long)blockIdx.x * NT + threadIdx.x; v < n_vec;
       v += (long long)gridDim.x * NT) {
    const long long e = v * 16;
    const float sc = scale_of(scales, e, cols, S, H, nb, block);
    const int4 raw = __ldg(q + v);
    const int w[4] = {raw.x, raw.y, raw.z, raw.w};
    float f[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) f[k] = byte_of(w[k / 4], k % 4) * sc;
    store16(out + e, f);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(NT)
dequant_scalar(const int8_t* __restrict__ q, const float* __restrict__ scales,
               OutT* __restrict__ out, long long n, long long cols,
               long long S, int H, long long nb, int block) {
  for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < n;
       e += (long long)gridDim.x * NT) {
    const float sc = scale_of(scales, e, cols, S, H, nb, block);
    store1(out + e, (float)__ldg(q + e) * sc);
  }
}

template <typename OutT>
void launch(const void* q, const float* scales, void* out, long long d01,
            long long S, int H, long long cols, long long nb, int block,
            cudaStream_t stream) {
  const long long n = d01 * S * H * cols;
  if (cols % 16 == 0) {
    const long long n_vec = n / 16;
    const long long blocks = grid_for(n_vec);
    dequant_vec16<OutT><<<(unsigned)blocks, NT, 0, stream>>>(
        static_cast<const int4*>(q), scales, static_cast<OutT*>(out), n_vec,
        cols, S, H, nb, block);
  } else {
    const long long blocks = grid_for(n);
    dequant_scalar<OutT><<<(unsigned)blocks, NT, 0, stream>>>(
        static_cast<const int8_t*>(q), scales, static_cast<OutT*>(out), n,
        cols, S, H, nb, block);
  }
}

}  // namespace

// q: d01 * S * H * cols int8 values; scales: d01 * nb * H fp32; out: like
// q in fp32 (out_bf16 == 0) or bf16 (out_bf16 == 1).  q and out start on
// 16-byte boundaries (the wrapper checks).  Returns cudaGetLastError().
extern "C" int repro_quant_kv(const void* q, const void* scales, void* out,
                              int out_bf16, long long d01, long long S, int H,
                              long long cols, long long nb, int block,
                              void* stream) {
  if (d01 * S * H * cols == 0) return 0;
  const float* s = static_cast<const float*>(scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    launch<__nv_bfloat16>(q, s, out, d01, S, H, cols, nb, block, st);
  else
    launch<float>(q, s, out, d01, S, H, cols, nb, block, st);
  return (int)cudaGetLastError();
}
