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
// VMEM, one call per leaf; the kernel writes fp32 and the wrapper slices and
// casts.  Here every quantized leaf of one stored segment is dequantized in
// ONE launch, each leaf read in place:
//   per-head leaves (d0, d1, S, H, cols) int8, scales (d0, d1, nb, H);
//   headless leaves (d0, d1, S, cols) int8, scales (d0, d1, nb) (H = 1).
// Element (d01, s, h, c) takes scale (d01 * nb + s / block) * H + h; rows
// s >= S do not exist, so nothing is padded or sliced.  The output is
// written directly in the model dtype (OutT = float or bf16): one fp32
// multiply, then one round-to-nearest-even conversion, which is bitwise
// (q.float() * s).to(dtype), the JAX package's fp32-then-astype result.
//
// The segment.  The leaves' descriptors (q, scales and out pointers; the
// leaf's rows, H, S, nb, and where its items start in the launch) travel by
// value in one kernel-parameter struct (__grid_constant__, at most 8
// leaves, 464 bytes of the 4 KB parameter space), so the wrapper checks
// the segment once and makes one ctypes call and one launch for it (a
// dense-stack segment has two leaves, k and v).  One flattened grid-stride
// loop runs over the items of all leaves; a thread finds its leaf among
// the prefix offsets (at most 8 compares, uniform across a warp but at leaf
// boundaries).
//
// Bound.  One multiply per element against 1 byte in and 2 or 4 out:
// bound by bytes.  A full-width 128-token segment, two (24, 1, 128, 8, 128)
// leaves, is 6.3 MB in and 12.6 MB of bf16 out: 5.6 us at 3.35 TB/s (the
// launch is of the same order); a 4096-token segment moves 604 MB, 0.180
// ms.  Each thread moves 16 int8 values with one 16-byte load and writes 16
// outputs with 16-byte stores.  With cols % 16 == 0 a vector never
// straddles a (row, head), so one scale load serves it; other widths take
// the scalar item (one element) in the same loop.  A leaf's scale index
// comes from its item index by 32-bit divisions (the wrapper refuses a
// leaf of 2^31 items or more), where one 64-bit division per step used to
// cost as much as the vector's arithmetic.
//
// The launch goes on the caller's stream; the kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr long long MAX_BLOCKS = 132 * 8;
constexpr int MAX_LEAVES = 8;
constexpr int LEAF_WORDS = 8;       // the host's descriptor: 8 int64 a leaf

struct Leaf {
  const void* q;
  const float* scales;
  void* out;
  long long begin;                  // first item of this leaf in the launch
  unsigned items;                   // 16-element vectors, or elements
  unsigned per_row;                 // items per (d01, s, h) row
  unsigned H, S, nb;
  int vec;                          // 1: 16-element items, 0: one element
};

struct Segment {
  Leaf leaf[MAX_LEAVES];
  long long total;                  // items over all leaves
  int n_leaves;
  int block;
};

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
dequant_segment(const __grid_constant__ Segment seg) {
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < seg.total;
       i += (long long)gridDim.x * NT) {
    int l = 0;
#pragma unroll
    for (int k = 1; k < MAX_LEAVES; ++k)
      if (k < seg.n_leaves && i >= seg.leaf[k].begin) l = k;
    const Leaf& L = seg.leaf[l];
    const unsigned v = (unsigned)(i - L.begin);
    const unsigned r = v / L.per_row;          // row over (d01, s, h)
    const unsigned t = r / L.H, h = r - t * L.H;
    const unsigned d = t / L.S, s = t - d * L.S;
    const float sc = __ldg(L.scales + ((size_t)d * L.nb + s / (unsigned)seg.block) * L.H + h);
    OutT* out = static_cast<OutT*>(L.out);
    if (L.vec) {
      const int4 raw = __ldg(static_cast<const int4*>(L.q) + v);
      const int w[4] = {raw.x, raw.y, raw.z, raw.w};
      float f[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) f[k] = byte_of(w[k / 4], k % 4) * sc;
      store16(out + (size_t)v * 16, f);
    } else {
      store1(out + v, (float)__ldg(static_cast<const int8_t*>(L.q) + v) * sc);
    }
  }
}

}  // namespace

// Dequantize n_leaves (1-8) leaves of one segment in one launch.  desc
// holds 8 int64 words a leaf: q, scales and out pointers, then d01, S, H,
// cols and nb; q is d01 * S * H * cols int8 values, scales d01 * nb * H
// fp32, out like q in fp32 (out_bf16 == 0) or bf16 (out_bf16 == 1); q and
// out start on 16-byte boundaries (the wrapper checks); a leaf without
// elements takes no work.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a descriptor it refuses.
extern "C" int repro_quant_kv(const long long* desc, int n_leaves, int block,
                              int out_bf16, void* stream) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || block <= 0)
    return (int)cudaErrorInvalidValue;
  Segment seg{};
  long long total = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const long long* w = desc + (size_t)l * LEAF_WORDS;
    const long long d01 = w[3], S = w[4], H = w[5], cols = w[6], nb = w[7];
    if (d01 < 0 || S < 0 || H < 0 || cols < 0 || nb <= 0 ||
        S > nb * (long long)block)
      return (int)cudaErrorInvalidValue;
    const int vec = cols % 16 == 0;
    const long long per_row = vec ? cols / 16 : cols;  // 0 for an empty leaf
    const long long items = d01 * S * H * per_row;
    if (items >= (1LL << 31) || d01 * nb * H >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    Leaf& L = seg.leaf[l];
    L.q = reinterpret_cast<const void*>(w[0]);
    L.scales = reinterpret_cast<const float*>(w[1]);
    L.out = reinterpret_cast<void*>(w[2]);
    L.begin = total;
    L.items = (unsigned)items;
    L.per_row = (unsigned)per_row;
    L.H = (unsigned)H;
    L.S = (unsigned)S;
    L.nb = (unsigned)nb;
    L.vec = vec;
    total += items;
  }
  if (total == 0) return 0;
  seg.total = total;
  seg.n_leaves = n_leaves;
  seg.block = block;
  const long long b = (total + NT - 1) / NT;
  const unsigned blocks = (unsigned)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    dequant_segment<__nv_bfloat16><<<blocks, NT, 0, st>>>(seg);
  else
    dequant_segment<float><<<blocks, NT, 0, st>>>(seg);
  return (int)cudaGetLastError();
}
