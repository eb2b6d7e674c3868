// Ragged flash-decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py
// (decode_attention_streams / _kernel, layout in ops.py::decode_attention):
// one new query per (row, head) scored against the row's cache positions
// <= pos[row] of a capacity-padded KV cache, online softmax over fixed
// 256-wide tiles, trip count pos // 256 + 1 (tiles past pos never load).
//
// Layout.  The kernel reads the model's own tensors, no transposed copies:
//   q, out  (B, 1, H, hd)     k, v  (B, T, KV, hd)     pos  int32[B] (device)
// One block per (row b, KV head kvh); the G query heads h = kvh*G + g that
// share the KV head are the block's query rows, so each KV byte is read once
// per group.
//
// Bit-invariance.  Every reduction's order depends only on pos and the fixed
// tiling, never on the padded capacity T: the tile count is pos // 256 + 1,
// a tile covers n_valid = min(256, pos - t0 + 1) positions, dot products run
// over d in order, the max/sum over a tile use a fixed lane pattern and
// butterfly, and P V accumulates positions 0..n_valid-1 in order.  Positions
// past pos are never loaded nor added.  T enters only as an address stride,
// so a row's output is bitwise the same at any capacity (batched serving
// merges packs of mixed capacity on this property).
//
// Bound.  Per (row, KV head) the work is 4*hd FLOPs per query head per
// position against 4*hd bytes of bf16 K/V per position, i.e. G = 8 FLOPs per
// byte at full width: far below the ~295 FLOP/byte ridge, so the function is
// bound by bytes (HBM at 3.35 TB/s).  This design reads each K/V row once,
// with 16-byte loads all issued before any is used, and all G heads score it
// from shared memory.  Its weakness is parallelism: B*KV blocks (8 at batch
// 1) cannot draw the card's bandwidth; a split-KV variant with splits fixed
// by tile index and a fixed-order combine is the later redesign.
//
// Numerics: fp32 math for fp32 and bf16 inputs; output in q's dtype.
// The launch goes on the caller's stream; the kernel allocates nothing.
// Pointers must be 16-byte aligned (the wrapper checks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 256;       // KV tile; fixed, so tiling is prefix-stable
constexpr int SUB = 128;        // positions staged in shared memory at once
constexpr int NT = 256;         // threads per block: 8 warps
constexpr int MAX_G = 16;       // query heads per KV head this build accepts
constexpr int GPT = MAX_G / (NT / SUB);   // score rows per thread, at most

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr size_t smem_floats(int G, int HD) {
  // q rows + one staged K or V sub-tile (row pad +1) + scores/probs + m,l,corr
  return (size_t)G * HD + (size_t)SUB * (HD + 1) + (size_t)G * TILE + 3 * (size_t)G;
}

// Stage rows [t0, t0 + n_rows) of one KV head into kv_s with 16-byte loads,
// all issued before the first is stored.  Rows past n_rows are not loaded.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* kv_s, const T* __restrict__ src,
                                      size_t row_base, int t0, int n_rows,
                                      int KV) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = HD / VEC;
  constexpr int VPT = (SUB * VPR + NT - 1) / NT;
  uint4 r[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int c = idx / VPR, w = idx % VPR;
    if (c < n_rows)
      r[i] = *reinterpret_cast<const uint4*>(
          src + (row_base + (size_t)(t0 + c) * KV) * HD + w * VEC);
  }
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int c = idx / VPR, w = idx % VPR;
    if (c >= n_rows) continue;
    const T* e = reinterpret_cast<const T*>(&r[i]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) kv_s[c * (HD + 1) + w * VEC + j] = load(e + j);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              const int* __restrict__ pos_ptr, int H, int KV, int T_cap,
              float scale) {
  constexpr int OPT = (MAX_G * HD + NT - 1) / NT;   // outputs per thread
  extern __shared__ float smem[];
  const int G = H / KV;
  float* q_s = smem;                          // G x HD
  float* kv_s = q_s + G * HD;                 // SUB x (HD + 1)
  float* s_s = kv_s + SUB * (HD + 1);         // G x TILE
  float* m_s = s_s + G * TILE;                // G
  float* l_s = m_s + G;                       // G
  float* c_s = l_s + G;                       // G: this tile's rescale

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pos = min(pos_ptr[b], T_cap - 1);
  // element (b, t, kvh, d) of k/v sits at (row_base + t*KV)*HD + d
  const size_t row_base = (size_t)b * T_cap * KV + kvh;

  for (int idx = tid; idx < G * HD; idx += NT)
    q_s[idx] = load(q + ((size_t)b * H + kvh * G) * HD + idx) * scale;
  for (int g = tid; g < G; g += NT) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  // score work: position j = tid % SUB against heads g = tid / SUB + i*(NT/SUB)
  const int sj = tid % SUB, sg = tid / SUB;
  // output work: element idx = tid + o*NT -> head idx / HD, column idx % HD
  float acc[OPT];
#pragma unroll
  for (int o = 0; o < OPT; ++o) acc[o] = 0.f;

  const int n_tiles = pos / TILE + 1;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * TILE;
    const int n_valid = min(TILE, pos - t0 + 1);

    // scores s[g][j] = q[g] . k[t0 + j] for j < n_valid
    for (int sub = 0; sub * SUB < n_valid; ++sub) {
      const int n_rows = min(SUB, n_valid - sub * SUB);
      __syncthreads();
      stage<T, HD>(kv_s, k, row_base, t0 + sub * SUB, n_rows, KV);
      __syncthreads();
      if (sj < n_rows) {
        float dot[GPT];
#pragma unroll
        for (int i = 0; i < GPT; ++i) dot[i] = 0.f;
        const float* kj = kv_s + sj * (HD + 1);
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
          const float kd = kj[d];
#pragma unroll
          for (int i = 0; i < GPT; ++i) {
            const int g = sg + i * (NT / SUB);
            if (g < G) dot[i] = fmaf(q_s[g * HD + d], kd, dot[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < GPT; ++i) {
          const int g = sg + i * (NT / SUB);
          if (g < G) s_s[g * TILE + sub * SUB + sj] = dot[i];
        }
      }
    }
    __syncthreads();

    // online-softmax statistics, one warp per query head
    for (int g = warp; g < G; g += NT / 32) {
      float* sg_row = s_s + g * TILE;
      float mx = NEG_INF;
      for (int j = lane; j < n_valid; j += 32) mx = fmaxf(mx, sg_row[j]);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < n_valid; j += 32) {
        const float p = expf(sg_row[j] - m_new);
        sg_row[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }

    // acc = acc * corr + sum_j p[g][j] * v[t0 + j], j ascending
    float pv[OPT];
#pragma unroll
    for (int o = 0; o < OPT; ++o) pv[o] = 0.f;
    for (int sub = 0; sub * SUB < n_valid; ++sub) {
      const int n_rows = min(SUB, n_valid - sub * SUB);
      __syncthreads();
      stage<T, HD>(kv_s, v, row_base, t0 + sub * SUB, n_rows, KV);
      __syncthreads();
      const float* p_sub = s_s + sub * SUB;
#pragma unroll
      for (int o = 0; o < OPT; ++o) {
        const int idx = tid + o * NT;
        if (idx >= G * HD) break;
        const float* pg = p_sub + (idx / HD) * TILE;
        const float* vd = kv_s + idx % HD;
        float a = pv[o];
        for (int j = 0; j < n_rows; ++j) a = fmaf(pg[j], vd[j * (HD + 1)], a);
        pv[o] = a;
      }
    }
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      const int idx = tid + o * NT;
      if (idx < G * HD) acc[o] = acc[o] * c_s[idx / HD] + pv[o];
    }
  }
  __syncthreads();

#pragma unroll
  for (int o = 0; o < OPT; ++o) {
    const int idx = tid + o * NT;
    if (idx >= G * HD) break;
    store(out + ((size_t)b * H + kvh * G) * HD + idx,
          acc[o] / fmaxf(l_s[idx / HD], 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* pos, int B, int H, int KV, int T_cap, float scale,
           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(MAX_G, HD) * sizeof(float)));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const size_t smem = smem_floats(H / KV, HD) * sizeof(float);
  decode_kernel<T, HD><<<B * KV, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), pos, H, KV, T_cap,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, const int* pos, int B, int H, int KV, int T_cap,
                float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, pos, B, H, KV, T_cap, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, pos, B, H, KV, T_cap, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, pos, B, H, KV, T_cap, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, pos, B, H, KV, T_cap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after launch.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, void* out, const int* pos,
                                      int B, int H, int KV, int T_cap, int hd,
                                      float scale, int dtype, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > MAX_G || T_cap <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, pos, B, H, KV, T_cap, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, pos, B, H, KV, T_cap, scale, s);
  return (int)cudaErrorInvalidValue;
}
