// Causal suffix (extend) attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/extend_attention/kernel.py
// (extend_attention_streams / _kernel, layout in ops.py::extend_attention):
// the q rows of one prefill chunk (the last `nb` positions of a stream whose
// valid length is t_real) attend over a capacity-padded KV cache with the
// mask  k_pos <= q_pos && k_pos < t_real,  q_pos = t_real - nb + i.
//
// Layout.  The kernel reads the model's own tensors, no transposed copies:
//   q, out  (B, nb, H, hd)     k, v  (B, T, KV, hd)     t_real  int32[1] (device)
// GQA: query head h = kvh*G + g shares KV head kvh.  Block (stream, tile) with
// stream = b*KV + kvh holds BM of the stream's G*nb rows, stacked as row
// r = g*nb + i (the TPU kernel's order), so the KV stream is read once per
// group of G heads and the grid is (B*KV, ceil(G*nb / BM)): at B=1, KV=8,
// G=8, nb=128 that is 128 blocks, not the 8 a grid over streams would give.
//
// Bound.  At the serving shapes (G=8, nb=128, hd=128) each KV position brings
// 4*hd bytes (bf16 K and V rows) and feeds G*nb rows x 4*hd FLOPs, i.e.
// G*nb = 1024 FLOPs per byte, far above the H100's ~295 FLOP/byte ridge: the
// function is bound by operations.  This first kernel does its products in
// fp32 on the CUDA cores (67 TFLOP/s peak), not on the tensor cores; wgmma +
// TMA is the later redesign.  What this design does about the bound: each
// block keeps its q tile in shared memory for the whole KV walk, every K/V
// tile it stages is reused by all BM rows, registers hold an 8-row x
// 2-column score tile and an 8-row x hd/32 accumulator per lane (8 warps, two
// per scheduler), the next K/V tile is fetched into registers with 16-byte
// loads while the current one is computed, and the walk stops after
// ceil(t_real / BN) tiles (tiles past t_real would add exact zeros, since
// tile 0 always sets a finite running max).
//
// Numerics: fp32 math for fp32 and bf16 inputs; output in q's dtype.
// t_real is read on the device, so a captured launch serves every chunk.
// The launch goes on the caller's stream; the kernel allocates nothing.
// Pointers must be 16-byte aligned (the wrapper checks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BM = 64;               // q rows per block
constexpr int BN = 64;               // KV positions per tile
constexpr int NT = 256;              // threads per block: 8 warps
constexpr int RPW = BM / (NT / 32);  // q rows per warp = 8

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

template <int HD>
constexpr size_t smem_bytes() {
  // q tile + K tile (row pad +1 against bank conflicts) + V tile + P tile
  return sizeof(float) * (size_t)(BM * HD + BN * (HD + 1) + BN * HD + BM * BN);
}

// One K/V tile in flight: each thread holds VPT 16-byte vectors of K and V.
template <typename T, int HD>
struct TileRegs {
  static constexpr int VEC = 16 / sizeof(T);            // elements per vector
  static constexpr int VPR = HD / VEC;                  // vectors per row
  static constexpr int VPT = (BN * VPR + NT - 1) / NT;  // vectors per thread
  uint4 k[VPT], v[VPT];

  __device__ __forceinline__ void fetch(const T* __restrict__ kp,
                                        const T* __restrict__ vp, int b,
                                        int kvh, int KV, int T_cap, int t0) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int c = idx / VPR, w = idx % VPR, t = t0 + c;
      k[i] = v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < BN * VPR && t < T_cap) {
        const size_t off = (((size_t)b * T_cap + t) * KV + kvh) * HD + w * VEC;
        k[i] = *reinterpret_cast<const uint4*>(kp + off);
        v[i] = *reinterpret_cast<const uint4*>(vp + off);
      }
    }
  }

  __device__ __forceinline__ void put(float* k_s, float* v_s) const {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int idx = threadIdx.x + i * NT;
      if (idx >= BN * VPR) continue;
      const int c = idx / VPR, w = idx % VPR;
      const T* ke = reinterpret_cast<const T*>(&k[i]);
      const T* ve = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        k_s[c * (HD + 1) + w * VEC + e] = load(ke + e);
        v_s[c * HD + w * VEC + e] = load(ve + e);
      }
    }
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
extend_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              const int* __restrict__ t_real_ptr,
              int nb, int H, int KV, int T_cap, float scale) {
  constexpr int DPL = (HD + 31) / 32;   // accumulator columns per lane
  extern __shared__ float smem[];
  float* q_s = smem;                     // BM x HD
  float* k_s = q_s + BM * HD;            // BN x (HD + 1)
  float* v_s = k_s + BN * (HD + 1);      // BN x HD
  float* p_s = v_s + BN * HD;            // BM x BN

  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int row0 = blockIdx.y * BM;
  const int rows = G * nb;
  const int t_real = *t_real_ptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (t_real + BN - 1) / BN;

  TileRegs<T, HD> regs;
  if (n_tiles > 0) regs.fetch(k, v, b, kvh, KV, T_cap, 0);

  for (int idx = tid; idx < BM * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD, row = row0 + r;
    float x = 0.f;
    if (row < rows) {
      const int g = row / nb, i = row % nb;
      x = load(q + (((size_t)b * nb + i) * H + kvh * G + g) * HD + d) * scale;
    }
    q_s[idx] = x;
  }

  int q_pos[RPW];
  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    q_pos[rr] = t_real - nb + (row0 + warp * RPW + rr) % nb;
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[rr][j] = 0.f;
  }
  const float* q_w = q_s + warp * RPW * HD;
  float* p_w = p_s + warp * RPW * BN;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * BN;
    __syncthreads();   // the previous tile's K/V reads are done
    regs.put(k_s, v_s);
    __syncthreads();
    if (tile + 1 < n_tiles) regs.fetch(k, v, b, kvh, KV, T_cap, t0 + BN);

    // scores: lane owns columns `lane` and `lane + 32` of the tile
    float s[RPW][2];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) s[rr][0] = s[rr][1] = 0.f;
    const float* k0 = k_s + lane * (HD + 1);
    const float* k1 = k_s + (lane + 32) * (HD + 1);
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float ka = k0[d], kb = k1[d];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float qv = q_w[rr * HD + d];
        s[rr][0] = fmaf(qv, ka, s[rr][0]);
        s[rr][1] = fmaf(qv, kb, s[rr][1]);
      }
    }

    // online softmax per row (warp-wide over the tile's 64 columns)
    const int kp0 = t0 + lane, kp1 = t0 + lane + 32;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const float a = (kp0 <= q_pos[rr] && kp0 < t_real) ? s[rr][0] : NEG_INF;
      const float c = (kp1 <= q_pos[rr] && kp1 < t_real) ? s[rr][1] : NEG_INF;
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(pa + pc);
      m[rr] = m_new;
      p_w[rr * BN + lane] = pa;
      p_w[rr * BN + lane + 32] = pc;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[rr][j] *= corr;
    }
    __syncwarp();

    // acc += P V: lane owns output columns d = lane + 32*j
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float vv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        vv[j] = d < HD ? v_s[c * HD + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float p = p_w[rr * BN + c];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[rr][j] = fmaf(p, vv[j], acc[rr][j]);
      }
    }
    __syncwarp();      // P reads done before the next tile rewrites it
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = row0 + warp * RPW + rr;
    if (row >= rows) continue;
    const int g = row / nb, i = row % nb;
    const float denom = fmaxf(l[rr], 1e-30f);
    T* o = out + (((size_t)b * nb + i) * H + kvh * G + g) * HD;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < HD) store(o + d, acc[rr][j] / denom);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* t_real, int B, int nb, int H, int KV, int T_cap,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        extend_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int G = H / KV;
  dim3 grid(B * KV, (G * nb + BM - 1) / BM);
  extend_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), t_real, nb, H, KV,
      T_cap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, const int* t_real, int B, int nb, int H, int KV,
                int T_cap, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, t_real, B, nb, H, KV, T_cap, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, t_real, B, nb, H, KV, T_cap, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, t_real, B, nb, H, KV, T_cap, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, t_real, B, nb, H, KV, T_cap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after launch.
extern "C" int repro_extend_attention(const void* q, const void* k,
                                      const void* v, void* out,
                                      const int* t_real, int B, int nb, int H,
                                      int KV, int T_cap, int hd, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || nb <= 0 || KV <= 0 || H % KV != 0 || T_cap <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, t_real, B, nb, H, KV, T_cap, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, t_real, B, nb, H, KV, T_cap, scale, s);
  return (int)cudaErrorInvalidValue;
}
