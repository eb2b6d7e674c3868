// Ragged flash-decode attention for Hopper (sm_90a), CUDA C++: split-KV.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py
// (decode_attention_streams / _kernel, layout in ops.py::decode_attention):
// one new query per (row, head) scored against the row's cache positions
// <= pos[row] of a capacity-padded KV cache, softmax, times V.
//
// Layout.  The kernel reads the model's own tensors, no transposed copies:
//   q, out  (B, 1, H, hd)     k, v  (B, T, KV, hd)     pos  int32[B] (device)
// The G = H / KV query heads h = kvh*G + g that share KV head kvh are
// scored together, so each K/V byte is read once per group.
//
// Bound.  Per position and KV head the work is 4*hd*G FLOPs against 4*hd
// bytes of bf16 K/V: G = 8 FLOPs per byte at full width, far below the
// card's ~295 FLOP/byte ridge, so the function is bound by bytes (HBM at
// 3.35 TB/s): 12.6 MB of K/V at position 3072 of the serving path is 3.8 us.
//
// Design.  Two kernels on the caller's stream, launched by one C call.
//  1. split_kernel, grid (B*KV, ceil(T/SPLIT)): block (b, kvh, s) owns the
//     SPLIT positions [s*SPLIT, (s+1)*SPLIT) and returns at once if
//     s*SPLIT > pos[b].  At batch 1, position 3072 and KV 8 that is 200
//     live blocks of 4 warps (SPLIT 128) where one block per (row, KV head)
//     gave 8.  Warp w takes the 16-position tiles i*NW + w of the split.
//     Each warp streams its tiles through its own two-slot ring in shared
//     memory, in the stored dtype: cp.async.cg, 16 bytes a thread, K and V
//     as separate commit groups, so tile i+1's K and V and tile i's V are in
//     flight while tile i is scored, and cp.async.wait_group plus __syncwarp
//     replace block barriers.  Rows are padded by 16 bytes (an odd number of
//     16-byte chunks), so the row-strided 16-byte reads and ldmatrix phases
//     hit distinct banks.  Rows past pos inside a tile are zero-filled (the
//     copy reads 0 bytes) and masked; tiles past pos are never loaded.
//     Each warp keeps its own online softmax (m, l, acc); the block merges
//     its warps in order w = 0..NW-1 and writes one fp32 partial per query
//     head: [m, l, acc[0:hd]] (acc unnormalised) into the scratch tensor
//     (B, KV, ceil(T/SPLIT), G, hd + 2) that the wrapper allocates.
//  2. combine_kernel, one block per (b, kvh, g): M = max_s m_s, then
//     L = sum_s l_s exp(m_s - M) and acc = sum_s acc_s exp(m_s - M) over
//     s = 0 .. pos // SPLIT in ascending order; out = acc / max(L, 1e-30)
//     in q's dtype.  A block per (b, kvh, g), not per (b, kvh): with G
//     times the blocks and the splits' m, l staged by all threads at once,
//     the combine is not a chain of dependent loads at batch 1.
//
// Tensor cores (bf16).  Both products are mma.sync.m16n8k16 (bf16 in, fp32
// accumulate) with the G query heads as the N = 8 dimension (G < 8 pads N
// with zero columns, G = 16 takes two N tiles):
//   scores  S^T (16 positions x G) = K_tile (16 x hd) . Q^T (hd x G),
//           K from shared memory through ldmatrix, Q^T held in registers;
//   output  O^T (hd x G) += V^T (hd x 16 positions) . P^T (16 x G),
//           V through ldmatrix.trans, P^T from the score fragment by
//           movmatrix.trans (the accumulator layout of S^T is the transpose
//           of the operand layout P^T needs).
// P enters the second product as three bf16 terms, P = P_0 + P_1 + P_2
// with P_0 = bf16(P), P_1 = bf16(P - P_0), P_2 = bf16(P - P_0 - P_1), and
// three mma accumulate them against the same V fragment in fp32: V is exact
// in bf16 and P is carried to 2^-27 relative, so the product is the TPU
// kernel's fp32 P.V (kernel.py:56-61) to within fp32 summation order; l
// sums the fp32 P.  Two terms (2^-18) leave |P.V| errors up to ~4e-6 |v|
// where few positions' P.V cancel to an output near zero, above the 1e-6
// floor of the one-ulp check.  In this byte-bound kernel the extra mma
// cost next to nothing.  wgmma does
// not fit: its tiles have 64 rows, and a decode has G = 8 query rows per KV
// head, so its M would be 8/64 used or the positions would need 64-row
// tiles per warpgroup and a cross-warp softmax for no gain in a byte-bound
// function.  fp32 inputs take the same
// pipeline (16-byte loads of 4 floats) with scalar fp32 math on the CUDA
// cores, no TF32.
//
// Bit-invariance.  Split boundaries are a fixed function of the position
// (SPLIT is a compile-time constant, never a function of T, B or the grid);
// a split's partial reads that split's positions <= pos and nothing else,
// in an order fixed by the tile and lane indices; the combine walks
// s = 0 .. pos // SPLIT in ascending order.  T enters only as an address
// stride and the number of (dead) blocks, B only as the grid, so a row's
// output is bitwise the same at any padded capacity and in any batch
// (batched serving merges packs of mixed capacity on this property).
//
// Head dims 16, 32, 64, 128 and 192 (nemotron-4-340b: G 12, which takes two
// N tiles).  At 192 a split block's rings take 102,400 bytes in bf16 and,
// with the CUDA-core path's q rows and probabilities, 217,408 in fp32; on
// the tensor cores a lane holds 48 registers of Q^T fragments and 96
// accumulators at G > 8.
//
// Numerics: fp32 softmax and accumulation; output in q's dtype.  The kernel
// allocates nothing.  k/v must be 16-byte aligned (the wrapper checks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
// positions per split: fixed, never a function of T, B or the grid (128
// was the fastest of 64/128/256 at the serving path's batch 1); the
// wrapper passes its own value and the entry point refuses another
constexpr int SPLIT = 128;
constexpr int NW = 4;                 // warps per split block
constexpr int NT = NW * 32;
constexpr int ROWS = 16;              // positions per warp tile (mma M)
constexpr int TPW = SPLIT / (ROWS * NW);   // tiles per warp
constexpr int MAX_G = 16;             // query heads per KV head
constexpr int CT = 128;               // combine threads
static_assert(SPLIT % (ROWS * NW) == 0, "a split is whole warp tiles");

// row stride of a staged tile, in elements: hd plus one 16-byte chunk
template <typename T, int HD>
__host__ __device__ constexpr int row_stride() { return HD + 16 / (int)sizeof(T); }

// shared memory of a split block: the warps' rings, then (CUDA-core path)
// the scaled q rows and each warp's probabilities and rescale factors.
// The warps' merge records [G][hd + 2] alias the rings.
template <typename T, int HD, bool MMA>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)NW * 2 * 2 * ROWS * row_stride<T, HD>() * sizeof(T) +
         (MMA ? 0 : ((size_t)MAX_G * (HD + 1) + (size_t)NW * MAX_G * (ROWS + 1)) * sizeof(float));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy; n_src 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n_src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// c += a . b, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x, y) as three bf16 pairs t[0] + t[1] + t[2] that carry them to 2^-27
// relative: each term rounds what the ones before left, and each remainder
// is exact in fp32
__device__ __forceinline__ void split3_bf16(float x, float y, uint32_t (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    t[i] = *reinterpret_cast<const uint32_t*>(&h);
    x -= hf.x;
    y -= hf.y;
  }
}

// Copy one warp tile (rows [r0, r0 + 16) of the split) of k or v into dst;
// rows at or past n_valid are zero-filled without reading memory.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          size_t row_base, int t0, int r0,
                                          int n_valid, int KV, int lane) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;               // 16-byte chunks per row
  constexpr int RS = row_stride<T, HD>();
#pragma unroll
  for (int i = 0; i < ROWS * CPR / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r0 + r < n_valid;
    const T* g = src + (row_base + (size_t)(t0 + (ok ? r0 + r : 0)) * KV) * HD + c * VEC;
    cp_async16(dst + r * RS + c * VEC, g, ok ? 16 : 0);
  }
}

// Per-warp online-softmax state on the tensor cores (bf16).  Lane l holds
// heads nt*8 + 2*(l%4) + {0, 1} of N tile nt; all lanes with the same l%4
// agree on m.  o[md][nt] is the O^T accumulator of rows d = md*16 + l/4
// (+8), columns those two heads.
template <int HD, int NTG>
struct MmaWarp {
  uint32_t qb[HD / 16][NTG][2];   // Q^T operand fragments
  float o[HD / 16][NTG][4];
  float m[NTG][2], l[NTG][2];

  __device__ void init(const __nv_bfloat16* __restrict__ qg, int G, int lane) {
    const int c = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NTG; ++nt) {
      const int g = nt * 8 + (lane >> 2);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = kk * 16 + h * 8 + 2 * c;
          qb[kk][nt][h] = g < G ? pack_bf16(__bfloat162float(qg[g * HD + d]),
                                            __bfloat162float(qg[g * HD + d + 1]))
                                : 0u;
        }
#pragma unroll
      for (int md = 0; md < HD / 16; ++md)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[md][nt][e] = 0.f;
      m[nt][0] = m[nt][1] = NEG_INF;
      l[nt][0] = l[nt][1] = 0.f;
    }
  }

  __device__ void scores(const __nv_bfloat16* kt, float scale, int rv, int lane,
                         float (&s)[NTG][4]) {
    constexpr int RS = row_stride<__nv_bfloat16, HD>();
#pragma unroll
    for (int nt = 0; nt < NTG; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const __nv_bfloat16* a_row = kt + ((lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_row + kk * 16);
#pragma unroll
      for (int nt = 0; nt < NTG; ++nt) mma_bf16(s[nt], a, qb[kk][nt][0], qb[kk][nt][1]);
    }
    const int j = lane >> 2;
#pragma unroll
    for (int nt = 0; nt < NTG; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = (j + (e >> 1) * 8 < rv) ? s[nt][e] * scale : NEG_INF;
  }

  __device__ void update(const __nv_bfloat16* vt, float (&s)[NTG][4], int lane) {
    constexpr int RS = row_stride<__nv_bfloat16, HD>();
    uint32_t pb[3][NTG][2];            // P^T operands, one per bf16 term of P
#pragma unroll
    for (int nt = 0; nt < NTG; ++nt) {
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = fmaxf(s[nt][h], s[nt][h + 2]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[nt][h], mx);
        corr[h] = expf(m[nt][h] - m_new);
        m[nt][h] = m_new;
        s[nt][h] = expf(s[nt][h] - m_new);
        s[nt][h + 2] = expf(s[nt][h + 2] - m_new);
        l[nt][h] = l[nt][h] * corr[h] + (s[nt][h] + s[nt][h + 2]);
      }
#pragma unroll
      for (int md = 0; md < HD / 16; ++md)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[md][nt][e] *= corr[e & 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t t[3];
        split3_bf16(s[nt][2 * r], s[nt][2 * r + 1], t);
#pragma unroll
        for (int i = 0; i < 3; ++i) pb[i][nt][r] = movmatrix_trans(t[i]);
      }
    }
    const int mi = lane >> 3;
    const __nv_bfloat16* a_row = vt + ((lane & 7) + (mi >> 1) * 8) * RS + (mi & 1) * 8;
#pragma unroll
    for (int md = 0; md < HD / 16; ++md) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, a_row + md * 16);
#pragma unroll
      for (int nt = 0; nt < NTG; ++nt)
#pragma unroll
        for (int i = 0; i < 3; ++i) mma_bf16(o[md][nt], a, pb[i][nt][0], pb[i][nt][1]);
    }
  }

  // this warp's [m, l, acc] per head into rec[g * (HD + 2)]
  __device__ void write(float* rec, int G, int lane) {
#pragma unroll
    for (int nt = 0; nt < NTG; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sum = l[nt][h];
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        sum += __shfl_xor_sync(0xffffffffu, sum, 8);
        sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        const int g = nt * 8 + 2 * (lane & 3) + h;
        if (g >= G) continue;
        if (lane < 4) {
          rec[g * (HD + 2)] = m[nt][h];
          rec[g * (HD + 2) + 1] = sum;
        }
#pragma unroll
        for (int md = 0; md < HD / 16; ++md)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            rec[g * (HD + 2) + 2 + md * 16 + r * 8 + (lane >> 2)] = o[md][nt][r * 2 + h];
      }
  }
};

// Per-warp online-softmax state on the CUDA cores (fp32 inputs).
// Scores: lane l takes tile row l%16 against heads l/16 + 2i.  P.V: the
// warp walks the (head, 16-byte column chunk) pairs idx = l + 32*i, head
// idx / CPL, chunk idx % CPL, so every chunk of a row is owned by a lane
// also where a row has more chunks than the warp has lanes (hd 192: 48).
// Each output element is one lane's sum over the tile rows in order.
template <typename T, int HD>
struct ScalarWarp {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int CPL = HD / VEC;                 // chunks per row
  static constexpr int HPL = (MAX_G * CPL + 31) / 32;  // (head, chunk) pairs per lane
  float acc[HPL][VEC];
  float m[MAX_G / 2], l[MAX_G / 2];
  const float* q_s;     // G x (HD + 1), scaled
  float* p_w;           // MAX_G x ROWS probabilities of this warp
  float* c_w;           // MAX_G rescale factors of this warp

  __device__ void init(const float* q, float* p, int lane) {
    q_s = q;
    p_w = p;
    c_w = p + MAX_G * ROWS;
#pragma unroll
    for (int i = 0; i < HPL; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_G / 2; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
    }
  }

  __device__ static void unpack(const uint4& raw, float (&x)[VEC]) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = to_float(e[i]);
  }

  __device__ void step(const T* kt, const T* vt, int rv, int G, int lane) {
    constexpr int RS = row_stride<T, HD>();
    const int j = lane & 15, hs = lane >> 4;
    float dot[MAX_G / 2];
#pragma unroll
    for (int i = 0; i < MAX_G / 2; ++i) dot[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < CPL; ++c) {
      float kx[VEC];
      unpack(*reinterpret_cast<const uint4*>(kt + j * RS + c * VEC), kx);
#pragma unroll
      for (int i = 0; i < MAX_G / 2; ++i) {
        const int g = hs + 2 * i;
        if (g < G) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot[i] = fmaf(q_s[g * (HD + 1) + c * VEC + e], kx[e], dot[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAX_G / 2; ++i) {
      if (2 * i >= G) break;                 // warp-uniform
      const int g = hs + 2 * i;              // may be G when G is odd
      const float sc = j < rv ? dot[i] : NEG_INF;
      float mx = sc;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      const float p = expf(sc - m_new);
      m[i] = m_new;
      l[i] = l[i] * corr + p;
      if (g < G) {
        p_w[g * ROWS + j] = p;
        if (j == 0) c_w[g] = corr;
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < HPL; ++i) {
      const int idx = lane + 32 * i, g = idx / CPL, cc = idx % CPL;
      if (g < G) {
        const float corr = c_w[g];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] *= corr;
#pragma unroll 4
        for (int r = 0; r < ROWS; ++r) {
          float vx[VEC];
          unpack(*reinterpret_cast<const uint4*>(vt + r * RS + cc * VEC), vx);
          const float p = p_w[g * ROWS + r];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(p, vx[e], acc[i][e]);
        }
      }
    }
    __syncwarp();
  }

  __device__ void write(float* rec, int G, int lane) {
    const int j = lane & 15, hs = lane >> 4;
#pragma unroll
    for (int i = 0; i < MAX_G / 2; ++i) {
      float sum = l[i];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const int g = hs + 2 * i;
      if (j == 0 && g < G) {
        rec[g * (HD + 2)] = m[i];
        rec[g * (HD + 2) + 1] = sum;
      }
    }
#pragma unroll
    for (int i = 0; i < HPL; ++i) {
      const int idx = lane + 32 * i, g = idx / CPL, cc = idx % CPL;
      if (g < G) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) rec[g * (HD + 2) + 2 + cc * VEC + e] = acc[i][e];
      }
    }
  }
};

template <typename T, int HD, bool MMA, int NTG>
__global__ void __launch_bounds__(NT)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ part,
             const int* __restrict__ pos_ptr, int H, int KV, int T_cap,
             float scale) {
  constexpr int RS = row_stride<T, HD>();
  constexpr int SLOT = ROWS * RS;                 // elements of one K or V tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int pos = min(pos_ptr[b], T_cap - 1);
  const int t0 = split * SPLIT;
  if (t0 > pos) return;
  const int n_valid = min(SPLIT, pos - t0 + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // element (b, t, kvh, d) of k/v sits at (row_base + t*KV)*HD + d
  const size_t row_base = (size_t)b * T_cap * KV + kvh;
  const T* qg = q + ((size_t)b * H + kvh * G) * HD;
  T* ring = reinterpret_cast<T*>(smem) + (size_t)warp * 4 * SLOT;   // [slot][K, V]

  using Warp = typename std::conditional<MMA, MmaWarp<HD, NTG>, ScalarWarp<T, HD>>::type;
  Warp st;
  if constexpr (MMA) {
    st.init(reinterpret_cast<const __nv_bfloat16*>(qg), G, lane);
  } else {
    float* q_s = reinterpret_cast<float*>(smem + (size_t)NW * 4 * SLOT * sizeof(T));
    for (int i = threadIdx.x; i < G * HD; i += NT)
      q_s[(i / HD) * (HD + 1) + i % HD] = to_float(qg[i]) * scale;
    st.init(q_s, q_s + MAX_G * (HD + 1) + warp * MAX_G * (ROWS + 1), lane);
    __syncthreads();
  }

  // tile i of this warp: split rows r0 = (i*NW + warp)*16 .. +15, slot i % 2
  auto issue = [&](int i) {
    const int r0 = (i * NW + warp) * ROWS;
    T* slot = ring + (i & 1) * 2 * SLOT;
    if (i < TPW && r0 < n_valid) load_tile<T, HD>(slot, k, row_base, t0, r0, n_valid, KV, lane);
    cp_async_commit();
    if (i < TPW && r0 < n_valid) load_tile<T, HD>(slot + SLOT, v, row_base, t0, r0, n_valid, KV, lane);
    cp_async_commit();
  };
  issue(0);
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    issue(i + 1);                       // next tile's K and V in flight
    const int r0 = (i * NW + warp) * ROWS;
    const T* kt = ring + (i & 1) * 2 * SLOT;
    cp_async_wait<3>();                 // this tile's K has landed
    __syncwarp();
    if constexpr (MMA) {
      float s[NTG][4];
      if (r0 < n_valid) st.scores(reinterpret_cast<const __nv_bfloat16*>(kt), scale,
                                  n_valid - r0, lane, s);
      cp_async_wait<2>();               // and its V
      __syncwarp();
      if (r0 < n_valid) st.update(reinterpret_cast<const __nv_bfloat16*>(kt + SLOT), s, lane);
    } else {
      cp_async_wait<2>();
      __syncwarp();
      if (r0 < n_valid) st.step(kt, kt + SLOT, n_valid - r0, G, lane);
    }
    __syncwarp();                       // slot free for tile i + 2
  }
  cp_async_wait<0>();

  // merge the warps in order w = 0..NW-1 into this split's partial
  __syncthreads();
  float* mrg = reinterpret_cast<float*>(smem);    // [NW][G][HD + 2]
  st.write(mrg + (size_t)warp * G * (HD + 2), G, lane);
  __syncthreads();
  float* rec = part + (((size_t)b * KV + kvh) * n_split + split) * G * (HD + 2);
  for (int idx = threadIdx.x; idx < G * (HD + 2); idx += NT) {
    const int g = idx / (HD + 2), f = idx % (HD + 2);
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, mrg[(w * G + g) * (HD + 2)]);
    float x = f == 0 ? M : 0.f;
    if (f > 0) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float* r = mrg + (w * G + g) * (HD + 2);
        x += r[f] * expf(r[0] - M);
      }
    }
    rec[idx] = x;
  }
}

// One block per (b, kvh, g).  The live splits' m and l are staged in shared
// memory by all threads at once, M = max_s m_s, each weight
// w_s = exp(m_s - M) is computed once, and every thread sums in ascending s:
// L = sum_s l_s w_s, and acc_s[d] w_s for its column d.
template <typename T, int HD>
__global__ void __launch_bounds__(CT)
combine_kernel(const float* __restrict__ part, T* __restrict__ out,
               const int* __restrict__ pos_ptr, int H, int KV, int T_cap,
               int n_split) {
  extern __shared__ float cs[];               // w[n_split], l[n_split]
  __shared__ float warp_max[CT / 32];
  float* w = cs;
  float* l = cs + n_split;
  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, g = blockIdx.y;
  const int n_live = min(pos_ptr[b], T_cap - 1) / SPLIT + 1;
  const size_t stride = (size_t)G * (HD + 2);     // one split's records
  const float* rec = part + ((size_t)b * KV + kvh) * n_split * stride + g * (HD + 2);
  float mx = NEG_INF;
  for (int s = threadIdx.x; s < n_live; s += CT) {
    w[s] = rec[s * stride];
    l[s] = rec[s * stride + 1];
    mx = fmaxf(mx, w[s]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = mx;
  __syncthreads();
  float M = warp_max[0];
#pragma unroll
  for (int i = 1; i < CT / 32; ++i) M = fmaxf(M, warp_max[i]);
  for (int s = threadIdx.x; s < n_live; s += CT) w[s] = expf(w[s] - M);
  __syncthreads();
  float L = 0.f;
  for (int s = 0; s < n_live; ++s) L += l[s] * w[s];
  for (int d = threadIdx.x; d < HD; d += CT) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_live; ++s) a += rec[s * stride + 2 + d] * w[s];
    store(out + ((size_t)b * H + kvh * G + g) * HD + d, a / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HD, bool MMA, int NTG>
int launch_split(const void* q, const void* k, const void* v, const int* pos,
                 float* part, int B, int H, int KV, int T_cap, float scale,
                 int n_split, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD, MMA>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(split_kernel<T, HD, MMA, NTG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  split_kernel<T, HD, MMA, NTG><<<dim3(B * KV, n_split), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      part, pos, H, KV, T_cap, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* pos, float* part, int B, int H, int KV, int T_cap,
           float scale, cudaStream_t stream) {
  const int n_split = (T_cap + SPLIT - 1) / SPLIT;
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;   // tensor cores
  const int err = H / KV <= 8
      ? launch_split<T, HD, MMA, 1>(q, k, v, pos, part, B, H, KV, T_cap, scale, n_split, stream)
      : launch_split<T, HD, MMA, 2>(q, k, v, pos, part, B, H, KV, T_cap, scale, n_split, stream);
  if (err != 0) return err;
  combine_kernel<T, HD><<<dim3(B * KV, H / KV), CT, 2 * n_split * sizeof(float), stream>>>(
      part, static_cast<T*>(out), pos, H, KV, T_cap, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, const int* pos, float* p, int B, int H, int KV,
                int T_cap, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, pos, p, B, H, KV, T_cap, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, pos, p, B, H, KV, T_cap, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, pos, p, B, H, KV, T_cap, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, pos, p, B, H, KV, T_cap, scale, s);
    case 192: return launch<T, 192>(q, k, v, out, pos, p, B, H, KV, T_cap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  partials: fp32 scratch of
// B*KV*ceil(T_cap/split)*G*(hd+2) floats, where split must be SPLIT.
// Launches the split and combine kernels on `stream`; returns
// cudaGetLastError() after them.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, void* out, const int* pos,
                                      void* partials, int split, int B, int H,
                                      int KV, int T_cap, int hd, float scale,
                                      int dtype, void* stream) {
  if (split != SPLIT || B <= 0 || KV <= 0 || H % KV != 0 || H / KV > MAX_G ||
      T_cap <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, pos, p, B, H, KV, T_cap, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, pos, p, B, H, KV, T_cap, scale, s);
  return (int)cudaErrorInvalidValue;
}
