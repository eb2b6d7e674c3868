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
// function is bound by operations (989 TFLOP/s of bf16 tensor-core work).
//
// Two kernels, chosen by dtype.
//
// bf16: extend_mma_kernel, both products on the tensor cores
// (mma.sync.m16n8k16, bf16 in, fp32 accumulate).  Block (stream, tile) has
// 8 warps in two groups of 4; in each group warp w owns the 16 stacked q
// rows row0 + 16w .. +15 as the M of both products, and the groups walk the
// even and the odd KV tiles, each with its own ring, barrier and online
// softmax, merged (group 0, then group 1) at the end.  Two warps per
// scheduler hide each other's mma, shuffle and barrier latency.
//  - Q: the block's 64 x hd q rows are gathered into shared memory once by
//    cp.async (each stacked row is one hd-wide row of q[b, i, kvh*G + g])
//    and held in registers as A fragments (ldmatrix) for the whole walk.
//    The hd^-0.5 scale is applied to S in fp32 (bf16 cannot hold
//    q * scale), with log2 e folded in for exp2.
//  - K, V: 64-position tiles through each group's two-slot ring in shared
//    memory, cp.async.cg at 16 bytes a thread, rows padded by 16 bytes (an
//    odd number of 16-byte chunks, so ldmatrix phases hit distinct banks).
//    Positions at or past t_real are zero-filled by a copy that reads 0
//    bytes, so nothing past t_real enters a sum, whatever the padding holds.
//  - S = Q K^T: K is the B operand through ldmatrix (a (pos, hd) row-major
//    tile is B in "col" layout).  The mask is applied only on tiles that
//    reach past the warp's least q_pos; a warp skips tiles past its greatest
//    q_pos (they would add exact zeros), and the block's walk ends with the
//    tile that holds its last visible position.
//  - Softmax: row max and sum by quad shuffles, fp32 exp2; l is kept per
//    thread and summed over the quad at the end.
//  - O += P V: the fp32 accumulators of two adjacent S tiles have the
//    layout of the A fragment, so P needs no shuffle.  P enters as three
//    bf16 terms, P_0 = bf16(P), P_1 = bf16(P - P_0), P_2 = bf16(P - P_0 -
//    P_1), three mma against the same V fragment: V is exact in bf16 and P
//    is carried to 2^-27 relative, as the TPU kernel's fp32 P
//    (kernel.py:56-61) asks.  Two terms (2^-18) leave errors up to ~4e-6 |v|
//    where few positions' P.V cancel to an output near zero, above the
//    1e-6 floor of the one-ulp check.  V is the B operand through
//    ldmatrix.trans.
//  - Epilogue: acc / max(l, 1e-30), written as bf16 pairs to
//    out[b, i, kvh*G + g]; rows past G*nb are skipped.
// Against the bound: the three-term P makes the issued tensor-core work 2x
// the function's (S: 2*hd, P V: 3 * 2*hd FLOPs per score); the walk stops
// at the causal edge and warps skip the tiles past their rows, so no tile
// above the diagonal is multiplied; every K/V tile is staged once per block
// and read by all 64 rows; the next tile of each group is in flight while
// one is computed.  wgmma (64-row warpgroup tiles) and TMA are the next
// step.
//
// fp32: extend_kernel, fp32 math on the CUDA cores (67 TFLOP/s peak).  Each
// block keeps its scaled q tile in shared memory for the whole KV walk,
// every K/V tile it stages is reused by all BM rows, registers hold an
// 8-row x 2-column score tile and an 8-row x hd/32 accumulator per lane (8
// warps, two per scheduler), the next K/V tile is fetched into registers
// with 16-byte loads while the current one is computed, and the walk stops
// after ceil(t_real / BN) tiles (tiles past t_real would add exact zeros,
// since tile 0 always sets a finite running max).
//
// Numerics: fp32 softmax and accumulation; output in q's dtype.  t_real is
// read on the device, so a captured launch serves every chunk.  The launch
// goes on the caller's stream; the kernel allocates nothing.  q, k and v
// must be 16-byte aligned (the wrapper checks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BM = 64;               // q rows per block
constexpr int BN = 64;               // KV positions per tile
constexpr int NT = 256;              // threads per block: 8 warps
constexpr int RPW = BM / (NT / 32);  // q rows per warp = 8

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
template <int HD>
struct TileRegs {
  static constexpr int VEC = 4;                         // floats per vector
  static constexpr int VPR = HD / VEC;                  // vectors per row
  static constexpr int VPT = (BN * VPR + NT - 1) / NT;  // vectors per thread
  uint4 k[VPT], v[VPT];

  __device__ __forceinline__ void fetch(const float* __restrict__ kp,
                                        const float* __restrict__ vp, int b,
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
      const float* ke = reinterpret_cast<const float*>(&k[i]);
      const float* ve = reinterpret_cast<const float*>(&v[i]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        k_s[c * (HD + 1) + w * VEC + e] = ke[e];
        v_s[c * HD + w * VEC + e] = ve[e];
      }
    }
  }
};

template <int HD>
__global__ void __launch_bounds__(NT)
extend_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
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

  TileRegs<HD> regs;
  if (n_tiles > 0) regs.fetch(k, v, b, kvh, KV, T_cap, 0);

  for (int idx = tid; idx < BM * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD, row = row0 + r;
    float x = 0.f;
    if (row < rows) {
      const int g = row / nb, i = row % nb;
      x = q[(((size_t)b * nb + i) * H + kvh * G + g) * HD + d] * scale;
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
    float* o = out + (((size_t)b * nb + i) * H + kvh * G + g) * HD;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < HD) o[d] = acc[rr][j] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int MW = 8;                  // warps per block
constexpr int MNT = MW * 32;
constexpr int GW = 4;                  // warps per tile group, 16 q rows each
constexpr int GNT = GW * 32;
constexpr int STAGES = 2;              // K/V ring slots per group
static_assert(BM == GW * 16 && MW == 2 * GW, "two groups of 4 warps x 16 rows");
constexpr float LOG2E = 1.4426950408889634f;

// row stride of a staged bf16 tile: hd plus one 16-byte chunk
template <int HD>
__host__ __device__ constexpr int mma_row_stride() { return HD + 8; }

// the block's q rows, then each group's ring of [K, V] tiles; the groups'
// merge records alias the rings
template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)mma_row_stride<HD>() * (BM + 2 * STAGES * 2 * BN);
}

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
// barrier of one group's 128 threads (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + group), "n"(GNT) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
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
  for (int i = 0; i < 2; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    t[i] = *reinterpret_cast<const uint32_t*>(&h);
    x -= hf.x;
    y -= hf.y;
  }
  t[2] = pack_bf16(x, y);
}

// Block (stream, row tile): 8 warps in two groups of 4.  Warp w of group
// kg = w / 4 owns the 16 stacked rows row0 + 16 (w % 4) .. +15 and walks
// the KV tiles kg, kg + 2, kg + 4, ... through its group's own ring (named
// barrier per group), keeping its own online softmax; at the end group 1's
// (m, l, acc) merge into group 0's in that order.  Scores are kept in log2
// units (S * hd^-0.5 * log2 e, exp2).
template <int HD>
__global__ void __launch_bounds__(MNT, 1)
extend_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out,
                  const int* __restrict__ t_real_ptr,
                  int nb, int H, int KV, int T_cap, float scale) {
  constexpr int RS = mma_row_stride<HD>();
  constexpr int CPR = HD / 8;                   // 16-byte chunks per row
  constexpr int TILE = BN * RS;                 // elements of one K or V tile
  constexpr int NO = HD / 8;                    // output N tiles
  static_assert((BN * CPR) % GNT == 0, "whole K/V copies per thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // BM x RS

  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int row0 = blockIdx.y * BM, rows = G * nb;
  const int t_real = min(*t_real_ptr, T_cap);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kg = warp / GW, gw = warp % GW, gtid = tid % GNT;
  __nv_bfloat16* ring = q_s + BM * RS + kg * STAGES * 2 * TILE;      // [slot][K, V]
  // element (b, t, kvh, d) of k/v sits at (kv_base + t*KV)*HD + d
  const size_t kv_base = (size_t)b * T_cap * KV + kvh;
  // the walk ends with the tile that holds the block's last visible position
  const int last = min(row0 + BM, rows) - 1;
  const int max_i = last / nb != row0 / nb ? nb - 1 : last % nb;
  const int n_tiles = (t_real - nb + max_i + BN) / BN;

  for (int idx = tid; idx < BM * CPR; idx += MNT) {
    const int r = idx / CPR, c = idx % CPR, row = row0 + r;
    const bool ok = row < rows;
    const int g = ok ? row / nb : 0, i = ok ? row % nb : 0;
    cp_async16(q_s + r * RS + c * 8,
               q + (((size_t)b * nb + i) * H + kvh * G + g) * HD + c * 8, ok ? 16 : 0);
  }
  cp_async_commit();
  // the group's j-th tile (kg + 2j) into slot j % STAGES, one commit group
  // (empty past the walk)
  auto issue = [&](int j) {
    const int tile = kg + 2 * j;
    if (tile < n_tiles) {
      __nv_bfloat16* kt = ring + (j % STAGES) * 2 * TILE;
      const int t0 = tile * BN;
#pragma unroll
      for (int jj = 0; jj < BN * CPR / GNT; ++jj) {
        const int idx = gtid + jj * GNT;
        const int r = idx / CPR, c = idx % CPR;
        const bool ok = t0 + r < t_real;
        const size_t off = (kv_base + (size_t)(ok ? t0 + r : 0) * KV) * HD + c * 8;
        cp_async16(kt + r * RS + c * 8, k + off, ok ? 16 : 0);
        cp_async16(kt + TILE + r * RS + c * 8, v + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) issue(j);

  // this thread's two rows: lane/4 and lane/4 + 8 of the warp's 16
  const int wr0 = row0 + gw * 16;
  int qp[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr0 + (lane >> 2) + 8 * h;
    live[h] = row < rows;
    qp[h] = t_real - nb + row % nb;
  }
  // the warp's least and greatest q_pos over its rows inside G*nb
  const int lo_pos = __reduce_min_sync(0xffffffffu, min(live[0] ? qp[0] : INT_MAX,
                                                        live[1] ? qp[1] : INT_MAX));
  const int hi_pos = __reduce_max_sync(0xffffffffu, max(live[0] ? qp[0] : -1,
                                                        live[1] ? qp[1] : -1));

  cp_async_wait<STAGES - 1>();                  // q has landed
  __syncthreads();
  uint32_t qa[HD / 16][4];                      // Q A fragments, whole walk
  {
    const __nv_bfloat16* a_row =
        q_s + (gw * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) ldmatrix_x4(qa[kk], a_row + kk * 16);
  }

  const float scale2 = scale * LOG2E;
  float o[NO][4];                               // O accumulators: 16 rows x HD
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int dn = 0; dn < NO; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;

  for (int j = 0; kg + 2 * j < n_tiles; ++j) {
    issue(j + STAGES - 1);                      // into the slot freed last round
    cp_async_wait<STAGES - 1>();                // this tile has landed
    group_sync(kg);
    const int t0 = (kg + 2 * j) * BN;
    if (t0 <= hi_pos) {
      const __nv_bfloat16* kt = ring + (j % STAGES) * 2 * TILE;
      const __nv_bfloat16* vt = kt + TILE;

      // S = Q K^T: 8 N tiles of 8 positions
      float s[BN / 8][4];
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const __nv_bfloat16* b_row =
          kt + ((lane & 7) + (lane >> 4) * 8) * RS + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, b_row + np * 16 * RS + kk * 16);
          mma_bf16(s[2 * np], qa[kk], bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], qa[kk], bf[2], bf[3]);
        }

      // scale in fp32; mask only where the tile reaches past a row's q_pos
      if (t0 + BN - 1 > lo_pos) {
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = t0 + nt * 8 + 2 * (lane & 3) + (e & 1);
            s[nt][e] = kp <= qp[e >> 1] && kp < t_real ? s[nt][e] * scale2 : NEG_INF;
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] *= scale2;
      }

      // online softmax per row; the quad (lanes 4j .. 4j+3) shares a row
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
          s[nt][2 * h] = exp2f(s[nt][2 * h] - m_new);
          s[nt][2 * h + 1] = exp2f(s[nt][2 * h + 1] - m_new);
          sum += s[nt][2 * h] + s[nt][2 * h + 1];
        }
        l[h] = l[h] * corr[h] + sum;
      }
      // a row whose max did not move keeps its sums (x * 1 is exact)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int dn = 0; dn < NO; ++dn)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[dn][e] *= corr[e >> 1];
      }

      // O += P V with P as three bf16 terms: k-steps of 16 positions, two
      // output N tiles per ldmatrix.trans
      const __nv_bfloat16* v_row =
          vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t pa[3][4];
        uint32_t t[3];
#pragma unroll
        for (int f = 0; f < 4; ++f) {           // A registers: (row half, k half)
          const float* sv = s[2 * kk + (f >> 1)] + 2 * (f & 1);
          split3_bf16(sv[0], sv[1], t);
#pragma unroll
          for (int i = 0; i < 3; ++i) pa[i][f] = t[i];
        }
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, v_row + kk * 16 * RS + dp * 16);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            mma_bf16(o[2 * dp], pa[i], bf[0], bf[1]);
            mma_bf16(o[2 * dp + 1], pa[i], bf[2], bf[3]);
          }
        }
      }
    }
    group_sync(kg);                             // slot free for the next issue
  }
  cp_async_wait<0>();

  // row sums over the quad; group 1 hands (m, l, acc) to group 0 through
  // shared memory (field-major, so consecutive threads hit consecutive words)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();                              // both rings are drained
  float* rec = reinterpret_cast<float*>(q_s + BM * RS);   // [4 + NO*4][GNT]
  if (kg == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rec[h * GNT + gtid] = m[h];
      rec[(2 + h) * GNT + gtid] = l[h];
    }
#pragma unroll
    for (int dn = 0; dn < NO; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) rec[(4 + dn * 4 + e) * GNT + gtid] = o[dn][e];
  }
  __syncthreads();
  if (kg == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m1 = rec[h * GNT + gtid];
    const float mm = fmaxf(m[h], m1);
    const float a0 = exp2f(m[h] - mm), a1 = exp2f(m1 - mm);
    const float denom = fmaxf(l[h] * a0 + rec[(2 + h) * GNT + gtid] * a1, 1e-30f);
    if (!live[h]) continue;
    const int row = wr0 + (lane >> 2) + 8 * h;
    const int g = row / nb, i = row % nb;
    __nv_bfloat16* dst = out + (((size_t)b * nb + i) * H + kvh * G + g) * HD + 2 * (lane & 3);
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      const float x0 = o[dn][2 * h] * a0 + rec[(4 + dn * 4 + 2 * h) * GNT + gtid] * a1;
      const float x1 = o[dn][2 * h + 1] * a0 + rec[(4 + dn * 4 + 2 * h + 1) * GNT + gtid] * a1;
      *reinterpret_cast<uint32_t*>(dst + dn * 8) = pack_bf16(x0 / denom, x1 / denom);
    }
  }
}

// ---------------------------------------------------------------------------

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* t_real, int B, int nb, int H, int KV, int T_cap,
           float scale, cudaStream_t stream) {
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;   // tensor cores
  constexpr size_t smem = MMA ? mma_smem_bytes<HD>() : smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e;
    if constexpr (MMA)
      e = cudaFuncSetAttribute(extend_mma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    else
      e = cudaFuncSetAttribute(extend_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int G = H / KV;
  dim3 grid(B * KV, (G * nb + BM - 1) / BM);
  if constexpr (MMA) {
    extend_mma_kernel<HD><<<grid, MNT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), t_real, nb, H, KV,
        T_cap, scale);
  } else {
    extend_kernel<HD><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), t_real, nb, H, KV,
        T_cap, scale);
  }
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
