// Causal suffix (extend) attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/extend_attention/kernel.py
// (extend_attention_streams / _kernel, layout in ops.py::extend_attention):
// the q rows of one prefill chunk (the last `nb` positions of a stream whose
// valid length is t_real) attend over a capacity-padded KV cache with the
// mask  k_pos <= q_pos && k_pos < t_real,  q_pos = t_real - nb + i.
//
// Layout.  The kernel reads the model's own tensors, no transposed copies:
//   q  (B, nb, H, HQK)   k  (B, T, KV, HQK)   v  (B, T, KV, HV)
//   out  (B, nb, H, HV)  t_real  int32[1] (device)
// HQK, the q.k width, and HV, the v width, are template parameters: equal for
// the GQA layout (ops.py::extend_attention; 16 to 128, and 192 for
// nemotron-4-340b at G 12), (HQK, HV) = (nope + rope, v) for
// MLA's packed [nope || rope] layout (ops.py::extend_attention_mla: 192, 128
// at full width, 24, 16 reduced), where H = KV (G = 1).  The scale is
// HQK^-0.5, which for MLA is (nope + rope)^-0.5.
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
// MLA (G=1, nb=128, 192/128) brings 2*(HQK + HV) = 640 bytes per position
// and head for 2*nb*(HQK + HV) = 81,920 FLOPs: 128 FLOPs per byte, below the
// ridge, so there the function is bound by bytes, and each K/V tile is read
// once per 64-row block (twice at nb = 128).
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
//  - Q: the block's 64 x HQK q rows are gathered into shared memory once by
//    cp.async (each stacked row is one HQK-wide row of q[b, i, kvh*G + g]).
//    Up to 128 columns their A fragments (ldmatrix) are held in registers
//    for the whole walk; past 128 (192) they are read again from the
//    resident q tile at each k-step of S: held there, 48 fragment registers
//    beside 64 or 96 output accumulators and the 32 of the S tile spill,
//    and the re-read is the faster of the two (extend_turns.py times both).
//    A q.k width that is not a multiple of the mma's k-step of 16 (MLA's
//    reduced 24) is staged as KD = 32 columns for q and K alike, the last
//    ones zeroed once: they add exact zeros to S.
//    The HQK^-0.5 scale is applied to S in fp32 (bf16 cannot hold
//    q * scale), with log2 e folded in for exp2.
//  - K, V: 64-position tiles through each group's two-slot ring in shared
//    memory, cp.async.cg at 16 bytes a thread, rows padded by 16 bytes (an
//    odd number of 16-byte chunks, so ldmatrix phases hit distinct banks);
//    K rows are KD + 8 wide and V rows HV + 8, so at MLA's 192/128 the q
//    tile and two groups' two-slot rings take 197,632 bytes, and at 192/192
//    230,400 of the 232,448 a block may have.
//    Positions at or past t_real are zero-filled by a copy that reads 0
//    bytes, so nothing past t_real enters a sum, whatever the padding holds.
//  - S = Q K^T: K is the B operand through ldmatrix (a (pos, KD) row-major
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
// the function's at HQK = HV (S: 2*HQK, P V: 3 * 2*HV FLOPs per score); the walk stops
// at the causal edge and warps skip the tiles past their rows, so no tile
// above the diagonal is multiplied; every K/V tile is staged once per block
// and read by all 64 rows; the next tile of each group is in flight while
// one is computed.  wgmma (64-row warpgroup tiles) and TMA are the next
// step.
//
// fp32: extend_kernel, fp32 math on the CUDA cores (67 TFLOP/s peak).  Each
// block keeps its scaled q tile in shared memory for the whole KV walk,
// every K/V tile it stages is reused by all BM rows, registers hold an
// 8-row x 2-column score tile and an 8-row x HV/32 accumulator per lane (8
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

template <int HQK, int HV>
constexpr size_t smem_bytes() {
  // q tile + K tile (row pad +1 against bank conflicts) + V tile + P tile
  return sizeof(float) * (size_t)(BM * HQK + BN * (HQK + 1) + BN * HV + BM * BN);
}

// One tile of W-wide rows in flight: each thread holds VPT 16-byte vectors.
template <int W>
struct RowRegs {
  static constexpr int VEC = 4;                         // floats per vector
  static constexpr int VPR = W / VEC;                   // vectors per row
  static constexpr int VPT = (BN * VPR + NT - 1) / NT;  // vectors per thread
  uint4 x[VPT];

  __device__ __forceinline__ void fetch(const float* __restrict__ p, int b,
                                        int kvh, int KV, int T_cap, int t0) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int c = idx / VPR, w = idx % VPR, t = t0 + c;
      x[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < BN * VPR && t < T_cap)
        x[i] = *reinterpret_cast<const uint4*>(
            p + (((size_t)b * T_cap + t) * KV + kvh) * W + w * VEC);
    }
  }

  // row c of the tile to dst + c * stride
  __device__ __forceinline__ void put(float* dst, int stride) const {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int idx = threadIdx.x + i * NT;
      if (idx >= BN * VPR) continue;
      const int c = idx / VPR, w = idx % VPR;
      const float* e = reinterpret_cast<const float*>(&x[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[c * stride + w * VEC + j] = e[j];
    }
  }
};

// One K/V tile in flight: K rows HQK wide, V rows HV wide.
template <int HQK, int HV>
struct TileRegs {
  RowRegs<HQK> k;
  RowRegs<HV> v;

  __device__ __forceinline__ void fetch(const float* __restrict__ kp,
                                        const float* __restrict__ vp, int b,
                                        int kvh, int KV, int T_cap, int t0) {
    k.fetch(kp, b, kvh, KV, T_cap, t0);
    v.fetch(vp, b, kvh, KV, T_cap, t0);
  }

  __device__ __forceinline__ void put(float* k_s, float* v_s) const {
    k.put(k_s, HQK + 1);
    v.put(v_s, HV);
  }
};

template <int HQK, int HV>
__global__ void __launch_bounds__(NT)
extend_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              const int* __restrict__ t_real_ptr,
              int nb, int H, int KV, int T_cap, float scale) {
  constexpr int DPL = (HV + 31) / 32;   // accumulator columns per lane
  extern __shared__ float smem[];
  float* q_s = smem;                     // BM x HQK
  float* k_s = q_s + BM * HQK;           // BN x (HQK + 1)
  float* v_s = k_s + BN * (HQK + 1);     // BN x HV
  float* p_s = v_s + BN * HV;            // BM x BN

  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int row0 = blockIdx.y * BM;
  const int rows = G * nb;
  const int t_real = *t_real_ptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (t_real + BN - 1) / BN;

  TileRegs<HQK, HV> regs;
  if (n_tiles > 0) regs.fetch(k, v, b, kvh, KV, T_cap, 0);

  for (int idx = tid; idx < BM * HQK; idx += NT) {
    const int r = idx / HQK, d = idx % HQK, row = row0 + r;
    float x = 0.f;
    if (row < rows) {
      const int g = row / nb, i = row % nb;
      x = q[(((size_t)b * nb + i) * H + kvh * G + g) * HQK + d] * scale;
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
  const float* q_w = q_s + warp * RPW * HQK;
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
    const float* k0 = k_s + lane * (HQK + 1);
    const float* k1 = k_s + (lane + 32) * (HQK + 1);
#pragma unroll 4
    for (int d = 0; d < HQK; ++d) {
      const float ka = k0[d], kb = k1[d];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float qv = q_w[rr * HQK + d];
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
        vv[j] = d < HV ? v_s[c * HV + d] : 0.f;
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
    float* o = out + (((size_t)b * nb + i) * H + kvh * G + g) * HV;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < HV) o[d] = acc[rr][j] / denom;
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

// the staged q.k width: HQK rounded up to the mma's k-step of 16
template <int HQK>
__host__ __device__ constexpr int mma_qk_width() { return (HQK + 15) / 16 * 16; }
// row stride of a staged bf16 tile: its width plus one 16-byte chunk
__host__ __device__ constexpr int mma_row_stride(int width) { return width + 8; }

// the block's q rows (KD + 8 wide), then each group's ring of [K, V] tiles
// (K rows KD + 8 wide, V rows HV + 8); the groups' merge records alias the
// rings
template <int HQK, int HV>
constexpr size_t mma_smem_bytes() {
  constexpr int RSK = mma_row_stride(mma_qk_width<HQK>()), RSV = mma_row_stride(HV);
  return sizeof(__nv_bfloat16) * (size_t)(BM * RSK + 2 * STAGES * BN * (RSK + RSV));
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
// units (S * HQK^-0.5 * log2 e, exp2).
template <int HQK, int HV>
__global__ void __launch_bounds__(MNT, 1)
extend_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out,
                  const int* __restrict__ t_real_ptr,
                  int nb, int H, int KV, int T_cap, float scale) {
  constexpr int KD = mma_qk_width<HQK>();       // staged q.k width
  constexpr int RSK = mma_row_stride(KD);       // q and K row stride
  constexpr int RSV = mma_row_stride(HV);       // V row stride
  constexpr int CPK = HQK / 8;                  // 16-byte chunks per q/K row
  constexpr int CPV = HV / 8;                   // 16-byte chunks per V row
  constexpr int KTILE = BN * RSK;               // elements of one K tile
  constexpr int SLOT = BN * (RSK + RSV);        // one ring slot: [K, V]
  constexpr int NO = HV / 8;                    // output N tiles
  constexpr bool HOLD_Q = KD <= 128;            // q's A fragments in registers
  static_assert(HQK % 8 == 0 && HV % 16 == 0, "16-byte rows, whole P.V k-steps");
  static_assert(sizeof(float) * (4 + NO * 4) * GNT <=
                    sizeof(__nv_bfloat16) * 2 * STAGES * SLOT,
                "the merge record fits in the rings");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // BM x RSK

  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int row0 = blockIdx.y * BM, rows = G * nb;
  const int t_real = min(*t_real_ptr, T_cap);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kg = warp / GW, gw = warp % GW, gtid = tid % GNT;
  __nv_bfloat16* ring = q_s + BM * RSK + kg * STAGES * SLOT;        // [slot][K, V]
  // element (b, t, kvh, d) of k sits at (kv_base + t*KV)*HQK + d, of v at
  // (kv_base + t*KV)*HV + d
  const size_t kv_base = (size_t)b * T_cap * KV + kvh;
  // the walk ends with the tile that holds the block's last visible position
  const int last = min(row0 + BM, rows) - 1;
  const int max_i = last / nb != row0 / nb ? nb - 1 : last % nb;
  const int n_tiles = (t_real - nb + max_i + BN) / BN;

  for (int idx = tid; idx < BM * CPK; idx += MNT) {
    const int r = idx / CPK, c = idx % CPK, row = row0 + r;
    const bool ok = row < rows;
    const int g = ok ? row / nb : 0, i = ok ? row % nb : 0;
    cp_async16(q_s + r * RSK + c * 8,
               q + (((size_t)b * nb + i) * H + kvh * G + g) * HQK + c * 8, ok ? 16 : 0);
  }
  cp_async_commit();
  if constexpr (KD > HQK) {
    // the staged columns past HQK of q and of every K slot, zeroed once (the
    // copies never write them); the barrier after the q wait publishes them
    constexpr int PC = (KD - HQK) / 8;          // pad chunks per row
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int idx = tid; idx < (BM + 2 * STAGES * BN) * PC; idx += MNT) {
      const int r = idx / PC, c = CPK + idx % PC;
      __nv_bfloat16* row = r < BM ? q_s + r * RSK
          : q_s + BM * RSK + ((r - BM) / BN) * SLOT + ((r - BM) % BN) * RSK;
      *reinterpret_cast<uint4*>(row + c * 8) = zero;
    }
  }
  // the group's j-th tile (kg + 2j) into slot j % STAGES, one commit group
  // (empty past the walk)
  auto issue = [&](int j) {
    const int tile = kg + 2 * j;
    if (tile < n_tiles) {
      __nv_bfloat16* kt = ring + (j % STAGES) * SLOT;
      const int t0 = tile * BN;
      // whole copies per thread where the chunk count divides (the test
      // folds away), a bound check where it does not (q.k 24: 192 chunks)
#pragma unroll
      for (int jj = 0; jj < (BN * CPK + GNT - 1) / GNT; ++jj) {
        const int idx = gtid + jj * GNT;
        if ((BN * CPK) % GNT == 0 || idx < BN * CPK) {
          const int r = idx / CPK, c = idx % CPK;
          const bool ok = t0 + r < t_real;
          const size_t row = kv_base + (size_t)(ok ? t0 + r : 0) * KV;
          cp_async16(kt + r * RSK + c * 8, k + row * HQK + c * 8, ok ? 16 : 0);
        }
      }
#pragma unroll
      for (int jj = 0; jj < (BN * CPV + GNT - 1) / GNT; ++jj) {
        const int idx = gtid + jj * GNT;
        if ((BN * CPV) % GNT == 0 || idx < BN * CPV) {
          const int r = idx / CPV, c = idx % CPV;
          const bool ok = t0 + r < t_real;
          const size_t row = kv_base + (size_t)(ok ? t0 + r : 0) * KV;
          cp_async16(kt + KTILE + r * RSV + c * 8, v + row * HV + c * 8, ok ? 16 : 0);
        }
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
  // this warp's q rows as A fragments: held for the whole walk, or (past
  // 128 columns) read from q_s at each k-step
  const __nv_bfloat16* qa_row =
      q_s + (gw * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RSK + (lane >> 4) * 8;
  uint32_t qa[HOLD_Q ? KD / 16 : 1][4];
  if constexpr (HOLD_Q) {
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) ldmatrix_x4(qa[kk], qa_row + kk * 16);
  }

  const float scale2 = scale * LOG2E;
  float o[NO][4];                               // O accumulators: 16 rows x HV
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
      const __nv_bfloat16* kt = ring + (j % STAGES) * SLOT;
      const __nv_bfloat16* vt = kt + KTILE;

      // S = Q K^T: 8 N tiles of 8 positions
      float s[BN / 8][4];
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const __nv_bfloat16* b_row =
          kt + ((lane & 7) + (lane >> 4) * 8) * RSK + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < KD / 16; ++kk) {
        uint32_t a[4];
        if constexpr (HOLD_Q) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
        } else {
          ldmatrix_x4(a, qa_row + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, b_row + np * 16 * RSK + kk * 16);
          mma_bf16(s[2 * np], a, bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
        }
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
          vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * RSV + (lane >> 4) * 8;
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
        for (int dp = 0; dp < HV / 16; ++dp) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, v_row + kk * 16 * RSV + dp * 16);
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
  float* rec = reinterpret_cast<float*>(q_s + BM * RSK);  // [4 + NO*4][GNT]
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
    __nv_bfloat16* dst = out + (((size_t)b * nb + i) * H + kvh * G + g) * HV + 2 * (lane & 3);
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      const float x0 = o[dn][2 * h] * a0 + rec[(4 + dn * 4 + 2 * h) * GNT + gtid] * a1;
      const float x1 = o[dn][2 * h + 1] * a0 + rec[(4 + dn * 4 + 2 * h + 1) * GNT + gtid] * a1;
      *reinterpret_cast<uint32_t*>(dst + dn * 8) = pack_bf16(x0 / denom, x1 / denom);
    }
  }
}

// ---------------------------------------------------------------------------

template <typename T, int HQK, int HV>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* t_real, int B, int nb, int H, int KV, int T_cap,
           float scale, cudaStream_t stream) {
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;   // tensor cores
  constexpr size_t smem = MMA ? mma_smem_bytes<HQK, HV>() : smem_bytes<HQK, HV>();
  static_assert(smem <= 232448, "within the H100's 227 KB per block");
  static bool configured = false;
  if (!configured) {
    cudaError_t e;
    if constexpr (MMA)
      e = cudaFuncSetAttribute(extend_mma_kernel<HQK, HV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    else
      e = cudaFuncSetAttribute(extend_kernel<HQK, HV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int G = H / KV;
  dim3 grid(B * KV, (G * nb + BM - 1) / BM);
  if constexpr (MMA) {
    extend_mma_kernel<HQK, HV><<<grid, MNT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), t_real, nb, H, KV,
        T_cap, scale);
  } else {
    extend_kernel<HQK, HV><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), t_real, nb, H, KV,
        T_cap, scale);
  }
  return (int)cudaGetLastError();
}

// the built (q.k width, v width) pairs; kernel.py::PAIRS lists the same
template <typename T>
int dispatch_widths(int hqk, int hv, const void* q, const void* k, const void* v,
                    void* out, const int* t_real, int B, int nb, int H, int KV,
                    int T_cap, float scale, cudaStream_t s) {
#define PAIR(A, C)                                                            \
  if (hqk == A && hv == C)                                                     \
    return launch<T, A, C>(q, k, v, out, t_real, B, nb, H, KV, T_cap, scale, s);
  PAIR(16, 16) PAIR(32, 32) PAIR(64, 64) PAIR(128, 128)   // GQA: HQK = HV
  PAIR(192, 192)                                          // GQA: nemotron
  PAIR(24, 16) PAIR(192, 128)                             // MLA: reduced, full
#undef PAIR
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after launch.
extern "C" int repro_extend_attention(const void* q, const void* k,
                                      const void* v, void* out,
                                      const int* t_real, int B, int nb, int H,
                                      int KV, int T_cap, int hqk, int hv,
                                      float scale, int dtype, void* stream) {
  if (B <= 0 || nb <= 0 || KV <= 0 || H % KV != 0 || T_cap <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_widths<float>(hqk, hv, q, k, v, out, t_real, B, nb, H, KV, T_cap,
                                  scale, s);
  if (dtype == 1)
    return dispatch_widths<__nv_bfloat16>(hqk, hv, q, k, v, out, t_real, B, nb, H, KV,
                                          T_cap, scale, s);
  return (int)cudaErrorInvalidValue;
}
