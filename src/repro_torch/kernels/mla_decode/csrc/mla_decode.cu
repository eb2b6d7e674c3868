// Multi-head Latent Attention's absorbed decode for Hopper (sm_90a), CUDA C++.
//
// Replaces no TPU kernel: the JAX package's absorbed decode
// (repro/models/mla.py::mla_decode) is plain XLA.  It was added because the
// port's plain version of it copied the whole padded latent cache to fp32 in
// every layer of every decode step and scored every position of the pack's
// capacity in fp32 on the CUDA cores.
//
// Function.  One new query per (row b, head h), already absorbed into latent
// space (q_lat = q_nope . W_uk, width L = kv_lora) beside its rope part
// (width R), scored against row b's latents c_kv and rope keys k_rope at
// positions <= pos[b] of a capacity-padded cache, then taken out of latent
// space through W_uv (width V = v_head_dim), all in fp32:
//   s_t   = (q_lat . c_kv[t] + q_rope . k_rope[t]) * scale
//   o_lat = sum_t softmax(s)_t c_kv[t]
//   out   = o_lat . W_uv[:, h, :]
//
// Layout.  The kernel reads the model's own tensors, no copies:
//   q_lat (B, H, L)   q_rope (B, H, R)   c_kv (B, T, L)   k_rope (B, T, R)
//   W_uv (L, H, V)    pos int32[B] (device)    out (B, H, V) fp32
//
// Bound.  The H heads share one latent stream (MQA with G = H), so each
// position brings (L + R) * 2 bytes in bf16 and feeds 2 H (2 L + R)
// FLOPs: at DeepSeek-V2's H 128, L 512, R 64 that is 2,176 bytes for
// 278,528 FLOPs, 128 FLOPs a byte, below the card's ~295 ridge: the
// function is bound by bytes, within a factor 2.3 of being bound by
// operations; W_uv adds L H V * 2 bytes (16 MB) and 2 B H L V FLOPs a call.
// The design therefore reads each latent byte from device memory once per
// block pair and keeps both attention products on the tensor cores.
//
// Design (bf16, L 512, R 64: mla_decode_split<bf16, true>).  Grid
// (B * ceil(H / 64), ceil(T / SPLIT)): block (b, head block, split) holds
// 64 heads of row b and owns the SPLIT positions [s * SPLIT, (s+1) * SPLIT),
// and returns at once if s * SPLIT > pos[b], so no work or bytes go past a
// row's last position.  The grid is a function of the pack's shape alone,
// pos is read on the device, and the wrapper allocates the scratch, so a
// launch is capturable in a CUDA graph and replays for any pos.
//  - The block's 64 rows of [q_lat || q_rope] (576 wide) are staged once in
//    shared memory by cp.async; the split's positions stream through a
//    three-slot ring of 32-position tiles of [c_kv || k_rope], cp.async.cg at
//    16 bytes a thread straight from the cache, two tiles in flight while
//    one is computed.  Both are kept as nine column blocks of [rows x 128
//    bytes] with the 128-byte swizzle wgmma reads (16-byte chunk c of row r
//    at chunk c ^ (r % 8)), 1024-byte aligned.  Positions past pos in the
//    last tile are zero-filled by a copy that reads 0 bytes, and masked.
//  - Two warpgroups, both products on the tensor cores with wgmma (bf16 in,
//    fp32 accumulate).  Warpgroup g holds output columns 256 g .. +255 of
//    the 512 for all 64 heads (64 x 256 fp32 accumulators: 128 registers a
//    thread; 64 x 512 would not fit), so both need the whole score tile.
//  - S = Q K^T, m64n32k16 with both operands read from shared memory
//    (K-major): warpgroup g sums k-steps [18 g, 18 g + 18) of the 36, the
//    two partial tiles are exchanged through shared memory and added low
//    half first, so both hold the same S and no product is issued twice.
//    The scale, with log2 e folded in, is applied in fp32.
//  - Online softmax in fp32 per head row (quad shuffles, exp2).
//  - O += P C, m64n256k16 with P from registers and C the tile's first 512
//    columns read as an MN-major operand (the same swizzled bytes): the
//    accumulators of two adjacent 8-position S tiles have the layout of a
//    16-position A fragment, so P needs no shuffle.  P enters as three bf16
//    terms, P_0 = bf16(P), P_1 = bf16(P - P_0), P_2 = bf16(P - P_0 - P_1),
//    three wgmma against the same C: C is exact in bf16 and P is carried to
//    2^-27 relative, so the product is fp32 P . C to within fp32 summation
//    order, as the plain version computes it.
//  - Each warpgroup writes its heads' fp32 partial of the split: (m, l) and
//    the unnormalised accumulator, into scratch (B, H, ceil(T / SPLIT), ...).
// Against the bound: the three-term P makes the issued tensor-core work
// 2 x (2 x 576 + 3 x 512) = 4,224 FLOPs a head and position where the
// function needs 2,176, so at the bound's bytes the tensor cores, not the
// memory, set the pace; a version on mma.sync (ldmatrix operands, 8 warps)
// took 1.25 times as long at the serving shape.
//
// Other widths and fp32 (the reduced test models) take
// mla_decode_split<T, false>: one block of 128 threads per (row, head,
// split) scores the split's positions one per thread, then sums p . c_kv
// per column, all in fp32 on the CUDA cores.
//
// Combine (mla_decode_combine, one block per head and group of up to 4
// rows): for each row M = max_s m_s, L = sum_s l_s 2^(m_s - M) and acc =
// sum_s acc_s 2^(m_s - M) over s = 0 .. pos // SPLIT in ascending order;
// o_lat = acc / max(L, 1e-30), kept in shared memory; then the epilogue
// out = o_lat . W_uv[:, h, :] in fp32 on the exact W_uv (bf16 widens
// exactly), for the group's rows at once: 16-byte loads of W_uv rows, each
// thread summing a fixed subset of the latent rows for 16 bytes of
// columns, and the subsets summed in ascending order.  The head's 128 KB
// slice of W_uv is read once a group (twice at B 8, from L2 the second
// time); no fp32 copy of W_uv and no o_lat leave the kernel.
//
// Bit-invariance.  Split boundaries are a fixed function of the position
// (SPLIT is a compile-time constant), a split's partial reads that split's
// positions <= pos in an order fixed by the tile and lane indices, and the
// combine walks the splits in ascending order: T enters only as an address
// stride and the number of (dead) blocks, B only as the grid.  A row's
// output is bitwise the same at any padded capacity and in any batch.
//
// Numerics: fp32 softmax and accumulation, fp32 output.  The kernels
// allocate nothing; every operand must be 16-byte aligned (the wrapper
// checks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
// positions per split: fixed, never a function of T, B or the grid; the
// wrapper passes its own value and the entry point refuses another
constexpr int SPLIT = 256;
constexpr int CT = 128;               // threads of a CUDA-core split block, of a combine row
constexpr int RB = 4;                 // rows of one head a combine block takes
constexpr int CC = RB * CT;           // threads of a combine block: CT a row
constexpr int MAX_SMEM = 232448;      // shared memory a block may have

// the tensor-core path's widths (DeepSeek-V2), tile and block
constexpr int ML = 512;               // kv_lora
constexpr int MR = 64;                // rope
constexpr int MD = ML + MR;           // q.k width
constexpr int HB = 64;                // heads per block
constexpr int BN = 32;                // positions per tile
constexpr int STAGES = 3;             // ring slots
constexpr int NT = 256;               // 2 warpgroups: the two column halves
constexpr int OH = ML / 2;            // output columns per warpgroup
constexpr int NO = OH / 8;            // output N tiles per warpgroup
constexpr int CPR = MD / 8;           // 16-byte chunks of a staged row
constexpr int KH = MD / 32;           // k-steps of S a warpgroup sums
// 1 KB of alignment, q, the ring and each warpgroup's partial S tile
constexpr size_t MMA_SMEM = 1024 + (size_t)(HB + STAGES * BN) * MD * sizeof(__nv_bfloat16) +
                            (size_t)2 * 16 * 128 * sizeof(float);
static_assert(SPLIT % BN == 0, "a split is whole tiles");
static_assert((BN * CPR) % NT == 0 && (HB * CPR) % NT == 0, "whole copies per thread");
static_assert(MMA_SMEM <= MAX_SMEM, "within the H100's 227 KB per block");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

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

struct Args {
  const void* q_lat;
  const void* q_rope;
  const void* ckv;
  const void* krope;
  const void* w_uv;   // (L, H, V)
  const int* pos;
  float* part_ml;     // (B, H, n_split, 2): m (log2 domain), l
  float* part_o;      // (B, H, n_split, L): unnormalised accumulators
  float* out;         // (B, H, V)
  int B, H, T_cap, L, R, V, n_split;
  float scale2;       // scale * log2 e
};

// ---------------------------------------------------------------------------
// tensor cores: bf16, L 512, R 64
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a wgmma shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)1 << 62);
}
// keeps the compiler from moving reads or writes of wgmma's registers
// across the wgmma instructions and waits (their results land, and their
// register operands are read, asynchronously)
template <typename R, int N>
__device__ __forceinline__ void fence_regs(R (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<R, float>::value)
      asm volatile("" : "+f"(x[i])::"memory");
    else
      asm volatile("" : "+r"(x[i])::"memory");
  }
}
// d += A . B, m64n32k16, A and B from shared memory (K-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
// d += A . B, m64n256k16, A from registers, B from shared memory (MN-major,
// 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Offset in bytes of element (row r, column c) of a [rows x 576] tile kept
// as 9 column blocks of [rows x 128 bytes], 16-byte chunks swizzled by the
// row (the 128-byte swizzle wgmma reads)
__device__ __forceinline__ uint32_t sw_off(int rows, int r, int c) {
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
                    (c & 7) * 2);
}

__device__ __forceinline__ void wgmma_split(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1024-byte aligned base: the swizzle repeats every 8 rows of 128 bytes
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;                                   // 9 x [64 x 128 B]
  unsigned char* ring = q_s + HB * MD * 2;                     // [slot] 9 x [BN x 128 B]
  float* xs = reinterpret_cast<float*>(ring + STAGES * BN * MD * 2);   // [wg][16][128]
  const int n_hb = (a.H + HB - 1) / HB;
  const int b = blockIdx.x / n_hb, h0 = (blockIdx.x % n_hb) * HB;
  const int split = blockIdx.y;
  const int pos = min(a.pos[b], a.T_cap - 1);
  const int t0 = split * SPLIT;
  if (t0 > pos) return;
  const int n_valid = min(SPLIT, pos - t0 + 1);
  const int n_tiles = (n_valid + BN - 1) / BN;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, lane = tid & 31;
  const auto* q_lat = static_cast<const __nv_bfloat16*>(a.q_lat);
  const auto* q_rope = static_cast<const __nv_bfloat16*>(a.q_rope);
  const auto* ckv = static_cast<const __nv_bfloat16*>(a.ckv);
  const auto* krope = static_cast<const __nv_bfloat16*>(a.krope);

  // q: row r is head h0 + r, [q_lat || q_rope]; heads past H are zeros
#pragma unroll
  for (int i = 0; i < HB * CPR / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / CPR, c = idx % CPR, h = h0 + r;
    const bool ok = h < a.H;
    const size_t row = (size_t)b * a.H + (ok ? h : 0);
    const __nv_bfloat16* src = c < ML / 8 ? q_lat + row * ML + c * 8
                                          : q_rope + row * MR + (c - ML / 8) * 8;
    cp_async16(q_s + sw_off(HB, r, c * 8), src, ok ? 16 : 0);
  }
  cp_async_commit();
  const size_t rbase = (size_t)b * a.T_cap + t0;
  auto issue = [&](int j) {
    if (j < n_tiles) {
      unsigned char* kt = ring + (j % STAGES) * BN * MD * 2;
#pragma unroll
      for (int i = 0; i < BN * CPR / NT; ++i) {
        const int idx = tid + i * NT;
        const int r = idx / CPR, c = idx % CPR, t = j * BN + r;
        const bool ok = t < n_valid;
        const size_t row = rbase + (ok ? t : 0);
        const __nv_bfloat16* src = c < ML / 8 ? ckv + row * ML + c * 8
                                              : krope + row * MR + (c - ML / 8) * 8;
        cp_async16(kt + sw_off(BN, r, c * 8), src, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) issue(j);

  const uint32_t q_addr = smem_addr(q_s);
  float o[NO * 4];                              // 64 heads x 256 columns over the warpgroup
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) o[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    issue(j + STAGES - 1);                      // into the slot freed last round
    cp_async_wait<STAGES - 1>();                // q and this tile have landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t k_addr = smem_addr(ring + (j % STAGES) * BN * MD * 2);

    // S = Q K^T (64 heads x 32 positions): warpgroup wg sums k-steps
    // [18 wg, 18 wg + 18) of the 36; the partial tiles are exchanged and
    // added low half first, so both warpgroups hold the same S
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KH; ++k) {
      const int kk = wg * KH + k;
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss_n32(s, sw128_desc(q_addr + (kk >> 2) * HB * 128 + off, 16, 1024),
                   sw128_desc(k_addr + (kk >> 2) * BN * 128 + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
#pragma unroll
    for (int i = 0; i < 16; ++i) xs[(wg * 16 + i) * 128 + wt] = s[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float other = xs[((wg ^ 1) * 16 + i) * 128 + wt];
      s[i] = wg == 0 ? s[i] + other : other + s[i];
    }

    // scale in fp32; mask the positions past pos in the last tile
    const int tp0 = j * BN + 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt * 4 + e] = tp0 + nt * 8 + (e & 1) < n_valid ? s[nt * 4 + e] * a.scale2 : NEG_INF;

    // online softmax per head row; the quad (lanes 4i .. 4i+3) shares a row
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt * 4 + 2 * h], s[nt * 4 + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        s[nt * 4 + 2 * h] = exp2f(s[nt * 4 + 2 * h] - m_new);
        s[nt * 4 + 2 * h + 1] = exp2f(s[nt * 4 + 2 * h + 1] - m_new);
        sum += s[nt * 4 + 2 * h] + s[nt * 4 + 2 * h + 1];
      }
      l[h] = l[h] * corr[h] + sum;
    }
#pragma unroll
    for (int i = 0; i < NO * 4; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P C with P as three bf16 terms, C from the tile's first 512
    // columns read as an MN-major operand: this warpgroup's 256 columns
    uint32_t pa[BN / 16][3][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {             // A registers: (row half, k half)
        const float* sv = s + (2 * kk + (f >> 1)) * 4 + 2 * (f & 1);
        uint32_t t[3];
        split3_bf16(sv[0], sv[1], t);
#pragma unroll
        for (int i = 0; i < 3; ++i) pa[kk][i][f] = t[i];
      }
    auto& pa_regs = reinterpret_cast<uint32_t(&)[BN / 16 * 12]>(pa);
    fence_regs(o);
    fence_regs(pa_regs);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dv = sw128_desc(k_addr + wg * (OH / 64) * BN * 128 + kk * 16 * 128,
                                     BN * 128, 1024);
#pragma unroll
      for (int i = 0; i < 3; ++i) wgmma_rs_n256(o, pa[kk][i], dv);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    fence_regs(pa_regs);                        // read until here
    __syncthreads();                            // slot free for the next issue
  }
  cp_async_wait<0>();

  // the split's partial: (m, l) once per head, the accumulators by column
  const int w4 = (tid >> 5) & 3;                // warp within the warpgroup: rows 16 w4 ..
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int head = h0 + w4 * 16 + (lane >> 2) + 8 * h;
    if (head >= a.H) continue;
    const size_t rec = ((size_t)b * a.H + head) * a.n_split + split;
    if (wg == 0 && (lane & 3) == 0)
      *reinterpret_cast<float2*>(a.part_ml + rec * 2) = make_float2(m[h], l[h]);
    float* dst = a.part_o + rec * ML + wg * OH + 2 * (lane & 3);
#pragma unroll
    for (int dn = 0; dn < NO; ++dn)
      *reinterpret_cast<float2*>(dst + dn * 8) =
          make_float2(o[dn * 4 + 2 * h], o[dn * 4 + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// CUDA cores: any widths, fp32 or bf16 (the reduced models)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float block_reduce(float x, float* red, bool is_max) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();                              // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < CT / 32; ++w) x = is_max ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

template <typename T>
__device__ __forceinline__ void scalar_split(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);   // CT / 32
  float* q_s = red + CT / 32;                         // L + R
  float* p_s = q_s + a.L + a.R;                       // SPLIT
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int split = blockIdx.y;
  const int pos = min(a.pos[b], a.T_cap - 1);
  const int t0 = split * SPLIT;
  if (t0 > pos) return;
  const int n_valid = min(SPLIT, pos - t0 + 1);
  const int L = a.L, R = a.R;
  const T* q_lat = static_cast<const T*>(a.q_lat) + ((size_t)b * a.H + h) * L;
  const T* q_rope = static_cast<const T*>(a.q_rope) + ((size_t)b * a.H + h) * R;
  const T* ckv = static_cast<const T*>(a.ckv) + ((size_t)b * a.T_cap + t0) * L;
  const T* krope = static_cast<const T*>(a.krope) + ((size_t)b * a.T_cap + t0) * R;
  for (int d = threadIdx.x; d < L + R; d += CT)
    q_s[d] = d < L ? to_float(q_lat[d]) : to_float(q_rope[d - L]);
  __syncthreads();
  float mx = NEG_INF;
  for (int j = threadIdx.x; j < n_valid; j += CT) {
    float dot = 0.f;
    for (int d = 0; d < L; ++d) dot = fmaf(q_s[d], to_float(ckv[(size_t)j * L + d]), dot);
    for (int d = 0; d < R; ++d) dot = fmaf(q_s[L + d], to_float(krope[(size_t)j * R + d]), dot);
    p_s[j] = dot * a.scale2;
    mx = fmaxf(mx, p_s[j]);
  }
  const float M = block_reduce(mx, red, true);
  float sum = 0.f;
  for (int j = threadIdx.x; j < n_valid; j += CT) {
    p_s[j] = exp2f(p_s[j] - M);
    sum += p_s[j];
  }
  const float l = block_reduce(sum, red, false);  // its barriers publish p_s
  const size_t rec = ((size_t)b * a.H + h) * a.n_split + split;
  for (int c = threadIdx.x; c < L; c += CT) {
    float acc = 0.f;
    for (int j = 0; j < n_valid; ++j) acc = fmaf(p_s[j], to_float(ckv[(size_t)j * L + c]), acc);
    a.part_o[rec * L + c] = acc;
  }
  if (threadIdx.x == 0) {
    a.part_ml[rec * 2] = M;
    a.part_ml[rec * 2 + 1] = l;
  }
}

template <typename T, bool MMA>
__global__ void __launch_bounds__(MMA ? NT : CT)
mla_decode_split(Args a) {
  if constexpr (MMA)
    wgmma_split(a);
  else
    scalar_split<T>(a);
}

// floats of the combine's staged m and l, rounded up to 16 bytes
__host__ __device__ constexpr int ml_floats(int n_split) { return (2 * n_split + 3) / 4 * 4; }
// whether the combine stages a head's W_uv slice in shared memory
__host__ __device__ constexpr bool stage_w(int L, int V, int elt) {
  return (size_t)L * V * elt <= 128 * 1024;
}
// shared memory of a combine block
__host__ __device__ constexpr size_t combine_smem(int L, int V, int elt, int n_split) {
  return (stage_w(L, V, elt) ? (size_t)L * V * elt : 0) +
         sizeof(float) * ((size_t)RB * L + (size_t)RB * CC * (16 / elt) +
                          (size_t)RB * (ml_floats(n_split) + 4));
}

// One block of 512 threads per (head h, group of up to RB = 4 rows),
// blockIdx.x = h * ceil(B / RB) + group.  The head's slice of W_uv is
// copied into shared memory by cp.async (where it fits) while thread group
// i (128 threads) merges row i: its live splits' m and l are staged, M =
// max_s m_s, each weight w_s = 2^(m_s - M) is computed once, and every
// thread sums in ascending s: L = sum_s l_s w_s, and acc_s[c] w_s for its
// four columns c, into the row's o_lat in shared memory.  Then out =
// o_lat . W_uv[:, h, :] for the group's rows at once: thread (r, g) sums
// the latent rows l = r, r + RW, ... for columns [g VEC, (g+1) VEC), and
// the RW partial sums of a column are added in ascending r.  A row's
// arithmetic depends neither on its group nor on B.
template <typename T>
__global__ void __launch_bounds__(CC)
mla_decode_combine(Args a) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char craw[];
  const bool stage = stage_w(a.L, a.V, sizeof(T));
  // [W_uv slice (L, V) if staged] o_lat[RB][L], part[RB][CC * VEC],
  // per group: w[n_split], l[n_split] (padded to 16 bytes), red[4]
  T* w_s = reinterpret_cast<T*>(craw);
  float* olat = reinterpret_cast<float*>(craw + (stage ? (size_t)a.L * a.V * sizeof(T) : 0));
  float* part = olat + RB * a.L;
  const int tid = threadIdx.x, grp = tid / CT, gt = tid % CT;
  float* w = part + RB * CC * VEC + grp * (ml_floats(a.n_split) + 4);
  float* ls = w + a.n_split;
  float* red = w + ml_floats(a.n_split);
  const int groups = (a.B + RB - 1) / RB;
  const int h = blockIdx.x / groups, b0 = (blockIdx.x % groups) * RB;
  const int nb = min(RB, a.B - b0);

  const T* w_g = static_cast<const T*>(a.w_uv) + (size_t)h * a.V;
  if (stage) {
    const int cpr = a.V / VEC;                  // 16-byte chunks of a W_uv row
    for (int idx = tid; idx < a.L * cpr; idx += CC)
      cp_async16(w_s + (idx / cpr) * a.V + (idx % cpr) * VEC,
                 w_g + (size_t)(idx / cpr) * a.H * a.V + (idx % cpr) * VEC, 16);
  }
  cp_async_commit();

  const bool live = grp < nb;
  const int b = b0 + grp;
  const int n_live = live ? min(a.pos[b], a.T_cap - 1) / SPLIT + 1 : 0;
  const size_t rec = live ? ((size_t)b * a.H + h) * a.n_split : 0;
  float mx = NEG_INF;
  for (int s = gt; s < n_live; s += CT) {
    w[s] = a.part_ml[(rec + s) * 2];
    ls[s] = a.part_ml[(rec + s) * 2 + 1];
    mx = fmaxf(mx, w[s]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((gt & 31) == 0) red[gt >> 5] = mx;
  __syncthreads();
  const float M = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  for (int s = gt; s < n_live; s += CT) w[s] = exp2f(w[s] - M);
  __syncthreads();
  if (live) {
    float L = 0.f;
    for (int s = 0; s < n_live; ++s) L += ls[s] * w[s];
    L = fmaxf(L, 1e-30f);
    const float* o = a.part_o + rec * a.L;
    for (int c = gt * 4; c < a.L; c += CT * 4) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int s = 0; s < n_live; ++s) {
        const float4 x = *reinterpret_cast<const float4*>(o + (size_t)s * a.L + c);
        acc.x += x.x * w[s];
        acc.y += x.y * w[s];
        acc.z += x.z * w[s];
        acc.w += x.w * w[s];
      }
      *reinterpret_cast<float4*>(olat + grp * a.L + c) =
          make_float4(acc.x / L, acc.y / L, acc.z / L, acc.w / L);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int G = a.V / VEC, RW = CC / G;         // threads per W_uv row, rows per pass
  const int g = tid % G, r = tid / G;
  const T* wrow = (stage ? w_s : w_g) + g * VEC;
  const size_t wstride = stage ? a.V : (size_t)a.H * a.V;
  float acc[RB][VEC];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
#pragma unroll 2
  for (int l = r; l < a.L; l += RW) {
    const uint4 raw = *reinterpret_cast<const uint4*>(wrow + l * wstride);
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      if (i < nb) {
        const float ol = olat[i * a.L + l];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(ol, to_float(x[e]), acc[i][e]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) part[(i * RW + r) * a.V + g * VEC + e] = acc[i][e];
  __syncthreads();
  for (int idx = tid; idx < nb * a.V; idx += CC) {
    const int i = idx / a.V, v = idx % a.V;
    float x = 0.f;
    for (int rr = 0; rr < RW; ++rr) x += part[(i * RW + rr) * a.V + v];
    a.out[((size_t)(b0 + i) * a.H + h) * a.V + v] = x;
  }
}

template <typename T, bool MMA>
int launch(const Args& a, cudaStream_t stream) {
  size_t smem;
  dim3 grid;
  if constexpr (MMA) {
    smem = MMA_SMEM;
    static bool configured = false;
    if (!configured) {
      const cudaError_t e = cudaFuncSetAttribute(
          mla_decode_split<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    grid = dim3(a.B * ((a.H + HB - 1) / HB), a.n_split);
  } else {
    smem = (CT / 32 + a.L + a.R + SPLIT) * sizeof(float);
    grid = dim3(a.B * a.H, a.n_split);
  }
  mla_decode_split<T, MMA><<<grid, MMA ? NT : CT, smem, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  static bool combine_configured = false;
  if (!combine_configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_decode_combine<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    combine_configured = true;
  }
  mla_decode_combine<T><<<a.H * ((a.B + RB - 1) / RB), CC,
                          combine_smem(a.L, a.V, sizeof(T), a.n_split), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part_ml, part_o: fp32 scratch of
// B*H*ceil(T_cap/split)*2 and *L floats, where split must be SPLIT; out
// (B, H, V) fp32.  V / (16 / element size) must divide the combine's 128
// threads.  Launches the split and combine kernels on `stream`; returns
// cudaGetLastError() after them.
extern "C" int repro_mla_decode(const void* q_lat, const void* q_rope, const void* ckv,
                                const void* krope, const void* w_uv, const int* pos,
                                void* part_ml, void* part_o, void* out, int split, int B,
                                int H, int T_cap, int L, int R, int V, float scale,
                                int dtype, void* stream) {
  const int elt = dtype == 1 ? 2 : 4, vec = 16 / elt;
  if (split != SPLIT || B <= 0 || H <= 0 || T_cap <= 0 || L <= 0 || R <= 0 || V <= 0 ||
      L % 8 != 0 || R % 8 != 0 || V % vec != 0 || CT % (V / vec) != 0 ||
      combine_smem(L, V, elt, (T_cap + SPLIT - 1) / SPLIT) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  Args a{q_lat, q_rope, ckv, krope, w_uv, pos, static_cast<float*>(part_ml),
         static_cast<float*>(part_o), static_cast<float*>(out), B, H, T_cap, L, R, V,
         (T_cap + SPLIT - 1) / SPLIT, scale * LOG2E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && L == ML && R == MR) return launch<__nv_bfloat16, true>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16, false>(a, s);
  if (dtype == 0) return launch<float, false>(a, s);
  return (int)cudaErrorInvalidValue;
}
