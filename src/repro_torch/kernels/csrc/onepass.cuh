// Device helpers shared by the one-pass kernels (linreg_stats.cu,
// nb_stats.cu, logreg_sgd.cu), sm_90a.
//
//   cp.async      16- and 4-byte copies from global to shared memory, their
//                 commit groups and waits;
//   stage_span    a span of rows at any element-aligned address into shared
//                 memory: 16-byte copies for the aligned middle, element
//                 copies for the unaligned head and tail;
//   halve         a warp's sum of many values by recursive halving;
//   ticket_add,   the cross-block sum's ticket (atom.acq_rel.gpu) and the
//   last_block    test for the block that drew the last one;
//   split_sum     that block's sum of the splits' partials in split order.
//
// Every sum here has a fixed order, so the kernels that use these helpers
// give bitwise the same results on every run.  kernels/build.py passes this
// directory to nvcc with -I and hashes the header into every library's
// name, so an edit here rebuilds every kernel that includes it.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace onepass {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// one element of an unaligned head or tail
__device__ __forceinline__ void copy_elem(void* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void copy_elem(void* dst, const int* src) { cp_async4(dst, src); }
__device__ __forceinline__ void copy_elem(void* dst, const __nv_bfloat16* src) {
  *static_cast<__nv_bfloat16*>(dst) = *src;
}

// Stage the span g[0, count) into shared memory at s + (g mod 16), where s
// is 16-byte aligned: 16-byte cp.async for the aligned units, element copies
// for the head before the first and the tail after the last (at most 15
// bytes each).  Every thread of the NT-thread block calls it; the caller
// commits and waits.
template <int NT, typename T>
__device__ __forceinline__ void stage_span(char* s, const T* g, int count) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  const uintptr_t e = a + (uintptr_t)count * sizeof(T);
  const uintptr_t base = a & ~uintptr_t(15);
  const uintptr_t up = (a + 15) & ~uintptr_t(15), down = e & ~uintptr_t(15);
  const uintptr_t b0 = up < e ? up : e;          // end of the head
  const uintptr_t b1 = down > b0 ? down : b0;    // start of the tail
  const int units = (int)((b1 - b0) >> 4);
  for (int u = threadIdx.x; u < units; u += NT)
    cp_async16(s + (b0 - base) + 16 * u, reinterpret_cast<const void*>(b0 + 16 * u));
  const int head = (int)((b0 - a) / sizeof(T));
  const int tail = (int)((e - b1) / sizeof(T));
  const int t = threadIdx.x;
  char* s0 = s + (a - base);
  if (t < head) {
    copy_elem(s0 + t * sizeof(T), g + t);
  } else if (NT - 1 - t < tail) {
    const int k = count - tail + (NT - 1 - t);
    copy_elem(s0 + k * sizeof(T), g + k);
  }
}

// Sum C values (of an array of V >= C + 1) over the 32 lanes of a warp by
// recursive halving, from lane offset O down to 1: at each level a lane
// keeps one half of its slots (the upper one if its bit O is set), adds the
// partner's matching half and sends the other, so a level costs ceil(C/2)
// shuffles where a butterfly per value costs C (67 shuffles against 330 for
// the 66 sums of linreg's d 10).  Slot i then holds global entry base + i,
// valid while base + i < end (an odd count leaves one empty slot per
// level).  A fixed tree: the same values give the same bits on every run.
template <int V, int C, int O>
__device__ __forceinline__ void halve(float (&v)[V], int lane, int& base, int& end) {
  constexpr int LO = (C + 1) / 2;
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < LO; ++i) {
    const float a = v[i];
    const float b = LO + i < C ? v[LO + i] : 0.f;  // slots >= C hold stale values
    v[i] = (up ? b : a) + __shfl_xor_sync(0xffffffffu, up ? a : b, O);
  }
  if (up) {
    base += LO;
  } else {
    end = min(end, base + LO);
  }
  if constexpr (O > 1) halve<V, LO, O / 2>(v, lane, base, end);
}

// the slots a lane holds after `levels` levels of halve over c values
constexpr int halved(int c, int levels) {
  return levels == 0 ? c : halved((c + 1) / 2, levels - 1);
}

__device__ __forceinline__ unsigned ticket_add(unsigned* p) {
  unsigned old;
  // release: the block's partial, ordered before this by the barrier, is
  // visible device-wide before the ticket moves; acquire: the block that
  // draws the last ticket sees every partial after its own barrier
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(p) : "memory");
  return old;
}

// Every block: the partial is written; draw a ticket.  True in the block
// that drew the last one (after which every partial is in view).
__device__ __forceinline__ bool last_block(unsigned* ticket, unsigned blocks) {
  __shared__ bool last;
  __syncthreads();               // the block's partial is written
  if (threadIdx.x == 0) last = ticket_add(ticket) == blocks - 1;
  __syncthreads();
  return last;
}

// The last block of an NT-thread launch: out[k] = sum over splits of
// partial[k * splits + s], in split order by a fixed tree (warp w takes
// entries w, w + NT/32, ...; lane l the splits l, l + 32, ... in order,
// then a butterfly over the 32 lanes), for k < K.  Reads through L2
// (__ldcg: never a stale line of the non-coherent L1 path).  KW entries a
// warp and SPL split loads a lane, all issued at once, when both bounds are
// compile-time; a loop otherwise (KW = SPL = 0).
template <int NT, int KW, int SPL>
__device__ __forceinline__ void split_sum(const float* __restrict__ partial,
                                          float* __restrict__ out, int K,
                                          int splits) {
  constexpr int NWARP = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (KW > 0) {
    float s[KW];
#pragma unroll
    for (int q = 0; q < KW; ++q) s[q] = 0.f;
#pragma unroll
    for (int it = 0; it < SPL; ++it) {
      const int c = lane + 32 * it;
#pragma unroll
      for (int q = 0; q < KW; ++q) {
        const int k = warp + q * NWARP;
        if (c < splits && k < K) s[q] += __ldcg(partial + (size_t)k * splits + c);
      }
    }
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      float v = s[q];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const int k = warp + q * NWARP;
      if (lane == 0 && k < K) out[k] = v;
    }
  } else {
    for (int k = warp; k < K; k += NWARP) {
      float v = 0.f;
      for (int c = lane; c < splits; c += 32) v += __ldcg(partial + (size_t)k * splits + c);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) out[k] = v;
    }
  }
}

}  // namespace onepass
