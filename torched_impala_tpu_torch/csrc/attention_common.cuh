// Shared pieces of the windowed-attention kernels (attention_fwd.cu,
// attention_bwd.cu): bf16 rounding, the visibility rule of
// torched_impala_tpu/ops/attention_pallas.py (`_visible_tile`), the
// 16-byte `cp.async` row copies and the TF32 tensor-core products
// (`mma.sync.m16n8k8`, 3xTF32 for float32).
//
// Layouts (the JAX package's): q, dO `[B, T, H, dh]`; k, v `[B, S, H, dh]`
// in float32 or bfloat16; seg_q `[B, T]`, seg_ctx `[B, S]` int32; the row
// logsumexp `[B, H, T]` and the forward output O `[B, T, H, dh]` in
// float32. Every sum runs in float32; both kernels' products run on the
// tensor cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "smem_ceiling.cuh"

namespace attn {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // the card's most a block (227 KB)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to the input type and back (the TPU kernels cast p and dS to
// the operands' dtype before their products); the identity for float.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Query t may see context slot s: same episode, and s is a cache slot
// (s < W) or an unroll step no later than t (causal).
__device__ __forceinline__ bool visible(int seg_t, int seg_s, int t, int s, int W) {
  return seg_t == seg_s && (s < W || s - W <= t);
}

// Head widths: each kernel is instantiated at a padded width DP in
// {16, 32, 64, 128, 256} and takes the true dh (1 <= dh <= DP) at run time.
// Shared memory holds DP columns; the columns dh <= d < DP are loaded as
// 0, so every dot product over DP adds only 0 x 0 terms to the dh true
// ones and the sums are exact; outputs are written for d < dh only. The
// scale is the caller's 1/sqrt(dh) of the true dh. Each instantiation
// takes its arrays from dynamic shared memory and its launcher sets the
// kernel's ceiling once (smem_ceiling.cuh) to the card's 227 KB, since
// the tiles, and so the size a launch asks for, are chosen per call.

// The padded width a head width runs at; 0 outside 1 to 256.
inline int padded_width(int dh) {
  if (dh < 1) return 0;
  for (int dp : {16, 32, 64, 128, 256}) {
    if (dh <= dp) return dp;
  }
  return 0;
}

inline bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename E>
__device__ __forceinline__ E zero() {
  if constexpr (std::is_same<E, float>::value) {
    return 0.0f;
  } else {
    return __float2bfloat16(0.0f);
  }
}

// `rows` x DP elements of head h from a [B, L, H, dh] tensor into shared
// memory (row stride LD elements): zeros past row L and in the padded
// columns dh <= d < DP. With `vec` (dh a whole number of 16-byte chunks,
// the tensor 16-byte aligned) as asynchronous 16-byte copies, else as
// plain loads.
template <typename E, int DP, int LD>
__device__ __forceinline__ void copy_rows(E* dst, const E* __restrict__ src, int rows, int b,
                                          int h, int row0, int L, int H, int dh, bool vec) {
  if (vec) {
    constexpr int kChunk = 16 / static_cast<int>(sizeof(E));
    constexpr int kChunks = DP / kChunk;  // chunks a row
    for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
      const int r = c / kChunks, d = (c % kChunks) * kChunk, row = row0 + r;
      const bool valid = row < L && d < dh;
      const E* s = valid ? src + ((static_cast<long>(b) * L + row) * H + h) * dh + d : src;
      cp_async16(dst + r * LD + d, s, valid);
    }
  } else {
    for (int c = threadIdx.x; c < rows * DP; c += blockDim.x) {
      const int r = c / DP, d = c % DP, row = row0 + r;
      dst[r * LD + d] =
          row < L && d < dh ? src[((static_cast<long>(b) * L + row) * H + h) * dh + d] : zero<E>();
    }
  }
}

// An mma operand fragment of N values as TF32. For float32 inputs
// (kSplit) hi is x with its low 13 bits cleared and lo = x - hi, exact in
// f32; the tensor cores read the top 19 bits of each, so lo keeps x to
// about 2^-21. bfloat16 values are exact in TF32 and pass as they are.
template <bool kSplit, int N>
struct Frag {
  unsigned hi[N];
  unsigned lo[kSplit ? N : 1];
  __device__ __forceinline__ void set(int i, float x) {
    if constexpr (kSplit) {
      hi[i] = __float_as_uint(x) & 0xffffe000u;
      lo[i] = __float_as_uint(x - __uint_as_float(hi[i]));
    } else {
      hi[i] = __float_as_uint(x);
    }
  }
};

// Fragment coordinates (PTX m16n8k8): lane = 4 gr + tc. A (16 x 8): a0 (gr,
// tc), a1 (gr + 8, tc), a2 (gr, tc + 4), a3 (gr + 8, tc + 4). B (8 x 8): b0
// (tc, gr), b1 (tc + 4, gr). C (16 x 8): c0 (gr, 2 tc), c1 (gr, 2 tc + 1),
// c2 (gr + 8, 2 tc), c3 (gr + 8, 2 tc + 1). A product whose A operand is a
// previous product's C reads A's columns tc and tc + 4 as C's columns 2 tc
// and 2 tc + 1 (a0, a1, a2, a3 <- c0, c2, c1, c3), and takes B's rows in
// the same order: no shuffle between the two.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b: one TF32 product, or three when kSplit (3xTF32).
template <bool kSplit>
__device__ __forceinline__ void mma(float (&c)[4], const Frag<kSplit, 4>& a,
                                    const Frag<kSplit, 2>& b) {
  if constexpr (kSplit) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
  }
  mma_tf32(c, a.hi, b.hi);
}

// big += a.hi b.hi and small += the cross terms: two shorter chains of
// dependent products where one accumulator would serialise three.
template <bool kSplit>
__device__ __forceinline__ void mma2(float (&big)[4], float (&small)[4],
                                     const Frag<kSplit, 4>& a, const Frag<kSplit, 2>& b) {
  if constexpr (kSplit) {
    mma_tf32(small, a.lo, b.hi);
    mma_tf32(small, a.hi, b.lo);
  }
  mma_tf32(big, a.hi, b.hi);
}

}  // namespace attn
