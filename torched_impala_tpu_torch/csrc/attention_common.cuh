// Shared pieces of the windowed-attention kernels (attention_fwd.cu,
// attention_bwd.cu): element loads, bf16 rounding, warp reductions and
// the visibility rule of torched_impala_tpu/ops/attention_pallas.py
// (`_visible_tile`, `_tile_may_see`).
//
// Layouts (the JAX package's): q, dO `[B, T, H, dh]`; k, v `[B, S, H, dh]`
// in float32 or bfloat16; seg_q `[B, T]`, seg_ctx `[B, S]` int32; the row
// logsumexp `[B, H, T]` and the forward output O `[B, T, H, dh]` in
// float32. Every sum runs in float32: the forward's on the CUDA cores, the
// backward's products on the tensor cores (attention_bwd.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "smem_ceiling.cuh"

namespace attn {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o /= 2) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
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

// Can any query of [t0, t1] see any slot of [s0, ...)? False only for
// slots past the cache and past every query: the tiles above the causal
// diagonal, which the kernels skip.
__device__ __forceinline__ bool tile_may_see(int t1, int s0, int W) {
  return s0 < W || s0 - W <= t1;
}

// Head widths: each kernel is instantiated at a padded width DP in
// {16, 32, 64, 128, 256} and takes the true dh (1 <= dh <= DP) at run time.
// Shared memory holds DP columns; the columns dh <= d < DP are loaded as
// 0, so every dot product over DP adds only 0 x 0 terms to the dh true
// ones and the sums are exact; outputs are written for d < dh only. The
// scale is the caller's 1/sqrt(dh) of the true dh. Each instantiation
// takes its arrays from dynamic shared memory and its launcher sets the
// kernel's ceiling once (smem_ceiling.cuh): the forward's size, which
// depends on DP alone; the backward's, whose tiles are chosen per call,
// the card's 227 KB.

// The padded width a head width runs at; 0 outside 1 to 256.
inline int padded_width(int dh) {
  if (dh < 1) return 0;
  for (int dp : {16, 32, 64, 128, 256}) {
    if (dh <= dp) return dp;
  }
  return 0;
}

// ROWS x DP elements of head h from a [B, L, H, dh] tensor (global row
// stride dh) into shared memory (row stride LD floats): zeros past row L
// and in the padded columns dh <= d < DP. All kThreads threads take part,
// each with fixed columns (d0, d0 + kThreads, ...) of fixed rows, so the
// column test and the offsets are worked out once.
template <typename T, int DP, int ROWS, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int b, int h, int row0, int L, int H,
                                          int dh) {
  constexpr int kColStep = DP < kThreads ? DP : kThreads;
  constexpr int kRowStep = kThreads / kColStep;  // rows a pass
  static_assert(ROWS % kRowStep == 0, "a pass covers whole rows");
  const int d0 = threadIdx.x % kColStep, r0 = threadIdx.x / kColStep;
#pragma unroll
  for (int n = 0; n < ROWS / kRowStep; ++n) {
    const int r = r0 + n * kRowStep, row = row0 + r;
    const T* s = src + ((static_cast<long>(b) * L + row) * H + h) * dh;
#pragma unroll
    for (int d = d0; d < DP; d += kColStep) {
      dst[r * LD + d] = row < L && d < dh ? to_f32(s[d]) : 0.0f;
    }
  }
}

}  // namespace attn
