// Shared pieces of the windowed-attention kernels (attention_fwd.cu,
// attention_bwd.cu): element loads, bf16 rounding, warp reductions and
// the visibility rule of torched_impala_tpu/ops/attention_pallas.py
// (`_visible_tile`, `_tile_may_see`).
//
// Layouts (the JAX package's): q, dO `[B, T, H, dh]`; k, v `[B, S, H, dh]`
// in float32 or bfloat16; seg_q `[B, T]`, seg_ctx `[B, S]` int32; the row
// logsumexp `[B, H, T]` and D = sum_d O * dO `[B, T, H]` in float32.
// Every sum runs in float32 on the CUDA cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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

// rows x DH elements of head h from a [B, L, H, DH] tensor into shared
// memory (row stride LD floats), zeros past row L. All threads take part.
template <typename T, int DH, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int b, int h, int row0, int rows,
                                          int L, int H) {
  for (int i = threadIdx.x; i < rows * DH; i += blockDim.x) {
    const int r = i / DH, d = i % DH, row = row0 + r;
    dst[r * LD + d] =
        row < L ? to_f32(src[((static_cast<long>(b) * L + row) * H + h) * DH + d]) : 0.0f;
  }
}

}  // namespace attn
