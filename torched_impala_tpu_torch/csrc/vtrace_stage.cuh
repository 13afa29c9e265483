// The staged V-trace pass shared by csrc/vtrace.cu and csrc/fused_loss.cu.
//
// A block owns a tile of kCols batch columns and walks all of T in chunks
// of kChunk steps, latest first. Each chunk's [len, kCols] operands sit in
// shared memory; the block then
//   1. computes the parts that need no carry in parallel (`prep`): rho,
//      the clips, delta_t and gamma_t * c_t, with V(x_{t+1}) of a chunk's
//      last step taken from the chunk after it (the bootstrap for the
//      last chunk);
//   2. runs the serial chain acc = delta + (gamma * c) * acc with one
//      thread per column (`chain`): two operations a step, from shared
//      memory, the carry in a register across chunks;
//   3. computes vs and the advantages in parallel (`advantage`), vs_{t+1}
//      of a chunk's last step again from the chunk after it.
// The chain stays serial: a parallel scan would reorder the sums.
//
// Numerics: every multiply and add goes through __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into fused multiply-adds, in the
// plain version's order (ops/vtrace.py:vtrace_reference). With FMAs the
// targets drifted 4.6e-5 from the plain version at T = 100 (measured on an
// H100 80GB HBM3), past the 1e-5 the kernels are held to.

#pragma once

#include <cuda_runtime.h>

namespace vt {

constexpr int kCols = 32;   // the most batch columns a tile holds: one warp runs the chain
constexpr int kChunk = 32;  // steps of T staged in shared memory at once

using Tile = float[kChunk][kCols];

// min(clip, rho) that passes a NaN rho through, as torch.clamp and
// jnp.minimum do (fminf would return `clip`). An infinite clip (no
// threshold) returns rho.
__device__ __forceinline__ float clip_to(float clip, float rho) {
  return rho > clip ? clip : rho;
}

// One float from global to shared memory without waiting.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Steps [t0, t1) of T, latest chunk first: chunk k ends at T - k * kChunk.
struct Chunk {
  int t0, len;
  __device__ Chunk(int T, int k) {
    const int t1 = T - k * kChunk;
    t0 = t1 > kChunk ? t1 - kChunk : 0;
    len = t1 - t0;
  }
};

// The parallel part before the chain, for every step of the chunk and each
// of the tile's first `cols` columns: `rho`
// holds log rho on entry and rho on exit; delta_t = min(clip_rho, rho) *
// ((r + gamma * V(x_{t+1})) - V(x_t)) and dc_t = gamma * lambda *
// min(clip_c, rho). `v_after` is V(x_{t1}) of each column.
__device__ __forceinline__ void prep(Tile& rho, const Tile& d, const Tile& r, const Tile& v,
                                     const float* v_after, Tile& delta, Tile& dc, int len,
                                     int cols, float clip_rho, float clip_c, float lambda_) {
  for (int i = threadIdx.x; i < len * cols; i += blockDim.x) {
    const int tl = i / cols, j = i % cols;
    const float rh = expf(rho[tl][j]);
    const float v_next = tl + 1 < len ? v[tl + 1][j] : v_after[j];
    const float c = __fmul_rn(lambda_, clip_to(clip_c, rh));
    delta[tl][j] = __fmul_rn(clip_to(clip_rho, rh),
                             __fsub_rn(__fadd_rn(r[tl][j], __fmul_rn(d[tl][j], v_next)), v[tl][j]));
    dc[tl][j] = __fmul_rn(d[tl][j], c);
    rho[tl][j] = rh;
  }
}

// The serial chain of column threadIdx.x (< kCols): acc = delta + dc * acc
// from the chunk's last step to its first; acc (= vs - V) overwrites delta.
// Returns the carry for the chunk before.
// Eight steps' operands are read before their eight dependent steps, so
// the shared-memory latency is paid once in eight.
__device__ __forceinline__ float chain(Tile& delta, const Tile& dc, int len, float acc) {
  const int j = threadIdx.x;
  int tl = len - 1;
  for (; tl >= 7; tl -= 8) {
    float dl[8], cc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      dl[u] = delta[tl - u][j];
      cc[u] = dc[tl - u][j];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      acc = __fadd_rn(dl[u], __fmul_rn(cc[u], acc));
      delta[tl - u][j] = acc;
    }
  }
  for (; tl >= 0; --tl) {
    acc = __fadd_rn(delta[tl][j], __fmul_rn(dc[tl][j], acc));
    delta[tl][j] = acc;
  }
  return acc;
}

// The policy-gradient advantage min(clip_pg_rho, rho) * ((r + gamma *
// vs_{t+1}) - V(x_t)).
__device__ __forceinline__ float advantage(float rho, float r, float d, float v, float vs_next,
                                           float clip_pg_rho) {
  return __fmul_rn(clip_to(clip_pg_rho, rho), __fsub_rn(__fadd_rn(r, __fmul_rn(d, vs_next)), v));
}

}  // namespace vt
