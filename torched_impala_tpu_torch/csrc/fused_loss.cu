// The fused V-trace + loss epilogue: the V-trace recursion, then the
// masked policy-gradient, baseline and entropy sums, in one pass.
//
// Replaces the Pallas TPU kernel `_fused_loss_kernel` /
// `_fused_sums_kernel_call` of torched_impala_tpu/ops/vtrace_pallas.py.
// The TPU kernel keeps a 128-lane batch tile in VMEM, writes one partial
// sum per tile and lets XLA add the tiles up. Here the batch columns are
// threads, as in csrc/vtrace.cu.
//
// Design: one thread per batch column b walks t = T-1 .. 0 with the
// carry acc (= vs_t - V(x_t)), V(x_{t+1}) and vs_{t+1} in registers (the
// bootstrap at t = T-1), writes vs and the advantage, and adds its three
// masked terms to three registers. A block of 128 threads reduces them in
// shared memory by a fixed tree and writes one row of `partials`
// [n_blocks, 3]; the wrapper adds the rows (torch.sum). No atomics, so
// the sums are the same from run to run. Threads with b >= B add zero,
// as the TPU kernel's mask-0 padding does.
//
// Bound: at the Pong shape (T = 20, B = 32) the kernel reads
// 7 * 20 * 32 * 4 + 32 * 4 = 18,048 bytes and writes 2 * 20 * 32 * 4 + 12
// = 5,132 bytes, about 7 ns at 3.35 TB/s: launch latency bounds it, as it
// bounds the V-trace kernel. Folding the [T, B, A] softmax phase in, so
// that the logits are read once, is later work.
//
// Numerics: vs and the advantage go through __fmul_rn / __fadd_rn /
// __fsub_rn in the plain version's order (csrc/vtrace.cu says why: with
// fused multiply-adds they drifted 4.6e-5 at T = 100). The three sums are
// f32 in another order than torch.sum's; they are held to rtol 1e-5.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// min(clip, rho) that passes a NaN rho through, as torch.clamp does.
__device__ __forceinline__ float clip_to(float clip, float rho) {
  return rho > clip ? clip : rho;
}

__global__ void fused_loss_kernel(
    const float* __restrict__ log_pi_a, const float* __restrict__ entropy,
    const float* __restrict__ values, const float* __restrict__ bootstrap,
    const float* __restrict__ log_rhos, const float* __restrict__ discounts,
    const float* __restrict__ rewards, const float* __restrict__ mask,
    float* __restrict__ vs_out, float* __restrict__ adv_out,
    float* __restrict__ partials, int T, int B, float clip_rho,
    float clip_c, float clip_pg_rho, float lambda_) {
  __shared__ float sums[3][kThreads];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  float pg = 0.0f, bl = 0.0f, ent = 0.0f;
  if (b < B) {
    float acc = 0.0f;
    float v_next = bootstrap[b];
    float vs_next = v_next;
    for (int t = T - 1; t >= 0; --t) {
      const long i = static_cast<long>(t) * B + b;
      const float rho = expf(log_rhos[i]);
      const float d = discounts[i];
      const float r = rewards[i];
      const float v = values[i];
      const float m = mask[i];
      const float c = __fmul_rn(lambda_, clip_to(clip_c, rho));
      const float delta = __fmul_rn(
          clip_to(clip_rho, rho), __fsub_rn(__fadd_rn(r, __fmul_rn(d, v_next)), v));
      acc = __fadd_rn(delta, __fmul_rn(__fmul_rn(d, c), acc));
      const float vs = __fadd_rn(v, acc);
      const float adv = __fmul_rn(clip_to(clip_pg_rho, rho),
                                  __fsub_rn(__fadd_rn(r, __fmul_rn(d, vs_next)), v));
      vs_out[i] = vs;
      adv_out[i] = adv;
      pg = __fadd_rn(pg, __fmul_rn(__fmul_rn(-adv, log_pi_a[i]), m));
      const float err = __fsub_rn(vs, v);
      bl = __fadd_rn(bl, __fmul_rn(__fmul_rn(err, err), m));
      ent = __fadd_rn(ent, __fmul_rn(-entropy[i], m));
      v_next = v;
      vs_next = vs;
    }
  }
  sums[0][threadIdx.x] = pg;
  sums[1][threadIdx.x] = bl;
  sums[2][threadIdx.x] = ent;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride /= 2) {
    if (threadIdx.x < stride) {
      for (int k = 0; k < 3; ++k)
        sums[k][threadIdx.x] += sums[k][threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partials[blockIdx.x * 3 + 0] = sums[0][0];
    partials[blockIdx.x * 3 + 1] = 0.5f * sums[1][0];
    partials[blockIdx.x * 3 + 2] = sums[2][0];
  }
}

}  // namespace

extern "C" int fused_loss_blocks(int B) { return (B + kThreads - 1) / kThreads; }

// Launches on `stream` (PyTorch's current stream) on `device`, returns
// cudaGetLastError() so a refused launch is reported to the caller.
// `partials` holds fused_loss_blocks(B) rows of 3 floats.
extern "C" int fused_loss_launch(
    const float* log_pi_a, const float* entropy, const float* values,
    const float* bootstrap, const float* log_rhos, const float* discounts,
    const float* rewards, const float* mask, float* vs_out, float* adv_out,
    float* partials, int T, int B, float clip_rho, float clip_c,
    float clip_pg_rho, float lambda_, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_loss_kernel<<<fused_loss_blocks(B), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      log_pi_a, entropy, values, bootstrap, log_rhos, discounts, rewards, mask,
      vs_out, adv_out, partials, T, B, clip_rho, clip_c, clip_pg_rho, lambda_);
  return static_cast<int>(cudaGetLastError());
}
