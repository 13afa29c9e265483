// V-trace targets and policy-gradient advantages, one reverse pass over T.
//
// Replaces the Pallas TPU kernel `_vtrace_kernel` / `vtrace_pallas` of
// torched_impala_tpu/ops/vtrace_pallas.py. The TPU kernel keeps a
// 128-lane batch tile and its [T, 128] scratch in VMEM; here the batch
// columns are independent threads and the recursion lives in registers.
//
// Design: one thread per batch column b, walking t = T-1 .. 0 with the
// carry `acc` (= vs_t - V(x_t)), V(x_{t+1}) and vs_{t+1} in registers
// (the bootstrap at t = T-1). Every input is read once and every output
// written once; there is no scratch. Inputs are time-major [T, B], so
// the 32 threads of a warp read 32 neighbouring floats of one row.
// Blocks of 128 threads, grid ceil(B / 128); the ragged edge b >= B is
// masked instead of padded to 128 lanes as on the TPU.
//
// Bound: at the Pong shape (T = 20, B = 32) the kernel reads
// 4*20*32*4 + 32*4 = 10,368 bytes and writes 3*20*32*4 = 7,680 bytes,
// about 5 ns at 3.35 TB/s: launch latency (microseconds) bounds it, not
// the memory or the arithmetic. Removing the launch (CUDA graphs, or
// fusing the recursion into the loss) is later work.
//
// Numerics: expf (not __expf), f32 throughout. nvcc contracts a*b + c
// into fused multiply-adds by default, which rounds once where the plain
// PyTorch version rounds twice: at T = 100 with unclipped weights that
// drift reached 4.6e-5 absolute on targets of magnitude ~50 (measured
// on an H100 80GB HBM3), past the 1e-5 the kernel is held to. So every multiply and add
// goes through the __fmul_rn / __fadd_rn / __fsub_rn intrinsics, which
// nvcc never contracts, in the plain version's operation order. Against
// the CPU reference the sums still round alike; only expf may differ by
// an ulp, which the tests' tolerance (1e-5) allows for.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// min(clip, rho) that passes a NaN rho through, as torch.clamp and
// jnp.minimum do (fminf would return `clip`). An infinite clip (no
// threshold) returns rho.
__device__ __forceinline__ float clip_to(float clip, float rho) {
  return rho > clip ? clip : rho;
}

__global__ void vtrace_kernel(const float* __restrict__ log_rhos,
                              const float* __restrict__ discounts,
                              const float* __restrict__ rewards,
                              const float* __restrict__ values,
                              const float* __restrict__ bootstrap,
                              float* __restrict__ vs_out,
                              float* __restrict__ pg_out,
                              float* __restrict__ err_out,
                              int T, int B, float clip_rho, float clip_c,
                              float clip_pg_rho, float lambda_) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float acc = 0.0f;
  float v_next = bootstrap[b];
  float vs_next = v_next;
  for (int t = T - 1; t >= 0; --t) {
    const long i = static_cast<long>(t) * B + b;
    const float rho = expf(log_rhos[i]);
    const float d = discounts[i];
    const float r = rewards[i];
    const float v = values[i];
    const float clipped_rho = clip_to(clip_rho, rho);
    const float c = __fmul_rn(lambda_, clip_to(clip_c, rho));
    // delta = clipped_rho * ((r + d * v_next) - v)
    const float delta =
        __fmul_rn(clipped_rho, __fsub_rn(__fadd_rn(r, __fmul_rn(d, v_next)), v));
    // acc = delta + (d * c) * acc
    acc = __fadd_rn(delta, __fmul_rn(__fmul_rn(d, c), acc));
    const float vs = __fadd_rn(v, acc);
    // pg = min(clip_pg_rho, rho) * ((r + d * vs_next) - v)
    pg_out[i] = __fmul_rn(clip_to(clip_pg_rho, rho),
                          __fsub_rn(__fadd_rn(r, __fmul_rn(d, vs_next)), v));
    vs_out[i] = vs;
    err_out[i] = acc;
    v_next = v;
    vs_next = vs;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) on `device`, returns
// cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int vtrace_launch(const float* log_rhos, const float* discounts,
                             const float* rewards, const float* values,
                             const float* bootstrap, float* vs_out,
                             float* pg_out, float* err_out, int T, int B,
                             float clip_rho, float clip_c, float clip_pg_rho,
                             float lambda_, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kThreads - 1) / kThreads;
  vtrace_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      log_rhos, discounts, rewards, values, bootstrap, vs_out, pg_out,
      err_out, T, B, clip_rho, clip_c, clip_pg_rho, lambda_);
  return static_cast<int>(cudaGetLastError());
}
