// V-trace targets and policy-gradient advantages, one staged pass over T.
//
// Replaces the Pallas TPU kernel `_vtrace_kernel` / `vtrace_pallas` of
// torched_impala_tpu/ops/vtrace_pallas.py. The TPU kernel keeps a 128-lane
// batch tile and its [T, 128] scratch in VMEM and runs the recursion over
// rows of that scratch; here shared memory takes the place of VMEM.
//
// Design (vtrace_stage.cuh): a block of 256 threads owns 32 batch columns
// and all of T, in chunks of 32 steps, latest first. All threads copy a
// chunk's four [len, 32] inputs into shared memory at once with
// `cp.async` (rows of up to 32 neighbouring floats), the
// next chunk's copies in flight while this chunk computes (two buffers);
// they compute rho, the clips, delta and gamma * c in parallel; one warp
// runs the two-operation chain, one thread a column; then all threads
// compute vs, the advantages and the errors and store them coalesced.
// The carries between chunks are acc (a register of the chain thread),
// and V(x_{t1}) and vs_{t1} (shared memory). Grid ceil(B / 32); the last
// block's tile holds the ragged rest of B.
//
// Why staged: the first port (one thread per column walking T with its
// own global loads) paid one memory latency a step, T in all; here the
// loads of a chunk are started together and the serial part reads shared
// memory only.
//
// Bound: at the Pong shape (T = 20, B = 32) the kernel reads
// 4*20*32*4 + 32*4 = 10,368 bytes and writes 3*20*32*4 = 7,680 bytes,
// about 5 ns at 3.35 TB/s: launch latency (microseconds) bounds it, then
// one round trip to memory and the T-step chain.
//
// Numerics: expf (not __expf), f32 throughout, every multiply and add in
// the plain version's order without fused multiply-adds
// (vtrace_stage.cuh). Only expf may differ from the CPU's exp by an ulp,
// which the tests' tolerance (1e-5) allows for.

#include <cuda_runtime.h>

#include "vtrace_stage.cuh"

namespace {

constexpr int kThreads = 256;
using vt::kChunk;
using vt::kCols;

struct Inputs {
  vt::Tile lr, d, r, v;  // log rho (rho after prep), discounts, rewards, values
};

// Starts the copies of chunk `c` of columns [b0, b0 + cols) into `in`.
__device__ __forceinline__ void load_chunk(Inputs& in, const float* log_rhos,
                                           const float* discounts, const float* rewards,
                                           const float* values, vt::Chunk c, int b0, int cols,
                                           int B) {
  for (int i = threadIdx.x; i < c.len * cols; i += blockDim.x) {
    const int tl = i / cols, j = i % cols;
    const long g = static_cast<long>(c.t0 + tl) * B + b0 + j;
    vt::cp_async4(&in.lr[tl][j], log_rhos + g);
    vt::cp_async4(&in.d[tl][j], discounts + g);
    vt::cp_async4(&in.r[tl][j], rewards + g);
    vt::cp_async4(&in.v[tl][j], values + g);
  }
  vt::cp_async_commit();
}

__global__ void __launch_bounds__(kThreads) vtrace_kernel(
    const float* __restrict__ log_rhos, const float* __restrict__ discounts,
    const float* __restrict__ rewards, const float* __restrict__ values,
    const float* __restrict__ bootstrap, float* __restrict__ vs_out,
    float* __restrict__ pg_out, float* __restrict__ err_out, int T, int B, float clip_rho,
    float clip_c, float clip_pg_rho, float lambda_) {
  __shared__ Inputs in[2];
  __shared__ vt::Tile delta, dc;  // delta, then acc (= vs - V); gamma * c
  // V(x_{t1}) and vs_{t1} of each column, for the chunk before; two copies,
  // since a chunk reads one while it writes the other.
  __shared__ float v_after[2][kCols], vs_after[2][kCols];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kCols;
  const int cols = min(kCols, B - b0);
  // The bootstrap goes with the first chunk's copies: no thread waits on
  // a load before it starts its share of them.
  if (tid < cols) vt::cp_async4(&v_after[0][tid], bootstrap + b0 + tid);
  const int chunks = (T + kChunk - 1) / kChunk;
  load_chunk(in[0], log_rhos, discounts, rewards, values, vt::Chunk(T, 0), b0, cols, B);
  float acc = 0.0f;
  for (int k = 0; k < chunks; ++k) {
    const vt::Chunk c(T, k);
    Inputs& cur = in[k & 1];
    if (k + 1 < chunks) {
      load_chunk(in[(k + 1) & 1], log_rhos, discounts, rewards, values, vt::Chunk(T, k + 1),
                 b0, cols, B);
      vt::cp_async_wait<1>();
    } else {
      vt::cp_async_wait<0>();
    }
    __syncthreads();
    if (k == 0 && tid < cols) vs_after[0][tid] = v_after[0][tid];
    vt::prep(cur.lr, cur.d, cur.r, cur.v, v_after[k & 1], delta, dc, c.len, cols, clip_rho,
             clip_c, lambda_);
    __syncthreads();
    if (tid < cols) acc = vt::chain(delta, dc, c.len, acc);
    __syncthreads();
    for (int i = tid; i < c.len * cols; i += kThreads) {
      const int tl = i / cols, j = i % cols;
      const float v = cur.v[tl][j];
      const float err = delta[tl][j];
      const float vs = __fadd_rn(v, err);
      const float vs_next =
          tl + 1 < c.len ? __fadd_rn(cur.v[tl + 1][j], delta[tl + 1][j]) : vs_after[k & 1][j];
      const long g = static_cast<long>(c.t0 + tl) * B + b0 + j;
      pg_out[g] = vt::advantage(cur.lr[tl][j], cur.r[tl][j], cur.d[tl][j], v, vs_next,
                                clip_pg_rho);
      vs_out[g] = vs;
      err_out[g] = err;
    }
    if (tid < cols) {
      v_after[(k + 1) & 1][tid] = cur.v[0][tid];
      vs_after[(k + 1) & 1][tid] = __fadd_rn(cur.v[0][tid], delta[0][tid]);
    }
    __syncthreads();
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
  const int blocks = (B + kCols - 1) / kCols;
  vtrace_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      log_rhos, discounts, rewards, values, bootstrap, vs_out, pg_out, err_out, T, B, clip_rho,
      clip_c, clip_pg_rho, lambda_);
  return static_cast<int>(cudaGetLastError());
}
