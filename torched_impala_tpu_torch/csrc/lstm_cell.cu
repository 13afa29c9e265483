// One LSTM cell step: both gate products, the gate activations and the
// carry update in one kernel.
//
// Replaces the Pallas TPU kernel `_lstm_cell_kernel` / `_lstm_forward`
// of torched_impala_tpu/ops/lstm_pallas.py. The TPU kernel holds the
// whole [B, 4H] gate tile in VMEM and runs both products on the MXU;
// here each block owns a tile of hidden units and every thread owns one
// (batch row, hidden unit) pair, so the four gates of a unit meet in one
// thread's registers and nothing goes back to device memory between the
// products and the gates.
//
// Computes, all in float32, with the gates (i, f, g, o) along 4H:
//   gates = (h @ Wh + b) + x @ Wi          (this grouping, as flax does)
//   i, f, o = sigmoid(.), g = tanh(.)
//   new_c = f * c + i * g,  new_h = o * tanh(new_c)
// and writes new_c, new_h and the activated gates `acts` [B, 4H] that
// the backward reads.
//
// Design: blocks of 32 hidden units (threadIdx.x) x 8 batch rows
// (threadIdx.y), grid ceil(H / 32) x ceil(B / 8). The reduction runs in
// chunks of 32: the block stages the [8, 32] slice of h (then x) and the
// four [32, 32] weight slices of columns j, H+j, 2H+j, 3H+j in shared
// memory, and each thread accumulates its four dot products. Weight
// rows are read by 32 neighbouring threads at 32 neighbouring columns
// (coalesced); the ragged edges (B, F, H not multiples of the tiles)
// load zeros and are masked on the store.
//
// Bound: at the learner's shape (B = 32, F = H = 256) the kernel must
// read Wi and Wh (2 x 256 x 1024 x 4 B = 2 MiB) plus x, h, c and b, and
// write new_c, new_h and acts (~0.2 MiB): about 0.7 us at 3.35 TB/s,
// against 2 x 2 x 32 x 256 x 1024 = 33.6 MFLOP, 0.5 us at the f32 rate.
// It is bound by the bytes of the weights. Each batch tile re-reads the
// weights, which the 50 MB L2 absorbs; a single launch of this size is
// in any case bound by launch latency (microseconds), so the simple
// CUDA-core product is kept; tensor cores (wgmma) and a persistent
// kernel over the T steps of an unroll are later work.
//
// Numerics: the dot products accumulate with fused multiply-adds in
// another order than the plain version's matmul (its own order on either
// device), so they differ by f32 rounding of 512-term sums. The gate
// grouping and the carry update go through __fadd_rn / __fmul_rn, which
// nvcc never contracts, in the plain version's order. expf and tanhf,
// not the fast intrinsics; no --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kTileJ = 32;  // hidden units per block
constexpr int kTileB = 8;   // batch rows per block
constexpr int kTileK = 32;  // reduction chunk

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// acc[g] += in[row, :] . w[:, g*H + j] for the four gates g, over K.
__device__ __forceinline__ void accumulate(const float* __restrict__ in,
                                           const float* __restrict__ w,
                                           int K, int B, int H, int row,
                                           int j, float (&s_in)[kTileB][kTileK + 1],
                                           float (&s_w)[4][kTileK][kTileJ],
                                           float (&acc)[4]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long H4 = 4L * H;
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    const int k = k0 + tx;
    s_in[ty][tx] = (row < B && k < K) ? in[static_cast<long>(row) * K + k] : 0.0f;
    for (int kk = ty; kk < kTileK; kk += kTileB) {
      const int kr = k0 + kk;
      const bool ok = kr < K && j < H;
      const float* wr = w + static_cast<long>(kr) * H4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        s_w[g][kk][tx] = ok ? wr[static_cast<long>(g) * H] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTileK; ++kk) {
      const float v = s_in[ty][kk];
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g] = fmaf(v, s_w[g][kk][tx], acc[g]);
    }
    __syncthreads();
  }
}

__global__ void lstm_cell_kernel(const float* __restrict__ x,
                                 const float* __restrict__ h,
                                 const float* __restrict__ c,
                                 const float* __restrict__ wi,
                                 const float* __restrict__ wh,
                                 const float* __restrict__ b,
                                 float* __restrict__ new_c,
                                 float* __restrict__ new_h,
                                 float* __restrict__ acts, int B, int F,
                                 int H) {
  __shared__ float s_in[kTileB][kTileK + 1];
  __shared__ float s_w[4][kTileK][kTileJ];
  const int j = blockIdx.x * kTileJ + threadIdx.x;
  const int row = blockIdx.y * kTileB + threadIdx.y;
  float acc_h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc_x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  accumulate(h, wh, H, B, H, row, j, s_in, s_w, acc_h);
  accumulate(x, wi, F, B, H, row, j, s_in, s_w, acc_x);
  if (row >= B || j >= H) return;
  float gate[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    gate[g] = __fadd_rn(__fadd_rn(acc_h[g], b[g * H + j]), acc_x[g]);
  }
  const float i = sigmoid(gate[0]);
  const float f = sigmoid(gate[1]);
  const float gg = tanhf(gate[2]);
  const float o = sigmoid(gate[3]);
  const long rc = static_cast<long>(row) * H + j;
  const float nc = __fadd_rn(__fmul_rn(f, c[rc]), __fmul_rn(i, gg));
  new_c[rc] = nc;
  new_h[rc] = __fmul_rn(o, tanhf(nc));
  float* a = acts + static_cast<long>(row) * 4 * H + j;
  a[0] = i;
  a[H] = f;
  a[2 * H] = gg;
  a[3 * H] = o;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) on `device`, returns
// cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int lstm_cell_launch(const float* x, const float* h,
                                const float* c, const float* wi,
                                const float* wh, const float* b,
                                float* new_c, float* new_h, float* acts,
                                int B, int F, int H, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kTileJ, kTileB);
  const dim3 grid((H + kTileJ - 1) / kTileJ, (B + kTileB - 1) / kTileB);
  lstm_cell_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, h, c, wi, wh, b, new_c, new_h, acts, B, F, H);
  return static_cast<int>(cudaGetLastError());
}
