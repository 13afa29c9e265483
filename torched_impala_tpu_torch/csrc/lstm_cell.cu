// One LSTM cell step: both gate products, the gate activations and the
// carry update in one kernel.
//
// Replaces the Pallas TPU kernel `_lstm_cell_kernel` / `_lstm_forward`
// of torched_impala_tpu/ops/lstm_pallas.py. The TPU kernel holds the
// whole [B, 4H] gate tile in VMEM and runs both products on the MXU;
// here the four gates of a hidden unit and every partial sum of them
// meet in one block's shared memory, and nothing goes back to device
// memory between the products and the gates.
//
// Computes, all in float32, with the gates (i, f, g, o) along 4H:
//   gates = (h @ Wh + b) + x @ Wi          (this grouping, as flax does)
//   i, f, o = sigmoid(.), g = tanh(.)
//   new_c = f * c + i * g,  new_h = o * tanh(new_c)
// and writes new_c, new_h and the activated gates `acts` [B, 4H] that
// the backward reads.
//
// Design: a block owns kUnits = 2 hidden units u, that is the gate
// columns u, H+u, 2H+u, 3H+u, and all B rows, in tiles of 32 rows (one a
// lane). The grid is ceil(H / 2) blocks whatever B is: 128 at H = 256,
// at the learner's B = 32 and at the actors' B = 8 alike. Inside the
// block the reduction is split: warps 0-7 take h @ Wh (K = H), warps
// 8-15 take x @ Wi (K = F), each warp an eighth of every chunk of 256
// reduction rows. A stage (one row tile, one chunk of both products) is
// brought in by `cp.async`: h and x transposed to [k][row] (rows padded
// to 33 floats, so the lanes' row reads and the copies' k-major writes
// both hit 32 banks) and the block's 2 x 4 weight columns as [k][8], read
// by all lanes at one address (a broadcast). At F, H <= 256 and B <= 32
// (the presets' learner and actor shapes) one stage holds everything;
// past that the stages are double-buffered, so the next one's copies run
// under this one's products, and they tile any F, H and B, so no shape
// is refused for shared memory (184,320 bytes a block, dynamic, whatever
// the shape). Each lane accumulates its row's eight columns over its
// warp's rows of K; at the end of a row tile the warps' partial sums go
// to shared memory and 64 threads (a row and a unit each) add them in a
// fixed order, the h sums and the x sums apart, and run the gates and
// the carry update, with c and b read before the products. No atomics
// and no cluster: a launch repeated on the same inputs is bit-identical.
//
// Bound: at the learner's shape (B = 32, F = H = 256) the kernel must
// read Wi and Wh (2 x 256 x 1024 x 4 B = 2 MiB) plus x, h, c and b, and
// write new_c, new_h and acts (~0.2 MiB): about 0.7 us at 3.35 TB/s,
// against 2 x 2 x 32 x 256 x 1024 = 33.6 MFLOP, 0.5 us at the f32 rate.
// Every block reads all of x and h (64 KiB at B = 32, 8 MiB across the
// 128 blocks, from L2) and its weight columns in 8-byte runs, so L2
// traffic and one launch's latency, not device memory, set its time. The
// products stay on the CUDA cores in f32: TF32 tensor-core products
// would round the inputs past the 5e-5 gate over 512-term sums.
//
// Numerics: the dot products accumulate with fused multiply-adds in
// another order than the plain version's matmul (its own order on either
// device), so they differ by f32 rounding of 512-term sums. The partial
// sums, the gate grouping and the carry update go through __fadd_rn /
// __fmul_rn, which nvcc never contracts, the last two in the plain
// version's order. expf and tanhf, not the fast intrinsics; no
// --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>

#include "smem_ceiling.cuh"

namespace {

constexpr int kUnits = 2;                        // hidden units a block
constexpr int kCols = 4 * kUnits;                // gate columns a block: g * kUnits + j
constexpr int kRows = 32;                        // batch rows a tile, one a lane
constexpr int kWarpsPerProduct = 8;              // warps on h @ Wh, then on x @ Wi
constexpr int kWarps = 2 * kWarpsPerProduct;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 256;                      // reduction rows a stage, each product
constexpr int kSlice = kChunk / kWarpsPerProduct;  // a warp's rows of a chunk
constexpr int kLd = kRows + 1;                   // padded row of the transposed inputs

struct Stage {
  float in[2][kChunk][kLd];   // [product][k][row]: h, then x, transposed
  float w[2][kChunk][kCols];  // [product][k][col]: Wh, then Wi, the block's columns
};

struct Smem {
  Stage stage[2];
  float part[kWarps][kCols][kRows];  // each warp's partial sums of a row tile
};

constexpr int kSmemBytes = static_cast<int>(sizeof(Smem));

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const auto d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const float *x, *h, *c, *wi, *wh, *b;
  float *new_c, *new_h, *acts;
  int B, F, H;
};

// Issues the copies of one stage: rows [row0, row0 + rows) of h and x and
// reduction rows [k0, k0 + kChunk) of both products, for units [u0, u0 +
// kUnits). Reduction rows past K and units past H are not copied; the
// products stop at K and the epilogue skips those units.
__device__ __forceinline__ void load_stage(Stage& dst, const Args& a, int row0,
                                           int rows, int k0, int u0) {
  const long H4 = 4L * a.H;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int K = p == 0 ? a.H : a.F;
    const float* in = p == 0 ? a.h : a.x;
    const float* w = p == 0 ? a.wh : a.wi;
    for (int i = threadIdx.x; i < rows * kChunk; i += kThreads) {
      const int r = i / kChunk, k = i % kChunk;
      if (k0 + k < K) {
        cp_async4(&dst.in[p][k][r], in + static_cast<long>(row0 + r) * K + k0 + k);
      }
    }
    for (int i = threadIdx.x; i < kChunk * kCols; i += kThreads) {
      const int k = i / kCols, col = i % kCols;
      const int g = col / kUnits, u = u0 + col % kUnits;
      if (k0 + k < K && u < a.H) {
        cp_async4(&dst.w[p][k][col], w + static_cast<long>(k0 + k) * H4 + g * a.H + u);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) lstm_cell_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int u0 = blockIdx.x * kUnits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int product = warp / kWarpsPerProduct;  // 0: h @ Wh, 1: x @ Wi
  const int k_warp = (warp % kWarpsPerProduct) * kSlice;
  const int K = product == 0 ? a.H : a.F;
  const int chunks = ((a.H > a.F ? a.H : a.F) + kChunk - 1) / kChunk;
  const int stages = (a.B + kRows - 1) / kRows * chunks;

  load_stage(s.stage[0], a, 0, a.B < kRows ? a.B : kRows, 0, u0);
  cp_async_commit();
  float acc[kCols];
#pragma unroll
  for (int col = 0; col < kCols; ++col) acc[col] = 0.0f;
  // The epilogue's thread: row r of the tile, unit j of the block.
  const int r = threadIdx.x % kRows, j = threadIdx.x / kRows;
  float c_old = 0.0f, bias[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int st = 0; st < stages; ++st) {
    const int row0 = st / chunks * kRows, chunk = st % chunks;
    const int rows = a.B - row0 < kRows ? a.B - row0 : kRows;
    const int row = row0 + r, u = u0 + j;
    const bool epilogue = j < kUnits && r < rows && u < a.H;
    if (chunk == 0 && epilogue) {  // read early: in flight under the products
      c_old = a.c[static_cast<long>(row) * a.H + u];
#pragma unroll
      for (int g = 0; g < 4; ++g) bias[g] = a.b[g * a.H + u];
    }
    if (st + 1 < stages) {
      const int next_row0 = (st + 1) / chunks * kRows;
      const int next_rows = a.B - next_row0 < kRows ? a.B - next_row0 : kRows;
      load_stage(s.stage[(st + 1) & 1], a, next_row0, next_rows,
                 (st + 1) % chunks * kChunk, u0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage's copies, from every thread, have landed

    const Stage& sg = s.stage[st & 1];
    const int k_left = K - chunk * kChunk - k_warp;
    const int k_end = k_left < kSlice ? k_left : kSlice;
    if (lane < rows) {
      const float(*in)[kLd] = sg.in[product] + k_warp;
      const float(*w)[kCols] = sg.w[product] + k_warp;
#pragma unroll 8
      for (int k = 0; k < k_end; ++k) {
        const float v = in[k][lane];
        const float4 w0 = *reinterpret_cast<const float4*>(&w[k][0]);
        const float4 w1 = *reinterpret_cast<const float4*>(&w[k][4]);
        acc[0] = fmaf(v, w0.x, acc[0]);
        acc[1] = fmaf(v, w0.y, acc[1]);
        acc[2] = fmaf(v, w0.z, acc[2]);
        acc[3] = fmaf(v, w0.w, acc[3]);
        acc[4] = fmaf(v, w1.x, acc[4]);
        acc[5] = fmaf(v, w1.y, acc[5]);
        acc[6] = fmaf(v, w1.z, acc[6]);
        acc[7] = fmaf(v, w1.w, acc[7]);
      }
    }

    if (chunk == chunks - 1) {  // the row tile is summed: the epilogue
#pragma unroll
      for (int col = 0; col < kCols; ++col) {
        s.part[warp][col][lane] = acc[col];
        acc[col] = 0.0f;
      }
      __syncthreads();
      if (epilogue) {
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int col = g * kUnits + j;
          float acc_h = s.part[0][col][r];
          float acc_x = s.part[kWarpsPerProduct][col][r];
#pragma unroll
          for (int wp = 1; wp < kWarpsPerProduct; ++wp) {
            acc_h = __fadd_rn(acc_h, s.part[wp][col][r]);
            acc_x = __fadd_rn(acc_x, s.part[kWarpsPerProduct + wp][col][r]);
          }
          gate[g] = __fadd_rn(__fadd_rn(acc_h, bias[g]), acc_x);
        }
        const float i = sigmoid(gate[0]);
        const float f = sigmoid(gate[1]);
        const float gg = tanhf(gate[2]);
        const float o = sigmoid(gate[3]);
        const long rc = static_cast<long>(row) * a.H + u;
        const float nc = __fadd_rn(__fmul_rn(f, c_old), __fmul_rn(i, gg));
        a.new_c[rc] = nc;
        a.new_h[rc] = __fmul_rn(o, tanhf(nc));
        float* out = a.acts + static_cast<long>(row) * 4 * a.H + u;
        out[0] = i;
        out[a.H] = f;
        out[2 * a.H] = gg;
        out[3 * a.H] = o;
      }
    }
    __syncthreads();  // the stage (and the partial sums) may be overwritten
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) on `device`, returns
// cudaGetLastError() so a refused launch is reported to the caller.
// Takes every B, F, H >= 1.
extern "C" int lstm_cell_launch(const float* x, const float* h,
                                const float* c, const float* wi,
                                const float* wh, const float* b,
                                float* new_c, float* new_h, float* acts,
                                int B, int F, int H, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || F < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  err = set_smem_ceiling_once<lstm_cell_kernel>(device, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{x, h, c, wi, wh, b, new_c, new_h, acts, B, F, H};
  const int grid = (H + kUnits - 1) / kUnits;
  lstm_cell_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
