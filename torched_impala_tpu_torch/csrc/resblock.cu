// The IMPALA ResNet's residual block in one kernel:
//   out = x + conv2(relu(conv1(relu(x)) + b1)) + b2
// with 3x3 SAME convs over NHWC [N, H, W, C] and C in = C out.
//
// Replaces the Pallas TPU kernel `_residual_block_kernel` /
// `_block_forward` of torched_impala_tpu/ops/conv_pallas.py. The TPU
// kernel takes one image per grid step, a pre-padded relu(x) and a VMEM
// scratch ring; here a block takes a band of R output rows of one image,
// applies the relu and the zero padding itself while it stages the input
// in shared memory (x is read once from device memory, plus a two-row
// halo per band), and keeps conv1's output in shared memory only.
//
// Numerics, as the TPU kernel's: operands in x's type (float32 or
// bfloat16; the f32 kernels are rounded to that type on staging), every
// product accumulated in float32, b1 added in float32, the relu'd
// intermediate rounded to x's type, b2 and the skip added in float32,
// one rounding of the result to x's type.
//
// Design: grid (bands, N), 256 threads a block. Shared memory holds both
// kernels [3, 3, C, C] in x's type, the input band relu(x) for image rows
// r0-2 .. r0+R+1 and columns -1 .. W (zero outside the image), and the
// intermediate y1 for rows r0-1 .. r0+R and columns -1 .. W inside a
// ZERO ring: conv2's SAME padding pads conv1's OUTPUT with zeros, so y1
// is zero (not conv1 evaluated) outside the image. Each thread computes
// one (pixel, output channel) at a time as 9 x C fused multiply-adds out
// of shared memory; neighbouring threads take neighbouring output
// channels, so the input value is a broadcast and the kernel row is
// contiguous. The two halo rows are conv1 computed twice (once in each
// neighbouring band), 2 / R extra conv1 work.
//
// Bound: at the learner's shapes (N = 672 images; H x W x C of 42x42x16,
// 21x21x32, 11x11x32) the block must read x and write out once, 2 bytes
// an element in bf16: 2 x 672 x 42 x 42 x 16 x 2 B = 76 MB at the
// largest shape, 23 us at 3.35 TB/s, against 2 x 2 x 9 x C x C x H x W
// x N = 10.9 GFLOP, 11 us at the bf16 tensor-core rate (989 TFLOP/s):
// the function is bound by its bytes. This kernel does its products on
// the CUDA cores in f32 (67 TFLOP/s, 163 us for the same work), so as
// written it is bound by its operations: tensor cores (an implicit GEMM
// with wgmma, nine shifted [pixels, C] x [C, C] products out of the same
// shared-memory band) are the later PR's lever.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBand = 8;          // target band height
constexpr int kMaxSmem = 227 * 1024;     // bytes a block may use

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// max(v, 0) that passes NaN through, as jnp.maximum and torch.relu do.
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    resblock_kernel(const T* __restrict__ x, const float* __restrict__ k1,
                    const float* __restrict__ b1, const float* __restrict__ k2,
                    const float* __restrict__ b2, T* __restrict__ out, int H,
                    int W, int C, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const int Wp = W + 2;
  const int kk = 9 * C * C;
  T* s_k1 = reinterpret_cast<T*>(smem);
  T* s_k2 = s_k1 + kk;
  T* s_in = s_k2 + kk;                       // [R + 4][Wp][C]
  T* s_y1 = s_in + (R + 4) * Wp * C;         // [R + 2][Wp][C]
  const long img = static_cast<long>(n) * H * W * C;

  for (int i = threadIdx.x; i < kk; i += kThreads) {
    s_k1[i] = from_f<T>(k1[i]);
    s_k2[i] = from_f<T>(k2[i]);
  }
  // relu(x) for image rows r0-2 .. r0+R+1, columns -1 .. W; zero outside.
  const int n_in = (R + 4) * Wp * C;
  for (int i = threadIdx.x; i < n_in; i += kThreads) {
    const int ch = i % C;
    const int col = (i / C) % Wp - 1;
    const int row = i / (C * Wp) + r0 - 2;
    float v = 0.0f;
    if (row >= 0 && row < H && col >= 0 && col < W) {
      v = relu(to_f(x[img + (static_cast<long>(row) * W + col) * C + ch]));
    }
    s_in[i] = from_f<T>(v);
  }
  __syncthreads();

  // y1 = relu(conv1 + b1) for image rows r0-1 .. r0+R inside a zero ring.
  const int n_y1 = (R + 2) * Wp * C;
  for (int i = threadIdx.x; i < n_y1; i += kThreads) {
    const int co = i % C;
    const int yc = (i / C) % Wp;
    const int yr = i / (C * Wp);
    const int row = yr + r0 - 1;
    float v = 0.0f;
    if (row >= 0 && row < H && yc >= 1 && yc <= W) {
      float acc = 0.0f;
      for (int dy = 0; dy < 3; ++dy) {
        for (int dx = 0; dx < 3; ++dx) {
          const T* src = s_in + ((yr + dy) * Wp + (yc - 1 + dx)) * C;
          const T* w = s_k1 + (dy * 3 + dx) * C * C + co;
          for (int ci = 0; ci < C; ++ci) {
            acc = fmaf(to_f(src[ci]), to_f(w[ci * C]), acc);
          }
        }
      }
      v = relu(__fadd_rn(acc, b1[co]));
    }
    s_y1[i] = from_f<T>(v);
  }
  __syncthreads();

  // out = x + (conv2(y1) + b2) for image rows r0 .. r0+R-1.
  const int n_out = R * W * C;
  for (int i = threadIdx.x; i < n_out; i += kThreads) {
    const int co = i % C;
    const int col = (i / C) % W;
    const int r = i / (C * W);
    const int row = r0 + r;
    if (row >= H) break;  // i only grows: every later i is past H too
    float acc = 0.0f;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const T* src = s_y1 + ((r + dy) * Wp + (col + dx)) * C;
        const T* w = s_k2 + (dy * 3 + dx) * C * C + co;
        for (int ci = 0; ci < C; ++ci) {
          acc = fmaf(to_f(src[ci]), to_f(w[ci * C]), acc);
        }
      }
    }
    const long o = img + (static_cast<long>(row) * W + col) * C + co;
    out[o] = from_f<T>(__fadd_rn(to_f(x[o]), __fadd_rn(acc, b2[co])));
  }
}

template <typename T>
int launch(const void* x, const float* k1, const float* b1, const float* k2,
           const float* b2, void* out, int N, int H, int W, int C,
           cudaStream_t stream) {
  // Bands of about kRowsPerBand rows, evened out over H; thinner bands
  // where a wide image would not fit in shared memory.
  const int bands0 = (H + kRowsPerBand - 1) / kRowsPerBand;
  int R = (H + bands0 - 1) / bands0;
  auto smem_for = [&](int rows) {
    return (2L * 9 * C * C + (2L * rows + 6) * (W + 2) * C) *
           static_cast<long>(sizeof(T));
  };
  while (R > 1 && smem_for(R) > kMaxSmem) --R;
  const long smem = smem_for(R);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    // The attribute is the kernel's, shared by every host thread: the
    // learner and the actors launch at different shapes at once. Each
    // sets the same ceiling, so no thread can lower it under another's
    // launch (setting it to this call's smem did: a launch between
    // another thread's smaller setting and its own was refused).
    cudaError_t err = cudaFuncSetAttribute(
        resblock_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((H + R - 1) / R, N);
  resblock_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), k1, b1, k2, b2, static_cast<T*>(out), H, W,
      C, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out). Launches on `stream`
// (PyTorch's current stream) on `device`, returns cudaGetLastError() (or
// cudaErrorInvalidValue when one row band of the image does not fit in
// shared memory) so a refused launch is reported to the caller.
extern "C" int resblock_launch(const void* x, const float* k1,
                               const float* b1, const float* k2,
                               const float* b2, void* out, int N, int H,
                               int W, int C, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, k1, b1, k2, b2, out, N, H, W, C, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, k1, b1, k2, b2, out, N, H, W, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
