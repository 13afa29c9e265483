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
// halo per band), and keeps conv1's output in shared memory only. conv2's
// SAME padding pads conv1's OUTPUT with zeros, so the intermediate y1
// lives inside a ZERO ring (never conv1 evaluated outside the image), and
// the two halo rows of y1 are conv1 computed twice, once in each
// neighbouring band.
//
// Numerics, as the TPU kernel's: operands in x's type (the f32 kernels
// are rounded to it on staging), every product accumulated in float32,
// b1 added in float32, the relu'd intermediate rounded to x's type, b2
// and the skip added in float32, one rounding of the result.
//
// Two kernels, picked by x's type:
//
// bfloat16: `resblock_bf16_wgmma_kernel`, an implicit GEMM on Hopper's
// tensor cores. A 3x3 SAME conv is nine shifted [pixels, C] x [C, C]
// products (the TPU kernel's `_nine_shift`). A warpgroup takes a tile of
// 64 output pixels of the band (rows x columns flattened, so W need not
// divide anything) and, for each tap and each 16 input channels, issues
// `wgmma.mma_async m64nNk16` (bf16 operands, f32 accumulators, N = 16
// or 32). A comes from registers, loaded with `ldmatrix` out of the
// shared-memory band: each lane gives the address of one pixel's 8
// channels, so the shifted, zero-padded window is an address offset and
// nothing is gathered in device memory; conv1 applies relu(x) to the A
// fragments, so the band holds x itself and the skip reads it there. B,
// the tap's [C, C] slice, is staged once per block in the core-matrix
// layout the descriptor reads (8 output channels x 8 input channels, 128
// contiguous bytes; no swizzle). C is zero-padded to CP, a multiple of 16
// (zeros add exact zeros), up to CP = 80. Up to CP = 64 both kernels stay
// in shared memory and two blocks share an SM; at CP = 80 they do not
// fit together, so one block an SM stages each conv's kernel before that
// conv, per item. Pixels past the band's last one are computed on a clamped
// address and their rows stored to a trash row. Each pixel's 16-byte
// channel chunks are XOR-swizzled by the pixel index so that the 8 lanes
// of one `ldmatrix` or `stmatrix` phase hit 8 different bank groups.
//
// A block is persistent: it stages both kernels once (f32 -> bf16; at
// CP = 80 once per item and conv), then walks (image, band) items. Per item: `cp.async` brings the band of x
// in; conv1's epilogue adds b1, applies the relu and writes y1 with one
// `stmatrix` per 16 channels; conv2's epilogue reads the skip with one
// `ldmatrix` in the accumulators' layout, adds b2 and the skip in f32 and
// writes the bf16 result over the skip in the band; a last pass copies
// the band's output rows to device memory 16 bytes at a time. The band
// height R and the grid come from the wrapper's launch plan
// (ops/conv_block_cuda.py:`bf16_launch_plan`); the launcher works out the
// shared memory from its own layout and refuses a band that does not fit.
//
// Bound: at the learner's shapes (N = 672 images; H x W x C of 42x42x16,
// 21x21x32, 11x11x32) the block must read x and write out once, 2 bytes
// an element: 2 x 672 x 42 x 42 x 16 x 2 B = 76 MB at the largest shape,
// 23 us at 3.35 TB/s, against 2 x 2 x 9 x C x C x H x W x N = 10.9 GFLOP,
// 11 us at the bf16 tensor-core rate (989 TFLOP/s): bound by its bytes.
// Within a block the stages run one after another behind barriers, with
// one commit and wait per tile; they overlap only across the two blocks
// resident on an SM. N = 16 or 32 keeps each wgmma small.
//
// float32: `resblock_f32_kernel`, the CUDA-core kernel: 256 threads, each
// computes one (pixel, output channel) at a time as 9 x C fused
// multiply-adds out of shared memory (the f32 products stay f32, as the
// JAX function computes them; TF32 would miss the f32 gate).
//
// Past both kernels' shared memory: `resblock_general_conv_kernel<T,
// kSecond>`, a simple CUDA-core kernel for either type, in two launches
// and a scratch y1 of x's type. The two kernels above stage a conv's
// whole [3, 3, C, C] kernel (and a band of rows) in shared memory, which
// caps them: bf16 at C = 80 (or a one-row band too wide), f32 where two
// staged kernels and a one-row band pass 227 KB (C = 48 from W = 42, any W
// from C = 57). The wrapper routes such shapes here before launch
// (ops/conv_block_cuda.py:route). One thread computes one (pixel, output
// channel) as 9 x C fused multiply-adds, reading x (or y1) and the
// weights through L1/L2: a warp's 32 output channels read one input
// pixel's channels as a broadcast and 32 neighbouring weights. The first
// launch writes y1 = relu(conv1(relu(x)) + b1) rounded to x's type, the
// second out = x + (conv2(y1) + b2), rounded once, with the numerics of
// the kernels above (operands in x's type, f32 sums). Bound: each launch
// reads its input and writes its output once, and does 2 x 9 x C x C
// operations a pixel on the CUDA cores; it is the kernel that is right
// for widths no preset uses, and its times stand in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 227 * 1024;     // bytes a block may use

// max(v, 0) that passes NaN through, as jnp.maximum and torch.relu do.
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// The launch attribute is the kernel's, shared by every host thread: the
// learner and the actors launch at different shapes at once. Each call
// sets the same ceiling, so no thread can lower it under another's
// launch (setting it to each call's own size did: a launch between
// another thread's smaller setting and its own was refused).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

// ---------------------------------------------------------------------
// float32: the CUDA-core kernel.

constexpr int kF32Threads = 256;
constexpr int kRowsPerBand = 8;          // target band height

__global__ void __launch_bounds__(kF32Threads)
    resblock_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ k1,
                        const float* __restrict__ b1,
                        const float* __restrict__ k2,
                        const float* __restrict__ b2, float* __restrict__ out,
                        int H, int W, int C, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const int Wp = W + 2;
  const int kk = 9 * C * C;
  float* s_k1 = reinterpret_cast<float*>(smem);
  float* s_k2 = s_k1 + kk;
  float* s_in = s_k2 + kk;                   // [R + 4][Wp][C]
  float* s_y1 = s_in + (R + 4) * Wp * C;     // [R + 2][Wp][C]
  const long img = static_cast<long>(n) * H * W * C;

  for (int i = threadIdx.x; i < kk; i += kF32Threads) {
    s_k1[i] = k1[i];
    s_k2[i] = k2[i];
  }
  // relu(x) for image rows r0-2 .. r0+R+1, columns -1 .. W; zero outside.
  const int n_in = (R + 4) * Wp * C;
  for (int i = threadIdx.x; i < n_in; i += kF32Threads) {
    const int ch = i % C;
    const int col = (i / C) % Wp - 1;
    const int row = i / (C * Wp) + r0 - 2;
    float v = 0.0f;
    if (row >= 0 && row < H && col >= 0 && col < W) {
      v = relu(x[img + (static_cast<long>(row) * W + col) * C + ch]);
    }
    s_in[i] = v;
  }
  __syncthreads();

  // y1 = relu(conv1 + b1) for image rows r0-1 .. r0+R inside a zero ring.
  const int n_y1 = (R + 2) * Wp * C;
  for (int i = threadIdx.x; i < n_y1; i += kF32Threads) {
    const int co = i % C;
    const int yc = (i / C) % Wp;
    const int yr = i / (C * Wp);
    const int row = yr + r0 - 1;
    float v = 0.0f;
    if (row >= 0 && row < H && yc >= 1 && yc <= W) {
      float acc = 0.0f;
      for (int dy = 0; dy < 3; ++dy) {
        for (int dx = 0; dx < 3; ++dx) {
          const float* src = s_in + ((yr + dy) * Wp + (yc - 1 + dx)) * C;
          const float* w = s_k1 + (dy * 3 + dx) * C * C + co;
          for (int ci = 0; ci < C; ++ci) {
            acc = fmaf(src[ci], w[ci * C], acc);
          }
        }
      }
      v = relu(__fadd_rn(acc, b1[co]));
    }
    s_y1[i] = v;
  }
  __syncthreads();

  // out = x + (conv2(y1) + b2) for image rows r0 .. r0+R-1.
  const int n_out = R * W * C;
  for (int i = threadIdx.x; i < n_out; i += kF32Threads) {
    const int co = i % C;
    const int col = (i / C) % W;
    const int r = i / (C * W);
    const int row = r0 + r;
    if (row >= H) break;  // i only grows: every later i is past H too
    float acc = 0.0f;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const float* src = s_y1 + ((r + dy) * Wp + (col + dx)) * C;
        const float* w = s_k2 + (dy * 3 + dx) * C * C + co;
        for (int ci = 0; ci < C; ++ci) {
          acc = fmaf(src[ci], w[ci * C], acc);
        }
      }
    }
    const long o = img + (static_cast<long>(row) * W + col) * C + co;
    out[o] = __fadd_rn(x[o], __fadd_rn(acc, b2[co]));
  }
}

int launch_f32(const float* x, const float* k1, const float* b1,
               const float* k2, const float* b2, float* out, int N, int H,
               int W, int C, cudaStream_t stream) {
  // Bands of about kRowsPerBand rows, evened out over H; thinner bands
  // where a wide image would not fit in shared memory.
  const int bands0 = (H + kRowsPerBand - 1) / kRowsPerBand;
  int R = (H + bands0 - 1) / bands0;
  auto smem_for = [&](int rows) {
    return (2L * 9 * C * C + (2L * rows + 6) * (W + 2) * C) *
           static_cast<long>(sizeof(float));
  };
  while (R > 1 && smem_for(R) > kMaxSmem) --R;
  const long smem = smem_for(R);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(resblock_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + R - 1) / R, N);
  resblock_f32_kernel<<<grid, kF32Threads, smem, stream>>>(
      x, k1, b1, k2, b2, out, H, W, C, R);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// bfloat16: the wgmma implicit GEMM.

constexpr int kWarpgroups = 2;
constexpr int kBf16Threads = 128 * kWarpgroups;
constexpr int kTile = 64;                // output pixels a wgmma M tile

template <int CP>
struct Shape {
  static constexpr int CH = CP / 8;                    // 16-byte chunks a pixel
  static constexpr int KS = CP / 16;                   // k16 steps a tap
  static constexpr int NT = CP % 32 == 0 ? 32 : 16;    // wgmma N
  static constexpr int NTILES = CP / NT;
  static constexpr int ACC = NT / 2;                   // f32 accumulators a thread
  // gcd(CH, 8): the swizzle's period in chunks.
  static constexpr int G = CH % 8 == 0 ? 8 : (CH % 4 == 0 ? 4 : 2);
  // Taps whose A fragments are loaded before one commit and wait: all
  // nine while the registers allow.
  static constexpr int TAPS = CP <= 32 ? 9 : 3;
  static constexpr int kWeights = 9 * CP * CP;         // elements a kernel
  // Above CP = 64 the two kernels do not fit in shared memory together:
  // each is staged before its conv, and one block takes an SM.
  static constexpr bool kPerConv = CP > 64;
  static constexpr int kKernels = kPerConv ? 1 : 2;    // kernels in shared memory
};

// Index, in 16-byte chunks, of chunk `chunk` of band pixel `q`.
template <int CP>
__device__ __forceinline__ int chunk_at(int q, int chunk) {
  using S = Shape<CP>;
  return q * S::CH + (chunk ^ ((q / (8 / S::G)) % S::G));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, no swizzle: start address, LBO (the
// stride between core matrices along K) and SBO (along N), in 16 bytes.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
          addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// Two floats as the bf16 pair of one register (lo in the low half), and
// back.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] += a[64 x 16] (registers) x b[16 x N] (shared, descriptor).
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                                      uint64_t b);

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
      "p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16],
                                          const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// relu of the two bf16 in a register; NaN passes through.
__device__ __forceinline__ uint32_t relu2(uint32_t v) {
  uint32_t r;
  asm("max.NaN.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(v), "r"(0u));
  return r;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// One warpgroup's 64-pixel tile of a 3x3 conv: acc = sum over the nine
// taps of A (the band `src`, [rows][Wp][CP] in swizzled chunks; relu'd
// in registers when kRelu) times the tap's weights at `w` (core-matrix
// layout). `q0` is this lane's pixel under tap (0, 0), as a band index.
template <int CP, bool kRelu>
__device__ __forceinline__ void conv_tile(
    float (&acc)[Shape<CP>::NTILES][Shape<CP>::ACC], uint32_t src, uint32_t w,
    int q0, int Wp) {
  using S = Shape<CP>;
  const int half = (threadIdx.x & 31) >> 4;  // lanes 16-31: channels 8-15
  __syncwarp();  // ldmatrix and wgmma need the warp converged
#pragma unroll
  for (int nt = 0; nt < S::NTILES; ++nt) {
#pragma unroll
    for (int i = 0; i < S::ACC; ++i) acc[nt][i] = 0.0f;
  }
#pragma unroll
  for (int t0 = 0; t0 < 9; t0 += S::TAPS) {
    uint32_t a[S::TAPS][S::KS][4];
#pragma unroll
    for (int tt = 0; tt < S::TAPS; ++tt) {
      const int t = t0 + tt;
      const int q = q0 + (t / 3) * Wp + t % 3;
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
        ldmatrix_x4(a[tt][ks], src + 16 * chunk_at<CP>(q, 2 * ks + half));
        if (kRelu) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[tt][ks][e] = relu2(a[tt][ks][e]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < S::NTILES; ++nt) fence_acc(acc[nt]);
    wgmma_fence();
#pragma unroll
    for (int tt = 0; tt < S::TAPS; ++tt) {
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
#pragma unroll
        for (int nt = 0; nt < S::NTILES; ++nt) {
          const int core = ((t0 + tt) * S::CH + 2 * ks) * S::CH + nt * S::NT / 8;
          wgmma<S::NT>(acc[nt], a[tt][ks],
                       descriptor(w + 128 * core, 128 * S::CH, 128));
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int nt = 0; nt < S::NTILES; ++nt) fence_acc(acc[nt]);
  }
}

// One kernel, HWIO f32 -> bf16 core matrices: (tap, ci / 8, co / 8), row
// co % 8, column ci % 8; zero past C. A thread takes units of 4 output
// channels, kBatch at a time, so its loads are in flight together. The
// caller fences the async proxy (wgmma reads these) before a barrier.
template <int CP>
__device__ __forceinline__ void stage_kernel(__nv_bfloat16* s_w,
                                             const float* __restrict__ k,
                                             int C) {
  using S = Shape<CP>;
  constexpr int kUnits = S::kWeights / 4;  // (tap, ci, co / 4)
  constexpr int kBatch = 8;
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0;
  for (int base = threadIdx.x; base < kUnits; base += kBf16Threads * kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int u = base + b * kBf16Threads;
      const int co = 4 * (u % (CP / 4));
      const int ci = (u / (CP / 4)) % CP;
      const int tap = u / (CP * CP / 4);
      v[b] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (u >= kUnits || ci >= C || co >= C) continue;
      const float* src = k + (tap * C + ci) * C + co;
      if (vec) {
        v[b] = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        v[b].x = src[0];
        v[b].y = co + 1 < C ? src[1] : 0.0f;
        v[b].z = co + 2 < C ? src[2] : 0.0f;
        v[b].w = co + 3 < C ? src[3] : 0.0f;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int u = base + b * kBf16Threads;
      if (u >= kUnits) break;
      const int co = 4 * (u % (CP / 4));
      const int ci = (u / (CP / 4)) % CP;
      const int tap = u / (CP * CP / 4);
      const int core = (tap * S::CH + ci / 8) * S::CH + co / 8;
      __nv_bfloat16* dst = s_w + core * 64 + (co % 8) * 8 + ci % 8;
      dst[0] = __float2bfloat16_rn(v[b].x);
      dst[8] = __float2bfloat16_rn(v[b].y);
      dst[16] = __float2bfloat16_rn(v[b].z);
      dst[24] = __float2bfloat16_rn(v[b].w);
    }
  }
}

// A persistent block: it stages both kernels once (kPerConv: each before
// its conv, per item), then walks the (image, band) items gridDim.x apart.
template <int CP>
__global__ void __launch_bounds__(kBf16Threads, Shape<CP>::kPerConv ? 1 : 2)
    resblock_bf16_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                               const float* __restrict__ k1,
                               const float* __restrict__ b1,
                               const float* __restrict__ k2,
                               const float* __restrict__ b2,
                               __nv_bfloat16* __restrict__ out, int H, int W,
                               int C, int R, int bands, int items) {
  using S = Shape<CP>;
  extern __shared__ __align__(128) unsigned char smem_bf16[];
  const int Wp = W + 2;
  const int tid = threadIdx.x;
  // [k1, k2 (kPerConv: the current conv's only): 9 taps x CH x CH core
  // matrices of 8 x 8 bf16][b1, b2: CP f32]
  // [trash: 16 bytes][band: (R + 4) x Wp pixels][y1: (R + 2) x Wp pixels],
  // CH chunks a pixel. stmatrix rows past a band's last pixel go to trash.
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  float* s_b = reinterpret_cast<float*>(s_w + S::kKernels * S::kWeights);
  uint4* s_in = reinterpret_cast<uint4*>(s_b + 2 * CP) + 1;
  uint4* s_y1 = s_in + (R + 4) * Wp * S::CH;
  const uint32_t trash = smem_addr(s_in - 1);
  const uint32_t in_addr = smem_addr(s_in);
  const uint32_t y1_addr = smem_addr(s_y1);
  const uint32_t w1 = smem_addr(s_w);
  const uint32_t w2 = w1 + 2 * (S::kKernels - 1) * S::kWeights;
  const bool vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

  if (!S::kPerConv) {
    stage_kernel<CP>(s_w, k1, C);
    stage_kernel<CP>(s_w + S::kWeights, k2, C);
  }
  for (int i = tid; i < 2 * CP; i += kBf16Threads) {
    const int co = i % CP;
    s_b[i] = co < C ? (i < CP ? b1 : b2)[co] : 0.0f;
  }
  // y1's ring columns stay zero for every item: the epilogue writes only
  // columns 1 .. W.
  for (int i = tid; i < (R + 2) * Wp * S::CH; i += kBf16Threads) {
    s_y1[i] = make_uint4(0, 0, 0, 0);
  }
  // The weights are read by wgmma (the async proxy).
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const int wg = tid / 128;
  const int lane = tid & 31;
  const int warp_row = 16 * ((tid / 32) % 4);  // this warp's 16 rows of a tile
  // The tile row (pixel) whose address this lane gives ldmatrix and
  // stmatrix, and the first of the two channels it holds in each chunk.
  const int ld_row = warp_row + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int ld_half = lane >> 4;  // ... and its channel chunk of a pair
  const int col_pair = 2 * (lane & 3);
  float acc[S::NTILES][S::ACC];

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int n = item / bands;
    const int r0 = (item % bands) * R;
    const long img = static_cast<long>(n) * H * W * C;
    // x (conv1 applies the relu to its A fragments; the skip reads x from
    // here) for image rows r0-2 .. r0+R+1, columns -1 .. W; zero outside
    // the image and past C.
    const int n_in = (R + 4) * Wp * S::CH;
    for (int i = tid; i < n_in; i += kBf16Threads) {
      const int chunk = i % S::CH;
      const int q = i / S::CH;
      const int col = q % Wp - 1;
      const int row = q / Wp + r0 - 2;
      uint4* dst = s_in + chunk_at<CP>(q, chunk);
      if (row >= 0 && row < H && col >= 0 && col < W && chunk * 8 < C) {
        const __nv_bfloat16* src =
            x + img + (static_cast<long>(row) * W + col) * C + chunk * 8;
        if (vec) {
          cp_async16(smem_addr(dst), src);
        } else {
          union {
            uint4 u;
            unsigned short e[8];
          } c;
          for (int k = 0; k < 8; ++k) {
            c.e[k] = chunk * 8 + k < C ? __bfloat16_as_ushort(src[k]) : 0;
          }
          *dst = c.u;
        }
      } else {
        *dst = make_uint4(0, 0, 0, 0);
      }
    }
    // y1's band rows inside the image are [ylo, yhi) (band row yr is image
    // row r0 - 1 + yr, its taps band rows yr .. yr + 2); the rows outside
    // are zeros.
    const int ylo = r0 == 0 ? 1 : 0;
    const int yhi = min(R + 2, H - r0 + 1);
    const int n_zero = (R + 2 - (yhi - ylo)) * Wp * S::CH;
    for (int i = tid; i < n_zero; i += kBf16Threads) {
      const int k = i / (Wp * S::CH);
      const int yr = k < ylo ? k : yhi + k - ylo;
      s_y1[yr * Wp * S::CH + i % (Wp * S::CH)] = make_uint4(0, 0, 0, 0);
    }
    if (S::kPerConv) {
      // The last item's conv2 is done with the weights (the barrier at
      // its end).
      stage_kernel<CP>(s_w, k1, C);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // conv1: y1 = relu(conv1(relu(x)) + b1), rounded to bf16 and stored
    // by stmatrix (rows past the band's last pixel go to the trash row).
    const int npix1 = (yhi - ylo) * W;
    for (int tile = wg; tile * kTile < npix1; tile += kWarpgroups) {
      const int p = tile * kTile + ld_row;
      const int pc = min(p, npix1 - 1);
      conv_tile<CP, true>(acc, in_addr, w1, (ylo + pc / W) * Wp + pc % W, Wp);
      const int q = (ylo + pc / W) * Wp + pc % W + 1;
#pragma unroll
      for (int nt = 0; nt < S::NTILES; ++nt) {
#pragma unroll
        for (int kp = 0; kp < S::NT / 16; ++kp) {
          uint32_t r[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            // Register m: channel chunk 2 kp + m / 2, rows g (+ 8 if m odd).
            const int i = 8 * kp + 4 * (m / 2) + 2 * (m % 2);
            const int co = nt * S::NT + 16 * kp + 8 * (m / 2) + col_pair;
            // Channels past C stay zero even where a non-finite x met a
            // zero-padded weight.
            r[m] = pack_bf16(co < C ? relu(__fadd_rn(acc[nt][i], s_b[co])) : 0.0f,
                             co + 1 < C ? relu(__fadd_rn(acc[nt][i + 1], s_b[co + 1])) : 0.0f);
          }
          const int chunk = nt * S::NT / 8 + 2 * kp + ld_half;
          stmatrix_x4(p < npix1 ? y1_addr + 16 * chunk_at<CP>(q, chunk) : trash, r);
        }
      }
    }
    __syncthreads();
    if (S::kPerConv) {
      stage_kernel<CP>(s_w, k2, C);  // over k1: conv1 is done with it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }

    // conv2 over the band's output rows inside the image: x + (conv2(y1) +
    // b2), with x read from the band (row + 2, column + 1) in the
    // accumulators' layout by ldmatrix, and the result stored over it.
    const int nrows = min(R, H - r0);
    const int npix2 = nrows * W;
    for (int tile = wg; tile * kTile < npix2; tile += kWarpgroups) {
      const int p = tile * kTile + ld_row;
      const int pc = min(p, npix2 - 1);
      conv_tile<CP, false>(acc, y1_addr, w2, (pc / W) * Wp + pc % W, Wp);
      const int q = (pc / W + 2) * Wp + pc % W + 1;
#pragma unroll
      for (int nt = 0; nt < S::NTILES; ++nt) {
#pragma unroll
        for (int kp = 0; kp < S::NT / 16; ++kp) {
          const int chunk = nt * S::NT / 8 + 2 * kp + ld_half;
          const uint32_t at = in_addr + 16 * chunk_at<CP>(q, chunk);
          uint32_t r[4];
          ldmatrix_x4(r, at);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int i = 8 * kp + 4 * (m / 2) + 2 * (m % 2);
            const int co = nt * S::NT + 16 * kp + 8 * (m / 2) + col_pair;
            const float2 skip = unpack_bf16(r[m]);
            r[m] = pack_bf16(__fadd_rn(skip.x, __fadd_rn(acc[nt][i], s_b[CP + co])),
                             __fadd_rn(skip.y, __fadd_rn(acc[nt][i + 1], s_b[CP + co + 1])));
          }
          stmatrix_x4(p < npix2 ? at : trash, r);
        }
      }
    }
    __syncthreads();

    // out: the band's output rows, 16 bytes at a time where C allows.
    const long o = img + static_cast<long>(r0) * W * C;
    if (C % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
      const int cw = C / 8;  // chunks a pixel in out
      for (int i = tid; i < npix2 * cw; i += kBf16Threads) {
        const int pe = i / cw;
        const int q = (pe / W + 2) * Wp + pe % W + 1;
        *reinterpret_cast<uint4*>(out + o + 8L * i) = s_in[chunk_at<CP>(q, i % cw)];
      }
    } else {
      for (int i = tid; i < npix2 * C; i += kBf16Threads) {
        const int pe = i / C;
        const int q = (pe / W + 2) * Wp + pe % W + 1;
        const int ch = i % C;
        out[o + i] = reinterpret_cast<const __nv_bfloat16*>(
            s_in + chunk_at<CP>(q, ch / 8))[ch % 8];
      }
    }
    __syncthreads();  // the next item overwrites the band and y1
  }
}

// Bytes of shared memory the bf16 kernel takes at band height R (the
// wrapper's launch plan mirrors this to choose R and the blocks an SM).
template <int CP>
long bf16_smem_bytes(int R, int W) {
  return 2L * Shape<CP>::kKernels * Shape<CP>::kWeights + 2L * CP * 4 + 16 +
         (2L * R + 6) * (W + 2) * CP * 2;
}

template <int CP>
int launch_bf16(const __nv_bfloat16* x, const float* k1, const float* b1,
                const float* k2, const float* b2, __nv_bfloat16* out, int N,
                int H, int W, int C, int R, int blocks, cudaStream_t stream) {
  if (R < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long smem = bf16_smem_bytes<CP>(R, W);
  const long items = static_cast<long>(N) * ((H + R - 1) / R);
  if (smem > kMaxSmem || items > 0x7FFFFFFFL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(resblock_bf16_wgmma_kernel<CP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  resblock_bf16_wgmma_kernel<CP><<<blocks, kBf16Threads, smem, stream>>>(
      x, k1, b1, k2, b2, out, H, W, C, R, (H + R - 1) / R,
      static_cast<int>(items));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// Either type, any shape: the general kernel in two launches.

constexpr int kGeneralThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (sizeof(T) == 2) {
    return __float2bfloat16(v);
  } else {
    return v;
  }
}

// kSecond = false: out = y1 = relu(conv1(relu(in)) + b) in T, in = x.
// kSecond = true: out = x + (conv2(in) + b) in T, in = y1.
template <typename T, bool kSecond>
__global__ void __launch_bounds__(kGeneralThreads)
    resblock_general_conv_kernel(const T* __restrict__ x, const T* __restrict__ in,
                                 const float* __restrict__ k, const float* __restrict__ b,
                                 T* __restrict__ out, int H, int W, int C, long total) {
  const long i = static_cast<long>(blockIdx.x) * kGeneralThreads + threadIdx.x;
  if (i >= total) return;
  const int co = static_cast<int>(i % C);
  const long pix = i / C;
  const int col = static_cast<int>(pix % W);
  const int row = static_cast<int>((pix / W) % H);
  const long img = pix / (static_cast<long>(W) * H);
  float acc = 0.0f;
  for (int dy = 0; dy < 3; ++dy) {
    const int r = row + dy - 1;
    if (r < 0 || r >= H) continue;
    for (int dx = 0; dx < 3; ++dx) {
      const int c = col + dx - 1;
      if (c < 0 || c >= W) continue;
      const T* src = in + ((img * H + r) * W + c) * C;
      const float* w = k + (dy * 3 + dx) * static_cast<long>(C) * C + co;
      for (int ci = 0; ci < C; ++ci) {
        float a = to_f32(src[ci]);
        if (!kSecond) a = relu(a);
        // The weight rounded to x's type, as the tuned kernels stage it.
        const float wv = to_f32(from_f32<T>(w[static_cast<long>(ci) * C]));
        acc = fmaf(a, wv, acc);
      }
    }
  }
  if (kSecond) {
    out[i] = from_f32<T>(__fadd_rn(to_f32(x[i]), __fadd_rn(acc, b[co])));
  } else {
    out[i] = from_f32<T>(relu(__fadd_rn(acc, b[co])));
  }
}

template <typename T>
int launch_general(const void* x, const float* k1, const float* b1, const float* k2,
                   const float* b2, void* out, void* y1, int N, int H, int W, int C,
                   cudaStream_t stream) {
  const long total = static_cast<long>(N) * H * W * C;
  const long blocks = (total + kGeneralThreads - 1) / kGeneralThreads;
  if (blocks > 0x7FFFFFFFL) return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y1);
  resblock_general_conv_kernel<T, false><<<blocks, kGeneralThreads, 0, stream>>>(
      xt, xt, k1, b1, yt, H, W, C, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  resblock_general_conv_kernel<T, true><<<blocks, kGeneralThreads, 0, stream>>>(
      xt, yt, k2, b2, static_cast<T*>(out), H, W, C, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point launches on `stream` (PyTorch's current stream) on
// `device` and return cudaGetLastError(), or cudaErrorInvalidValue for a
// shape the kernel does not take, so a refused launch reaches the caller.

// x and out float32. Returns cudaErrorInvalidValue when one row band of
// the image does not fit in shared memory.
extern "C" int resblock_f32_launch(const float* x, const float* k1,
                                   const float* b1, const float* k2,
                                   const float* b2, float* out, int N, int H,
                                   int W, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_f32(x, k1, b1, k2, b2, out, N, H, W, C,
                    static_cast<cudaStream_t>(stream));
}

// x and out bfloat16; R (band height) and blocks (the persistent grid)
// from the wrapper's launch plan. Returns cudaErrorInvalidValue when C > 80
// or when a band of R rows does not fit in shared memory.
extern "C" int resblock_bf16_launch(const void* x, const float* k1,
                                    const float* b1, const float* k2,
                                    const float* b2, void* out, int N, int H,
                                    int W, int C, int R, int blocks,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 15) / 16 * 16) {
    case 16: return launch_bf16<16>(xb, k1, b1, k2, b2, ob, N, H, W, C, R, blocks, s);
    case 32: return launch_bf16<32>(xb, k1, b1, k2, b2, ob, N, H, W, C, R, blocks, s);
    case 48: return launch_bf16<48>(xb, k1, b1, k2, b2, ob, N, H, W, C, R, blocks, s);
    case 64: return launch_bf16<64>(xb, k1, b1, k2, b2, ob, N, H, W, C, R, blocks, s);
    case 80: return launch_bf16<80>(xb, k1, b1, k2, b2, ob, N, H, W, C, R, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, out and the scratch y1 [N, H, W, C] of x's type (bfloat16 where
// is_bf16, else float32): the general kernel, any C and W, two launches.
extern "C" int resblock_general_launch(const void* x, const float* k1, const float* b1,
                                       const float* k2, const float* b2, void* out, void* y1,
                                       int N, int H, int W, int C, int is_bf16, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_general<__nv_bfloat16>(x, k1, b1, k2, b2, out, y1, N, H, W, C, s)
                 : launch_general<float>(x, k1, b1, k2, b2, out, y1, N, H, W, C, s);
}
