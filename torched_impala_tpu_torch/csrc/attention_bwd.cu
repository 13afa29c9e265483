// Windowed flash attention, backward: dQ, and dK with dV, each kernel
// recomputing the probabilities from q, k and the forward's row
// logsumexp. D = sum_d O * dO comes from the caller (the wrapper computes
// it from the saved f32 output, as the JAX package does outside its
// kernels).
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` of
// `_bwd_pallas` in torched_impala_tpu/ops/attention_pallas.py. There a
// sequential grid carries dq (or dk, dv) in VMEM scratch across the inner
// sweep; here each block owns its output rows and walks the other axis
// itself, so nothing crosses blocks and no atomics are needed.
//
//   P  = exp(q . k * scale - lse) where visible, exactly 0 elsewhere
//   dS = P * (dO . v - D)
//   dQ = scale * sum_s dS k        dK = scale * sum_t dS q
//   dV = sum_t P dO
//
// dQ: one block of 4 warps per (b, h, 8 query rows), each warp owning 2
// rows, sweeping the context in shared-memory tiles of 32 slots: lane <->
// slot for the two dot products, then lane <-> dim for dS k with dS
// broadcast by shuffles; dq stays in registers.
// dK/dV: one block per (b, h, 16 context slots), each warp owning 4 slots,
// sweeping the queries in tiles of 32 rows (q and dO in shared memory,
// rows padded to DH + 1 floats): lane <-> query for P and dS, then
// lane <-> dim for P dO and dS q; dk and dv stay in registers.
// Both skip the tiles above the causal diagonal and a row (slot) that sees
// nothing of a tile.
//
// bf16 inputs: dS is rounded to bf16 before dS k and dS q, and P before
// P dO, as the TPU kernels cast them to the operands' dtype; every sum
// is f32, and the outputs are f32 (the wrapper casts them).
//
// Bound: at the learner's shape (B = 32, T = 21, H = 4, dh = 64, S = 149,
// f32) the two kernels must read q, dO, k, v, lse, D and the segments and
// write dq, dk and dv: about 21.6 MB together, 6.5 us at 3.35 TB/s; their
// seven products of 2 T S dh operations a (b, h) are 3.6e8 f32 operations,
// 5.4 us at 67 TFLOP/s. Like the forward, these simple CUDA-core kernels
// are far from that bound.

#include "attention_common.cuh"

namespace {

using namespace attn;

// ---- dQ ------------------------------------------------------------------

constexpr int kQRowsPerWarp = 2;
constexpr int kQRows = kWarps * kQRowsPerWarp;
constexpr int kSlots = 32;

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) attention_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ dcap, const int* __restrict__ seg_q,
    const int* __restrict__ seg_ctx, float* __restrict__ dq, int Tq, int S,
    int H, int W, float scale) {
  constexpr int DPL = (DH + 31) / 32;
  __shared__ float q_s[kQRows * DH];
  __shared__ float g_s[kQRows * DH];
  __shared__ float k_s[kSlots * (DH + 1)];
  __shared__ float v_s[kSlots * (DH + 1)];
  __shared__ int segc_s[kSlots];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int t0 = blockIdx.x * kQRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows<T, DH, DH>(q_s, q, b, h, t0, kQRows, Tq, H);
  load_rows<T, DH, DH>(g_s, g, b, h, t0, kQRows, Tq, H);
  float acc[kQRowsPerWarp][DPL], lse_t[kQRowsPerWarp], d_t[kQRowsPerWarp];
  int seg_t[kQRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kQRowsPerWarp; ++r) {
    const int t = t0 + warp * kQRowsPerWarp + r;
    const bool in = t < Tq;
    seg_t[r] = in ? seg_q[static_cast<long>(b) * Tq + t] : 0;
    lse_t[r] = in ? lse[(static_cast<long>(b) * H + h) * Tq + t] : 0.0f;
    d_t[r] = in ? dcap[(static_cast<long>(b) * Tq + t) * H + h] : 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.0f;
  }

  for (int s0 = 0; s0 < S && tile_may_see(t0 + kQRows - 1, s0, W); s0 += kSlots) {
    __syncthreads();
    load_rows<T, DH, DH + 1>(k_s, k, b, h, s0, kSlots, S, H);
    load_rows<T, DH, DH + 1>(v_s, v, b, h, s0, kSlots, S, H);
    if (threadIdx.x < kSlots) {
      const int s = s0 + threadIdx.x;
      segc_s[threadIdx.x] = s < S ? seg_ctx[static_cast<long>(b) * S + s] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kQRowsPerWarp; ++r) {
      const int row = warp * kQRowsPerWarp + r, t = t0 + row;
      const int s = s0 + lane;
      const bool vis = t < Tq && s < S && visible(seg_t[r], segc_s[lane], t, s, W);
      if (!__any_sync(kFull, vis)) continue;
      float ds = 0.0f;
      if (vis) {
        float qk = 0.0f, dp = 0.0f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          qk += q_s[row * DH + d] * k_s[lane * (DH + 1) + d];
          dp += g_s[row * DH + d] * v_s[lane * (DH + 1) + d];
        }
        const float p = expf(qk * scale - lse_t[r]);
        ds = round_to<T>(p * (dp - d_t[r]));
      }
      for (int sl = 0; sl < kSlots; ++sl) {
        const float dss = __shfl_sync(kFull, ds, sl);
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < DH) acc[r][j] += dss * k_s[sl * (DH + 1) + d];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kQRowsPerWarp; ++r) {
    const int t = t0 + warp * kQRowsPerWarp + r;
    if (t >= Tq) continue;
    const long row = (static_cast<long>(b) * Tq + t) * H + h;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < DH) dq[row * DH + d] = acc[r][j] * scale;
    }
  }
}

// ---- dK / dV -------------------------------------------------------------

constexpr int kKRowsPerWarp = 4;
constexpr int kKRows = kWarps * kKRowsPerWarp;  // context slots a block
constexpr int kQTile = 32;                      // query rows a tile

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) attention_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ dcap, const int* __restrict__ seg_q,
    const int* __restrict__ seg_ctx, float* __restrict__ dk,
    float* __restrict__ dv, int Tq, int S, int H, int W, float scale) {
  constexpr int DPL = (DH + 31) / 32;
  __shared__ float k_s[kKRows * DH];
  __shared__ float v_s[kKRows * DH];
  __shared__ float q_s[kQTile * (DH + 1)];
  __shared__ float g_s[kQTile * (DH + 1)];
  __shared__ float lse_s[kQTile], d_s[kQTile];
  __shared__ int segq_s[kQTile];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int s0 = blockIdx.x * kKRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows<T, DH, DH>(k_s, k, b, h, s0, kKRows, S, H);
  load_rows<T, DH, DH>(v_s, v, b, h, s0, kKRows, S, H);
  float dk_acc[kKRowsPerWarp][DPL], dv_acc[kKRowsPerWarp][DPL];
  int seg_s[kKRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kKRowsPerWarp; ++r) {
    const int s = s0 + warp * kKRowsPerWarp + r;
    seg_s[r] = s < S ? seg_ctx[static_cast<long>(b) * S + s] : 0;
#pragma unroll
    for (int j = 0; j < DPL; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.0f;
  }

  for (int t0 = 0; t0 < Tq; t0 += kQTile) {
    if (!tile_may_see(t0 + kQTile - 1, s0, W)) continue;
    __syncthreads();
    load_rows<T, DH, DH + 1>(q_s, q, b, h, t0, kQTile, Tq, H);
    load_rows<T, DH, DH + 1>(g_s, g, b, h, t0, kQTile, Tq, H);
    if (threadIdx.x < kQTile) {
      const int t = t0 + threadIdx.x;
      const bool in = t < Tq;
      segq_s[threadIdx.x] = in ? seg_q[static_cast<long>(b) * Tq + t] : 0;
      lse_s[threadIdx.x] = in ? lse[(static_cast<long>(b) * H + h) * Tq + t] : 0.0f;
      d_s[threadIdx.x] = in ? dcap[(static_cast<long>(b) * Tq + t) * H + h] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kKRowsPerWarp; ++r) {
      const int slot = warp * kKRowsPerWarp + r, s = s0 + slot;
      const int t = t0 + lane;
      const bool vis = t < Tq && s < S && visible(segq_s[lane], seg_s[r], t, s, W);
      if (!__any_sync(kFull, vis)) continue;
      float p = 0.0f, ds = 0.0f;
      if (vis) {
        float qk = 0.0f, dp = 0.0f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          qk += q_s[lane * (DH + 1) + d] * k_s[slot * DH + d];
          dp += g_s[lane * (DH + 1) + d] * v_s[slot * DH + d];
        }
        p = expf(qk * scale - lse_s[lane]);
        ds = round_to<T>(p * (dp - d_s[lane]));
        p = round_to<T>(p);
      }
      for (int tl = 0; tl < kQTile; ++tl) {
        const float pt = __shfl_sync(kFull, p, tl);
        const float dst = __shfl_sync(kFull, ds, tl);
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < DH) {
            dv_acc[r][j] += pt * g_s[tl * (DH + 1) + d];
            dk_acc[r][j] += dst * q_s[tl * (DH + 1) + d];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kKRowsPerWarp; ++r) {
    const int s = s0 + warp * kKRowsPerWarp + r;
    if (s >= S) continue;
    const long row = (static_cast<long>(b) * S + s) * H + h;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < DH) {
        dk[row * DH + d] = dk_acc[r][j] * scale;
        dv[row * DH + d] = dv_acc[r][j];
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *dcap;
  const int *seg_q, *seg_ctx;
  float *dq, *dk, *dv;
  int B, Tq, S, H, W;
  float scale;
};

template <typename T, int DH>
int launch_dq(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Tq + kQRows - 1) / kQRows, a.B * a.H);
  attention_dq_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.lse, a.dcap, a.seg_q, a.seg_ctx, a.dq, a.Tq, a.S,
      a.H, a.W, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_dkv(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.S + kKRows - 1) / kKRows, a.B * a.H);
  attention_dkv_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.lse, a.dcap, a.seg_q, a.seg_ctx, a.dk, a.dv, a.Tq,
      a.S, a.H, a.W, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// kind 0 launches dQ, kind 1 dK/dV.
template <typename T, int DH>
int launch_kind(int kind, const Args& a, cudaStream_t stream) {
  return kind == 0 ? launch_dq<T, DH>(a, stream) : launch_dkv<T, DH>(a, stream);
}

template <typename T>
int launch_dh(int kind, int dh, const Args& a, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_kind<T, 16>(kind, a, stream);
    case 32: return launch_kind<T, 32>(kind, a, stream);
    case 64: return launch_kind<T, 64>(kind, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch(int kind, const void* q, const void* k, const void* v, const void* g,
           const float* lse, const float* dcap, const int* seg_q,
           const int* seg_ctx, float* dq, float* dk, float* dv, int B, int Tq,
           int S, int H, int dh, int W, float scale, int is_bf16, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, g, lse, dcap, seg_q, seg_ctx, dq, dk, dv, B, Tq, S, H, W, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dh<__nv_bfloat16>(kind, dh, a, st) : launch_dh<float>(kind, dh, a, st);
}

}  // namespace

// Both launch on `stream` (PyTorch's current stream) on `device` and
// return cudaGetLastError(). is_bf16 selects bfloat16 q/k/v/dO (else
// float32); dh is 16, 32 or 64; scale is 1/sqrt(dh), rounded to float by
// the caller. dq is [B, T, H, dh], dk and dv [B, S, H, dh], all float32.
extern "C" int attention_dq_launch(const void* q, const void* k, const void* v,
                                   const void* g, const float* lse,
                                   const float* dcap, const int* seg_q,
                                   const int* seg_ctx, float* dq, int B, int Tq,
                                   int S, int H, int dh, int W, float scale,
                                   int is_bf16, int device, void* stream) {
  return launch(0, q, k, v, g, lse, dcap, seg_q, seg_ctx, dq, nullptr, nullptr, B, Tq,
                S, H, dh, W, scale, is_bf16, device, stream);
}

extern "C" int attention_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* g, const float* lse,
                                    const float* dcap, const int* seg_q,
                                    const int* seg_ctx, float* dk, float* dv,
                                    int B, int Tq, int S, int H, int dh, int W,
                                    float scale, int is_bf16, int device,
                                    void* stream) {
  return launch(1, q, k, v, g, lse, dcap, seg_q, seg_ctx, nullptr, dk, dv, B, Tq, S,
                H, dh, W, scale, is_bf16, device, stream);
}
