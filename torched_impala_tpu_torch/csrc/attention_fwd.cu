// Windowed flash attention, forward: the online-softmax output and the row
// logsumexp, with visibility derived from the segment ids in the kernel.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `_forward` of
// torched_impala_tpu/ops/attention_pallas.py. The TPU kernel walks a
// sequential grid over 128 x 512 tiles with the running max, normalizer
// and accumulator in VMEM scratch and the products on the MXU. Here blocks
// run in parallel, so each block owns whole query rows and walks the
// context itself.
//
// Design: one block of 4 warps per (b, h, 8 query rows); each warp owns 2
// rows. The context streams through shared memory in tiles of 32 slots
// (k, v converted to f32; k's rows padded to DH + 1 floats so that 32
// lanes reading 32 different rows hit 32 banks). For each of its rows a
// warp maps lane <-> slot for the logits (q . k over DH), takes the tile
// max and sum with shuffles, rescales its accumulator by
// alpha = exp(m_old - m_new), and then maps lane <-> output dim for
// P V, broadcasting each slot's probability with a shuffle. m, l and the
// accumulator (DH / 32 floats a lane) stay in registers. Tiles past the
// causal diagonal end the sweep (`tile_may_see`); a row that sees nothing
// of a tile skips it (exact: p = 0 changes neither m, l nor acc). A row
// that sees nothing at all writes zeros and lse = -1e30 (finite).
//
// bf16 inputs: the probabilities are rounded to bf16 before P V, as the
// TPU kernel feeds p in v's dtype to the MXU; every sum is f32.
//
// Bound: at the learner's shape (B = 32, T = 21, H = 4, dh = 64, S = 149,
// f32) the kernel must read q (0.69 MB), k and v (4.88 MB each) and write
// out (0.69 MB) and lse: about 11.1 MB, 3.3 us at 3.35 TB/s; the products
// are 4 B H T S dh = 1.0e8 f32 operations, 1.5 us at 67 TFLOP/s. This
// simple kernel runs on the CUDA cores, with no tensor cores, TMA or
// pipelining, and reloads k and v for every block of 8 rows (from L2),
// so it is far from that bound; wgmma tiles are later work.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows a block
constexpr int kSlots = 32;                    // context slots a tile

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ seg_q, const int* __restrict__ seg_ctx,
    float* __restrict__ out, float* __restrict__ lse, int Tq, int S, int H,
    int W, float scale) {
  constexpr int DPL = (DH + 31) / 32;  // output dims a lane
  __shared__ float q_s[kRows * DH];
  __shared__ float k_s[kSlots * (DH + 1)];
  __shared__ float v_s[kSlots * DH];
  __shared__ int segc_s[kSlots];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int t0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows<T, DH, DH>(q_s, q, b, h, t0, kRows, Tq, H);
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
  int seg_t[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = t0 + warp * kRowsPerWarp + r;
    m[r] = kNegInf;
    l[r] = 0.0f;
    seg_t[r] = t < Tq ? seg_q[static_cast<long>(b) * Tq + t] : 0;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.0f;
  }

  for (int s0 = 0; s0 < S && tile_may_see(t0 + kRows - 1, s0, W); s0 += kSlots) {
    __syncthreads();  // the previous tile is consumed
    load_rows<T, DH, DH + 1>(k_s, k, b, h, s0, kSlots, S, H);
    load_rows<T, DH, DH>(v_s, v, b, h, s0, kSlots, S, H);
    if (threadIdx.x < kSlots) {
      const int s = s0 + threadIdx.x;
      segc_s[threadIdx.x] = s < S ? seg_ctx[static_cast<long>(b) * S + s] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r, t = t0 + row;
      const int s = s0 + lane;
      const bool vis = t < Tq && s < S && visible(seg_t[r], segc_s[lane], t, s, W);
      if (!__any_sync(kFull, vis)) continue;
      float logit = kNegInf;
      if (vis) {
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < DH; ++d) dot += q_s[row * DH + d] * k_s[lane * (DH + 1) + d];
        logit = dot * scale;
      }
      const float m_new = fmaxf(m[r], warp_max(logit));
      const float alpha = expf(m[r] - m_new);
      const float p = vis ? expf(logit - m_new) : 0.0f;
      l[r] = alpha * l[r] + warp_sum(p);
      m[r] = m_new;
      const float p_v = round_to<T>(p);
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] *= alpha;
      for (int sl = 0; sl < kSlots; ++sl) {
        const float ps = __shfl_sync(kFull, p_v, sl);
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < DH) acc[r][j] += ps * v_s[sl * DH + d];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = t0 + warp * kRowsPerWarp + r;
    if (t >= Tq) continue;
    const float safe_l = l[r] > 0.0f ? l[r] : 1.0f;
    const long row = (static_cast<long>(b) * Tq + t) * H + h;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < DH) out[row * DH + d] = acc[r][j] / safe_l;
    }
    if (lane == 0) lse[(static_cast<long>(b) * H + h) * Tq + t] = m[r] + logf(safe_l);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const int* seg_q,
           const int* seg_ctx, float* out, float* lse, int B, int Tq, int S,
           int H, int W, float scale, cudaStream_t stream) {
  const dim3 grid((Tq + kRows - 1) / kRows, B * H);
  attention_fwd_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      seg_q, seg_ctx, out, lse, Tq, S, H, W, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v,
              const int* seg_q, const int* seg_ctx, float* out, float* lse,
              int B, int Tq, int S, int H, int W, float scale, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, seg_q, seg_ctx, out, lse, B, Tq, S, H, W, scale, stream);
    case 32: return launch<T, 32>(q, k, v, seg_q, seg_ctx, out, lse, B, Tq, S, H, W, scale, stream);
    case 64: return launch<T, 64>(q, k, v, seg_q, seg_ctx, out, lse, B, Tq, S, H, W, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) on `device`; returns
// cudaGetLastError() so a refused launch is reported to the caller.
// is_bf16 selects bfloat16 q/k/v (else float32); dh is 16, 32 or 64;
// scale is 1/sqrt(dh), rounded to float by the caller.
extern "C" int attention_fwd_launch(const void* q, const void* k, const void* v,
                                    const int* seg_q, const int* seg_ctx,
                                    float* out, float* lse, int B, int Tq,
                                    int S, int H, int dh, int W, float scale,
                                    int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dh<__nv_bfloat16>(dh, q, k, v, seg_q, seg_ctx, out, lse, B, Tq, S, H, W, scale, st)
                 : launch_dh<float>(dh, q, k, v, seg_q, seg_ctx, out, lse, B, Tq, S, H, W, scale, st);
}
