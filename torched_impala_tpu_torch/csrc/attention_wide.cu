// Windowed attention at head widths above the tiled kernels' 256: a simple
// general forward and backward, one block per row.
//
// Replaces, for dh > 256, the Pallas TPU kernels `_fwd_kernel` / `_forward`
// and `_dq_kernel`, `_dkv_kernel` / `_bwd_pallas` of
// torched_impala_tpu/ops/attention_pallas.py, which take any dh that fits
// VMEM. The tiled kernels (attention_fwd.cu, attention_bwd.cu) keep every
// dh up to 256 in registers; past that their tiles do not fit a block.
// Here a row's vectors live in shared memory instead, so any dh whose few
// rows fit in 227 KB runs (ops/attention_cuda.py:wide_smem_bytes).
//
// Forward, `attention_wide_fwd_kernel`: one block per (query row t, head
// h, batch b). The block stages q's row in shared memory, walks the
// context slots with the visibility rule of attention_common.cuh (same
// episode, causal past the W cache slots), and for each visible slot
// takes the dot product q.k (each thread a stride of dh, then a fixed-
// order block sum) and updates an online softmax: the running max m and
// normalizer l in registers, the accumulator over dh in shared memory.
// It writes out = acc / l and lse = m + log l; a row that sees nothing
// writes zeros and lse = -1e30, as the plain version does.
//
// Backward: `attention_wide_dq_kernel`, one block per query row, computes
// D = sum_d O dO for its row (kept in a scratch for the second kernel),
// then for each visible slot P = exp(q.k scale - lse) and dP = dO.v (one
// block sum of the pair), dS = P (dP - D), and dq += dS k.
// `attention_wide_dkv_kernel`, one block per context slot, walks the
// query rows that see its slot and accumulates dk += dS q and dv += P dO,
// recomputing P and dS the same way from the saved lse and D. Every sum
// is owned by one block in a fixed order: no atomics, and two launches
// on the same inputs are bit-identical.
//
// bf16 inputs keep bf16 operands with f32 sums, as the plain version
// (ops/attention.py) does: P is rounded to v's dtype before P V, dS to
// k's dtype for dq and to q's for dk, and P to dO's for dv.
//
// Bound: each block reads its row's vectors and the visible slots' rows
// once; the kernels re-read K and V (and Q, dO in the backward) once for
// each row that sees them, from L2. These kernels serve only widths no
// preset uses; they are right and simple first, and their times stand in
// PERF.md beside their bounds.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// The block-wide sums of a and b, in a fixed order (each warp's lanes by
// the xor tree, then the warps in index order). `red` is kWarps float2 of
// shared memory; every thread of the block must call it.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  float2 total = red[0];
  for (int w = 1; w < kWarps; ++w) {
    total.x += red[w].x;
    total.y += red[w].y;
  }
  __syncthreads();  // red is free again for the next call
  return total;
}

__device__ __forceinline__ long row_of(int b, int i, int n, int H, int h, int dh) {
  return ((static_cast<long>(b) * n + i) * H + h) * dh;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ seg_q,
                              const int* __restrict__ seg_ctx, float* __restrict__ out,
                              float* __restrict__ lse, int Tq, int S, int H, int dh, int W,
                              float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* red = reinterpret_cast<float2*>(smem);
  float* qs = reinterpret_cast<float*>(red + kWarps);
  float* acc = qs + dh;
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long qrow = row_of(b, t, Tq, H, h, dh);
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    qs[d] = to_f32(q[qrow + d]);
    acc[d] = 0.0f;
  }
  __syncthreads();
  const int seg_t = seg_q[b * Tq + t];
  const int last = min(S - 1, W + t);
  float m = kNegInf, l = 0.0f;
  for (int s = 0; s <= last; ++s) {
    // The same for every thread of the block: the block sum below is
    // reached by all of them or by none.
    if (!visible(seg_t, seg_ctx[b * S + s], t, s, W)) continue;
    const long krow = row_of(b, s, S, H, h, dh);
    float part = 0.0f;
    for (int d = threadIdx.x; d < dh; d += kThreads) part += qs[d] * to_f32(k[krow + d]);
    const float x = block_sum2(part, 0.0f, red).x * scale;
    const float m_new = fmaxf(m, x);
    const float corr = expf(m - m_new);
    const float p = expf(x - m_new);
    l = l * corr + p;
    const float pv = round_to<T>(p);
    for (int d = threadIdx.x; d < dh; d += kThreads) {
      acc[d] = acc[d] * corr + pv * to_f32(v[krow + d]);
    }
    m = m_new;
  }
  const float inv = l > 0.0f ? 1.0f / l : 0.0f;
  for (int d = threadIdx.x; d < dh; d += kThreads) out[qrow + d] = acc[d] * inv;
  if (threadIdx.x == 0) {
    lse[(static_cast<long>(b) * H + h) * Tq + t] = l > 0.0f ? m + logf(l) : kNegInf;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ g,
                             const float* __restrict__ o, const float* __restrict__ lse,
                             const int* __restrict__ seg_q, const int* __restrict__ seg_ctx,
                             float* __restrict__ dq, float* __restrict__ dcap, int Tq, int S,
                             int H, int dh, int W, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* red = reinterpret_cast<float2*>(smem);
  float* qs = reinterpret_cast<float*>(red + kWarps);
  float* gs = qs + dh;
  float* acc = gs + dh;
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long qrow = row_of(b, t, Tq, H, h, dh);
  float part = 0.0f;
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    qs[d] = to_f32(q[qrow + d]);
    gs[d] = to_f32(g[qrow + d]);
    acc[d] = 0.0f;
    part += o[qrow + d] * gs[d];
  }
  const float D = block_sum2(part, 0.0f, red).x;  // also orders the stores above
  const long row = (static_cast<long>(b) * H + h) * Tq + t;
  if (threadIdx.x == 0) dcap[row] = D;
  const float row_lse = lse[row];
  const int seg_t = seg_q[b * Tq + t];
  const int last = min(S - 1, W + t);
  for (int s = 0; s <= last; ++s) {
    if (!visible(seg_t, seg_ctx[b * S + s], t, s, W)) continue;
    const long krow = row_of(b, s, S, H, h, dh);
    float qk = 0.0f, gv = 0.0f;
    for (int d = threadIdx.x; d < dh; d += kThreads) {
      qk += qs[d] * to_f32(k[krow + d]);
      gv += gs[d] * to_f32(v[krow + d]);
    }
    const float2 sums = block_sum2(qk, gv, red);
    const float p = expf(sums.x * scale - row_lse);
    const float ds = round_to<T>(p * (sums.y - D));
    for (int d = threadIdx.x; d < dh; d += kThreads) acc[d] += ds * to_f32(k[krow + d]);
  }
  for (int d = threadIdx.x; d < dh; d += kThreads) dq[qrow + d] = acc[d] * scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ g,
                              const float* __restrict__ lse, const float* __restrict__ dcap,
                              const int* __restrict__ seg_q, const int* __restrict__ seg_ctx,
                              float* __restrict__ dk, float* __restrict__ dv, int Tq, int S,
                              int H, int dh, int W, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* red = reinterpret_cast<float2*>(smem);
  float* ks = reinterpret_cast<float*>(red + kWarps);
  float* vs = ks + dh;
  float* dk_acc = vs + dh;
  float* dv_acc = dk_acc + dh;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long krow = row_of(b, s, S, H, h, dh);
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    ks[d] = to_f32(k[krow + d]);
    vs[d] = to_f32(v[krow + d]);
    dk_acc[d] = 0.0f;
    dv_acc[d] = 0.0f;
  }
  __syncthreads();
  const int seg_s = seg_ctx[b * S + s];
  const long rows = (static_cast<long>(b) * H + h) * Tq;
  for (int t = s < W ? 0 : s - W; t < Tq; ++t) {
    if (!visible(seg_q[b * Tq + t], seg_s, t, s, W)) continue;
    const long qrow = row_of(b, t, Tq, H, h, dh);
    float qk = 0.0f, gv = 0.0f;
    for (int d = threadIdx.x; d < dh; d += kThreads) {
      qk += to_f32(q[qrow + d]) * ks[d];
      gv += to_f32(g[qrow + d]) * vs[d];
    }
    const float2 sums = block_sum2(qk, gv, red);
    const float p = expf(sums.x * scale - lse[rows + t]);
    const float ds = round_to<T>(p * (sums.y - dcap[rows + t]));
    const float pg = round_to<T>(p);
    for (int d = threadIdx.x; d < dh; d += kThreads) {
      dk_acc[d] += ds * to_f32(q[qrow + d]);
      dv_acc[d] += pg * to_f32(g[qrow + d]);
    }
  }
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    dk[krow + d] = dk_acc[d] * scale;
    dv[krow + d] = dv_acc[d];
  }
}

// Shared memory of each kernel: the reduction pairs, then `rows` vectors of dh.
long smem_bytes(int rows, int dh) {
  return static_cast<long>(kWarps) * sizeof(float2) + static_cast<long>(rows) * dh * 4;
}

// Sets each kernel's ceiling to the card's most once (smem_ceiling.cuh),
// then launches it with its own size.
template <auto Kernel>
cudaError_t prepare(int device, long smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return set_smem_ceiling_once<Kernel>(device, kMaxSmem);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const int* seg_q,
               const int* seg_ctx, float* out, float* lse, int B, int Tq, int S, int H, int dh,
               int W, float scale, int device, cudaStream_t stream) {
  const long smem = smem_bytes(2, dh);
  cudaError_t err = prepare<attention_wide_fwd_kernel<T>>(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_wide_fwd_kernel<T><<<dim3(Tq, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg_q,
      seg_ctx, out, lse, Tq, S, H, dh, W, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, const float* o,
               const float* lse, const int* seg_q, const int* seg_ctx, float* dq, float* dk,
               float* dv, float* dcap, int B, int Tq, int S, int H, int dh, int W, float scale,
               int device, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const long dq_smem = smem_bytes(3, dh);
  cudaError_t err = prepare<attention_wide_dq_kernel<T>>(device, dq_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long dkv_smem = smem_bytes(4, dh);
  err = prepare<attention_wide_dkv_kernel<T>>(device, dkv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dq first: it writes D, which the dk/dv kernel reads (same stream).
  attention_wide_dq_kernel<T><<<dim3(Tq, H, B), kThreads, dq_smem, stream>>>(
      qt, kt, vt, gt, o, lse, seg_q, seg_ctx, dq, dcap, Tq, S, H, dh, W, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_wide_dkv_kernel<T><<<dim3(S, H, B), kThreads, dkv_smem, stream>>>(
      qt, kt, vt, gt, lse, dcap, seg_q, seg_ctx, dk, dv, Tq, S, H, dh, W, scale);
  return static_cast<int>(cudaGetLastError());
}

bool grid_ok(int B, int Tq, int S, int H) {
  return B >= 1 && Tq >= 1 && S >= 1 && H >= 1 && B <= 65535 && H <= 65535;
}

}  // namespace

// Both entry points launch on `stream` (PyTorch's current stream) on
// `device` and return cudaGetLastError(), or cudaErrorInvalidValue for a
// shape they do not take (a row's vectors past 227 KB, a grid past the
// card's limits), so a refused launch reaches the caller.

// out [B, T, H, dh] and lse [B, H, T] float32.
extern "C" int attention_wide_fwd_launch(const void* q, const void* k, const void* v,
                                         const int* seg_q, const int* seg_ctx, float* out,
                                         float* lse, int B, int Tq, int S, int H, int dh, int W,
                                         float scale, int is_bf16, int device, void* stream) {
  if (!grid_ok(B, Tq, S, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, seg_q, seg_ctx, out, lse, B, Tq, S, H,
                                             dh, W, scale, device, st)
                 : launch_fwd<float>(q, k, v, seg_q, seg_ctx, out, lse, B, Tq, S, H, dh, W,
                                     scale, device, st);
}

// dq [B, T, H, dh], dk and dv [B, S, H, dh] float32; dcap a [B, H, T]
// float32 scratch for D.
extern "C" int attention_wide_bwd_launch(const void* q, const void* k, const void* v,
                                         const void* g, const float* o, const float* lse,
                                         const int* seg_q, const int* seg_ctx, float* dq,
                                         float* dk, float* dv, float* dcap, int B, int Tq, int S,
                                         int H, int dh, int W, float scale, int is_bf16,
                                         int device, void* stream) {
  if (!grid_ok(B, Tq, S, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(q, k, v, g, o, lse, seg_q, seg_ctx, dq, dk, dv,
                                             dcap, B, Tq, S, H, dh, W, scale, device, st)
                 : launch_bwd<float>(q, k, v, g, o, lse, seg_q, seg_ctx, dq, dk, dv, dcap, B,
                                     Tq, S, H, dh, W, scale, device, st);
}
