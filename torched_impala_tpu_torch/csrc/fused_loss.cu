// The fused V-trace loss: a forward kernel and its closed-form backward,
// each reading the [T, B, A] logits once.
//
// Replaces the Pallas TPU kernel `_fused_loss_kernel` /
// `_fused_sums_kernel_call` of torched_impala_tpu/ops/vtrace_pallas.py and
// the XLA around it in `_fused_core_fwd` and `_fused_core_bwd` (the
// log_softmax cube phase, the gathers, the entropy, the means and the
// VJP). The plain versions are ops/fused_loss.py:fused_core_reference and
// fused_core_backward_reference.
//
// Forward (`fused_loss_fwd_kernel`): clusters of 8 blocks of 256 threads,
// one block an SM. Block g takes the column tile g (tiles of `tile`
// columns, `fwd_tile`: up to B = 64 the batch split over one cluster, 4
// columns at the presets' B = 32; past it 8 to 32 columns, about 128
// blocks' worth, in as many clusters as that takes) and walks it in
// chunks of 32 steps of T, latest first (vtrace_stage.cuh). For each
// chunk:
//   1. all threads copy the chunk's [T, B] operands (values, discounts,
//      rewards, mask, int64 actions) and both logit cubes' rows into
//      shared memory with `cp.async`, all in flight at once (the rows in
//      batches of up to 16384 floats a cube, whole steps of the tile, 16
//      bytes a copy where a step's rows are 16-byte aligned, as at the
//      presets' shapes); then groups of `lanes` threads take a row (t, b)
//      each, the lanes striding over A: the max, logsumexp and entropy
//      -sum(p * log p) of the target row, the logsumexp of the behaviour
//      row, log pi(a), log mu(a) and log rho. lse and the entropy are
//      written out for the backward. The exp sums are added in the order
//      of torch's own log_softmax over a short last axis
//      (`softmax_warp_forward`): an xor butterfly as wide as A rounded up
//      to a power of two (zeros past A), its widest steps inside a lane
//      (up to 4 entries a lane, `xor_tree`), the rest by shuffles; past
//      32 entries each of 32 lanes adds its entries in order first. So
//      log pi(a) and log mu(a) are the plain version's bits, and the
//      recursion, which multiplies up to T clipped ratios, has no ulp of
//      theirs to grow;
//   2. the V-trace recursion, staged as in csrc/vtrace.cu (parallel prep,
//      the serial chain one thread a column from shared memory, parallel
//      epilogue);
//   3. vs and the advantages are written out and each thread adds its
//      masked terms -adv * log pi(a) * m, (vs - V)^2 * m, -H * m and vs,
//      adv to five registers.
// Each block adds the five in a fixed tree (warp shuffles, then the warps
// in order) and writes them into its cluster's block 0's shared memory
// (distributed shared memory); after one cluster barrier block 0 adds the
// blocks' in rank order. With one cluster it writes pg, 0.5 * bl, ent and
// the means of vs and adv; with more, each cluster's five go to a scratch
// row and `fused_loss_fold_kernel` (one warp, launched next on the same
// stream) adds the rows in cluster order and writes them. No float
// atomics and no counter to reset: two launches on the same inputs are
// bit-identical. The logits' dynamic shared memory (128 KB) is
// the kernel's own fixed size, its ceiling set once per device
// (smem_ceiling.cuh).
//
// Why this shape: a first version in one block read each row's logits
// from global memory four rows a lane group at a time; its rows phase
// took most of its time on one SM. Spread over 8 SMs and staged through
// shared memory, the rows cost one round trip to memory a chunk. One
// cluster for every B was slower than the eager ops it replaced at
// B = 1024 (each block walked four 32-column tiles in turn), so wider
// batches take more clusters, and the presets' B <= 64 keep one launch.
//
// Backward (`fused_loss_bwd_kernel`): one thread an element of the
// [T, B, A] cube, coalesced: p = exp(z - lse), plp = p * log p, and
//   dL/dz = p * c1 - coef_ent * plp (+ coef_pg at the taken action),
//   c1 = -coef_pg - coef_ent * H, coef_pg = -adv * m * g_pg,
//   coef_ent = -m * g_ent;
// the first T * B threads also write dL/dvalues = (V - vs) * m * g_bl.
// The three cotangents are read from device memory (no host sync).
//
// Bound: at the pong_transformer shape (T, B, A) = (20, 32, 6) the
// forward reads 2 * 15,360 bytes of logits, 5,120 of int64 actions,
// 4 * 2,560 of [T, B] operands and the bootstrap, and writes 4 * 2,560 and
// the five sums (56,468 bytes, about 17 ns at 3.35 TB/s); the backward
// moves 53,772 bytes. Launch latency bounds both; in the forward the row
// phase, the copies and the chain follow.
//
// Numerics: as csrc/vtrace.cu for vs and adv (vtrace_stage.cuh); the row
// phase uses expf and logf, plp is p * log p as the plain version forms
// it (a -inf logit gives NaN there as here), and the backward rounds
// every multiply and add in the plain version's order. log p is
// (z - max) - log(sum exp(z - max)), as torch's log_softmax forms it, and
// lse = max + log(sum exp(z - max)), as torch.logsumexp. The entropy's
// sum of A terms and the loss sums run in another order than torch's;
// their gates are 1e-5 absolute and rtol 1e-5. An action outside [0, A)
// gives NaN log pi(a) and adds no coef_pg (torch raises there).

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "smem_ceiling.cuh"
#include "vtrace_stage.cuh"

namespace {

constexpr int kCluster = 8;  // blocks of a forward cluster
constexpr int kWideTile = 8;      // least columns a tile past one cluster
constexpr int kWideBlocks = 128;  // blocks a batch past kWideTile * kWideBlocks takes
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;  // most logits of a row a lane holds in registers (A <= 32)
// Floats of each logit cube a block stages at once in dynamic shared
// memory (64 KB each, 128 KB for the two); at least one row of A <= 16384.
constexpr int kCubeFloats = 16384;
constexpr int kDynSmem = 2 * kCubeFloats * static_cast<int>(sizeof(float));
constexpr int kBwdThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
using vt::kChunk;
using vt::kCols;

__device__ __forceinline__ float group_max(float x, int lanes) {
  for (int o = lanes / 2; o > 0; o /= 2) x = fmaxf(x, __shfl_xor_sync(kFull, x, o, lanes));
  return x;
}

__device__ __forceinline__ float group_sum(float x, int lanes) {
  for (int o = lanes / 2; o > 0; o /= 2) x += __shfl_xor_sync(kFull, x, o, lanes);
  return x;
}

// The steps of a width-(lanes * per) xor butterfly that stay inside one
// lane, whose entries sit `lanes` apart: offsets 2 * lanes, then lanes.
__device__ __forceinline__ float xor_tree(const float (&v)[kPer], int per) {
  if (per == 4) return (v[0] + v[2]) + (v[1] + v[3]);
  if (per == 2) return v[0] + v[1];
  return v[0];
}

// Lanes a row of A logits: A rounded up to a power of two, over 4 when
// A <= 32 (so 4 entries a lane, 1 at A = 1, 2 at A = 2); 32 past 32. Four
// entries a lane keep the butterfly's order (`xor_tree`) with fewer, busier
// lanes than torch's one a lane.
__host__ __device__ inline int lanes_for(int A) {
  if (A > 32) return 32;
  int width = 1;
  while (width < A) width *= 2;
  return width < 4 ? 1 : width / 4;
}

// Columns a tile of the forward: up to B = 64 the batch split over one
// cluster's blocks (ceil(B / 8) <= 8); past it, B / kWideBlocks rounded up,
// between kWideTile and kCols. So one cluster serves B <= 64, and past it
// there are at most ceil(B / 64) clusters.
inline int fwd_tile(int B) {
  return std::max(std::min((B + kCluster - 1) / kCluster, kWideTile),
                  std::min((B + kWideBlocks - 1) / kWideBlocks, kCols));
}

// pg, 0.5 * bl, ent and the means of vs and adv from the five sums.
__device__ __forceinline__ float finish(float total, int q, int T, int B) {
  const float n = static_cast<float>(T) * static_cast<float>(B);
  return q == 1 ? __fmul_rn(0.5f, total) : q >= 3 ? __fdiv_rn(total, n) : total;
}

// 16 bytes from global to shared memory without waiting (both 16-byte
// aligned).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// One int64 from global to shared memory without waiting.
__device__ __forceinline__ void cp_async8(long long* dst, const long long* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

// The cluster barrier, split: `arrive` lets the block run on, `wait`
// blocks until every block of the cluster has arrived (with release and
// acquire ordering of shared-memory writes across the cluster; the
// relaxed arrive orders nothing).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Stores `x` at `local` in block `rank`'s shared memory (the address of
// the same variable there).
__device__ __forceinline__ void store_remote(float* local, unsigned rank, float x) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(local));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(s), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(x) : "memory");
}

struct Stage {
  vt::Tile lr, d, r, v, m;  // log rho (rho after prep), discounts, rewards, values, mask
  vt::Tile lpa, ent;        // log pi(a) and the entropy
  vt::Tile delta, dc;       // delta, then acc (= vs - V); gamma * c
  long long act[kChunk][kCols];
};

// Block g of the grid takes the column tiles g, g + gridDim.x, ... of
// `tile` columns each (the last one ragged); the launcher's grid has a
// block for each tile.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    fused_loss_fwd_kernel(const float* __restrict__ z, const float* __restrict__ mu,
                          const long long* __restrict__ actions,
                          const float* __restrict__ values, const float* __restrict__ bootstrap,
                          const float* __restrict__ discounts, const float* __restrict__ rewards,
                          const float* __restrict__ mask, float* __restrict__ vs_out,
                          float* __restrict__ adv_out, float* __restrict__ lse_out,
                          float* __restrict__ ent_out, float* __restrict__ sums_out,
                          float* __restrict__ partials, int T, int B,
                          int A, int tile, int lanes, int aligned, float clip_rho,
                          float clip_c, float clip_pg_rho, float lambda_) {
  extern __shared__ float cubes[];  // [kCubeFloats] target rows, then behaviour rows
  float* zs = cubes;
  float* ms = cubes + kCubeFloats;
  __shared__ Stage s;
  __shared__ float v_after[2][kCols], vs_after[2][kCols];
  __shared__ float red[5][kWarps];
  __shared__ float part[kCluster][5];  // the cluster's block 0's: each block's five sums
  // Every block of the cluster has started before any writes to its
  // block 0's shared memory.
  cluster_arrive_relaxed();
  const unsigned rank = cluster_rank();
  const int tid = threadIdx.x;
  const int groups = kThreads / lanes;
  const int group = tid / lanes, lane = tid % lanes;
  // Entries a lane holds (A <= 32), else 0: the butterfly is as wide as A
  // rounded up to a power of two, as torch's.
  int width = 1;
  while (width < A) width *= 2;
  const int per = A <= 32 ? width / lanes : 0;
  float sum_pg = 0.0f, sum_bl = 0.0f, sum_ent = 0.0f, sum_vs = 0.0f, sum_adv = 0.0f;
  const int chunks = (T + kChunk - 1) / kChunk;
  for (int b0 = static_cast<int>(blockIdx.x) * tile; b0 < B;
       b0 += static_cast<int>(gridDim.x) * tile) {
    const int cols = min(tile, B - b0);
    // Rows of logits staged at once: whole steps of the tile where a step's
    // cols * A floats fit, so that the rows of a step are one contiguous
    // run in both memories, copied 16 bytes at a time where aligned.
    const int steps_a_batch = kCubeFloats / (A * cols);
    const int batch_rows = steps_a_batch > 0 ? steps_a_batch * cols : kCubeFloats / A;
    const int run = cols * A;  // floats of one step's rows
    const bool vec = aligned && steps_a_batch > 0 && run % 4 == 0 &&
                     (static_cast<long>(B) * A) % 4 == 0 && (static_cast<long>(b0) * A) % 4 == 0;
    float acc = 0.0f;
    for (int k = 0; k < chunks; ++k) {
      const vt::Chunk c(T, k);
      const int rows = c.len * cols;
      if (k == 0 && tid < cols) vt::cp_async4(&v_after[0][tid], bootstrap + b0 + tid);
      for (int i = tid; i < rows; i += kThreads) {
        const int tl = i / cols, j = i % cols;
        const long g = static_cast<long>(c.t0 + tl) * B + b0 + j;
        vt::cp_async4(&s.v[tl][j], values + g);
        vt::cp_async4(&s.d[tl][j], discounts + g);
        vt::cp_async4(&s.r[tl][j], rewards + g);
        vt::cp_async4(&s.m[tl][j], mask + g);
        cp_async8(&s.act[tl][j], actions + g);
      }

      // 1. The rows, `batch_rows` at a time: both logit rows copied to
      // shared memory (with the [T, B] operands in the first batch), then
      // a group of `lanes` threads a row, the lanes striding over A.
      for (int r0 = 0; r0 < rows; r0 += batch_rows) {
        const int nb = min(batch_rows, rows - r0);
        if (vec) {
          const int quads = run / 4;
          for (int e = tid; e < nb * A / 4; e += kThreads) {
            const int step = e / quads;
            const long g = (static_cast<long>(c.t0 + r0 / cols + step) * B + b0) * A +
                           4 * (e - step * quads);
            cp_async16(zs + 4 * e, z + g);
            cp_async16(ms + 4 * e, mu + g);
          }
        } else {
          for (int e = tid; e < nb * A; e += kThreads) {
            const int i = r0 + e / A, a = e % A;
            const long g = (static_cast<long>(c.t0 + i / cols) * B + b0 + i % cols) * A + a;
            vt::cp_async4(zs + e, z + g);
            vt::cp_async4(ms + e, mu + g);
          }
        }
        vt::cp_async_commit();
        vt::cp_async_wait<0>();
        __syncthreads();
        // Every lane of a warp runs the same iterations: the shuffles need
        // the whole warp.
        for (int q0 = 0; q0 < nb; q0 += groups) {
          const int q = q0 + group;
          const int n = q < nb ? A : 0;  // entries of this group's row
          const float* zr = zs + q * A;
          const float* mr = ms + q * A;
          float zmax = -INFINITY, mmax = -INFINITY, zsum, msum;
          float zv[kPer];
          if (per > 0) {
            // A <= 32: entries lane + lanes * k, k < per, in registers.
            float mv[kPer], ze[kPer], me[kPer];
#pragma unroll
            for (int k = 0; k < kPer; ++k) {
              const int a = lane + lanes * k;
              const bool in = k < per && a < n;
              zv[k] = in ? zr[a] : -INFINITY;
              mv[k] = in ? mr[a] : -INFINITY;
              zmax = fmaxf(zmax, zv[k]);
              mmax = fmaxf(mmax, mv[k]);
            }
            zmax = group_max(zmax, lanes);
            mmax = group_max(mmax, lanes);
#pragma unroll
            for (int k = 0; k < kPer; ++k) {
              const bool in = k < per && lane + lanes * k < n;
              ze[k] = in ? expf(zv[k] - zmax) : 0.0f;
              me[k] = in ? expf(mv[k] - mmax) : 0.0f;
            }
            zsum = xor_tree(ze, per);
            msum = xor_tree(me, per);
          } else {
            // A > 32: 32 lanes, each adding its entries lane + 32 * k in
            // order, as torch's warp softmax does past 32 entries.
            for (int a = lane; a < n; a += lanes) {
              zmax = fmaxf(zmax, zr[a]);
              mmax = fmaxf(mmax, mr[a]);
            }
            zmax = group_max(zmax, lanes);
            mmax = group_max(mmax, lanes);
            zsum = 0.0f;
            msum = 0.0f;
            for (int a = lane; a < n; a += lanes) {
              zsum += expf(zr[a] - zmax);
              msum += expf(mr[a] - mmax);
            }
          }
          // log p = (z - max) - log(sum), as torch's log_softmax forms it.
          const float zlog = logf(group_sum(zsum, lanes));
          const float mlog = logf(group_sum(msum, lanes));
          float plp = 0.0f;
          if (per > 0) {
            float pl[kPer];
#pragma unroll
            for (int k = 0; k < kPer; ++k) {
              const float log_p = __fsub_rn(__fsub_rn(zv[k], zmax), zlog);
              pl[k] = k < per && lane + lanes * k < n ? __fmul_rn(expf(log_p), log_p) : 0.0f;
            }
            plp = xor_tree(pl, per);
          } else {
            for (int a = lane; a < n; a += lanes) {
              const float log_p = __fsub_rn(__fsub_rn(zr[a], zmax), zlog);
              plp = __fadd_rn(plp, __fmul_rn(expf(log_p), log_p));
            }
          }
          const float ent = -group_sum(plp, lanes);
          if (lane == 0 && q < nb) {
            const int i = r0 + q;
            const int tl = i / cols, j = i % cols;
            const long long a = s.act[tl][j];
            const bool in = a >= 0 && a < A;
            const float log_pi_a = in ? __fsub_rn(__fsub_rn(zr[a], zmax), zlog) : NAN;
            const float log_mu_a = in ? __fsub_rn(__fsub_rn(mr[a], mmax), mlog) : NAN;
            const long g = static_cast<long>(c.t0 + tl) * B + b0 + j;
            lse_out[g] = __fadd_rn(zmax, zlog);
            ent_out[g] = ent;
            s.lpa[tl][j] = log_pi_a;
            s.ent[tl][j] = ent;
            s.lr[tl][j] = __fsub_rn(log_pi_a, log_mu_a);
          }
        }
        __syncthreads();  // the staged rows are free for the next batch
      }
      if (k == 0 && tid < cols) vs_after[0][tid] = v_after[0][tid];

      // 2. The recursion.
      vt::prep(s.lr, s.d, s.r, s.v, v_after[k & 1], s.delta, s.dc, c.len, cols, clip_rho,
               clip_c, lambda_);
      __syncthreads();
      if (tid < cols) acc = vt::chain(s.delta, s.dc, c.len, acc);
      __syncthreads();

      // 3. vs, the advantages and this thread's terms of the sums.
      for (int i = tid; i < rows; i += kThreads) {
        const int tl = i / cols, j = i % cols;
        const float v = s.v[tl][j];
        const float vs = __fadd_rn(v, s.delta[tl][j]);
        const float vs_next =
            tl + 1 < c.len ? __fadd_rn(s.v[tl + 1][j], s.delta[tl + 1][j]) : vs_after[k & 1][j];
        const float adv =
            vt::advantage(s.lr[tl][j], s.r[tl][j], s.d[tl][j], v, vs_next, clip_pg_rho);
        const long g = static_cast<long>(c.t0 + tl) * B + b0 + j;
        vs_out[g] = vs;
        adv_out[g] = adv;
        const float m = s.m[tl][j];
        const float e = __fsub_rn(vs, v);
        sum_pg = __fadd_rn(sum_pg, __fmul_rn(__fmul_rn(-adv, s.lpa[tl][j]), m));
        sum_bl = __fadd_rn(sum_bl, __fmul_rn(__fmul_rn(e, e), m));
        sum_ent = __fadd_rn(sum_ent, __fmul_rn(-s.ent[tl][j], m));
        sum_vs = __fadd_rn(sum_vs, vs);
        sum_adv = __fadd_rn(sum_adv, adv);
      }
      if (tid < cols) {
        v_after[(k + 1) & 1][tid] = s.v[0][tid];
        vs_after[(k + 1) & 1][tid] = __fadd_rn(s.v[0][tid], s.delta[0][tid]);
      }
      __syncthreads();
    }
  }

  // The five sums in a fixed order: each warp's tree, the warps in order,
  // then the cluster's block 0 adds the blocks' in rank order (and the fold
  // kernel the clusters' in cluster order). Each block writes its five into
  // block 0's shared memory; the cluster barrier orders the writes before
  // block 0 reads them.
  float sums[5] = {sum_pg, sum_bl, sum_ent, sum_vs, sum_adv};
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    sums[q] = group_sum(sums[q], 32);
    if (tid % 32 == 0) red[q][tid / 32] = sums[q];
  }
  __syncthreads();
  cluster_wait();  // the arrive at the start: every block is running
  if (tid < 5) {
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total = __fadd_rn(total, red[tid][w]);
    store_remote(&part[rank][tid], 0, total);
  }
  cluster_arrive();
  cluster_wait();
  if (rank == 0 && tid < 5) {
    float total = 0.0f;
    for (int r = 0; r < kCluster; ++r) total = __fadd_rn(total, part[r][tid]);
    if (gridDim.x == kCluster) {
      sums_out[tid] = finish(total, tid, T, B);
    } else {
      partials[(blockIdx.x / kCluster) * 5 + tid] = total;
    }
  }
}

// The clusters' five sums (rows of `partials`) added in cluster order.
__global__ void fused_loss_fold_kernel(const float* __restrict__ partials, int clusters, int T,
                                       int B, float* __restrict__ sums_out) {
  const int q = threadIdx.x;
  if (q >= 5) return;
  float total = 0.0f;
  for (int c = 0; c < clusters; ++c) total = __fadd_rn(total, partials[c * 5 + q]);
  sums_out[q] = finish(total, q, T, B);
}

__global__ void __launch_bounds__(kBwdThreads) fused_loss_bwd_kernel(
    const float* __restrict__ z, const float* __restrict__ lse, const float* __restrict__ ent,
    const float* __restrict__ adv, const float* __restrict__ vs, const float* __restrict__ values,
    const float* __restrict__ mask, const long long* __restrict__ actions,
    const float* __restrict__ g_pg, const float* __restrict__ g_bl,
    const float* __restrict__ g_ent, float* __restrict__ g_z, float* __restrict__ g_values,
    long rows, int A) {
  const float gp = *g_pg, gb = *g_bl, ge = *g_ent;
  const long n = rows * A;
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  for (long e = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; e < n; e += stride) {
    const long row = e / A;
    const int a = static_cast<int>(e - row * A);
    const float m = mask[row];
    const float log_p = __fsub_rn(z[e], lse[row]);
    const float p = expf(log_p);
    const float plp = __fmul_rn(p, log_p);
    const float coef_pg = __fmul_rn(__fmul_rn(-adv[row], m), gp);
    const float coef_ent = __fmul_rn(-m, ge);
    const float c1 = __fsub_rn(-coef_pg, __fmul_rn(coef_ent, ent[row]));
    float g = __fsub_rn(__fmul_rn(p, c1), __fmul_rn(coef_ent, plp));
    if (a == actions[row]) g = __fadd_rn(g, coef_pg);
    g_z[e] = g;
    if (e < rows) g_values[e] = __fmul_rn(__fmul_rn(__fsub_rn(values[e], vs[e]), mask[e]), gb);
  }
}

}  // namespace

// Each launcher runs on `stream` (PyTorch's current stream) on `device` and
// returns cudaGetLastError(), so a refused launch is reported to the caller.
// The forward refuses A above kCubeFloats (cudaErrorInvalidValue): a row
// must fit the staged logits. `partials` is scratch of 5 * ceil(B / 64)
// floats, read only where B takes more than one cluster (B > 64); the fold
// kernel then follows the forward on `stream`.
extern "C" int fused_loss_fwd_launch(
    const float* z, const float* mu, const long long* actions, const float* values,
    const float* bootstrap, const float* discounts, const float* rewards, const float* mask,
    float* vs_out, float* adv_out, float* lse_out, float* ent_out, float* sums_out,
    float* partials, int T, int B, int A, float clip_rho, float clip_c, float clip_pg_rho,
    float lambda_, int device, void* stream) {
  if (A > kCubeFloats) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = fwd_tile(B);
  const int clusters = ((B + tile - 1) / tile + kCluster - 1) / kCluster;
  const int aligned = reinterpret_cast<std::uintptr_t>(z) % 16 == 0 &&
                      reinterpret_cast<std::uintptr_t>(mu) % 16 == 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem_ceiling_once<fused_loss_fwd_kernel>(device, kDynSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  fused_loss_fwd_kernel<<<kCluster * clusters, kThreads, kDynSmem, s>>>(
      z, mu, actions, values, bootstrap, discounts, rewards, mask, vs_out, adv_out, lse_out,
      ent_out, sums_out, partials, T, B, A, tile, lanes_for(A), aligned, clip_rho, clip_c,
      clip_pg_rho, lambda_);
  err = cudaGetLastError();
  if (err != cudaSuccess || clusters == 1) return static_cast<int>(err);
  fused_loss_fold_kernel<<<1, 32, 0, s>>>(partials, clusters, T, B, sums_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_loss_bwd_launch(
    const float* z, const float* lse, const float* ent, const float* adv, const float* vs,
    const float* values, const float* mask, const long long* actions, const float* g_pg,
    const float* g_bl, const float* g_ent, float* g_z, float* g_values, long rows, int A,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long n = rows * A;
  const long blocks = std::min<long>((n + kBwdThreads - 1) / kBwdThreads, 132L * 16);
  fused_loss_bwd_kernel<<<static_cast<int>(blocks), kBwdThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      z, lse, ent, adv, vs, values, mask, actions, g_pg, g_bl, g_ent, g_z, g_values, rows, A);
  return static_cast<int>(cudaGetLastError());
}
