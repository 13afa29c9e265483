// Windowed flash attention, backward: dQ, dK and dV in one kernel that
// computes the probabilities P and dS once for each (query tile, key tile)
// pair, with D = sum_d O * dO worked out inside from the saved f32 output.
//
// Replaces `_bwd_pallas` of torched_impala_tpu/ops/attention_pallas.py:409:
// both of its pallas_calls, `_dq_kernel` (:438) and `_dkv_kernel` (:458),
// and the einsum that computes D before them (:427-431). On the TPU each
// call carries its output in VMEM scratch across a sequential grid, and
// each recomputes q . k and dO . v; here one block owns (b, h, a tile of
// key slots), sweeps the query tiles that can see that tile, and does the
// five products of a pair once each:
//
//   S^T  = K Q^T,   dP^T = V dO^T          (16 slots x 16 queries a warp)
//   P    = exp(S * scale - lse) where visible, exactly 0 elsewhere
//   dS   = P * (dP - D)
//   dV  += P^T dO,  dK += dS^T Q                (registers, across queries)
//   dQ_t = dS K                                 (this key tile's share)
//
// Ownership (FlashAttention-2's): each warp owns 16 key slots and keeps
// their dK and dV in registers over the whole sweep (at DP = 128 and 256,
// two and four warps split the columns of the same 16 slots, each
// computing S and dP for them in full). A block of key_warps x
// query_groups warps owns 16 key_warps slots and takes 16 query_groups
// query rows a step, each group of warps 16 of them; at the end the
// groups' dK and dV are added in group order in shared memory. dS goes
// through shared memory for the dQ product, whose output is split into
// 16 x 8 tiles between all warps. No sum crosses blocks: a key tile's dQ
// share is written to its own plane of an f32 scratch [tiles, B, T, H,
// dh], and a second short kernel adds the planes in tile order. Where one
// key tile covers S the block writes dq itself and the second kernel does
// not run. No atomics: two launches on the same inputs are bit-identical.
//
// Tensor cores: every product is `mma.sync.m16n8k8` in TF32 with f32
// accumulators. A float32 operand x is split as hi = x with its low 13
// bits cleared and lo = x - hi, and each product sums lo*hi + hi*lo +
// hi*hi (3xTF32, the scheme of CUTLASS's OpMultiplyAddFastF32): about
// 2^-20 relative per product, so the f32 gates hold. bfloat16 inputs, and
// P and dS rounded to bfloat16 before their products (as the TPU kernels
// cast them to the operands' dtype), are exact in TF32, so they take one
// product each. P^T and dS^T leave S^T's accumulator layout as the A
// operand of dV's and dK's products with no shuffle: A's columns t and
// t + 4 are read as queries 2t and 2t + 1, and B's rows in the same order.
//
// Copies: K and V of the block's tile, then each query tile's q, dO, O,
// lse and segments go to shared memory with 16-byte `cp.async` (zero-filled
// past the row count and the true dh), double-buffered, so the next query
// tile's copy runs under this tile's products. A head width whose rows are
// not whole 16-byte chunks, or a tensor not 16-byte aligned, takes plain
// loads at the same points.
//
// Head widths: any dh from 1 to 256 runs at the padded width DP of
// attention_common.cuh (16, 32, 64, 128 or 256); the padded columns load as
// 0 and add only 0 x 0 terms. The wrapper chooses the tiles per call
// (ops/attention_cuda.py:bwd_tiles): one key tile over the whole context
// where at most 12 warps cover it (the learner's S = 149: 10 warps, 128
// blocks, one launch), else 64 slots and 48 query rows a step. The
// kernel's shared-memory ceiling is the card's 227 KB, set once per
// instantiation and device (smem_ceiling.cuh); a launch asks for its own
// tiles' size, 124,288 bytes at the learner's.
//
// Bound: at the learner's shape (B = 32, T = 21, H = 4, dh = 64, S = 149,
// f32) the call must read q, dO and O once (0.69 MB each), k and v once
// (4.88 MB each), lse and the segments, and write dq (0.69 MB), dk and dv
// (4.88 MB each): about 22.3 MB, 6.7 us at 3.35 TB/s. The parent's two
// kernels bounded 9.8 us together, as each read the inputs again.

#include <algorithm>

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kRows = 16;       // rows a warp owns: the m16 of every product
constexpr int kMaxWarps = 12;   // a block's most: 168 registers a thread fit

// The layout of the DP instantiation. A warp owns 16 key slots, a group of
// columns of their dK and dV (kCols <= 64 keeps them in 64 registers) and
// one 16-row group of each query tile; a block has key_warps x kColGroups
// x query_groups warps, its key tile 16 key_warps slots and its query
// tile 16 query_groups rows.
template <typename T, int DP>
struct Tile {
  static constexpr int kColGroups = DP <= 64 ? 1 : DP / 64;
  static constexpr int kCols = DP / kColGroups;
  static constexpr int kColTiles = kCols / 8;
  static constexpr int kLd = DP + 16 / static_cast<int>(sizeof(T));  // a row of q, dO, k, v
  static constexpr int kLdO = DP + 4;                                // a row of O (floats)
  // A query row of a buffer: q, dO, O, then its lse, segment and D.
  static constexpr int kRowBytes = 2 * kLd * static_cast<int>(sizeof(T)) + kLdO * 4 + 12;
  // Dynamic shared memory: K and V of the key tile, two query buffers,
  // then dS [query rows][keys + 8] (rows padded for conflict-free reads);
  // after the sweep, the query groups' dK and dV to add up.
  static int smem_bytes(int key_warps, int query_groups) {
    const int keys = kRows * key_warps, rows = kRows * query_groups;
    const int sweep = 2 * keys * kLd * static_cast<int>(sizeof(T)) + 2 * rows * kRowBytes +
                      rows * (keys + 8) * 4;
    const int sums = (query_groups - 1) * key_warps * kColGroups * 32 * 8 * kColTiles * 4;
    return std::max(sweep, sums);
  }
};

// The first query tile (of `rows` rows) that may see key slot s0 onward:
// the tiles before it lie above the causal diagonal: each of their
// queries t has t < s0 - W, so none sees slot s0 or a later one.
__device__ __forceinline__ int first_query_tile(int s0, int W, int rows) {
  return s0 < W ? 0 : (s0 - W) / rows;
}

// Fragment coordinates: attention_common.cuh, above mma_tf32.
template <typename T, int DP>
__global__ void __launch_bounds__(32 * kMaxWarps) attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ o, const float* __restrict__ lse,
    const int* __restrict__ seg_q, const int* __restrict__ seg_ctx, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ dv, int Tq, int S, int H, int dh, int W,
    float scale, int key_warps, int query_groups, bool vec) {
  using L = Tile<T, DP>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kLd = L::kLd, kLdO = L::kLdO, kColTiles = L::kColTiles;
  const int keys = kRows * key_warps, rows = kRows * query_groups, ld_ds = keys + 8;
  const int n_warps = blockDim.x / 32;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + keys * kLd;
  unsigned char* bufs = reinterpret_cast<unsigned char*>(v_s + keys * kLd);
  float* ds_s = reinterpret_cast<float*>(bufs + 2 * rows * L::kRowBytes);
  auto q_buf = [&](int i) { return reinterpret_cast<T*>(bufs + i * rows * L::kRowBytes); };
  auto g_buf = [&](int i) { return q_buf(i) + rows * kLd; };
  auto o_buf = [&](int i) { return reinterpret_cast<float*>(g_buf(i) + rows * kLd); };
  auto lse_buf = [&](int i) { return o_buf(i) + rows * kLdO; };
  auto seg_buf = [&](int i) { return reinterpret_cast<int*>(lse_buf(i) + rows); };
  auto d_buf = [&](int i) { return reinterpret_cast<float*>(seg_buf(i) + rows); };

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int s0 = blockIdx.x * keys;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tc = lane % 4;
  const int kg = warp % key_warps, cg = warp / key_warps % L::kColGroups;
  const int qg = warp / (key_warps * L::kColGroups);
  const int key0 = kg * kRows;      // the warp's first slot in the key tile
  const int col0 = cg * L::kCols;   // its first dK, dV column
  const int qr0 = qg * kRows;       // its first row in each query tile

  // One commit group a query tile (its q, dO, O, lse and segments).
  auto load_queries = [&](int buf, int t0) {
    copy_rows<T, DP, kLd>(q_buf(buf), q, rows, b, h, t0, Tq, H, dh, vec);
    copy_rows<T, DP, kLd>(g_buf(buf), g, rows, b, h, t0, Tq, H, dh, vec);
    copy_rows<float, DP, kLdO>(o_buf(buf), o, rows, b, h, t0, Tq, H, dh, vec);
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int t = t0 + r;
      const bool in = t < Tq;
      cp_async4(lse_buf(buf) + r, lse + (in ? (static_cast<long>(b) * H + h) * Tq + t : 0), in);
      cp_async4(seg_buf(buf) + r, seg_q + (in ? static_cast<long>(b) * Tq + t : 0), in);
    }
    cp_async_commit();
  };

  copy_rows<T, DP, kLd>(k_s, k, keys, b, h, s0, S, H, dh, vec);
  copy_rows<T, DP, kLd>(v_s, v, keys, b, h, s0, S, H, dh, vec);
  const int n_tiles = (Tq + rows - 1) / rows;
  const int first = first_query_tile(s0, W, rows);
  if (first < n_tiles) {
    load_queries(0, first * rows);  // its group holds K and V too
  } else {
    cp_async_commit();
  }

  int seg_s[2];
  bool key_in[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int s = s0 + key0 + gr + 8 * j;
    key_in[j] = s < S;
    seg_s[j] = key_in[j] ? seg_ctx[static_cast<long>(b) * S + s] : 0;
  }
  float dk_acc[kColTiles][4] = {}, dv_acc[kColTiles][4] = {};

  for (int i = first; i < n_tiles; ++i) {
    const int buf = (i - first) & 1, t0 = i * rows;
    if (i + 1 < n_tiles) {
      load_queries(buf ^ 1, t0 + rows);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();
    const T* q_s = q_buf(buf);
    const T* g_s = g_buf(buf);
    const float* o_s = o_buf(buf);
    const float* lse_s = lse_buf(buf);
    const int* segq_s = seg_buf(buf);
    float* d_s = d_buf(buf);

    // D = sum_d O * dO of the tile's rows (0 past Tq, where O loads as 0).
    for (int r = warp; r < rows; r += n_warps) {
      float acc = 0.0f;
      for (int d = lane; d < DP; d += 32) acc += o_s[r * kLdO + d] * to_f32(g_s[r * kLd + d]);
      acc = warp_sum(acc);
      if (lane == 0) d_s[r] = acc;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 slots x its 16 queries.
    float st[2][4] = {}, st_lo[2][4] = {}, dpt[2][4] = {}, dpt_lo[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < DP; kk += 8) {
      Frag<kSplit, 4> ka, va;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int at = (key0 + gr + 8 * (j & 1)) * kLd + kk + tc + 4 * (j >> 1);
        ka.set(j, to_f32(k_s[at]));
        va.set(j, to_f32(v_s[at]));
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        Frag<kSplit, 2> qb, gb;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int at = (qr0 + n * 8 + gr) * kLd + kk + tc + 4 * j;
          qb.set(j, to_f32(q_s[at]));
          gb.set(j, to_f32(g_s[at]));
        }
        mma2<kSplit>(st[n], st_lo[n], ka, qb);
        mma2<kSplit>(dpt[n], dpt_lo[n], va, gb);
      }
    }

    // P and dS in S^T's layout; dS also to shared memory as [row][slot].
    float p[2][4], ds[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = qr0 + n * 8 + 2 * tc + (j & 1), t = t0 + row;
        const int slot = key0 + gr + 8 * (j >> 1);
        const bool vis =
            t < Tq && key_in[j >> 1] && visible(segq_s[row], seg_s[j >> 1], t, s0 + slot, W);
        const float pv = vis ? expf((st[n][j] + st_lo[n][j]) * scale - lse_s[row]) : 0.0f;
        ds[n][j] = round_to<T>(pv * (dpt[n][j] + dpt_lo[n][j] - d_s[row]));
        p[n][j] = round_to<T>(pv);
        ds_s[row * ld_ds + slot] = ds[n][j];
      }
    }

    // dV += P^T dO and dK += dS^T Q over the warp's queries, eight a step:
    // A's columns tc and tc + 4 are queries 2 tc and 2 tc + 1 of the step.
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      Frag<kSplit, 4> pa, dsa;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = (j & 1) * 2 + (j >> 1);  // a0, a1, a2, a3 <- c0, c2, c1, c3
        pa.set(j, p[n][c]);
        dsa.set(j, ds[n][c]);
      }
      const int r0 = qr0 + n * 8 + 2 * tc;
#pragma unroll
      for (int c = 0; c < kColTiles; ++c) {
        const int col = col0 + c * 8 + gr;
        Frag<kSplit, 2> gb, qb;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          gb.set(j, to_f32(g_s[(r0 + j) * kLd + col]));
          qb.set(j, to_f32(q_s[(r0 + j) * kLd + col]));
        }
        mma<kSplit>(dv_acc[c], pa, gb);
        mma<kSplit>(dk_acc[c], dsa, qb);
      }
    }
    __syncthreads();  // dS complete; the next copy may reuse this buffer

    // This key tile's share of dQ = dS K, rows x DP in 16 x 8 tiles spread
    // over the warps; k runs over slots kk + 2 tc and kk + 2 tc + 1, so each
    // lane reads its two dS values as one float2.
    for (int tile = warp; tile < query_groups * (DP / 8); tile += n_warps) {
      const int m0 = tile / (DP / 8) * kRows, col = tile % (DP / 8) * 8 + gr;
      float acc[4] = {}, acc_lo[4] = {};
      const float* ds_row = ds_s + (m0 + gr) * ld_ds + 2 * tc;
#pragma unroll 2
      for (int kk = 0; kk < keys; kk += 8) {
        const float2 top = *reinterpret_cast<const float2*>(ds_row + kk);
        const float2 bot = *reinterpret_cast<const float2*>(ds_row + 8 * ld_ds + kk);
        Frag<kSplit, 4> a;
        a.set(0, top.x);
        a.set(1, bot.x);
        a.set(2, top.y);
        a.set(3, bot.y);
        Frag<kSplit, 2> kb;
        kb.set(0, to_f32(k_s[(kk + 2 * tc) * kLd + col]));
        kb.set(1, to_f32(k_s[(kk + 2 * tc + 1) * kLd + col]));
        mma2<kSplit>(acc, acc_lo, a, kb);
      }
      const long plane = static_cast<long>(gridDim.y) * Tq * dh;  // B T H dh
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + m0 + gr + 8 * (j >> 1), d = col - gr + 2 * tc + (j & 1);
        if (t < Tq && d < dh) {
          dq[blockIdx.x * plane + ((static_cast<long>(b) * Tq + t) * H + h) * dh + d] =
              (acc[j] + acc_lo[j]) * scale;
        }
      }
    }
  }
  cp_async_wait<0>();

  // The query groups' dK and dV, added in group order by group 0's warps.
  if (query_groups > 1) {
    constexpr int kAcc = 8 * kColTiles;  // dK then dV values a lane
    __syncthreads();                     // the sweep's shared memory is free
    float* sums = reinterpret_cast<float*>(smem);
    const int in_group = warp % (key_warps * L::kColGroups);
    auto at = [&](int group) {
      return sums + ((group - 1) * key_warps * L::kColGroups + in_group) * kAcc * 32 + lane;
    };
    if (qg > 0) {
      float* dst = at(qg);
#pragma unroll
      for (int c = 0; c < kColTiles; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dst[(c * 4 + j) * 32] = dk_acc[c][j];
          dst[(kAcc / 2 + c * 4 + j) * 32] = dv_acc[c][j];
        }
      }
    }
    __syncthreads();
    if (qg > 0) return;
    for (int group = 1; group < query_groups; ++group) {
      const float* src = at(group);
#pragma unroll
      for (int c = 0; c < kColTiles; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dk_acc[c][j] += src[(c * 4 + j) * 32];
          dv_acc[c][j] += src[(kAcc / 2 + c * 4 + j) * 32];
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kColTiles; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + key0 + gr + 8 * (j >> 1), d = col0 + c * 8 + 2 * tc + (j & 1);
      if (s < S && d < dh) {
        const long at = ((static_cast<long>(b) * S + s) * H + h) * dh + d;
        dk[at] = dk_acc[c][j] * scale;
        dv[at] = dv_acc[c][j];
      }
    }
  }
}

// dq = the key tiles' shares, added in tile order; a tile that lies above
// the diagonal of a row's query tile wrote nothing there and is skipped.
__global__ void attention_bwd_dq_sum_kernel(const float* __restrict__ part,
                                            float* __restrict__ dq, int tiles, int keys,
                                            int rows, int Tq, int row_elems, int W,
                                            long plane) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  const int tile = static_cast<int>((i / row_elems) % Tq) / rows;
  float acc = 0.0f;
  for (int kt = 0; kt < tiles && first_query_tile(kt * keys, W, rows) <= tile; ++kt) {
    acc += part[kt * plane + i];
  }
  dq[i] = acc;
}

struct Args {
  const void *q, *k, *v, *g;
  const float *o, *lse;
  const int *seg_q, *seg_ctx;
  float *dq, *dq_part, *dk, *dv;
  int B, Tq, S, H, dh, W, key_warps, query_groups;
  float scale;
  int device;
};

template <typename T, int DP>
int launch_dp(const Args& a, cudaStream_t stream) {
  using L = Tile<T, DP>;
  const int warps = a.key_warps * L::kColGroups * a.query_groups;
  if (a.key_warps < 1 || a.query_groups < 1 || warps > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = L::smem_bytes(a.key_warps, a.query_groups);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = set_smem_ceiling_once<attention_bwd_kernel<T, DP>>(a.device, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int keys = kRows * a.key_warps, tiles = (a.S + keys - 1) / keys;
  if (tiles > 1 && a.dq_part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = a.dh % (16 / static_cast<int>(sizeof(T))) == 0 && aligned16(a.q) &&
                   aligned16(a.k) && aligned16(a.v) && aligned16(a.g) && aligned16(a.o);
  const dim3 grid(tiles, a.B * a.H);
  attention_bwd_kernel<T, DP><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.o, a.lse, a.seg_q, a.seg_ctx,
      tiles > 1 ? a.dq_part : a.dq, a.dk, a.dv, a.Tq, a.S, a.H, a.dh, a.W, a.scale,
      a.key_warps, a.query_groups, vec);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess || tiles == 1) return static_cast<int>(launched);
  const long plane = static_cast<long>(a.B) * a.Tq * a.H * a.dh;
  constexpr int kSumThreads = 256;
  attention_bwd_dq_sum_kernel<<<static_cast<unsigned>((plane + kSumThreads - 1) / kSumThreads),
                                kSumThreads, 0, stream>>>(
      a.dq_part, a.dq, tiles, keys, kRows * a.query_groups, a.Tq, a.H * a.dh, a.W, plane);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const Args& a, cudaStream_t stream) {
  switch (padded_width(a.dh)) {
    case 16: return launch_dp<T, 16>(a, stream);
    case 32: return launch_dp<T, 32>(a, stream);
    case 64: return launch_dp<T, 64>(a, stream);
    case 128: return launch_dp<T, 128>(a, stream);
    case 256: return launch_dp<T, 256>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) on `device` and returns
// cudaGetLastError(). is_bf16 selects bfloat16 q/k/v/dO (else float32);
// o is the f32 forward output [B, T, H, dh] and lse [B, H, T]; dh is 1 to
// 256; scale is 1/sqrt(dh), rounded to float by the caller. A block takes
// a key tile of 16 key_warps slots and query tiles of 16 query_groups
// rows with key_warps x query_groups x max(1, DP / 64) warps, at most 12,
// in at most 227 KB of shared memory (else cudaErrorInvalidValue). With
// one key tile (S <= 16 key_warps) dq_part is unused; with `tiles` of them
// it is an f32 scratch of tiles x B x T x H x dh and a second kernel sums
// it into dq. dq is [B, T, H, dh], dk and dv [B, S, H, dh], all float32.
extern "C" int attention_bwd_launch(const void* q, const void* k, const void* v,
                                    const void* g, const float* o, const float* lse,
                                    const int* seg_q, const int* seg_ctx, float* dq,
                                    float* dq_part, float* dk, float* dv, int B, int Tq,
                                    int S, int H, int dh, int W, int key_warps,
                                    int query_groups, float scale, int is_bf16, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, g, o, lse, seg_q, seg_ctx, dq, dq_part, dk, dv,
               B, Tq, S, H, dh, W, key_warps, query_groups, scale, device};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dh<__nv_bfloat16>(a, st) : launch_dh<float>(a, st);
}
