// Windowed flash attention, forward: the online-softmax output and the row
// logsumexp, with visibility derived from the segment ids in the kernel.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `_forward` of
// torched_impala_tpu/ops/attention_pallas.py. The TPU kernel walks a
// sequential grid over 128 x 512 tiles with the running max, normalizer
// and accumulator in VMEM scratch and the products on the MXU. Here a
// block owns one (b, h) and a query tile of 16 query_groups rows, and
// walks the context itself:
//
//   S   = Q K^T                      (16 queries x 16 slots a warp a step)
//   m'  = max(m, rowmax(S * scale)),  P = exp(S * scale - m') where visible
//   l   = l exp(m - m') + rowsum(P),  acc = acc exp(m - m') + P V
//
// Ownership: each group of warps owns 16 query rows (the m16 of every
// product), and key_warps warps share those rows and split the context:
// a step of the sweep copies 16 key_warps slots, and each key warp takes
// its own 16 of them, so each keeps its own running (m, l, acc) in
// registers. At DP = 128 and 256, DP / 64 warps split acc's columns into
// groups of 64 (acc stays at 32 registers a lane), each computing S in
// full. At the end every warp hands its partial to shared memory, and the
// key warps of a row group merge them in key-warp order, each taking
// every key_warps-th 8-column tile of the output, which it stores as
// column pairs (whole 32-byte sectors a row). No atomics: two launches
// on the same inputs are bit-identical.
//
// Copies: q's rows and segments, then each step's K, V and slot segments,
// go to shared memory with 16-byte `cp.async` (zero-filled past the row
// count and the true dh) from every thread, double-buffered over the
// steps, so the next step's copy runs under this step's products. Each K
// and V element is read from device memory once for each (b, h, query
// tile): once in all where one query tile covers T (the learner's T =
// 21). A head width whose rows are not whole 16-byte chunks, or a tensor
// not 16-byte aligned, takes plain loads at the same points.
//
// Tensor cores: both products are `mma.sync.m16n8k8` in TF32 with f32
// accumulators (attention_common.cuh). float32 operands are split in two
// (3xTF32: lo*hi + hi*lo + hi*hi), so the f32 gates hold; bfloat16 inputs,
// and P rounded to bfloat16 before P V (as the TPU kernel feeds p in v's
// dtype to the MXU), are exact in TF32 and take one product. S's
// contraction takes q's and k's columns in pairs (one 8- or 4-byte read),
// and P leaves S's accumulators as the A operand of P V with no shuffle.
// Masking is elementwise on S's fragment, from the segments in shared
// memory. A step past the causal diagonal of the block's last row ends
// the sweep, and a warp skips the slots past its own rows' diagonal. An
// (m16 x n8) fragment that sees nothing skips its product, its
// exponentials and its share of P V: exact, since P is 0 there. A row
// that sees nothing at all writes zeros and lse = -1e30 (finite). Why
// `mma.sync` and not `wgmma`: `wgmma`'s 64-row tile would be two-thirds
// padding at the learner's 21 query rows.
//
// Tiles: the wrapper chooses (key_warps, query_groups) per call
// (ops/attention_cuda.py:fwd_tiles). The grid is (B H, query tiles), the
// last (longest, under the causal sweep) query tiles first. The shared-
// memory ceiling is the card's 227 KB, set once per instantiation and
// device (smem_ceiling.cuh); a launch asks for its own tiles' size.
//
// Head widths: any dh from 1 to 256 runs at the padded width DP of
// attention_common.cuh (16, 32, 64, 128 or 256); the padded columns load as
// 0 and add only 0 x 0 terms, and out is written for d < dh.
//
// Bound: at the learner's shape (B = 32, T = 21, H = 4, dh = 64, S = 149,
// f32) the kernel must read q (0.69 MB), k and v (4.88 MB each) and write
// out (0.69 MB) and lse: about 11.1 MB, 3.3 us at 3.35 TB/s. The products
// are at most 4 B H T S dh = 1.0e8 operations, 0.6 us as 3xTF32 at
// 495 / 3 TFLOP/s.

#include <algorithm>

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kRows = 16;      // query rows a warp owns: the m16 of every product
constexpr int kKeys = 16;      // slots a key warp takes a step
constexpr int kTiles = kKeys / 8;  // its n8 tiles of S
constexpr int kMaxWarps = 12;  // a block's most: 168 registers a thread fit

// The layout of the DP instantiation: a block has key_warps x kColGroups
// x query_groups warps, its query tile 16 query_groups rows and a step
// 16 key_warps slots.
template <typename T, int DP>
struct Tile {
  static constexpr int kColGroups = DP <= 64 ? 1 : DP / 64;
  static constexpr int kCols = DP / kColGroups;
  static constexpr int kColTiles = kCols / 8;
  // Row strides (elements) for conflict-free fragment reads: q and k are
  // read as pairs of columns (kk + 2 tc, kk + 2 tc + 1), v one column of
  // rows 2 tc and 2 tc + 1.
  static constexpr int kLd = DP + 8;                                  // a row of q, k
  static constexpr int kLdV = DP + 16 / static_cast<int>(sizeof(T));  // a row of v
  static constexpr int kRowBytes = kLd * static_cast<int>(sizeof(T)) + 4;  // and its segment
  static constexpr int kKeyBytes = kRowBytes + kLdV * static_cast<int>(sizeof(T));  // k, v, segment
  // Q's A fragments a warp keeps in registers for the whole sweep (at DP
  // <= 64; wider rows are read from shared memory for each step).
  static constexpr int kQSteps = DP <= 64 ? DP / 8 : 1;
  // What a lane hands over for the merge: acc, then m and l of its rows.
  static constexpr int kPartial = 4 * kColTiles + 4;
  // Dynamic shared memory: q's rows and segments, then two buffers of
  // K, V and the slot segments; after the sweep, the warps' partials.
  static int smem_bytes(int key_warps, int query_groups) {
    const int rows = kRows * query_groups, keys = kKeys * key_warps;
    const int sweep = rows * kRowBytes + 2 * keys * kKeyBytes;
    const int merge = query_groups * kColGroups * key_warps * kPartial * 32 * 4;
    return std::max(sweep, merge);
  }
};

// Two adjacent elements (8- or 4-byte aligned) as floats.
__device__ __forceinline__ float2 to_f32x2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 to_f32x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int DP>
__global__ void __launch_bounds__(32 * kMaxWarps) attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ seg_q, const int* __restrict__ seg_ctx, float* __restrict__ out,
    float* __restrict__ lse, int Tq, int S, int H, int dh, int W, float scale, int key_warps,
    int query_groups, bool vec) {
  using L = Tile<T, DP>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kLd = L::kLd, kLdV = L::kLdV, kColTiles = L::kColTiles;
  const int rows = kRows * query_groups, keys = kKeys * key_warps;

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  int* segq_s = reinterpret_cast<int*>(q_s + rows * kLd);
  unsigned char* bufs = reinterpret_cast<unsigned char*>(segq_s + rows);
  const int buf_bytes = keys * L::kKeyBytes;
  auto k_buf = [&](int i) { return reinterpret_cast<T*>(bufs + i * buf_bytes); };
  auto v_buf = [&](int i) { return k_buf(i) + keys * kLd; };
  auto seg_buf = [&](int i) { return reinterpret_cast<int*>(v_buf(i) + keys * kLdV); };

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * rows;  // the longest sweeps first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tc = lane % 4;
  const int kw = warp % key_warps, cg = warp / key_warps % L::kColGroups;
  const int qg = warp / (key_warps * L::kColGroups);
  const int qr0 = qg * kRows;      // the warp's first row in the query tile
  const int col0 = cg * L::kCols;  // its first output column

  // The slots [0, s_end) that the block's rows may see, and [0, warp_end)
  // that the warp's may (none for rows past Tq).
  const int s_end = min(S, W + min(t0 + rows, Tq));
  const int warp_end = t0 + qr0 < Tq ? min(S, W + min(t0 + qr0 + kRows, Tq)) : 0;
  const int steps = (s_end + keys - 1) / keys;

  // One commit group a step (its K, V and slot segments).
  auto load_keys = [&](int buf, int s0) {
    copy_rows<T, DP, kLd>(k_buf(buf), k, keys, b, h, s0, S, H, dh, vec);
    copy_rows<T, DP, kLdV>(v_buf(buf), v, keys, b, h, s0, S, H, dh, vec);
    for (int r = threadIdx.x; r < keys; r += blockDim.x) {
      const int s = s0 + r;
      const bool in = s < S;
      cp_async4(seg_buf(buf) + r, seg_ctx + (in ? static_cast<long>(b) * S + s : 0), in);
    }
    cp_async_commit();
  };

  copy_rows<T, DP, kLd>(q_s, q, rows, b, h, t0, Tq, H, dh, vec);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int t = t0 + r;
    const bool in = t < Tq;
    cp_async4(segq_s + r, seg_q + (in ? static_cast<long>(b) * Tq + t : 0), in);
  }
  load_keys(0, 0);  // its group holds q and q's segments too
  if (steps > 1) {
    load_keys(1, keys);
  } else {
    cp_async_commit();
  }
  cp_async_wait<1>();
  __syncthreads();

  // The warp's rows gr and gr + 8, and Q's A fragments.
  int t_row[2], seg_t[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    t_row[r] = t0 + qr0 + gr + 8 * r;
    seg_t[r] = segq_s[qr0 + gr + 8 * r];
  }
  // S's contraction runs over the columns of q and k in any order that
  // both take: A's columns tc and tc + 4, and B's rows tc and tc + 4, are
  // columns kk + 2 tc and kk + 2 tc + 1, read as one pair.
  auto q_frag = [&](int kk) {
    Frag<kSplit, 4> a;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 x = to_f32x2(q_s + (qr0 + gr + 8 * i) * kLd + kk + 2 * tc);
      a.set(i, x.x);
      a.set(i + 2, x.y);
    }
    return a;
  };
  Frag<kSplit, 4> q_reg[L::kQSteps];
  if constexpr (DP <= 64) {
#pragma unroll
    for (int i = 0; i < L::kQSteps; ++i) q_reg[i] = q_frag(8 * i);
  }

  // m and l of rows gr and gr + 8 (l summed over this lane's columns
  // only, until the end); acc of its 16 rows x kCols columns.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[kColTiles][4] = {};

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step > 0) {
      cp_async_wait<1>();
      __syncthreads();
    }
    const int s0 = step * keys + kw * kKeys;  // the warp's first slot
    if (s0 < warp_end) {
      const T* k_s = k_buf(buf) + kw * kKeys * kLd;
      const T* v_s = v_buf(buf) + kw * kKeys * kLdV;
      const int* segc_s = seg_buf(buf) + kw * kKeys;

      // Visibility of S's fragment: element j of tile n is row gr + 8 (j >> 1),
      // slot n * 8 + 2 tc + (j & 1).
      bool vis[kTiles][4], live[kTiles], any_live = false;
#pragma unroll
      for (int n = 0; n < kTiles; ++n) {
        bool any = false;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int slot = n * 8 + 2 * tc + (j & 1), s = s0 + slot, r = j >> 1;
          vis[n][j] = t_row[r] < Tq && s < S && visible(seg_t[r], segc_s[slot], t_row[r], s, W);
          any |= vis[n][j];
        }
        live[n] = __any_sync(kFull, any);
        any_live |= live[n];
      }

      if (any_live) {
        // S = Q K^T over DP, for the tiles that see anything.
        float st[kTiles][4] = {}, st_lo[kTiles][4] = {};
#pragma unroll
        for (int kk = 0; kk < DP; kk += 8) {
          Frag<kSplit, 4> qa;
          if constexpr (DP <= 64) {
            qa = q_reg[kk / 8];
          } else {
            qa = q_frag(kk);
          }
#pragma unroll
          for (int n = 0; n < kTiles; ++n) {
            if (!live[n]) continue;
            Frag<kSplit, 2> kb;
            const float2 x = to_f32x2(k_s + (n * 8 + gr) * kLd + kk + 2 * tc);
            kb.set(0, x.x);
            kb.set(1, x.y);
            mma2<kSplit>(st[n], st_lo[n], qa, kb);
          }
        }

        // The online softmax of rows gr and gr + 8 over the step's slots.
        float logit[kTiles][4], m_new[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < kTiles; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            logit[n][j] = vis[n][j] ? (st[n][j] + st_lo[n][j]) * scale : kNegInf;
            m_new[j >> 1] = fmaxf(m_new[j >> 1], logit[n][j]);
          }
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(kFull, m_new[r], 1));
          m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(kFull, m_new[r], 2));
          alpha[r] = expf(m[r] - m_new[r]);
          m[r] = m_new[r];
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int c = 0; c < kColTiles; ++c) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[c][j] *= alpha[j >> 1];
        }

        // acc += P V, eight slots a product: A's columns tc and tc + 4 are
        // slots 2 tc and 2 tc + 1 of the tile, and so are B's rows.
#pragma unroll
        for (int n = 0; n < kTiles; ++n) {
          if (!live[n]) continue;
          float p[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p[j] = vis[n][j] ? expf(logit[n][j] - m[j >> 1]) : 0.0f;
            l[j >> 1] += p[j];
          }
          Frag<kSplit, 4> pa;
#pragma unroll
          for (int j = 0; j < 4; ++j) pa.set(j, round_to<T>(p[(j & 1) * 2 + (j >> 1)]));
          const T* v_rows = v_s + (n * 8 + 2 * tc) * kLdV + col0 + gr;
#pragma unroll
          for (int c = 0; c < kColTiles; ++c) {
            Frag<kSplit, 2> vb;
            vb.set(0, to_f32(v_rows[c * 8]));
            vb.set(1, to_f32(v_rows[kLdV + c * 8]));
            mma<kSplit>(acc[c], pa, vb);
          }
        }
      }
    }
    __syncthreads();  // this buffer is consumed; the copy two steps on reuses it
    if (step + 2 < steps) {
      load_keys(buf, (step + 2) * keys);
    } else {
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // The key warps' partials (acc, m, l) merged in key-warp order, each
  // key warp of a row group taking every key_warps-th column tile of the
  // output: the merge and the stores are spread over all the warps.
  constexpr int kAcc = 4 * kColTiles;
  __syncthreads();  // the sweep's shared memory is free
  float* parts = reinterpret_cast<float*>(smem);
  const int group = qg * L::kColGroups + cg;
  auto at = [&](int from) { return parts + (group * key_warps + from) * L::kPartial * 32 + lane; };
  float* own = at(kw);
#pragma unroll
  for (int c = 0; c < kColTiles; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) own[(c * 4 + j) * 32] = acc[c][j];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    own[(kAcc + r) * 32] = m[r];
    own[(kAcc + 2 + r) * 32] = l[r];
  }
  __syncthreads();
  unsigned mine = 0;  // the column tiles this warp merges and stores
  for (int c = kw; c < kColTiles; c += key_warps) mine |= 1u << c;
  float m_all[2] = {kNegInf, kNegInf}, l_all[2] = {0.0f, 0.0f};
  for (int from = 0; from < key_warps; ++from) {
#pragma unroll
    for (int r = 0; r < 2; ++r) m_all[r] = fmaxf(m_all[r], at(from)[(kAcc + r) * 32]);
  }
#pragma unroll
  for (int c = 0; c < kColTiles; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] = 0.0f;
  }
  for (int from = 0; from < key_warps; ++from) {
    const float* src = at(from);
    float f[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      f[r] = expf(src[(kAcc + r) * 32] - m_all[r]);
      l_all[r] += src[(kAcc + 2 + r) * 32] * f[r];
    }
#pragma unroll
    for (int c = 0; c < kColTiles; ++c) {
      if (!(mine >> c & 1u)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][j] += src[(c * 4 + j) * 32] * f[j >> 1];
    }
  }

  // l over the row's four lanes (the same sum, bit for bit, in each), then
  // out = acc / l and lse = m + log(l); l = 0 (a row that sees nothing)
  // gives zeros and -1e30.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_all[r] += __shfl_xor_sync(kFull, l_all[r], 1);
    l_all[r] += __shfl_xor_sync(kFull, l_all[r], 2);
    const int t = t_row[r];
    if (t >= Tq) continue;
    const float safe_l = l_all[r] > 0.0f ? l_all[r] : 1.0f, inv_l = 1.0f / safe_l;
    const long row = ((static_cast<long>(b) * Tq + t) * H + h) * dh;
#pragma unroll
    for (int c = 0; c < kColTiles; ++c) {
      if (!(mine >> c & 1u)) continue;
      const int d = col0 + c * 8 + 2 * tc;
      if (dh % 2 == 0) {
        // Columns d and d + 1 as one 8-byte store: a row's four lanes
        // write whole 32-byte sectors.
        if (d < dh) {
          *reinterpret_cast<float2*>(out + row + d) =
              make_float2(acc[c][2 * r] * inv_l, acc[c][2 * r + 1] * inv_l);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (d + j < dh) out[row + d + j] = acc[c][2 * r + j] * inv_l;
        }
      }
    }
    if (kw == 0 && cg == 0 && tc == 0) {
      lse[(static_cast<long>(b) * H + h) * Tq + t] = m_all[r] + logf(safe_l);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const int *seg_q, *seg_ctx;
  float *out, *lse;
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
  const int rows = kRows * a.query_groups, tiles = (a.Tq + rows - 1) / rows;
  if (smem > kMaxSmem || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = set_smem_ceiling_once<attention_fwd_kernel<T, DP>>(a.device, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = a.dh % (16 / static_cast<int>(sizeof(T))) == 0 && aligned16(a.q) &&
                   aligned16(a.k) && aligned16(a.v);
  const dim3 grid(a.B * a.H, tiles);
  attention_fwd_kernel<T, DP><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.seg_q, a.seg_ctx, a.out, a.lse, a.Tq, a.S, a.H, a.dh, a.W, a.scale, a.key_warps,
      a.query_groups, vec);
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
// cudaGetLastError(). is_bf16 selects bfloat16 q/k/v (else float32); dh is
// 1 to 256; scale is 1/sqrt(dh), rounded to float by the caller. A block
// takes query tiles of 16 query_groups rows and steps of 16 key_warps
// slots with key_warps x query_groups x max(1, DP / 64) warps, at most 12,
// in at most 227 KB of shared memory (else cudaErrorInvalidValue). out is
// [B, T, H, dh] and lse [B, H, T], both float32.
extern "C" int attention_fwd_plan_launch(const void* q, const void* k, const void* v,
                                         const int* seg_q, const int* seg_ctx, float* out,
                                         float* lse, int B, int Tq, int S, int H, int dh, int W,
                                         int key_warps, int query_groups, float scale,
                                         int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, seg_q, seg_ctx, out, lse, B, Tq, S, H, dh, W,
               key_warps, query_groups, scale, device};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dh<__nv_bfloat16>(a, st) : launch_dh<float>(a, st);
}
