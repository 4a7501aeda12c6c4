// Tiled self-attention forward and backward: BERT-style attention with a
// per-row additive mask over q, k and v held as (N, hd) head tiles, for any
// sequence length N. Keys and values stream through shared memory in tiles
// of 64 rows, so no buffer grows with N (the row 5 kernel,
// self_attention.cu, stages a head's whole K and V per block: at N = 577,
// hd = 64 in fp32 that is about 300 KB, above the 227 KB a block may have).
//
// Replaces: empirical_mvm_tpu/ops/window_attention.py `_sa_kernel` (forward,
// with `_sa_dropout`) and `_sa_bwd_kernel` (backward), over the grids that
// `packed_self_attention` and `fused_self_attention` give them through
// `_sa_call`. Same function: for every row b and head h,
//   out[b, h] = dropout(softmax(q[b, h] * scale . k[b, h]^T + mask[b])) . v[b, h]
// with q, k, v (N, hd) tiles, mask (B, N, N) fp32 addressed through a batch
// and a row stride (a (B, 1, N) padding mask broadcast over the query rows
// has row stride 0), out (B, nH, N, hd) in the inputs' dtype. The packed
// layout is one (B, 3nH, N, hd) array, q, k and v of head h at head slots h,
// nH + h and 2nH + h; the split layout is three (B, nH, N, hd) arrays. The
// C entry points take the q, k and v base pointers and the stride between
// rows b (3nH * N * hd or nH * N * hd elements), so one kernel body serves
// both. Dropout is Philox from (seed, offset) with the counter over
// (b, h, row, col), as `lane_self_attention` draws it (common.cuh), so the
// forward, the backward and the plain version agree whatever the tiling;
// the TPU kernel drew from the core's generator per program and had to keep
// one block shape between forward and backward.
//
// Rounding points, those of the JAX kernels: q * scale rounded to the
// storage type before the scores and before dk; fp32 scores, mask, softmax
// (p = exp(s - max) / sum); the probabilities after dropout rounded before
// P.V and before dv; ds = p * (dp - D), D = rowsum(dp * p), rounded before
// dq and dk; dq scaled in fp32. FlashAttention's D = rowsum(dO * O) is the
// same sum in exact arithmetic, but from O rounded to bf16 it moves a large
// share of the bf16 dq and dk elements by a rounding
// (tests/test_torch_self_attention.py shows it), so the backward sums the
// JAX D in a pass of its own.
//
// Two bodies, picked by dtype and hd in the C entry points (the rule of
// ops/window_attention.py `_sa_body`):
//   * bf16 at hd 32, 64 or 128: the tensor-core body, self_attention_mma.cuh
//     (mma.sync m16n8k16, ldmatrix, cp.async; its design is there). BERT-base
//     and DPT-L have hd = 64.
//   * fp32, and bf16 at any other hd (up to 128): the CUDA-core body below,
//     whose fp32 products the fp32 limits need (TF32 tensor cores keep about
//     three digits).
//
// Bound on the H100: at the multiple-choice fusion shape (40 rows of
// N = 350, 12 heads, hd = 64, bf16) the forward does 4 * N^2 * hd operations
// per (row, head), 15.05 GFLOP in all (0.015 ms at 989 TFLOP/s), on 86 MB
// (q, k, v and out in bf16, read or written once; the stride-0 mask 56 KB):
// 0.026 ms at 3.35 TB/s, memory. The backward does 2.5 times the operations
// (37.6 GFLOP, 0.038 ms) on 150 MB (0.045 ms): memory. The tensor-core body
// does more than that count, three products of 2 * N^2 * hd in the forward
// (the scores twice) and nine in the backward (the scores and dp three
// times), and its exp, division and Philox per score run on the CUDA cores.
//
// The CUDA-core body (first, simple version). Every block holds fixed-size
// tiles only:
//   forward, one 256-thread block per (query tile of kTile rows, head, row
//     b), each of its 8 warps owning kTile / 8 query rows. Pass 1 streams
//     the K tiles and keeps each query row's running max and sum (an online
//     softmax in fp32); pass 2 streams K and V again, forms the normalised
//     probability exp(s - max) / sum exactly as the plain softmax does,
//     applies dropout, rounds it and accumulates P.V in fp32. A one-pass
//     online softmax would round the unnormalised probability, not the JAX
//     kernel's normalised one. The row's max and sum (the log-sum-exp in two
//     parts, fp32, (B, nH, 2, N)) go to `stats` for the backward;
//   backward, two kernels over the same grid, no atomics, so that two runs
//     give bit-identical gradients:
//     rows: per query row, pass A over the K and V tiles sums
//       D = rowsum(dp * p) in fp32 (written to `dsum`), p recomputed from
//       the stored max and sum and dp = dO . v^T under the keep mask; pass B
//       streams them again for ds = p * (dp - D) and dq = round(ds) . K *
//       scale;
//     columns: per key tile, one pass over the query tiles (q * scale, dO,
//       the mask tile, max, sum and D staged) recomputing p and ds bit for
//       bit as the rows kernel computed them (the same fma chains), then
//       dv = round(p_drop)^T . dO and dk = round(ds)^T . (q * scale).
#include "common.cuh"
#include "self_attention_mma.cuh"

#include <algorithm>

namespace emvm {
namespace {

constexpr int kTile = 64;                         // query rows of a block, keys of a tile
constexpr int kRowsPerWarp = kTile / kAttnWarps;  // 8
constexpr int kMaxHd = 128;
constexpr int kHdSlots = kMaxHd / 32;             // channels per lane, at most

template <typename T>
__host__ __device__ inline size_t tile_bytes(int hd) {
  return align16(size_t(kTile) * k_row_stride<T>(hd) * sizeof(T));
}

__host__ __device__ inline size_t warp_rows_bytes(int hd) {
  return align16(size_t(kAttnWarps) * kRowsPerWarp * hd * sizeof(float));
}

constexpr size_t kWarpTileBytes = size_t(kAttnWarps) * kTile * sizeof(float);

// Shared memory of each kernel (none depends on N).
template <typename T>
__host__ __device__ inline size_t fwd_smem_bytes(int hd) {
  return 2 * tile_bytes<T>(hd) + warp_rows_bytes(hd) + kWarpTileBytes;
}
template <typename T>
__host__ __device__ inline size_t rows_smem_bytes(int hd) {
  return 2 * tile_bytes<T>(hd) + 2 * warp_rows_bytes(hd) + kWarpTileBytes;
}
constexpr size_t kMaskTileBytes = size_t(kTile) * (kTile + 1) * sizeof(float);
constexpr size_t kStatTileBytes = 3 * kTile * sizeof(float);
template <typename T>
__host__ __device__ inline size_t cols_smem_bytes(int hd) {
  return 2 * tile_bytes<T>(hd) + kMaskTileBytes + kStatTileBytes + 2 * warp_rows_bytes(hd) +
         2 * kWarpTileBytes;
}

// The score and dp dot products. Every kernel forms s(i, j) and dp(i, j)
// with this one fma chain over d = 0..hd-1 (fmaf is exact in the order of
// its two factors), so the backward recomputes the forward's p bit for bit.
template <typename T>
__device__ __forceinline__ float dot_row(const float* __restrict__ a, const T* __restrict__ b,
                                         int hd) {
  float acc = 0.f;
  for (int d = 0; d < hd; ++d) acc = fmaf(a[d], to_float(b[d]), acc);
  return acc;
}

// Stage rows [r0, r0 + rows) of a (N, hd) head tile into smem rows of stride
// ks, optionally multiplied by the scale and rounded to T (q * scale).
template <typename T>
__device__ __forceinline__ void stage_tile(T* __restrict__ dst, const T* __restrict__ src,
                                           int r0, int rows, int hd, int ks, bool scaled,
                                           float scale_t) {
  for (int idx = threadIdx.x; idx < rows * hd; idx += blockDim.x) {
    const int r = idx / hd, e = idx % hd;
    const T x = src[size_t(r0 + r) * hd + e];
    dst[r * ks + e] = scaled ? from_float<T>(to_float(x) * scale_t) : x;
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    tiled_sa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, long long bs, const float* __restrict__ mask,
                        long long mask_sb, long long mask_sr, T* __restrict__ out,
                        float* __restrict__ stats, int n, int nh, int hd, float scale_t,
                        const int* __restrict__ seed, unsigned threshold, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ks = k_row_stride<T>(hd);
  T* kt = reinterpret_cast<T*>(smem_raw);
  T* vt = reinterpret_cast<T*>(smem_raw + tile_bytes<T>(hd));
  float* qw = reinterpret_cast<float*>(smem_raw + 2 * tile_bytes<T>(hd)) +
              size_t(warp) * kRowsPerWarp * hd;
  float* pw = reinterpret_cast<float*>(smem_raw + 2 * tile_bytes<T>(hd) + warp_rows_bytes(hd)) +
              size_t(warp) * kTile;
  const Heads hs = heads(bs, n, nh, hd);
  const T *qh = q + hs.qkv, *kh = k + hs.qkv, *vh = v + hs.qkv;
  const float* mask_b = mask + b * mask_sb;
  const Dropout drop(seed, threshold, inv_keep);
  const int i0 = blockIdx.x * kTile + warp;       // row r of this warp: i0 + r * kAttnWarps

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = i0 + r * kAttnWarps;
    for (int d = lane; d < hd; d += 32)
      qw[r * hd + d] =
          i < n ? to_float(from_float<T>(to_float(qh[size_t(i) * hd + d]) * scale_t)) : 0.f;
  }
  __syncwarp();

  float mx[kRowsPerWarp], sum[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    mx[r] = -CUDART_INF_F;
    sum[r] = 0.f;
  }
  const int n_tiles = (n + kTile - 1) / kTile;

  // pass 1: each row's max and sum over the streamed K tiles
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kTile, jn = min(kTile, n - j0);
    __syncthreads();                              // the previous tile is read
    stage_tile(kt, kh, j0, jn, hd, ks, false, 0.f);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = i0 + r * kAttnWarps;
      if (i < n) {                                // warp-uniform
        const float* mrow = mask_b + i * mask_sr + j0;
        float s[2], tmax = -CUDART_INF_F;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int jj = lane + 32 * u;
          s[u] = jj < jn ? dot_row(qw + r * hd, kt + jj * ks, hd) + mrow[jj] : -CUDART_INF_F;
          tmax = fmaxf(tmax, s[u]);
        }
        const float m_new = fmaxf(mx[r], warp_max(tmax));
        const float e = warp_sum(expf(s[0] - m_new) + expf(s[1] - m_new));
        sum[r] = sum[r] * expf(mx[r] - m_new) + e;
        mx[r] = m_new;
      }
    }
  }

  // pass 2: p = exp(s - max) / sum, dropout, rounded, accumulated into P.V
  float acc[kRowsPerWarp][kHdSlots];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kHdSlots; ++c) acc[r][c] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kTile, jn = min(kTile, n - j0);
    __syncthreads();
    stage_tile(kt, kh, j0, jn, hd, ks, false, 0.f);
    stage_tile(vt, vh, j0, jn, hd, hd, false, 0.f);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = i0 + r * kAttnWarps;
      if (i < n) {
        const float* mrow = mask_b + i * mask_sr + j0;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int jj = lane + 32 * u;
          float p = 0.f;
          if (jj < jn) {
            p = expf(dot_row(qw + r * hd, kt + jj * ks, hd) + mrow[jj] - mx[r]) / sum[r];
            if (drop.on) p = drop.keep(b, h, i, j0 + jj) ? p * drop.inv_keep : 0.f;
          }
          pw[jj] = to_float(from_float<T>(p));
        }
        __syncwarp();
#pragma unroll
        for (int c = 0; c < kHdSlots; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) {
            float a = acc[r][c];
            for (int jj = 0; jj < jn; ++jj) a = fmaf(pw[jj], to_float(vt[jj * hd + d]), a);
            acc[r][c] = a;
          }
        }
        __syncwarp();                             // the next row rewrites pw
      }
    }
  }

  T* oh = out + hs.out;
  float* st = stats + hs.stat * 2 * n;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = i0 + r * kAttnWarps;
    if (i < n) {
#pragma unroll
      for (int c = 0; c < kHdSlots; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) oh[size_t(i) * hd + d] = from_float<T>(acc[r][c]);
      }
      if (lane == 0) {
        st[i] = mx[r];
        st[n + i] = sum[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: rows (dq and D), then columns (dk and dv)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    tiled_sa_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ dq, long long bs,
                             const float* __restrict__ mask, long long mask_sb,
                             long long mask_sr, const T* __restrict__ dout,
                             const float* __restrict__ stats,
                             float* __restrict__ dsum, int n, int nh, int hd, float scale_t,
                             float scale_f, const int* __restrict__ seed, unsigned threshold,
                             float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ks = k_row_stride<T>(hd);
  const size_t tb = tile_bytes<T>(hd), wb = warp_rows_bytes(hd);
  T* kt = reinterpret_cast<T*>(smem_raw);
  T* vt = reinterpret_cast<T*>(smem_raw + tb);
  float* qw = reinterpret_cast<float*>(smem_raw + 2 * tb) + size_t(warp) * kRowsPerWarp * hd;
  float* dw = reinterpret_cast<float*>(smem_raw + 2 * tb + wb) + size_t(warp) * kRowsPerWarp * hd;
  float* sw = reinterpret_cast<float*>(smem_raw + 2 * tb + 2 * wb) + size_t(warp) * kTile;
  const Heads hs = heads(bs, n, nh, hd);
  const T *qh = q + hs.qkv, *kh = k + hs.qkv, *vh = v + hs.qkv;
  const T* doh = dout + hs.out;
  const float* st = stats + hs.stat * 2 * n;
  const float* mask_b = mask + b * mask_sb;
  const Dropout drop(seed, threshold, inv_keep);
  const int i0 = blockIdx.x * kTile + warp;

  float mx[kRowsPerWarp], sum[kRowsPerWarp], dd[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = i0 + r * kAttnWarps;
    for (int d = lane; d < hd; d += 32) {
      qw[r * hd + d] =
          i < n ? to_float(from_float<T>(to_float(qh[size_t(i) * hd + d]) * scale_t)) : 0.f;
      dw[r * hd + d] = i < n ? to_float(doh[size_t(i) * hd + d]) : 0.f;
    }
    mx[r] = i < n ? st[i] : 0.f;
    sum[r] = i < n ? st[n + i] : 1.f;
    dd[r] = 0.f;                                  // this lane's part of D
  }
  __syncwarp();
  const int n_tiles = (n + kTile - 1) / kTile;

  // pass A: D = rowsum(dp * p)
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kTile, jn = min(kTile, n - j0);
    __syncthreads();
    stage_tile(kt, kh, j0, jn, hd, ks, false, 0.f);
    stage_tile(vt, vh, j0, jn, hd, ks, false, 0.f);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = i0 + r * kAttnWarps;
      if (i < n) {
        const float* mrow = mask_b + i * mask_sr + j0;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int jj = lane + 32 * u;
          if (jj < jn) {
            const float p =
                expf(dot_row(qw + r * hd, kt + jj * ks, hd) + mrow[jj] - mx[r]) / sum[r];
            float dp = dot_row(dw + r * hd, vt + jj * ks, hd);
            if (drop.on) dp = drop.keep(b, h, i, j0 + jj) ? dp * drop.inv_keep : 0.f;
            dd[r] += dp * p;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = i0 + r * kAttnWarps;
    dd[r] = warp_sum(dd[r]);
    if (lane == 0 && i < n) dsum[hs.stat * n + i] = dd[r];
  }

  // pass B: ds and dq
  float acc[kRowsPerWarp][kHdSlots];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kHdSlots; ++c) acc[r][c] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kTile, jn = min(kTile, n - j0);
    __syncthreads();
    stage_tile(kt, kh, j0, jn, hd, ks, false, 0.f);
    stage_tile(vt, vh, j0, jn, hd, ks, false, 0.f);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = i0 + r * kAttnWarps;
      if (i < n) {
        const float* mrow = mask_b + i * mask_sr + j0;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int jj = lane + 32 * u;
          float ds = 0.f;
          if (jj < jn) {
            const float p =
                expf(dot_row(qw + r * hd, kt + jj * ks, hd) + mrow[jj] - mx[r]) / sum[r];
            float dp = dot_row(dw + r * hd, vt + jj * ks, hd);
            if (drop.on) dp = drop.keep(b, h, i, j0 + jj) ? dp * drop.inv_keep : 0.f;
            ds = to_float(from_float<T>(p * (dp - dd[r])));
          }
          sw[jj] = ds;
        }
        __syncwarp();
#pragma unroll
        for (int c = 0; c < kHdSlots; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) {
            float a = acc[r][c];
            for (int jj = 0; jj < jn; ++jj) a = fmaf(sw[jj], to_float(kt[jj * ks + d]), a);
            acc[r][c] = a;
          }
        }
        __syncwarp();
      }
    }
  }

  T* dqh = dq + hs.qkv;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = i0 + r * kAttnWarps;
    if (i < n) {
#pragma unroll
      for (int c = 0; c < kHdSlots; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) dqh[size_t(i) * hd + d] = from_float<T>(acc[r][c] * scale_f);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    tiled_sa_bwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ dk, T* __restrict__ dv,
                             long long bs, const float* __restrict__ mask, long long mask_sb,
                             long long mask_sr, const T* __restrict__ dout,
                             const float* __restrict__ stats, const float* __restrict__ dsum,
                             int n, int nh, int hd, float scale_t, const int* __restrict__ seed,
                             unsigned threshold, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ks = k_row_stride<T>(hd);
  const size_t tb = tile_bytes<T>(hd), wb = warp_rows_bytes(hd);
  unsigned char* cur = smem_raw;
  T* qt = reinterpret_cast<T*>(cur);                // q * scale, rounded
  T* dt = reinterpret_cast<T*>(cur += tb);          // dO
  float* mt = reinterpret_cast<float*>(cur += tb);  // mask tile, (query, key), rows kTile + 1
  float* st_max = reinterpret_cast<float*>(cur += kMaskTileBytes);
  float* st_sum = st_max + kTile;
  float* st_d = st_sum + kTile;
  float* kw = reinterpret_cast<float*>(cur += kStatTileBytes) + size_t(warp) * kRowsPerWarp * hd;
  float* vw = reinterpret_cast<float*>(cur += wb) + size_t(warp) * kRowsPerWarp * hd;
  float* pa = reinterpret_cast<float*>(cur += wb) + size_t(warp) * kTile;
  float* pb = reinterpret_cast<float*>(cur + kWarpTileBytes) + size_t(warp) * kTile;
  const Heads hs = heads(bs, n, nh, hd);
  const T *qh = q + hs.qkv, *kh = k + hs.qkv, *vh = v + hs.qkv, *doh = dout + hs.out;
  const float* st = stats + hs.stat * 2 * n;
  const float* dsh = dsum + hs.stat * n;
  const float* mask_b = mask + b * mask_sb;
  const Dropout drop(seed, threshold, inv_keep);
  const int key0 = blockIdx.x * kTile, keys = min(kTile, n - key0);
  const int j0 = key0 + warp;                     // key row r of this warp: j0 + r * kAttnWarps

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int j = j0 + r * kAttnWarps;
    for (int d = lane; d < hd; d += 32) {
      kw[r * hd + d] = j < n ? to_float(kh[size_t(j) * hd + d]) : 0.f;
      vw[r * hd + d] = j < n ? to_float(vh[size_t(j) * hd + d]) : 0.f;
    }
  }
  __syncwarp();

  float ak[kRowsPerWarp][kHdSlots], av[kRowsPerWarp][kHdSlots];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kHdSlots; ++c) ak[r][c] = av[r][c] = 0.f;
  const int n_tiles = (n + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kTile, qn = min(kTile, n - q0);
    __syncthreads();
    stage_tile(qt, qh, q0, qn, hd, ks, true, scale_t);
    stage_tile(dt, doh, q0, qn, hd, ks, false, 0.f);
    for (int idx = threadIdx.x; idx < qn * keys; idx += blockDim.x) {
      const int ii = idx / keys, jj = idx % keys;
      mt[ii * (kTile + 1) + jj] = mask_b[(q0 + ii) * mask_sr + key0 + jj];
    }
    for (int ii = threadIdx.x; ii < qn; ii += blockDim.x) {
      st_max[ii] = st[q0 + ii];
      st_sum[ii] = st[n + q0 + ii];
      st_d[ii] = dsh[q0 + ii];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int j = j0 + r * kAttnWarps;
      if (j < n) {
        const int jl = warp + r * kAttnWarps;     // j - key0
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int ii = lane + 32 * u;
          float pd = 0.f, ds = 0.f;
          if (ii < qn) {
            const float p =
                expf(dot_row(kw + r * hd, qt + ii * ks, hd) + mt[ii * (kTile + 1) + jl] -
                     st_max[ii]) / st_sum[ii];
            float dp = dot_row(vw + r * hd, dt + ii * ks, hd);
            pd = p;
            if (drop.on) {
              const bool keep = drop.keep(b, h, q0 + ii, j);
              pd = keep ? p * drop.inv_keep : 0.f;
              dp = keep ? dp * drop.inv_keep : 0.f;
            }
            pd = to_float(from_float<T>(pd));
            ds = to_float(from_float<T>(p * (dp - st_d[ii])));
          }
          pa[ii] = pd;
          pb[ii] = ds;
        }
        __syncwarp();
#pragma unroll
        for (int c = 0; c < kHdSlots; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) {
            float a = av[r][c], g = ak[r][c];
            for (int ii = 0; ii < qn; ++ii) {
              a = fmaf(pa[ii], to_float(dt[ii * ks + d]), a);
              g = fmaf(pb[ii], to_float(qt[ii * ks + d]), g);
            }
            av[r][c] = a;
            ak[r][c] = g;
          }
        }
        __syncwarp();
      }
    }
  }

  T *dkh = dk + hs.qkv, *dvh = dv + hs.qkv;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int j = j0 + r * kAttnWarps;
    if (j < n) {
#pragma unroll
      for (int c = 0; c < kHdSlots; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) {
          dkh[size_t(j) * hd + d] = from_float<T>(ak[r][c]);
          dvh[size_t(j) * hd + d] = from_float<T>(av[r][c]);
        }
      }
    }
  }
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, long long bs, const void* mask,
               long long mask_sb, long long mask_sr, void* out, void* stats, int b, int n,
               int nh, int hd, float scale_t, const void* seed, unsigned threshold,
               float inv_keep, cudaStream_t stream) {
  if (hd < 1 || hd > kMaxHd) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem_bytes<T>(hd);
  auto kernel = tiled_sa_fwd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile, nh, b);
  kernel<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bs,
      static_cast<const float*>(mask), mask_sb, mask_sr, static_cast<T*>(out),
      static_cast<float*>(stats), n, nh, hd, scale_t, static_cast<const int*>(seed), threshold,
      inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, void* dq, void* dk, void* dv,
               long long bs, const void* mask, long long mask_sb, long long mask_sr,
               const void* dout, const void* stats, void* dsum, int b, int n,
               int nh, int hd, float scale_t, float scale_f, const void* seed,
               unsigned threshold, float inv_keep, cudaStream_t stream) {
  if (hd < 1 || hd > kMaxHd) return static_cast<int>(cudaErrorInvalidValue);
  auto rows = tiled_sa_bwd_rows_kernel<T>;
  auto cols = tiled_sa_bwd_cols_kernel<T>;
  cudaError_t err = allow_smem(rows, rows_smem_bytes<T>(hd));
  if (err == cudaSuccess) err = allow_smem(cols, cols_smem_bytes<T>(hd));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile, nh, b);
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v);
  const float* m = static_cast<const float*>(mask);
  const int* sd = static_cast<const int*>(seed);
  rows<<<grid, kAttnThreads, rows_smem_bytes<T>(hd), stream>>>(
      tq, tk, tv, static_cast<T*>(dq), bs, m, mask_sb, mask_sr, static_cast<const T*>(dout),
      static_cast<const float*>(stats), static_cast<float*>(dsum), n, nh, hd, scale_t, scale_f,
      sd, threshold, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cols<<<grid, kAttnThreads, cols_smem_bytes<T>(hd), stream>>>(
      tq, tk, tv, static_cast<T*>(dk), static_cast<T*>(dv), bs, m, mask_sb, mask_sr,
      static_cast<const T*>(dout), static_cast<const float*>(stats),
      static_cast<const float*>(dsum), n, nh, hd, scale_t, sd, threshold, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
size_t mma_smem_bytes(bool backward) {
  return backward ? std::max(sa_mma::rows_smem<HD>(), sa_mma::cols_smem<HD>())
                  : sa_mma::fwd_smem<HD>();
}

}  // namespace

// The body rule (ops/window_attention.py `_sa_body` mirrors it): bf16 at hd
// 32, 64 or 128 runs on the tensor cores, everything else on the CUDA cores.
// Rows 5 and 6, the lane forward and backward (self_attention.cu), take the
// same rule.
bool tensor_core_body(int dtype, int hd) {
  return dtype == kBFloat16 && (hd == 32 || hd == 64 || hd == 128);
}

// Row 5's forward on the tensor-core body (sa_mma::launch_lane_fwd), for
// self_attention.cu's C entry; hd as tensor_core_body takes it.
int lane_self_attention_fwd_mma(const void* x3, const void* mask, long long mask_sb,
                                long long mask_sr, void* out, int b, int l, int dm, int nh,
                                float scale_t, const void* seed, unsigned threshold,
                                float inv_keep, cudaStream_t stream) {
  const int hd = dm / nh;
  auto fwd = hd == 32   ? sa_mma::launch_lane_fwd<32>
             : hd == 64 ? sa_mma::launch_lane_fwd<64>
                        : sa_mma::launch_lane_fwd<128>;
  return fwd(x3, mask, mask_sb, mask_sr, out, b, l, dm, nh, scale_t, seed, threshold, inv_keep,
             stream);
}

// Row 6's backward on the tensor-core body (sa_mma::launch_lane_bwd), for
// self_attention.cu's C entry, so that the body's kernels are instantiated in
// this file alone; hd as tensor_core_body takes it.
int lane_self_attention_bwd_mma(const void* x3, const void* mask, long long mask_sb,
                                long long mask_sr, const void* dout, void* dx3, void* scratch,
                                int b, int l, int dm, int nh, float scale_t, float scale_f,
                                const void* seed, unsigned threshold, float inv_keep,
                                cudaStream_t stream) {
  const int hd = dm / nh;
  auto bwd = hd == 32   ? sa_mma::launch_lane_bwd<32>
             : hd == 64 ? sa_mma::launch_lane_bwd<64>
                        : sa_mma::launch_lane_bwd<128>;
  return bwd(x3, mask, mask_sb, mask_sr, dout, dx3, scratch, b, l, dm, nh, scale_t, scale_f,
             seed, threshold, inv_keep, stream);
}

// Shared memory of the largest block of row 5's tensor-core forward
// (backward false) or row 6's backward.
size_t lane_self_attention_mma_smem(int hd, bool backward) {
  return hd == 32 ? mma_smem_bytes<32>(backward)
         : hd == 64 ? mma_smem_bytes<64>(backward) : mma_smem_bytes<128>(backward);
}

}  // namespace emvm

// q, k, v: base pointers of the (B, nH, N, hd) head tiles, rows b `bs`
// elements apart (3nH * N * hd packed, nH * N * hd split). mask_sb / mask_sr:
// element strides of the mask's batch and query-row axes (its key axis is
// contiguous). out (B, nH, N, hd) and stats (B, nH, 2, N) fp32 are
// contiguous. scale_t is the softmax scale rounded to the storage dtype.
// seed: two int32 (seed, offset) in device memory, or null for no dropout;
// threshold = floor(p * 2^32), inv_keep = 1 / (1 - p).
extern "C" int emvm_tiled_self_attention_fwd(int dtype, const void* q, const void* k,
                                             const void* v, long long bs, const void* mask,
                                             long long mask_sb, long long mask_sr, void* out,
                                             void* stats, int b, int n, int nh, int hd,
                                             float scale_t, const void* seed,
                                             unsigned threshold, float inv_keep, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (emvm::tensor_core_body(dtype, hd)) {
    auto fwd = hd == 32 ? emvm::sa_mma::launch_fwd<32>
               : hd == 64 ? emvm::sa_mma::launch_fwd<64> : emvm::sa_mma::launch_fwd<128>;
    return fwd(q, k, v, bs, mask, mask_sb, mask_sr, out, stats, b, n, nh, scale_t, seed,
               threshold, inv_keep, s);
  }
  switch (dtype) {
    case emvm::kFloat32:
      return emvm::launch_fwd<float>(q, k, v, bs, mask, mask_sb, mask_sr, out, stats, b, n, nh,
                                     hd, scale_t, seed, threshold, inv_keep, s);
    case emvm::kBFloat16:
      return emvm::launch_fwd<__nv_bfloat16>(q, k, v, bs, mask, mask_sb, mask_sr, out, stats, b,
                                             n, nh, hd, scale_t, seed, threshold, inv_keep, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward: dq, dk, dv in the layout of q, k, v (the three segments of one
// dqkv for the packed layout), from dout (B, nH, N, hd) and the forward's
// stats. dsum is fp32 scratch of B * nH * N floats (D of every
// query row); scale_f is the fp32 scale for dq.
extern "C" int emvm_tiled_self_attention_bwd(int dtype, const void* q, const void* k,
                                             const void* v, void* dq, void* dk, void* dv,
                                             long long bs, const void* mask, long long mask_sb,
                                             long long mask_sr, const void* dout,
                                             const void* stats, void* dsum,
                                             int b, int n, int nh, int hd, float scale_t,
                                             float scale_f, const void* seed,
                                             unsigned threshold, float inv_keep, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (emvm::tensor_core_body(dtype, hd)) {
    auto bwd = hd == 32 ? emvm::sa_mma::launch_bwd<32>
               : hd == 64 ? emvm::sa_mma::launch_bwd<64> : emvm::sa_mma::launch_bwd<128>;
    return bwd(q, k, v, dq, dk, dv, bs, mask, mask_sb, mask_sr, dout, stats, dsum, b, n, nh,
               scale_t, scale_f, seed, threshold, inv_keep, s);
  }
  switch (dtype) {
    case emvm::kFloat32:
      return emvm::launch_bwd<float>(q, k, v, dq, dk, dv, bs, mask, mask_sb, mask_sr, dout,
                                     stats, dsum, b, n, nh, hd, scale_t, scale_f, seed,
                                     threshold, inv_keep, s);
    case emvm::kBFloat16:
      return emvm::launch_bwd<__nv_bfloat16>(q, k, v, dq, dk, dv, bs, mask, mask_sb, mask_sr,
                                             dout, stats, dsum, b, n, nh, hd, scale_t, scale_f,
                                             seed, threshold, inv_keep, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of the largest block the forward (backward = 0) or
// the backward launches, in the body that dtype and hd pick; it depends on
// hd only.
extern "C" size_t emvm_tiled_self_attention_smem_bytes(int dtype, int hd, int backward) {
  if (emvm::tensor_core_body(dtype, hd))
    return hd == 32 ? emvm::mma_smem_bytes<32>(backward)
           : hd == 64 ? emvm::mma_smem_bytes<64>(backward) : emvm::mma_smem_bytes<128>(backward);
  if (dtype == emvm::kFloat32)
    return backward ? emvm::cols_smem_bytes<float>(hd) : emvm::fwd_smem_bytes<float>(hd);
  return backward ? emvm::cols_smem_bytes<__nv_bfloat16>(hd)
                  : emvm::fwd_smem_bytes<__nv_bfloat16>(hd);
}
