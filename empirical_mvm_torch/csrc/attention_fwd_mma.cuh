// The tensor-core body of the window-attention forward, beside attend_row
// (common.cuh) and with the interface of the backward's tensor-core body
// (attention_bwd_mma.cuh): one block of 4 warps computes one (window, head);
// the caller's `addr(seg, t)` gives token t's head row (seg 0-2: in q, k, v
// from their bases; seg 3: in out). The direct (window_attention.cu, row 3),
// packed (packed_window_attention.cu, rows 9 and 10) and lane window
// (lane_window_attention.cu, row 7, and lane_attention, row 12) forwards take
// it for bf16 at hd = 32, the head width of every Swin on their paths, and
// N <= kMaxKeys (49, 196 and 245 on the paths); fp32, and bf16 at any other
// hd or N, keep attend_row.
//
// Same rounding points as the JAX kernels (`_direct_fwd_kernel`,
// `_attn_kernel`, `_lane_fwd_kernel`): qs = round(q * scale_t); s = (qs.k^T +
// bias) + mask in fp32, the two terms added in that order; with kScoreScale
// (row 12, tools/lanebench.py `_lane_kernel`, attend_row's switch of the same
// name) q stays as stored and s = ((q.k^T) * scale + bias) + mask, the fp32
// product times the fp32 scale; p = exp(s - max) / sum, normalised
// in fp32 and then rounded to bf16 (a one-pass online softmax would round the
// unnormalised p); P.V accumulated in fp32; the output rounded once. Both
// products are `mma.sync` m16n8k16 on bf16 operands, exact in fp32, so only
// the order of the fp32 sums of qs.k^T and P.V is new.
//
// Bound on the H100: the bytes of q, k, v and out, 8 N hd bytes a
// window-head (about 120 operations a byte at N = 245, against the card's
// ~295). What a block reads most is the bias and the mask: 2 N^2 fp32 a
// window-head (480 KB at N = 245, against 63 KB of q, k, v and out), from L2
// (a head's bias and a slot's mask serve every window and clip). Read in the
// accumulator layout of the scores, each warp load touches 8 rows; here each
// is read once, with consecutive lanes on consecutive keys, and its
// latency kept off the row pass. Per 16 query rows a warp
//   (A) forms S = qs.k^T on the tensor cores in 16-key chunks (q's A
//       fragments straight from device memory, rounded in registers, the
//       next 16 rows' loaded during (B) and (C); K from shared memory) and
//       adds it to the 16 bias rows, which cp.async copies put in its
//       score buffer after the previous 16 rows' (B) (rows 8-15, which P
//       does not cover) and (C) (rows 0-7): S + bias;
//   (B) walks the 16 rows two at a time, a half-warp a row with its lanes
//       over the keys: s = (S + bias) + mask, the row max and sum by
//       half-warp shuffles, e = exp(s - max),
//       p = e / sum (the IEEE division, from one reciprocal a row:
//       sa_mma::div_rn) rounded to bf16 into the warp's P rows, which lie
//       over score rows already read; the next pair's mask loads are in
//       flight, in registers, while a pair is computed;
//   (C) P.V on the tensor cores, P's A fragments by ldmatrix, V from shared
//       memory; the output rows rounded and stored at `addr`.
// One exp a score. The row pass is latency-bound (8 warps an SM at N = 196
// and 245, held by shared memory), so a lane carries up to 16 independent
// keys of its row, and (A) and (C) take two chunks a loop trip.
// K and V of the window arrive once, by 16-byte cp.async (rows padded to 16
// and zero-filled past N, 16 bytes of padding a row so that ldmatrix's 8 rows
// fall in distinct banks). Padded keys get p = 0; padded query rows are
// computed and not stored. Shared memory: K and V, then a 16 x (Np + 8) fp32
// score buffer a warp (Np = N rounded up to 16): 108,544 B at N = 245,
// 88,576 at 196 (two blocks an SM), 28,672 at 49.
#pragma once

#include "self_attention_mma.cuh"

namespace emvm {
namespace win_fwd_mma {

using bf16 = __nv_bfloat16;
constexpr int kHd = 32;
using G = sa_mma::Geo<kHd>;           // K and V rows of kStride = 40 bf16
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 4;         // at most 128 registers a thread
constexpr int kMaxKeys = 256;         // keys a row the lanes hold in registers (16 a lane)

// query or key rows of a staged window: n rounded up to 16
__host__ __device__ constexpr int padded(int n) { return (n + 15) & ~15; }

// fp32 elements a row of a warp's score buffer: 8 more than padded(n), so
// that the float2 stores of 8 query rows fall 8 banks apart, and the bf16 P
// rows laid over it (the same element count) start on 16 bytes an odd
// number of 16 bytes apart, as ldmatrix wants
__host__ __device__ constexpr int score_stride(int n) { return padded(n) + 8; }

// keys a lane of a half-warp holds (16 lanes a row): the body is
// instantiated for 4 (N up to 64), 13 (N up to 208) and 16
__host__ __device__ constexpr int key_iters(int n) { return n <= 64 ? 4 : n <= 208 ? 13 : 16; }

__host__ __device__ inline size_t smem_bytes(int n) {
  return size_t(padded(n)) * 2 * G::kStride * sizeof(bf16) +
         size_t(kWarps) * 16 * score_stride(n) * sizeof(float);
}

// x over the 16 lanes of a half-warp (xor 8, 4, 2, 1): max or sum
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The body; KI = key_iters(n). bias_h (n, n) is the head's bias, mask_w
// (n, n) the window's mask or null. scale_t is the scale rounded to bf16
// that multiplies q, or with kScoreScale the fp32 scale that multiplies the
// scores. stats, where not null, takes each row's max (n floats) and then
// its sum (n floats), from which attention_bwd_onepass.cuh forms p again.
// Inlined into each caller's kernel.
template <int KI, bool kScoreScale = false, typename Addr>
__device__ __forceinline__ void attention_fwd_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias_h, const float* __restrict__ mask_w, bf16* __restrict__ out,
    int n, Addr addr, float scale_t, float* __restrict__ stats = nullptr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = padded(n), blocks16 = np / 16, ss = score_stride(n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3, half = lane >> 4, hl = lane & 15;
  bf16* kk = reinterpret_cast<bf16*>(smem_raw);
  bf16* vv = kk + np * G::kStride;
  float* sbuf = reinterpret_cast<float*>(vv + np * G::kStride) + warp * 16 * ss;
  bf16* pbuf = reinterpret_cast<bf16*>(sbuf);   // P row r: ss bf16 from pbuf + r * ss

  for (int x = threadIdx.x; x < 8 * np; x += kThreads) {
    const int seg = x / (4 * np), r = (x >> 2) % np, c = x & 3;
    const bool full = r < n;
    sa_mma::cp_async16((seg ? vv : kk) + r * G::kStride + c * 8,
                       (seg ? v : k) + addr(1 + seg, full ? r : 0) + c * 8, full);
  }
  // the bias rows r0 + lo ... r0 + hi - 1 into the score buffer, zero past
  // N, 16 bytes a lane where rows start on 16 bytes (N a multiple of 4),
  // else 4; pass (A) adds S to them
  const bool rows16 = n % 4 == 0 && (reinterpret_cast<uintptr_t>(bias_h) & 15) == 0;
  auto stage_bias = [&](int r0, int lo, int hi) {
    for (int rr = lo; rr < hi; ++rr) {
      const int i = r0 + rr;
      const float* src = i < n ? bias_h + size_t(i) * n : bias_h;
      if (rows16) {
        for (int j = 4 * lane; j < n; j += 128)
          sa_mma::cp_async16(sbuf + rr * ss + j, src + j, i < n);
      } else {
        for (int j = lane; j < n; j += 32) sa_mma::cp_async4(sbuf + rr * ss + j, src + j, i < n);
      }
    }
    sa_mma::cp_async_commit();
  };
  // q of rows r0 + g and r0 + g + 8 as stored, the words of the A fragments
  // of two k-steps
  uint32_t qw[G::kKSteps][4];
  auto load_q = [&](int r0) {
#pragma unroll
    for (int ks = 0; ks < G::kKSteps; ++ks)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = r0 + g + (u & 1) * 8, col = ks * 16 + (u >> 1) * 8 + 2 * tq;
        qw[ks][u] = row < n ? *reinterpret_cast<const uint32_t*>(q + addr(0, row) + col) : 0u;
      }
  };
  // the mask of this lane's keys hl + 16 u in row i
  float mk[KI];
  auto load_mask = [&](int i) {
    if (!mask_w) return;
#pragma unroll
    for (int u = 0; u < KI; ++u) {
      const int j = hl + 16 * u;
      mk[u] = i < n && j < n ? __ldg(mask_w + size_t(i) * n + j) : 0.f;
    }
  };
  // row of this half-warp in pair t of row block rb (pairs past 7 run into
  // this warp's next row block)
  auto pair_row = [&](int rb, int t) {
    return t < 8 ? rb * 16 + 2 * t + half : (rb + kWarps) * 16 + 2 * (t - 8) + half;
  };
  if (warp < blocks16) {
    stage_bias(warp * 16, 0, 16);
    load_q(warp * 16);
    load_mask(pair_row(warp, 0));
  }
  sa_mma::cp_async_commit();
  sa_mma::cp_async_wait<0>();
  __syncthreads();

  // warp w takes the 16-row blocks w, w + kWarps, ...
#pragma unroll 1
  for (int rb = warp; rb < blocks16; rb += kWarps) {
    const int r0 = rb * 16;
    // (A) S = qs.k^T, q * scale rounded to bf16 (the product of two bf16 is
    // exact), added to the staged bias (with kScoreScale S = q.k^T, then
    // S * scale + bias); then the next row block's q loaded
    sa_mma::AFrags<kHd, true> qa;
#pragma unroll
    for (int ks = 0; ks < G::kKSteps; ++ks)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (kScoreScale) {
          qa.r[ks][u] = qw[ks][u];
        } else {
          const float2 f =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qw[ks][u]));
          qa.r[ks][u] = sa_mma::pack(f.x * scale_t, f.y * scale_t);
        }
      }
    sa_mma::cp_async_wait<0>();
    __syncwarp();
#pragma unroll 2
    for (int c = 0; c < blocks16; ++c) {
      float sc[2][4] = {};
      sa_mma::product_nt<kHd>(sc, qa, kk, c * 16);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float2* sp =
              reinterpret_cast<float2*>(sbuf + (g + 8 * r) * ss + c * 16 + nt * 8 + 2 * tq);
          const float2 b = *sp;
          if constexpr (kScoreScale)
            *sp = make_float2(__fadd_rn(__fmul_rn(sc[nt][2 * r], scale_t), b.x),
                              __fadd_rn(__fmul_rn(sc[nt][2 * r + 1], scale_t), b.y));
          else
            *sp = make_float2(__fadd_rn(sc[nt][2 * r], b.x), __fadd_rn(sc[nt][2 * r + 1], b.y));
        }
    }
    if (rb + kWarps < blocks16) load_q(r0 + 16 * kWarps);
    __syncwarp();

    // (B) rows r0 + 2 t + half: s, max, exp, sum, the normalised p rounded
#pragma unroll 1
    for (int t = 0; t < 8 && r0 + 2 * t < n; ++t) {
      const int r = 2 * t + half;
      float sv[KI];
      float mx2[2] = {-CUDART_INF_F, -CUDART_INF_F};   // two chains of the max
#pragma unroll
      for (int u = 0; u < KI; ++u) {
        const int j = hl + 16 * u;
        float s = -CUDART_INF_F;
        if (j < n) {
          s = sbuf[r * ss + j];                       // S + bias
          if (mask_w) s = __fadd_rn(s, mk[u]);
        }
        sv[u] = s;
        mx2[u & 1] = fmaxf(mx2[u & 1], s);
      }
      load_mask(pair_row(rb, t + 1));
      const float mx = half_max(fmaxf(mx2[0], mx2[1]));
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < KI; ++u) {
        const float e = hl + 16 * u < n ? expf(__fsub_rn(sv[u], mx)) : 0.f;
        sv[u] = e;
        sum += e;
      }
      sum = half_sum(sum);
      const float rcp = __frcp_rn(sum);
      if (stats != nullptr && hl == 0 && r0 + r < n) {
        stats[r0 + r] = mx;
        stats[n + r0 + r] = sum;
      }
      // every lane has read score rows r0 + 2 t and r0 + 2 t + 1 (half_max):
      // P rows 2 t and 2 t + 1 may cover them
#pragma unroll
      for (int u = 0; u < KI; ++u) {
        const int j = hl + 16 * u;
        if (j < np) {
          const float p = sa_mma::div_rn(sv[u], sum, rcp);
          pbuf[r * ss + j] = __float2bfloat16(p);
        }
      }
    }
    __syncwarp();
    // P rows 0 ... 15 lie over score rows 0 ... 7: rows 8 ... 15 take the
    // next row block's bias while P.V runs
    if (rb + kWarps < blocks16) stage_bias(r0 + 16 * kWarps, 8, 16);

    // (C) P.V, the output rows rounded once
    float o[G::kDTiles][4] = {};
#pragma unroll 2
    for (int c = 0; c < blocks16; ++c) {
      uint32_t a[4];
      sa_mma::ldsm_x4(a, pbuf + (lane & 15) * ss + c * 16 + (lane >> 4) * 8);
      sa_mma::product_nn<kHd, G::kDTiles>(o, a, vv, c * 16, 0);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row >= n) continue;
      bf16* dst = out + addr(3, row);
#pragma unroll
      for (int dt = 0; dt < G::kDTiles; ++dt)
        *reinterpret_cast<uint32_t*>(dst + dt * 8 + 2 * tq) =
            sa_mma::pack(o[dt][2 * r], o[dt][2 * r + 1]);
    }
    __syncwarp();   // P is read (the products are stored): the next bias goes over it
    if (rb + kWarps < blocks16) stage_bias(r0 + 16 * kWarps, 0, 8);
  }
}

// The body each caller's forward runs: bf16 at hd 32 and N <= kMaxKeys here,
// else attend_row (ops/window_attention.py `_window_fwd_body` mirrors it).
inline bool takes(int dtype, int hd, int n) {
  return dtype == kBFloat16 && hd == kHd && n >= 1 && n <= kMaxKeys;
}

}  // namespace win_fwd_mma
}  // namespace emvm
