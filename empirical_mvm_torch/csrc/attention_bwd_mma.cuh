// The tensor-core body of the window-attention backward, beside the CUDA-core
// body of attention_bwd.cuh and with its interface: one block walks a fixed
// sequence of windows that share one head and one mask slot, computes dq, dk
// and dv of each, and adds its ds into the block's own fp32 dbias slice; the
// caller's `addr(seg, step, t)` gives each token's head row. The lane
// window (lane_window_attention.cu) and packed (packed_window_attention.cu)
// backwards take it for bf16 at hd = 32, the head width of every Swin on
// their paths (Swin-base, the C = 96 swin, Swin-tiny, the 2D Swin-base: C /
// nH = 32); fp32, and bf16 at any other hd, keep attention_bwd.cuh. The
// direct backward (window_attention.cu) runs its own one-pass body
// (attention_bwd_onepass.cuh) from the forward's statistics.
//
// Same algebra and rounding points as the JAX kernels (`_direct_bwd_kernel`,
// `_lane_bwd_kernel`, `_attn_bwd_kernel`) and the CUDA-core body: qs =
// round(q * scale), used in S and in dk; p = softmax(qs.k^T + bias + mask)
// in fp32, the two terms added in that order; dv = round(p)^T.do; ds = p *
// (dp - rowsum(dp * p)); dbias accumulates the fp32 ds, unrounded; dq =
// (round(ds).k) * scale_f; dk = round(ds)^T.qs. Every product is an
// `mma.sync` m16n8k16 on bf16 operands from `ldmatrix` (self_attention_mma.cuh's
// primitives, as row 11 uses them): bf16 products are exact in fp32, so only
// the order of the fp32 sums is new.
//
// Per window the block stages qs, k, v and do of its head (N rows rounded up
// to 16, zero-filled; 4 x 16-byte cp.async a token row, at the row `addr`
// gives) in shared memory, then
//   rows phase, one warp per 16 query rows, three passes over the keys in
//     chunks of 16: (1) the scores and each thread's running max and sum,
//     combined over the quad as row 11's forward does; (2) p and dp =
//     do.v^T, D = rowsum(dp * p) (per-thread partial sums, quad-combined);
//     (3) ds, its fp32 value added into the dbias slice (each (i, j) of the
//     slice is owned by one thread), round(ds) as the A fragment of dq's
//     product with K. The rows' max, sum, 1 / sum and D go to shared memory;
//   columns phase, one warp per 16 keys over the query chunks: S^T = k.qs^T
//     and dP^T = v.do^T, so p^T and ds^T come out as the A operands of dv
//     and dk. p and ds are formed with the rows phase's products (the same
//     factors summed over d in the same k-steps) and fp32 expressions, as row
//     11's columns kernel forms them.
// The bias and mask terms of each chunk are loaded before its products, so
// their latency hides behind the MMAs. N is not a multiple of 16 on any
// path (49, 196, 245): padded keys get p = 0 and add nothing to dv, dk, dq or
// dbias; padded query rows write nothing.
//
// dbias: the block adds into its own slice in its fixed window order, and
// sum_slices_kernel sums the slices in a fixed order: no atomics, so a step
// is bit-identical from run to run. The slice (N^2 fp32, 154 KB at N = 196)
// stays in device memory: beside the staged window it fits shared memory at
// N = 196 only, and not at N = 245. Its read-modify-write (2 N^2 * 4 bytes a
// window-head) is the largest byte stream; the chunk count
// (attention_bwd_chunks, kWaves) keeps the resident blocks' slices within
// the 50 MB L2 cache at the swin stages (at most 4 blocks an SM).
#pragma once

#include "attention_bwd.cuh"
#include "self_attention_mma.cuh"

namespace emvm {
namespace win_mma {

using bf16 = __nv_bfloat16;
constexpr int kHd = 32;
using G = sa_mma::Geo<kHd>;           // rows of kStride = 40 bf16, 2 k-steps, 4 d n-tiles
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 4;         // at most 128 registers a thread
constexpr int kWaves = 4;             // blocks of a launch: about kWaves x 132

// query or key rows of a staged window: n rounded up to 16
__host__ __device__ constexpr int padded(int n) { return (n + 15) & ~15; }

// shared memory of a block: qs, k, v, do, then the rows' max, sum, 1 / sum, D
__host__ __device__ inline size_t smem_bytes(int n) {
  return size_t(padded(n)) * (4 * G::kStride * sizeof(bf16) + 4 * sizeof(float));
}

// The body; windows step = first, first + stride, ... < steps. bias_h (n, n)
// is the head's bias, mask_w (n, n) the slot's mask or null, part (n, n) the
// block's dbias slice. Inlined into each caller's kernel.
template <typename Addr>
__device__ __forceinline__ void attention_bwd_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias_h, const float* __restrict__ mask_w,
    const bf16* __restrict__ dout, bf16* __restrict__ gq, bf16* __restrict__ gk,
    bf16* __restrict__ gv, float* __restrict__ part, int n, int first, int steps, int stride,
    Addr addr, float scale_t, float scale_f) {
  using sa_mma::product_nn;
  using sa_mma::product_nt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = padded(n), blocks16 = np / 16;
  const int tile = np * G::kStride;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // then k, v, do, tile elements apart
  bf16* kk = qs + tile;
  bf16* vv = kk + tile;
  bf16* dd = vv + tile;
  float* row_max = reinterpret_cast<float*>(dd + tile);
  float* row_sum = row_max + np;
  float* row_rcp = row_sum + np;
  float* row_d = row_rcp + np;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;

  for (int b = first; b < steps; b += stride) {
    const bool first_window = b == first;
    __syncthreads();  // the previous window is done with shared memory
    for (int x = threadIdx.x; x < 16 * np; x += kThreads) {
      const int seg = x / (4 * np), r = (x >> 2) % np, c = x & 3;
      const bool full = r < n;
      const bf16* src = seg == 0 ? q : seg == 1 ? k : seg == 2 ? v : dout;
      sa_mma::cp_async16(qs + seg * tile + r * G::kStride + c * 8,
                         src + addr(seg, b, full ? r : 0) + c * 8, full);
    }
    sa_mma::cp_async_commit();
    sa_mma::cp_async_wait<0>();
    __syncthreads();
    // qs = round(q * scale), in place (the product of two bf16 is exact)
    for (int x = threadIdx.x; x < np * 4; x += kThreads) {
      uint4* p = reinterpret_cast<uint4*>(qs + (x >> 2) * G::kStride + (x & 3) * 8);
      uint4 u = *p;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 f = __bfloat1622float2(e[w]);
        e[w] = __floats2bfloat162_rn(f.x * scale_t, f.y * scale_t);
      }
      *p = u;
    }
    __syncthreads();

    // rows phase: warp w takes the 16-row blocks w, w + kWarps, ...
    for (int rb = warp; rb < blocks16; rb += kWarps) {
      const int rows[2] = {rb * 16 + g, rb * 16 + g + 8};
      const bool row_ok[2] = {rows[0] < n, rows[1] < n};
      const float* brow[2];
      const float* mrow[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        brow[r] = bias_h + size_t(min(rows[r], n - 1)) * n;
        mrow[r] = mask_w ? mask_w + size_t(min(rows[r], n - 1)) * n : nullptr;
      }
      sa_mma::AFrags<kHd, true> qa, da;
      qa.init(qs, rb * 16);
      da.init(dd, rb * 16);
      // sc[nt][e]: row rows[e >> 1], key c * 16 + nt * 8 + 2 * tq + (e & 1)
      auto scores = [&](int c, float (&sc)[2][4]) {
        float bv[2][4], mv[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, j = c * 16 + nt * 8 + 2 * tq + (e & 1);
            const bool ok = j < n && row_ok[r];
            bv[nt][e] = ok ? __ldg(brow[r] + j) : 0.f;
            mv[nt][e] = ok && mask_w ? __ldg(mrow[r] + j) : 0.f;
          }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
        product_nt<kHd>(sc, qa, kk, c * 16);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = c * 16 + nt * 8 + 2 * tq + (e & 1);
            float s = __fadd_rn(sc[nt][e], bv[nt][e]);
            if (mask_w) s = __fadd_rn(s, mv[nt][e]);
            sc[nt][e] = j < n ? s : -CUDART_INF_F;
          }
      };
      auto prob = [&](float s, float mx, float sum, float rcp) {
        return sa_mma::div_rn(expf(__fsub_rn(s, mx)), sum, rcp);
      };

      // pass 1: each thread's running max and sum over its keys
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, sum[2] = {0.f, 0.f}, rcp[2];
#pragma unroll 1
      for (int c = 0; c < blocks16; ++c) {
        float sc[2][4];
        scores(c, sc);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m = fmaxf(fmaxf(mx[r], fmaxf(sc[0][2 * r], sc[0][2 * r + 1])),
                                fmaxf(sc[1][2 * r], sc[1][2 * r + 1]));
          if (m != mx[r]) {
            sum[r] = sum[r] * expf(mx[r] - m);
            mx[r] = m;
          }
          if (m != -CUDART_INF_F) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int u = 0; u < 2; ++u) sum[r] += expf(sc[nt][2 * r + u] - m);
          }
        }
      }
      sa_mma::quad_stats(mx, sum, rcp);

      // pass 2: D = rowsum(dp * p)
      float dsum[2] = {0.f, 0.f};
#pragma unroll 1
      for (int c = 0; c < blocks16; ++c) {
        float sc[2][4], dp[2][4] = {};
        scores(c, sc);
        product_nt<kHd>(dp, da, vv, c * 16);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, j = c * 16 + nt * 8 + 2 * tq + (e & 1);
            const float p = j < n && row_ok[r] ? prob(sc[nt][e], mx[r], sum[r], rcp[r]) : 0.f;
            dsum[r] += __fmul_rn(dp[nt][e], p);
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
        dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
      }

      // pass 3: ds into the dbias slice, dq = round(ds).k
      float acc[G::kDTiles][4] = {};
#pragma unroll 1
      for (int c = 0; c < blocks16; ++c) {
        float old[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, j = c * 16 + nt * 8 + 2 * tq + (e & 1);
            old[nt][e] = !first_window && j < n && row_ok[r]
                             ? part[size_t(rows[r]) * n + j] : 0.f;
          }
        float sc[2][4], dp[2][4] = {};
        scores(c, sc);
        product_nt<kHd>(dp, da, vv, c * 16);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, j = c * 16 + nt * 8 + 2 * tq + (e & 1);
            float ds = 0.f;
            if (j < n && row_ok[r]) {
              const float p = prob(sc[nt][e], mx[r], sum[r], rcp[r]);
              ds = __fmul_rn(p, __fsub_rn(dp[nt][e], dsum[r]));
              part[size_t(rows[r]) * n + j] = first_window ? ds : __fadd_rn(old[nt][e], ds);
            }
            sc[nt][e] = ds;
          }
        uint32_t a[4];
        sa_mma::to_a(a, sc);
        product_nn<kHd, G::kDTiles>(acc, a, kk, c * 16, 0);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!row_ok[r]) continue;
        bf16* dq = gq + addr(0, b, rows[r]);
#pragma unroll
        for (int dt = 0; dt < G::kDTiles; ++dt)
          *reinterpret_cast<uint32_t*>(dq + dt * 8 + 2 * tq) =
              sa_mma::pack(acc[dt][2 * r] * scale_f, acc[dt][2 * r + 1] * scale_f);
        if (tq == 0) {
          row_max[rows[r]] = mx[r];
          row_sum[rows[r]] = sum[r];
          row_rcp[rows[r]] = rcp[r];
          row_d[rows[r]] = dsum[r];
        }
      }
    }
    __syncthreads();  // the rows' statistics are complete

    // columns phase: warp w takes the 16-key blocks w, w + kWarps, ...
    for (int kb = warp; kb < blocks16; kb += kWarps) {
      const int keys[2] = {kb * 16 + g, kb * 16 + g + 8};
      const bool key_ok[2] = {keys[0] < n, keys[1] < n};
      sa_mma::AFrags<kHd, true> ka, va;
      ka.init(kk, kb * 16);
      va.init(vv, kb * 16);
      float ak[G::kDTiles][4] = {}, av[G::kDTiles][4] = {};
#pragma unroll 1
      for (int c = 0; c < blocks16; ++c) {
        // sc[nt][e]: key keys[e >> 1], query c * 16 + nt * 8 + 2 * tq + (e & 1)
        float bv[2][4], mv[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, i = c * 16 + nt * 8 + 2 * tq + (e & 1);
            const bool ok = i < n && key_ok[r];
            bv[nt][e] = ok ? __ldg(bias_h + size_t(i) * n + keys[r]) : 0.f;
            mv[nt][e] = ok && mask_w ? __ldg(mask_w + size_t(i) * n + keys[r]) : 0.f;
          }
        float sc[2][4] = {}, dp[2][4] = {};
        product_nt<kHd>(sc, ka, qs, c * 16);   // S^T
        product_nt<kHd>(dp, va, dd, c * 16);   // dP^T
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, i = c * 16 + nt * 8 + 2 * tq + (e & 1);
            float p = 0.f, ds = 0.f;
            if (i < n && key_ok[r]) {
              float s = __fadd_rn(sc[nt][e], bv[nt][e]);
              if (mask_w) s = __fadd_rn(s, mv[nt][e]);
              p = sa_mma::div_rn(expf(__fsub_rn(s, row_max[i])), row_sum[i], row_rcp[i]);
              ds = __fmul_rn(p, __fsub_rn(dp[nt][e], row_d[i]));
            }
            sc[nt][e] = p;
            dp[nt][e] = ds;
          }
        uint32_t pa[4], sa[4];
        sa_mma::to_a(pa, sc);
        sa_mma::to_a(sa, dp);
        product_nn<kHd, G::kDTiles>(av, pa, dd, c * 16, 0);
        product_nn<kHd, G::kDTiles>(ak, sa, qs, c * 16, 0);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!key_ok[r]) continue;
        bf16* dk = gk + addr(1, b, keys[r]);
        bf16* dv = gv + addr(2, b, keys[r]);
#pragma unroll
        for (int dt = 0; dt < G::kDTiles; ++dt) {
          *reinterpret_cast<uint32_t*>(dk + dt * 8 + 2 * tq) =
              sa_mma::pack(ak[dt][2 * r], ak[dt][2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dv + dt * 8 + 2 * tq) =
              sa_mma::pack(av[dt][2 * r], av[dt][2 * r + 1]);
        }
      }
    }
  }
}

// The body each caller's backward runs: bf16 at hd 32 here, else
// attention_bwd.cuh (ops/window_attention.py `_window_bwd_body` mirrors it).
inline bool takes(int dtype, int hd) { return dtype == kBFloat16 && hd == kHd; }

}  // namespace win_mma
}  // namespace emvm
