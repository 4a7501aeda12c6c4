// The direct window backward's own tensor-core body (row 4 in bf16 at hd 32,
// N <= 256; window_attention.cu `direct_window_attention_bwd_kernel_onepass`):
// one block walks a fixed sequence of windows that share one head and one
// mask slot, as attention_bwd_mma.cuh's body does, but forms each 16 x 16
// score tile of a window once in its main pass, from the row statistics the
// forward stored (attention_fwd_mma.cuh, `stats`), and keeps the block's dbias
// slice in shared memory where it fits. The lane window and packed backwards
// (rows 8-10) keep attention_bwd_mma.cuh.
//
// Same algebra and rounding points as attention_bwd_mma.cuh: qs = round(q *
// scale); s = (qs.k^T + bias) + mask in fp32, bit for bit the forward's s;
// p = exp(s - max) / sum with the forward's row max and sum, the IEEE
// division from one reciprocal a row (sa_mma::div_rn): bit for bit the
// forward's normalised p (exp(s - lse) would move it by up to ~10 fp32 ulps,
// enough to lift dx3's share of elements that differ from plain bf16 over
// the limit on the card); D = rowsum(dp * p); ds = p * (dp - D);
// dv = round(p)^T.do; dq = (round(ds).k) * scale_f; dk = round(ds)^T.qs;
// dbias sums the fp32 ds, unrounded. Only the order of the fp32 sums is new.
//
// Per window, with each warp owning kS 16-key blocks, j = w + s kW (13
// warps of one block at N = 196: the occupancy the body's latency wants, at
// 128 registers a thread; 8 of two at N = 245), their k and v rows held in
// registers as the B fragments of S and dP (through `movmatrix`, those of
// dq):
//   D sweep: each warp forms S, dP and p of its tiles (i, j) for every query
//     block i and sums dp * p over the tile's 16 keys (each thread its four,
//     then the quad); the 16-key partials of a row are then summed in
//     key-block order;
//   main pass: at step t key block j takes query block i = (j + t) mod
//     (N / 16), so that the tiles of a step hold distinct query blocks: S, dP
//     and p again, ds, its fp32 value added into the dbias tile (i, j) (which
//     j's warp owns for the block's whole life: no atomics), round(p) and
//     round(ds) moved to the A fragments of p^T and ds^T by `movmatrix` for
//     dv and dk (accumulated in registers over the steps), and round(ds).k
//     added to query block i's fp32 dq accumulator in shared memory, which
//     its next owner reads after the step's split barrier (below).
// The main pass forms each tile once and gives it to dv, dk, dq and dbias.
// Each tile's bias and mask terms are loaded once per sweep, from copies in
// the scores' accumulator order (two 16-byte words a lane, 1 KB a warp in
// one piece, -inf outside the window: no predicates), one tile ahead of
// their use. The next window's q, do, row statistics and k, v
// fragments are requested before this window's dq, dk and dv are written
// out.
// N is not a multiple of 16 on any path (49, 196, 245): padded keys and
// query rows get p = 0 and add nothing; padded rows write nothing.
//
// dbias: the block's slice (n x n fp32, in rows of dbias_stride(n) floats)
// stays in shared memory beside the window where both fit (N = 49, 196:
// 221,712 bytes at 196) and is written to device memory once per block; else
// (N = 245) it is the block's slice in device memory, read and written once
// a window. sum_slices_kernel then sums the slices in a fixed order: a step
// is bit-identical from run to run.
#pragma once

#include "self_attention_mma.cuh"

namespace emvm {
namespace win_bwd1 {

using bf16 = __nv_bfloat16;
constexpr int kHd = 32;
using G = sa_mma::Geo<kHd>;           // rows of kStride = 40 bf16, 2 k-steps, 4 d n-tiles
constexpr int kMaxKeys = 256;
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory a block may opt into (H100)

// query or key rows of a staged window: n rounded up to 16
__host__ __device__ constexpr int padded(int n) { return (n + 15) & ~15; }

// warps of a block: 4 at N <= 64 and 13 up to 208, one 16-key block each
// (13 warps put 4 on one scheduler: 128 registers a thread), 8 up to 256,
// two blocks each (16 warps would spill)
__host__ __device__ constexpr int warps(int n) { return n <= 64 ? 4 : n <= 208 ? 13 : 8; }

// floats of a row of the on-chip dbias slice: n rounded up to 8, and 8 mod
// 16, so that the float2 words of the 4 rows a quarter-warp touches fall in
// distinct banks
__host__ __device__ constexpr int dbias_stride(int n) {
  return ((n + 7) & ~7) % 16 ? ((n + 7) & ~7) : ((n + 7) & ~7) + 8;
}

// qs and do rows, the dq accumulators (the D partials before them), each
// row's (max, sum, 1 / sum, D), each token's two offsets, the steps'
// mbarrier (16 bytes), and on chip the dbias slice
__host__ __device__ inline size_t smem_bytes(int n, bool on_chip) {
  const size_t np = padded(n);
  return np * 2 * G::kStride * sizeof(bf16) + np * kHd * sizeof(float) +
         np * 4 * sizeof(float) + np * 2 * sizeof(int) + 16 +
         (on_chip ? size_t(n) * dbias_stride(n) * sizeof(float) : 0);
}

// the dbias placement: the slice in shared memory where it fits beside the window
__host__ __device__ inline bool on_chip(int n) { return smem_bytes(n, true) <= kMaxSmem; }

// The body of the direct backward for bf16 at hd 32 and N <= kMaxKeys, from
// the forward's statistics (ops/window_attention.py `_direct_bwd_body`
// mirrors it); else attention_bwd.cuh.
inline bool takes(int dtype, int hd, int n) {
  return dtype == kBFloat16 && hd == kHd && n >= 1 && n <= kMaxKeys;
}

// an 8 x 8 bf16 matrix held as an mma fragment (lane l: row l / 4, columns
// 2 (l % 4) and + 1), transposed across the warp
__device__ __forceinline__ uint32_t trans8(uint32_t a) {
  uint32_t d;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// The main pass's steps are held apart by an mbarrier in shared memory that
// completes a phase when every warp's lane 0 has arrived: a warp arrives
// after adding its part of dq and waits only before its next addition, so
// the next tile's work overlaps the slowest warp of the step (a block-wide
// barrier a step measured 10 % slower on the H100)
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(sa_mma::smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
                   sa_mma::smem_u32(bar))
               : "memory");
}
// until the phase of this parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done)
                 : "r"(sa_mma::smem_u32(bar)), "r"(parity)
                 : "memory");
}

// the A fragment of a 16 x 16 tile's transpose, from the tile's own
__device__ __forceinline__ void trans_a(uint32_t (&t)[4], const uint32_t (&a)[4]) {
  t[0] = trans8(a[0]);
  t[1] = trans8(a[2]);
  t[2] = trans8(a[1]);
  t[3] = trans8(a[3]);
}

// The bias and mask terms of the scores in tile order (terms_index): for
// each 16 x 16 tile (i, j), row-major over the tiles, 256 floats with lane
// l's 8 values at 8 l, the value of its accumulator slot nt 4 + e (row i 16
// + l / 4 + 8 (e / 2), key j 16 + nt 8 + 2 (l % 4) + e % 2), so that a lane
// reads a tile's terms as two 16-byte words and a warp 1 KB in one piece;
// outside the n x n window the bias is -inf (p = 0 there) and the mask 0.
// window_attention.cu `direct_window_attention_bwd_kernel_terms` writes them.
__host__ __device__ inline size_t tile_terms(int n) {
  return size_t(padded(n) / 16) * (padded(n) / 16) * 256;
}
__host__ __device__ inline void terms_index(size_t k, int nb, int* row, int* key) {
  const int tile = static_cast<int>(k >> 8), lane = (k >> 3) & 31, slot = k & 7;
  const int i = tile / nb, j = tile % nb, e = slot & 3;
  *row = i * 16 + (lane >> 2) + 8 * (e >> 1);
  *key = j * 16 + (slot >> 2) * 8 + 2 * (lane & 3) + (e & 1);
}

// The body; windows step = first, first + stride, ... < steps. bias_t is the
// head's bias and mask_t the slot's mask (or null) in tile order, stats + b
// * stats_step window b's n row maxima and then its n row sums, part (n, n)
// the block's dbias slice in device memory. kW = warps(n) warps of kS key
// blocks. `addr` is affine in the window (its offsets are tabled once a
// block). Inlined into the caller's kernel.
template <int kW, int kS, bool kOnChip, typename Addr>
__device__ __forceinline__ void attention_bwd_onepass(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias_t, const float* __restrict__ mask_t,
    const float* __restrict__ stats, size_t stats_step, const bf16* __restrict__ dout,
    bf16* __restrict__ gq, bf16* __restrict__ gk, bf16* __restrict__ gv,
    float* __restrict__ part, int n, int first, int steps, int stride, Addr addr,
    float scale_t, float scale_f) {
  using sa_mma::mma;
  using sa_mma::pack;
  constexpr int kThreads = kW * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = padded(n), nb = np / 16;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dd = qs + np * G::kStride;
  // dq accumulators of query block i in fragment order: float4 [i][dt][lane];
  // during the D sweep the 16-key partials of D, [j][row]
  float* dqa = reinterpret_cast<float*>(dd + np * G::kStride);
  float4* dqa4 = reinterpret_cast<float4*>(dqa);
  float4* rstat = reinterpret_cast<float4*>(dqa + np * kHd);   // (max, sum, 1 / sum, D) a row
  // token t's offset in window 0: tokq in q, k, v, dq, dk, dv (from their
  // bases), tokd in dout; window b adds b times the strides
  int* tokq = reinterpret_cast<int*>(rstat + np);
  int* tokd = tokq + np;
  uint64_t* bar = reinterpret_cast<uint64_t*>(tokd + np);      // the steps' mbarrier
  float* slice = reinterpret_cast<float*>(bar + 2);            // on chip: n rows of ss
  const int ss = dbias_stride(n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t step_q = addr(0, 1, 0) - addr(0, 0, 0), step_d = addr(3, 1, 0) - addr(3, 0, 0);
  for (int t = threadIdx.x; t < np; t += kThreads) {
    tokq[t] = static_cast<int>(addr(0, 0, t < n ? t : 0));
    tokd[t] = static_cast<int>(addr(3, 0, t < n ? t : 0));
  }
  auto aq = [&](int b, int t) { return b * step_q + tokq[t]; };
  auto ad = [&](int b, int t) { return b * step_d + tokd[t]; };
  int jb[kS];                    // the warp's key blocks; live while < nb
  bool live[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    jb[s] = warp + s * kW;
    live[s] = jb[s] < nb;
  }

  for (int x = threadIdx.x; x < np * kHd / 4; x += kThreads) dqa4[x] = zero4;
  if constexpr (kOnChip) {
    for (int x = threadIdx.x; x < n * ss / 4; x += kThreads)
      reinterpret_cast<float4*>(slice)[x] = zero4;
  }
  if (threadIdx.x == 0) bar_init(bar, kW);
  uint32_t phase = 0;                // the main-pass steps the mbarrier has counted
  __syncthreads();   // the token tables, the mbarrier

  // B fragments of the key blocks: kb[s][ks][nt][half] holds k[key jb[s]
  // 16 + nt 8 + g][d ks 16 + half 8 + 2 tq, + 1] (vb: v), the fragments of
  // S = qs.k^T (dP = do.v^T) that ldmatrix would give; 0 past n
  uint32_t kb[kS][G::kKSteps][2][2], vb[kS][G::kKSteps][2][2];
  auto load_kv = [&](int b) {
#pragma unroll
    for (int s = 0; s < kS; ++s)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int key = jb[s] * 16 + nt * 8 + g;
        const bool ok = key < n;
        const bf16* kr = k + aq(b, ok ? key : 0) + 2 * tq;
        const bf16* vr = v + aq(b, ok ? key : 0) + 2 * tq;
#pragma unroll
        for (int ks = 0; ks < G::kKSteps; ++ks)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int col = ks * 16 + hf * 8;
            kb[s][ks][nt][hf] = ok ? __ldg(reinterpret_cast<const unsigned*>(kr + col)) : 0u;
            vb[s][ks][nt][hf] = ok ? __ldg(reinterpret_cast<const unsigned*>(vr + col)) : 0u;
          }
      }
  };

  // window b's q and do rows into shared memory (16-byte cp.async, zero past
  // n), its row statistics (one row a thread; kThreads >= np), and the key
  // blocks' fragments
  float row_max = 0.f, row_sum = 1.f;
  auto stage = [&](int b) {
    for (int x = threadIdx.x; x < 8 * np; x += kThreads) {
      const bool seg = x >= 4 * np;
      const int r = (x >> 2) - (seg ? np : 0), c = x & 3;
      sa_mma::cp_async16((seg ? dd : qs) + r * G::kStride + c * 8,
                         (seg ? dout + ad(b, r) : q + aq(b, r)) + c * 8, r < n);
    }
    sa_mma::cp_async_commit();
    if (threadIdx.x < n) {
      row_max = __ldg(stats + b * stats_step + threadIdx.x);
      row_sum = __ldg(stats + b * stats_step + n + threadIdx.x);
    }
    load_kv(b);
  };
  // the staged rows arrived: qs = round(q * scale) in place (each thread
  // the chunks it copied: the product of two bf16 is exact), the rows'
  // statistics
  auto land = [&]() {
    sa_mma::cp_async_wait<0>();
    for (int x = threadIdx.x; x < 4 * np; x += kThreads) {
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
    if (threadIdx.x < np)
      rstat[threadIdx.x] = make_float4(row_max, row_sum, __frcp_rn(row_sum), 0.f);
    __syncthreads();
  };

  // bias and mask terms of tile (i, j) in the scores' accumulator layout:
  // t[nt][e] at row i 16 + g + 8 (e >> 1), key j 16 + nt 8 + 2 tq + (e & 1)
  auto load_terms = [&](int i, int j, float (&bt)[2][4], float (&mt)[2][4]) {
    const size_t at = (size_t(i) * nb + j) * 64 + lane * 2;   // in float4s
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias_t) + at);
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias_t) + at + 1);
    float4 m0 = make_float4(0.f, 0.f, 0.f, 0.f), m1 = m0;
    if (mask_t) {
      m0 = __ldg(reinterpret_cast<const float4*>(mask_t) + at);
      m1 = __ldg(reinterpret_cast<const float4*>(mask_t) + at + 1);
    }
    auto put = [](float (&t)[4], const float4& v) {
      t[0] = v.x;
      t[1] = v.y;
      t[2] = v.z;
      t[3] = v.w;
    };
    put(bt[0], b0);
    put(bt[1], b1);
    put(mt[0], m0);
    put(mt[1], m1);
  };

  // S and dP of tile (i, jb[s]), then p = exp(s - max) / sum in place of S
  // (0 outside the n x n window, where the bias is -inf; the mask term is 0
  // without a mask, and x + 0 takes exp to the same value as x); st[r] holds
  // row i 16 + g + 8 r's statistics
  auto tile = [&](int s, int i, const float (&bt)[2][4], const float (&mt)[2][4],
                  const float4 (&st)[2], float (&sc)[2][4], float (&dp)[2][4]) {
    sa_mma::AFrags<kHd, true> qa, da;
    qa.init(qs, i * 16);
    da.init(dd, i * 16);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < G::kKSteps; ++ks) {
      mma(sc[0], qa.r[ks], kb[s][ks][0][0], kb[s][ks][0][1]);
      mma(sc[1], qa.r[ks], kb[s][ks][1][0], kb[s][ks][1][1]);
      mma(dp[0], da.r[ks], vb[s][ks][0][0], vb[s][ks][0][1]);
      mma(dp[1], da.r[ks], vb[s][ks][1][0], vb[s][ks][1][1]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4& r = st[e >> 1];
        const float x = __fadd_rn(__fadd_rn(sc[nt][e], bt[nt][e]), mt[nt][e]);
        sc[nt][e] = sa_mma::div_rn(expf(__fsub_rn(x, r.x)), r.y, r.z);
      }
  };

  // each sweep starts at tile (j mod nb, j), whose terms no window changes:
  // they are requested before the barriers and waits that precede a sweep
  float bt[kS][2][4], mt[kS][2][4];
  int ib[kS];                        // each key block's query block at the step: (j + t) mod nb
  auto first_terms = [&]() {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      ib[s] = jb[s] % nb;
      if (live[s]) load_terms(ib[s], jb[s], bt[s], mt[s]);
    }
  };

  stage(first);
  first_terms();
  land();
  for (int b = first; b < steps; b += stride) {
    const bool first_window = b == first;

    // D sweep: the 16-key partials of dp * p, [j][row] in dqa
#pragma unroll 1
    for (int t = 0; t < nb; ++t) {
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        if (!live[s]) continue;
        const int i = ib[s];
        const float4 st[2] = {rstat[i * 16 + g], rstat[i * 16 + g + 8]};
        float sc[2][4], dp[2][4];
        tile(s, i, bt[s], mt[s], st, sc, dp);
        ib[s] = i + 1 == nb ? 0 : i + 1;
        if (t + 1 < nb) load_terms(ib[s], jb[s], bt[s], mt[s]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e)
              sum = __fadd_rn(sum, __fmul_rn(dp[nt][e], sc[nt][e]));
          sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
          sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
          if (tq == 0) dqa[jb[s] * np + i * 16 + g + 8 * r] = sum;
        }
      }
    }
    first_terms();
    __syncthreads();
    // D of each row, its partials summed in key-block order (and cleared:
    // the dq accumulators start at 0)
    if (threadIdx.x < np) {
      float dsum = 0.f;
      for (int j = 0; j < nb; ++j) {
        dsum = __fadd_rn(dsum, dqa[j * np + threadIdx.x]);
        dqa[j * np + threadIdx.x] = 0.f;
      }
      rstat[threadIdx.x].w = dsum;
    }
    __syncthreads();

    // main pass
    float ak[kS][G::kDTiles][4] = {}, av[kS][G::kDTiles][4] = {};
#pragma unroll 1
    for (int t = 0; t < nb; ++t) {
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        if (!live[s]) continue;
        const int i = ib[s], j = jb[s];
        const float4 st[2] = {rstat[i * 16 + g], rstat[i * 16 + g + 8]};
        float sc[2][4], dp[2][4];
        tile(s, i, bt[s], mt[s], st, sc, dp);
        ib[s] = i + 1 == nb ? 0 : i + 1;
        if (t + 1 < nb) load_terms(ib[s], j, bt[s], mt[s]);
        // ds = p (dp - D), into dp's registers
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[nt][e] = __fmul_rn(sc[nt][e], __fsub_rn(dp[nt][e], st[e >> 1].w));
        // the fp32 ds into dbias tile (i, j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = i * 16 + g + 8 * r;
          if (row >= n) continue;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int key = j * 16 + nt * 8 + 2 * tq;
            if (key >= n) continue;
            const float d0 = dp[nt][2 * r], d1 = dp[nt][2 * r + 1];
            if constexpr (kOnChip) {
              float2* sp = reinterpret_cast<float2*>(slice + row * ss + key);
              const float2 o = *sp;
              *sp = make_float2(__fadd_rn(o.x, d0), __fadd_rn(o.y, d1));
            } else {
              float* gp = part + size_t(row) * n + key;
              gp[0] = first_window ? d0 : __fadd_rn(gp[0], d0);
              if (key + 1 < n) gp[1] = first_window ? d1 : __fadd_rn(gp[1], d1);
            }
          }
        }
        uint32_t pa[4], sa[4], pt[4], st_a[4];
        sa_mma::to_a(pa, sc);
        sa_mma::to_a(sa, dp);
        trans_a(pt, pa);
        trans_a(st_a, sa);
        // dv_j += round(p)^T.do_i, dk_j += round(ds)^T.qs_i
        sa_mma::product_nn<kHd, G::kDTiles>(av[s], pt, dd, i * 16, 0);
        sa_mma::product_nn<kHd, G::kDTiles>(ak[s], st_a, qs, i * 16, 0);
        // dq_i += round(ds).k_j into the accumulators; the B fragments (keys
        // 0-7 and 8-15 at d dt 8 + g) are kb's 8 x 8 blocks transposed, once
        // every warp has added its part of the previous step
        if (t > 0 && s == 0) bar_wait(bar, (phase - 1) & 1);
        float4* acc4 = dqa4 + i * 4 * 32 + lane;
#pragma unroll
        for (int dt = 0; dt < G::kDTiles; ++dt) {
          const float4 a4 = acc4[dt * 32];
          float dq[4] = {a4.x, a4.y, a4.z, a4.w};
          mma(dq, sa, trans8(kb[s][dt >> 1][0][dt & 1]), trans8(kb[s][dt >> 1][1][dt & 1]));
          acc4[dt * 32] = make_float4(dq[0], dq[1], dq[2], dq[3]);
        }
      }
      // query block i's accumulators are its next owner's once all arrive
      // (an idle warp arrives once a phase too, after the previous one)
      if (t > 0 && !live[0]) bar_wait(bar, (phase - 1) & 1);
      __syncwarp();
      if (lane == 0) bar_arrive(bar);
      ++phase;
    }
    bar_wait(bar, (phase - 1) & 1);   // every warp's last step of dq

    // the next window's loads in flight while dq, dk and dv are written out
    const int next_b = b + stride;
    if (next_b < steps) {
      stage(next_b);
      first_terms();
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      if (!live[s]) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = jb[s] * 16 + g + 8 * r;
        if (key >= n) continue;
        bf16* dk = gk + aq(b, key);
        bf16* dv = gv + aq(b, key);
#pragma unroll
        for (int dt = 0; dt < G::kDTiles; ++dt) {
          *reinterpret_cast<uint32_t*>(dk + dt * 8 + 2 * tq) =
              pack(ak[s][dt][2 * r], ak[s][dt][2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dv + dt * 8 + 2 * tq) =
              pack(av[s][dt][2 * r], av[s][dt][2 * r + 1]);
        }
      }
    }
    for (int x = threadIdx.x; x < np * 8; x += kThreads) {
      const float4 f = dqa4[x];
      dqa4[x] = zero4;
      const int row = (x >> 7) * 16 + ((x & 31) >> 2), col = ((x >> 5) & 3) * 8 + 2 * (x & 3);
      if (row < n)
        *reinterpret_cast<uint32_t*>(gq + aq(b, row) + col) = pack(f.x * scale_f, f.y * scale_f);
      if (row + 8 < n)
        *reinterpret_cast<uint32_t*>(gq + aq(b, row + 8) + col) =
            pack(f.z * scale_f, f.w * scale_f);
    }
    if (next_b < steps) land();
  }

  if constexpr (kOnChip) {
    __syncthreads();
    for (int r = warp; r < n; r += kW)
      for (int c = lane; c < n; c += 32) part[size_t(r) * n + c] = slice[r * ss + c];
  }
}

}  // namespace win_bwd1
}  // namespace emvm
