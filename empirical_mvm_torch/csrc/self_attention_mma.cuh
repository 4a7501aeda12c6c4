// The tensor-core body of the tiled self-attention (self_attention_tiled.cu):
// bf16 q, k, v with hd = 32, 64 or 128 (a compile-time parameter, one
// instantiation each). Same function, same rounding points as the CUDA-core
// body and the JAX kernels it replaces (`_sa_kernel`, `_sa_bwd_kernel`):
// q * scale rounded to bf16 before the scores and before dk; fp32 scores,
// mask and softmax, p = exp(s - max) / sum; the probabilities after dropout
// rounded to bf16 before P.V and before dv; ds = p * (dp - D) rounded before
// dq and dk, D = rowsum(dp * p); dq scaled by the fp32 scale.
//
// Every product is one `mma.sync.aligned.m16n8k16` (bf16 operands, fp32
// accumulator): bf16 products are exact in fp32, so the only new error is
// the order of the fp32 sums. Operands come from shared memory through
// `ldmatrix` (`.trans` where the operand's rows are its k axis: V, K and dO
// as B of P.V, ds.K and P^T.dO, q * scale as B of ds^T.qs); the fp32 scores
// and ds, computed in the accumulator layout of one 16 x 16 tile, are exactly
// the A fragment of the next product once rounded, so p and ds never touch
// shared memory. Tiles of 64 rows arrive through 16-byte `cp.async` copies
// into a double-buffered ring (zero-filled past N); their rows are padded by
// 16 bytes so that the eight rows of each `ldmatrix` fall in distinct banks.
//
// Forward: one block of 4 warps per (64 query rows, head, row b), each warp
// 16 query rows. Pass 1 streams the K tiles and keeps, per thread, a running
// max and sum over its own keys; the 4 threads of a quad that share a row
// combine theirs (max, then sum of sum * exp(max - row max), shfl_xor 1 then
// 2). Pass 2 streams K and V, recomputes the scores with the same
// instructions and forms the normalised p, as the JAX kernel rounds it: a
// one-pass online softmax would round the unnormalised p. The division is
// IEEE's, correctly rounded, from one reciprocal a row (`div_rn`); the
// forward issues each chunk's mask loads before its products, whose time
// covers their latency (the backward has no registers to spare).
// Backward: a rows kernel (pass A: D; pass B: ds and dq) and a columns
// kernel (one block per 64 keys, 32 at hd 128, looping over the query
// tiles: S^T = K.qs^T and dP^T = V.dO^T, so P^T and dS^T come out as the A
// operands of dv and dk).
// The columns kernel forms p and ds with the rows kernel's products (the
// same pairs of factors summed over d in the same k-steps) and the same fp32
// expressions, so it reproduces the rows kernel's p bit for bit; no atomics.
// Every kernel reads the mask from global memory through its two strides at
// each score (the padding mask's stride-0 rows stay in the L1 cache); only
// the columns kernel's stats rows come through the cp.async ring.
//
// Layouts (`Layout`, a template parameter): row 11's (B, nH, N, hd) head
// tiles, and row 6's lane layout, x3 (B, L, 3D) with a head's rows 3D apart
// and out (B, L, D) (`launch_lane_bwd`). Each fixes the (row b, head h,
// token) strides of q, k, v (and dq, dk, dv) and of out (and dout); row 11's
// are compile-time constants, as before row 6 shared the kernels. Row 6's
// forward saves no softmax statistics, so its backward first runs the
// forward's pass 1 alone (`sa_fwd_mma_kernel` with kStatsOnly), writing the
// rows' max and sum as the row-11 forward does.
#pragma once

#include "common.cuh"

namespace emvm {

// Offsets of the (row b, head h) = (blockIdx.z, blockIdx.y) tiles, shared by
// both bodies of the tiled self-attention.
struct Heads {
  size_t qkv;   // element offset of (b, h) in q, k, v and their gradients
  size_t out;   // element offset of (b, h) in out and dout
  size_t stat;  // (b * nH + h)
};

__device__ __forceinline__ Heads heads(long long bs, int n, int nh, int hd) {
  const int h = blockIdx.y, b = blockIdx.z;
  return {size_t(b) * bs + size_t(h) * n * hd, (size_t(b) * nh + h) * n * hd,
          size_t(b) * nh + h};
}

// The layouts of the tensor-core body. kTiles: q, k, v (B, nH, N, hd) head
// tiles, rows b `bs` elements apart (3nH * N * hd packed, nH * N * hd
// split), out (B, nH, N, hd): (row b, head h, token) strides {bs, N hd, hd}
// and {nH N hd, N hd, hd}. kLane: x3 (B, N, 3D) with k and v D and 2D after
// q, out (B, N, D), D = nH hd: {3 N D, hd, 3D} and {N D, hd, D}. Every row
// starts on 16 bytes where D is a multiple of 8.
enum class Layout { kTiles, kLane };

template <Layout L, int HD>
__device__ __forceinline__ Heads layout_heads(long long bs, int n, int nh) {
  if constexpr (L == Layout::kTiles) {
    return heads(bs, n, nh, HD);
  } else {
    const int h = blockIdx.y, b = blockIdx.z;
    return {size_t(b) * n * 3 * nh * HD + size_t(h) * HD,
            size_t(b) * n * nh * HD + size_t(h) * HD, size_t(b) * nh + h};
  }
}

// elements between the token rows of a head: in q, k, v (kQkv) or in out
template <Layout L, int HD, bool kQkv>
__device__ __forceinline__ int row_stride(int nh) {
  return L == Layout::kTiles ? HD : (kQkv ? 3 : 1) * nh * HD;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

namespace sa_mma {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;       // query rows of a forward or rows block; rows of a streamed tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 4;   // 65536 / (4 * 128): at most 128 registers a thread
constexpr int kChunk = 16;      // keys (queries in the columns kernel) of one k-step

template <int HD>
struct Geo {
  static_assert(HD == 32 || HD == 64 || HD == 128, "the tensor-core body takes hd 32, 64, 128");
  static constexpr int kStride = HD + 8;            // bf16 elements a shared-memory row
  static constexpr int kTileElems = kTile * kStride;
  static constexpr int kKSteps = HD / 16;           // k-steps over d
  static constexpr int kDTiles = HD / 8;            // n-tiles over d
  static constexpr int kSplit = HD > 64 ? 2 : 1;    // columns kernel: warps sharing 16 keys
  static constexpr int kColKeys = 16 * kWarps / kSplit;
  static constexpr int kColDTiles = kDTiles / kSplit;
  static constexpr bool kHoldA = HD <= 64;          // A fragments held in registers
};

// Shared memory of each kernel, in bytes.
template <int HD>
constexpr size_t fwd_smem() {
  return size_t(5) * Geo<HD>::kTileElems * sizeof(bf16);   // Q, 2 K, 2 V
}
template <int HD>
constexpr size_t rows_smem() {
  return size_t(6) * Geo<HD>::kTileElems * sizeof(bf16);   // Q, dO, 2 K, 2 V
}
template <int HD>
constexpr size_t cols_smem() {
  // own K and V rows, 2 (q, dO) tiles, the q * scale tile, 2 x (max, sum, D, 1 / sum)
  return (size_t(2) * Geo<HD>::kColKeys * Geo<HD>::kStride + size_t(5) * Geo<HD>::kTileElems) *
             sizeof(bf16) +
         size_t(2) * 4 * kTile * sizeof(float);
}

// --- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the destination zero-filled where !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b for one 16 x 8 tile, k = 16
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 rounded to bf16, lo in the low half (the smaller column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments (16 x 16 per k-step) of one 16-row block of a tile with
// padded rows: ldmatrix row (lane & 15), column half (lane >> 4). kHold
// keeps every k-step's fragment in registers, else each get reloads it.
template <int HD, bool kHold>
struct AFrags {
  uint32_t r[kHold ? Geo<HD>::kKSteps : 1][4];
  const bf16* base;

  __device__ __forceinline__ void init(const bf16* tile, int row0) {
    const int lane = threadIdx.x & 31;
    base = tile + (row0 + (lane & 15)) * Geo<HD>::kStride + (lane >> 4) * 8;
    if constexpr (kHold) {
#pragma unroll
      for (int kk = 0; kk < Geo<HD>::kKSteps; ++kk) ldsm_x4(r[kk], base + kk * 16);
    }
  }

  __device__ __forceinline__ void get(int kk, uint32_t (&a)[4]) const {
    if constexpr (kHold) {
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = r[kk][u];
    } else {
      ldsm_x4(a, base + kk * 16);
    }
  }
};

// c[0], c[1] += A . B^T for 16 rows of B (two n-tiles of 8) starting at row0
// of a tile whose rows are the n axis and whose columns are k (d):
// K for the scores, V for dP, q * scale for S^T, dO for dP^T.
template <int HD, bool kHold>
__device__ __forceinline__ void product_nt(float (&c)[2][4], const AFrags<HD, kHold>& a,
                                           const bf16* tile, int row0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (row0 + ((lane >> 4) << 3) + (lane & 7)) * Geo<HD>::kStride +
                  ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < Geo<HD>::kKSteps; ++kk) {
    uint32_t af[4], bf[4];
    a.get(kk, af);
    ldsm_x4(bf, p + kk * 16);
    mma(c[0], af, bf[0], bf[1]);
    mma(c[1], af, bf[2], bf[3]);
  }
}

// acc[dt] += A . B for the 16 rows (k) starting at row0 of a tile whose rows
// are k and whose columns are the n axis (d), over n-tiles [dt0, dt0 + DT):
// V for P.V, K for ds.K, dO for P^T.dO, q * scale for dS^T.qs.
template <int HD, int DT>
__device__ __forceinline__ void product_nn(float (&acc)[DT][4], const uint32_t (&a)[4],
                                           const bf16* tile, int row0, int dt0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (row0 + (lane & 15)) * Geo<HD>::kStride + dt0 * 8 + (lane >> 4) * 8;
#pragma unroll
  for (int dt = 0; dt < DT; dt += 2) {
    uint32_t bf[4];
    ldsm_x4_t(bf, p + dt * 8);
    mma(acc[dt], a, bf[0], bf[1]);
    mma(acc[dt + 1], a, bf[2], bf[3]);
  }
}

// The accumulators of a 16 x 16 tile (two n-tiles) rounded to bf16 as the
// A fragment of the next product.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack(c[0][0], c[0][1]);
  a[1] = pack(c[0][2], c[0][3]);
  a[2] = pack(c[1][0], c[1][1]);
  a[3] = pack(c[1][2], c[1][3]);
}

// --- staging -----------------------------------------------------------------

// rows [r0, r0 + rows) of an (N, HD) head whose rows are `sr` elements
// apart into shared rows of kStride, by 16-byte cp.async; rows past n are
// zero-filled
template <int HD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* __restrict__ src, int r0, int rows,
                                      int n, int sr) {
  constexpr int kChunks = HD / 8;
  for (int x = threadIdx.x; x < rows * kChunks; x += kThreads) {
    const int r = x / kChunks, c = x % kChunks, row = r0 + r;
    const bool full = row < n;
    cp_async16(dst + r * Geo<HD>::kStride + c * 8, src + size_t(full ? row : 0) * sr + c * 8,
               full);
  }
}

// dst = round_bf16(src * scale) over kTile rows (q * scale, as JAX's
// q * jnp.asarray(scale, bf16): the product of two bf16 is exact in fp32)
template <int HD>
__device__ __forceinline__ void scale_tile(bf16* dst, const bf16* src, float scale) {
  constexpr int kChunks = HD / 8;
  for (int x = threadIdx.x; x < kTile * kChunks; x += kThreads) {
    const int off = (x / kChunks) * Geo<HD>::kStride + (x % kChunks) * 8;
    uint4 u = *reinterpret_cast<const uint4*>(src + off);
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 f = __bfloat1622float2(e[w]);
      e[w] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(dst + off) = u;
  }
}

// --- the elementwise terms, shared by the three kernels ------------------------

// x / y correctly rounded, as IEEE division rounds it, from the row's
// r = 1 / y correctly rounded: with q = x * r rounded, x - q y is exact (one
// fma) and q + (x - q y) r rounds to x / y (Markstein's theorem; no overflow
// here, x <= 1 <= y). Three instructions in place of a division's dozen.
__device__ __forceinline__ float div_rn(float x, float y, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-y, q, x), r, q);
}

// p = exp(s + mask - max) / sum, each operation rounded on its own (no
// contraction), so that every kernel forms the same bits; rcp = 1 / sum
__device__ __forceinline__ float prob(float acc, float m, float mx, float sum, float rcp) {
  return div_rn(expf(__fsub_rn(__fadd_rn(acc, m), mx)), sum, rcp);
}

__device__ __forceinline__ float drop_scale(bool keep, float x, float inv_keep) {
  return keep ? __fmul_rn(x, inv_keep) : 0.f;
}

__device__ __forceinline__ uint4 philox_at(const Dropout& d, int b, int h, int i, int j) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(j) >> 2, i, h, b), d.k0, d.k1);
}

__device__ __forceinline__ uint32_t word(const uint4& r, int w) {
  return w & 2 ? (w & 1 ? r.w : r.z) : (w & 1 ? r.y : r.x);
}

// Keep bits of a thread's score fragment of one n-tile in the forward and
// rows kernels: rows (ra, rb), keys (j, j + 1), j = 2 * (lane & 3) + 8m.
// Lanes tq and tq ^ 1 need the same two Philox counters (j / 4, ra) and
// (j / 4, rb): the even lane draws ra's, the odd rb's, and each passes the
// other the pair of words it needs (words 0-1 for the even lane, 2-3 for
// the odd). keep[r][u]: row r, key j + u. Every lane of the warp calls it.
__device__ __forceinline__ void keep_rows(const Dropout& d, int b, int h, const int (&rows)[2],
                                          int j, bool (&keep)[2][2]) {
  const int o = threadIdx.x & 1;
  const uint4 r = philox_at(d, b, h, o ? rows[1] : rows[0], j);
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, o ? r.x : r.z, 1);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, o ? r.y : r.w, 1);
  const uint32_t own0 = o ? r.z : r.x, own1 = o ? r.w : r.y;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    keep[row][0] = (row == o ? own0 : got0) >= d.threshold;
    keep[row][1] = (row == o ? own1 : got1) >= d.threshold;
  }
}

// Keep bits of a thread's fragment of one n-tile in the columns kernel:
// keys (ja, ja + 8) (rows of S^T), queries (i, i + 1). Element e = 2 * key
// + query takes word (ja & 3) of counter (j_e / 4, i_e); the four lanes
// that differ in (lane >> 2) & 3 need the same four counters, so lane rr
// draws counter rr and, in round k, passes lane rr ^ k word rr ^ k of it.
// keep[e]. Every lane of the warp calls it.
__device__ __forceinline__ void keep_cols(const Dropout& d, int b, int h, int ja, int i,
                                          bool (&keep)[4]) {
  const int rr = (threadIdx.x >> 2) & 3;
  const uint4 r = philox_at(d, b, h, i + (rr & 1), ja + (rr >> 1) * 8);
  uint32_t by_k[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t send = word(r, rr ^ k);
    by_k[k] = k ? __shfl_xor_sync(0xffffffffu, send, k << 2) : send;   // counter rr ^ k
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = e ^ rr;
    const uint32_t bits = k & 2 ? (k & 1 ? by_k[3] : by_k[2]) : (k & 1 ? by_k[1] : by_k[0]);
    keep[e] = bits >= d.threshold;
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// The row's max and sum from the four partial ones of a quad (max, then sum
// of sum * exp(max - row max), shfl_xor 1 then 2), and 1 / sum.
__device__ __forceinline__ void quad_stats(float (&mx)[2], float (&sum)[2], float (&rcp)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float part = mx[r] == m ? sum[r] : sum[r] * expf(mx[r] - m);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    mx[r] = m;
    sum[r] = part;
    rcp[r] = __frcp_rn(part);
  }
}

// kStatsOnly: pass 1 alone, writing the rows' max and sum and no output
// (the statistics pass of row 6's backward).
template <int HD, Layout L = Layout::kTiles, bool kStatsOnly = false>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sa_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, long long bs, const float* __restrict__ mask,
                      long long mask_sb, long long mask_sr, bf16* __restrict__ out,
                      float* __restrict__ stats, int n, int nh, float scale_t,
                      const int* __restrict__ seed, unsigned threshold, float inv_keep) {
  using G = Geo<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qt = reinterpret_cast<bf16*>(smem_raw);
  bf16* kt = qt + G::kTileElems;      // two buffers
  bf16* vt = kt + 2 * G::kTileElems;  // two buffers
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const Heads hs = layout_heads<L, HD>(bs, n, nh);
  const bf16 *qh = q + hs.qkv, *kh = k + hs.qkv, *vh = v + hs.qkv;
  const int qsr = row_stride<L, HD, true>(nh);
  const int i0 = blockIdx.x * kTile;
  const int rows[2] = {i0 + warp * 16 + g, i0 + warp * 16 + g + 8};
  const float* mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) mrow[r] = mask + b * mask_sb + min(rows[r], n - 1) * mask_sr;
  const Dropout drop(seed, threshold, inv_keep);
  const int n_tiles = (n + kTile - 1) / kTile, stages = (kStatsOnly ? 1 : 2) * n_tiles;

  stage<HD>(qt, qh, i0, kTile, n, qsr);
  cp_async_commit();
  stage<HD>(kt, kh, 0, kTile, n, qsr);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  scale_tile<HD>(qt, qt, scale_t);
  __syncthreads();
  AFrags<HD, G::kHoldA> qa;
  qa.init(qt, warp * 16);

  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, sum[2] = {0.f, 0.f}, rcp[2];
  float o[G::kDTiles][4] = {};
  // stage s < n_tiles: K tile s (pass 1); stage n_tiles + t: K and V tile t
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      const int nx = s + 1, t1 = nx < n_tiles ? nx : nx - n_tiles;
      stage<HD>(kt + (nx & 1) * G::kTileElems, kh, t1 * kTile, kTile, n, qsr);
      if (nx >= n_tiles) stage<HD>(vt + (nx & 1) * G::kTileElems, vh, t1 * kTile, kTile, n, qsr);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool second = s >= n_tiles;
    const int j0 = (second ? s - n_tiles : s) * kTile;
    const bf16* kb = kt + (s & 1) * G::kTileElems;
    const bf16* vb = vt + (s & 1) * G::kTileElems;
    if (s == n_tiles) quad_stats(mx, sum, rcp);
#pragma unroll
    for (int c = 0; c < kTile / kChunk; ++c) {
      // the mask terms first, so that their loads are in flight during the
      // products: -inf past N, 0 for rows past N
      const int jc = j0 + c * kChunk + 2 * tq;
      float mv[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = jc + nt * 8 + (e & 1), r = e >> 1;
          mv[nt][e] = j >= n ? -CUDART_INF_F : rows[r] < n ? __ldg(mrow[r] + j) : 0.f;
        }
      float sc[2][4] = {};
      product_nt<HD>(sc, qa, kb, c * kChunk);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = __fadd_rn(sc[nt][e], mv[nt][e]);
      if (kStatsOnly || !second) {
        // running max and sum of this thread's keys of each row
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
      } else {
        // the normalised p, dropout, rounded into P.V's A fragment
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[nt][e] =
                div_rn(expf(__fsub_rn(sc[nt][e], mx[e >> 1])), sum[e >> 1], rcp[e >> 1]);
        if (drop.on) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            bool keep[2][2];
            keep_rows(drop, b, h, rows, jc + nt * 8, keep);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[nt][e] = drop_scale(keep[e >> 1][e & 1], sc[nt][e], drop.inv_keep);
          }
        }
        uint32_t pa[4];
        to_a(pa, sc);
        product_nn<HD, G::kDTiles>(o, pa, vb, c * kChunk, 0);
      }
    }
    __syncthreads();                                // the buffer is reloaded next stage
  }

  if constexpr (kStatsOnly) quad_stats(mx, sum, rcp);
  bf16* oh = out + hs.out;
  float* st = stats + hs.stat * 2 * n;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= n) continue;
    if constexpr (!kStatsOnly) {
#pragma unroll
      for (int dt = 0; dt < G::kDTiles; ++dt)
        *reinterpret_cast<uint32_t*>(oh + size_t(rows[r]) * row_stride<L, HD, false>(nh) +
                                     dt * 8 + 2 * tq) =
            pack(o[dt][2 * r], o[dt][2 * r + 1]);
    }
    if (tq == 0) {
      st[rows[r]] = mx[r];
      st[n + rows[r]] = sum[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, rows: D = rowsum(dp * p) (pass A), then ds and dq (pass B)
// ---------------------------------------------------------------------------

template <int HD, Layout L = Layout::kTiles>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sa_bwd_rows_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ dq, long long bs,
                           const float* __restrict__ mask, long long mask_sb, long long mask_sr,
                           const bf16* __restrict__ dout, const float* __restrict__ stats,
                           float* __restrict__ dsum, int n, int nh, float scale_t,
                           float scale_f, const int* __restrict__ seed, unsigned threshold,
                           float inv_keep) {
  using G = Geo<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qt = reinterpret_cast<bf16*>(smem_raw);
  bf16* dt_ = qt + G::kTileElems;
  bf16* kt = dt_ + G::kTileElems;     // two buffers
  bf16* vt = kt + 2 * G::kTileElems;  // two buffers
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const Heads hs = layout_heads<L, HD>(bs, n, nh);
  const bf16 *qh = q + hs.qkv, *kh = k + hs.qkv, *vh = v + hs.qkv, *doh = dout + hs.out;
  const int qsr = row_stride<L, HD, true>(nh);
  const float* st = stats + hs.stat * 2 * n;
  const int i0 = blockIdx.x * kTile;
  const int rows[2] = {i0 + warp * 16 + g, i0 + warp * 16 + g + 8};
  const float* mrow[2];
  float mx[2], sum[2], rcp[2], dd[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mrow[r] = mask + b * mask_sb + min(rows[r], n - 1) * mask_sr;
    mx[r] = rows[r] < n ? st[rows[r]] : 0.f;
    sum[r] = rows[r] < n ? st[n + rows[r]] : 1.f;
    rcp[r] = __frcp_rn(sum[r]);
  }
  const Dropout drop(seed, threshold, inv_keep);
  const int n_tiles = (n + kTile - 1) / kTile, stages = 2 * n_tiles;

  stage<HD>(qt, qh, i0, kTile, n, qsr);
  stage<HD>(dt_, doh, i0, kTile, n, row_stride<L, HD, false>(nh));
  cp_async_commit();
  stage<HD>(kt, kh, 0, kTile, n, qsr);
  stage<HD>(vt, vh, 0, kTile, n, qsr);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  scale_tile<HD>(qt, qt, scale_t);
  __syncthreads();
  AFrags<HD, G::kHoldA> qa, da;
  qa.init(qt, warp * 16);
  da.init(dt_, warp * 16);

  float acc[G::kDTiles][4] = {};
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      const int nx = s + 1, t1 = nx < n_tiles ? nx : nx - n_tiles;
      stage<HD>(kt + (nx & 1) * G::kTileElems, kh, t1 * kTile, kTile, n, qsr);
      stage<HD>(vt + (nx & 1) * G::kTileElems, vh, t1 * kTile, kTile, n, qsr);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool second = s >= n_tiles;
    const int j0 = (second ? s - n_tiles : s) * kTile;
    const bf16* kb = kt + (s & 1) * G::kTileElems;
    const bf16* vb = vt + (s & 1) * G::kTileElems;
    if (s == n_tiles) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 1);
        dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 2);
        if (tq == 0 && rows[r] < n) dsum[hs.stat * n + rows[r]] = dd[r];
      }
    }
#pragma unroll 1
    for (int c = 0; c < kTile / kChunk; ++c) {
      float sc[2][4] = {}, dp[2][4] = {};
      product_nt<HD>(sc, qa, kb, c * kChunk);
      product_nt<HD>(dp, da, vb, c * kChunk);
      const int jc = j0 + c * kChunk + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        bool keep[2][2] = {{true, true}, {true, true}};
        if (drop.on) keep_rows(drop, b, h, rows, jc + nt * 8, keep);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, j = jc + nt * 8 + (e & 1);
          const bool valid = j < n && rows[r] < n;
          const float p =
              valid ? prob(sc[nt][e], __ldg(mrow[r] + j), mx[r], sum[r], rcp[r]) : 0.f;
          const float d = drop.on ? drop_scale(keep[r][e & 1], dp[nt][e], drop.inv_keep)
                                  : dp[nt][e];
          if (!second)
            dd[r] += __fmul_rn(d, p);
          else
            sc[nt][e] = __fmul_rn(p, __fsub_rn(d, dd[r]));   // ds
        }
      }
      if (second) {
        uint32_t da4[4];
        to_a(da4, sc);
        product_nn<HD, G::kDTiles>(acc, da4, kb, c * kChunk, 0);
      }
    }
    __syncthreads();
  }

  bf16* dqh = dq + hs.qkv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= n) continue;
#pragma unroll
    for (int dt = 0; dt < G::kDTiles; ++dt)
      *reinterpret_cast<uint32_t*>(dqh + size_t(rows[r]) * qsr + dt * 8 + 2 * tq) =
          pack(acc[dt][2 * r] * scale_f, acc[dt][2 * r + 1] * scale_f);
  }
}

// ---------------------------------------------------------------------------
// Backward, columns: dk and dv of kColKeys keys over every query tile
// ---------------------------------------------------------------------------

template <int HD, Layout L = Layout::kTiles>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sa_bwd_cols_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, long long bs, const float* __restrict__ mask,
                           long long mask_sb, long long mask_sr, const bf16* __restrict__ dout,
                           const float* __restrict__ stats, const float* __restrict__ dsum,
                           int n, int nh, float scale_t, const int* __restrict__ seed,
                           unsigned threshold, float inv_keep) {
  using G = Geo<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kt = reinterpret_cast<bf16*>(smem_raw);   // this block's keys
  bf16* vt = kt + G::kColKeys * G::kStride;
  bf16* qr = vt + G::kColKeys * G::kStride;       // two buffers of q, as stored
  bf16* dr = qr + 2 * G::kTileElems;              // two buffers of dO
  bf16* qs = dr + 2 * G::kTileElems;              // q * scale, rounded
  float* sr = reinterpret_cast<float*>(qs + G::kTileElems);  // two x (max, sum, D, 1 / sum)
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int kw = warp / G::kSplit, dpart = warp % G::kSplit;
  const Heads hs = layout_heads<L, HD>(bs, n, nh);
  const bf16 *qh = q + hs.qkv, *kh = k + hs.qkv, *vh = v + hs.qkv, *doh = dout + hs.out;
  const int qsr = row_stride<L, HD, true>(nh);
  const float* st = stats + hs.stat * 2 * n;
  const float* dsh = dsum + hs.stat * n;
  const float* mask_b = mask + b * mask_sb;
  const int key0 = blockIdx.x * G::kColKeys;
  const int keys[2] = {key0 + kw * 16 + g, key0 + kw * 16 + g + 8};
  const Dropout drop(seed, threshold, inv_keep);
  const int n_tiles = (n + kTile - 1) / kTile;

  auto stage_queries = [&](int t) {
    const int q0 = t * kTile;
    stage<HD>(qr + (t & 1) * G::kTileElems, qh, q0, kTile, n, qsr);
    stage<HD>(dr + (t & 1) * G::kTileElems, doh, q0, kTile, n, row_stride<L, HD, false>(nh));
    float* s3 = sr + (t & 1) * 4 * kTile;
    for (int x = threadIdx.x; x < 3 * kTile; x += kThreads) {
      const int which = x / kTile, i = q0 + x % kTile;
      const bool full = i < n;
      const float* src = which == 0 ? st + i : which == 1 ? st + n + i : dsh + i;
      cp_async4(s3 + x, full ? src : st, full);
    }
  };

  stage<HD>(kt, kh, key0, G::kColKeys, n, qsr);
  stage<HD>(vt, vh, key0, G::kColKeys, n, qsr);
  cp_async_commit();
  stage_queries(0);
  cp_async_commit();

  float ak[G::kColDTiles][4] = {}, av[G::kColDTiles][4] = {};
  AFrags<HD, false> ka, va;
  ka.init(kt, kw * 16);
  va.init(vt, kw * 16);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage_queries(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qb = qr + (t & 1) * G::kTileElems;
    const bf16* db = dr + (t & 1) * G::kTileElems;
    float* s3 = sr + (t & 1) * 4 * kTile;
    scale_tile<HD>(qs, qb, scale_t);
    if (threadIdx.x < kTile) s3[3 * kTile + threadIdx.x] = __frcp_rn(s3[kTile + threadIdx.x]);
    __syncthreads();
    const int q0 = t * kTile;
#pragma unroll 1
    for (int c = 0; c < kTile / kChunk; ++c) {
      const int ic = c * kChunk + 2 * tq;       // query within the tile
      // the keep bits first: Philox's state is not live beside the products
      bool keep[2][4] = {{true, true, true, true}, {true, true, true, true}};
      if (drop.on) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) keep_cols(drop, b, h, keys[0], q0 + ic + nt * 8, keep[nt]);
      }
      float sc[2][4] = {}, dp[2][4] = {};
      product_nt<HD>(sc, ka, qs, c * kChunk);   // S^T: rows keys, columns queries
      product_nt<HD>(dp, va, db, c * kChunk);   // dP^T
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = ic + nt * 8 + (e & 1), i = q0 + il, j = keys[e >> 1];
          float p = 0.f, ds = 0.f;
          if (i < n && j < n) {
            p = prob(sc[nt][e], __ldg(mask_b + i * mask_sr + j), s3[il], s3[kTile + il],
                     s3[3 * kTile + il]);
            const float d = drop.on ? drop_scale(keep[nt][e], dp[nt][e], drop.inv_keep)
                                    : dp[nt][e];
            ds = __fmul_rn(p, __fsub_rn(d, s3[2 * kTile + il]));
            if (drop.on) p = drop_scale(keep[nt][e], p, drop.inv_keep);
          }
          sc[nt][e] = p;    // after dropout
          dp[nt][e] = ds;
        }
      }
      uint32_t pa[4], sa[4];
      to_a(pa, sc);
      to_a(sa, dp);
      product_nn<HD, G::kColDTiles>(av, pa, db, c * kChunk, dpart * G::kColDTiles);
      product_nn<HD, G::kColDTiles>(ak, sa, qs, c * kChunk, dpart * G::kColDTiles);
    }
    __syncthreads();
  }

  bf16 *dkh = dk + hs.qkv, *dvh = dv + hs.qkv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= n) continue;
#pragma unroll
    for (int dt = 0; dt < G::kColDTiles; ++dt) {
      const size_t o = size_t(keys[r]) * qsr + (dpart * G::kColDTiles + dt) * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(dkh + o) = pack(ak[dt][2 * r], ak[dt][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvh + o) = pack(av[dt][2 * r], av[dt][2 * r + 1]);
    }
  }
}

// --- launches ----------------------------------------------------------------

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int HD, Layout L = Layout::kTiles, bool kStatsOnly = false>
int launch_fwd(const void* q, const void* k, const void* v, long long bs, const void* mask,
               long long mask_sb, long long mask_sr, void* out, void* stats, int b, int n,
               int nh, float scale_t, const void* seed, unsigned threshold, float inv_keep,
               cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto kernel = sa_fwd_mma_kernel<HD, L, kStatsOnly>;
  cudaError_t err = allow_smem(kernel, fwd_smem<HD>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile, nh, b);
  kernel<<<grid, kThreads, fwd_smem<HD>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), bs,
      static_cast<const float*>(mask), mask_sb, mask_sr, static_cast<bf16*>(out),
      static_cast<float*>(stats), n, nh, scale_t, static_cast<const int*>(seed), threshold,
      inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, Layout L = Layout::kTiles>
int launch_bwd(const void* q, const void* k, const void* v, void* dq, void* dk, void* dv,
               long long bs, const void* mask, long long mask_sb, long long mask_sr,
               const void* dout, const void* stats, void* dsum, int b, int n, int nh,
               float scale_t, float scale_f, const void* seed, unsigned threshold,
               float inv_keep, cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dq) || !aligned16(dk) ||
      !aligned16(dv) || !aligned16(dout))
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto rows = sa_bwd_rows_mma_kernel<HD, L>;
  auto cols = sa_bwd_cols_mma_kernel<HD, L>;
  cudaError_t err = allow_smem(rows, rows_smem<HD>());
  if (err == cudaSuccess) err = allow_smem(cols, cols_smem<HD>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16 *tq = static_cast<const bf16*>(q), *tk = static_cast<const bf16*>(k),
             *tv = static_cast<const bf16*>(v), *td = static_cast<const bf16*>(dout);
  const float* m = static_cast<const float*>(mask);
  const int* sd = static_cast<const int*>(seed);
  rows<<<dim3((n + kTile - 1) / kTile, nh, b), kThreads, rows_smem<HD>(), stream>>>(
      tq, tk, tv, static_cast<bf16*>(dq), bs, m, mask_sb, mask_sr, td,
      static_cast<const float*>(stats), static_cast<float*>(dsum), n, nh, scale_t, scale_f, sd,
      threshold, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kKeys = Geo<HD>::kColKeys;
  cols<<<dim3((n + kKeys - 1) / kKeys, nh, b), kThreads, cols_smem<HD>(), stream>>>(
      tq, tk, tv, static_cast<bf16*>(dk), static_cast<bf16*>(dv), bs, m, mask_sb, mask_sr, td,
      static_cast<const float*>(stats), static_cast<const float*>(dsum), n, nh, scale_t, sd,
      threshold, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

// Row 6, lane_self_attention's backward (self_attention.cu), in the kLane
// layout: x3 and dx3 (B, L, 3D), dout (B, L, D), D = nH * HD a multiple of
// 8. scratch: 3 * B * nH * L floats, the rows' max and sum (B, nH, 2, L) of
// the statistics pass (the forward's pass 1 alone), then D (B, nH, L).
template <int HD>
int launch_lane_bwd(const void* x3, const void* mask, long long mask_sb, long long mask_sr,
                    const void* dout, void* dx3, void* scratch, int b, int l, int dm, int nh,
                    float scale_t, float scale_f, const void* seed, unsigned threshold,
                    float inv_keep, cudaStream_t stream) {
  if (dm != nh * HD || dm % 8) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* q = static_cast<const bf16*>(x3);
  bf16* dq = static_cast<bf16*>(dx3);
  float* stats = static_cast<float*>(scratch);
  const long long bs = 3LL * l * dm;
  const int err = launch_fwd<HD, Layout::kLane, true>(q, q + dm, q + 2 * dm, bs, mask, mask_sb,
                                                      mask_sr, dq, stats, b, l, nh, scale_t,
                                                      seed, threshold, inv_keep, stream);
  if (err) return err;
  return launch_bwd<HD, Layout::kLane>(q, q + dm, q + 2 * dm, dq, dq + dm, dq + 2 * dm, bs, mask,
                                       mask_sb, mask_sr, dout, stats, stats + 2LL * b * nh * l,
                                       b, l, nh, scale_t, scale_f, seed, threshold, inv_keep,
                                       stream);
}

}  // namespace sa_mma
}  // namespace emvm
