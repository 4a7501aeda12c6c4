// Shared pieces of the port's hand-written Hopper kernels: dtype codes,
// float <-> storage conversions, warp reductions, the Philox counter-based
// generator behind attention dropout, and the one-query-row attention
// routine that both attention forward kernels run.
//
// Every C entry point of this library takes raw device pointers and a
// cudaStream_t passed as void*, launches on that stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so that a refused
// launch (too much shared memory, a bad grid) reaches the Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

namespace emvm {

// dtype codes shared with empirical_mvm_torch/ops/_build.py
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA rounds
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Attention-probability dropout. Philox4x32-10 (Salmon et al., SC'11), keyed
// by a per-call (seed, offset) pair that the wrapper draws from the step's
// generator and passes in device memory. The counter is the element's
// (j / 4, i, h, b) index and the element takes output word j % 4, so a kernel
// regenerates any element's bit whatever its block partition: the backward
// replays the forward's keep mask without storing it. An element is kept
// where its 32 bits are >= threshold = floor(p * 2^32), with P(keep) = 1 - p,
// and a kept probability is scaled by inv_keep = 1 / (1 - p).
// empirical_mvm_torch/ops/window_attention.py `philox4x32` is the same
// generator in integer tensor ops.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

struct Dropout {
  bool on = false;
  uint32_t k0 = 0, k1 = 0, threshold = 0;
  float inv_keep = 1.f;

  // seed: two int32 (seed, offset) in device memory, or null for no dropout
  __device__ Dropout(const int* seed, uint32_t thr, float inv) {
    if (seed) {
      on = true;
      k0 = static_cast<uint32_t>(seed[0]);
      k1 = static_cast<uint32_t>(seed[1]);
      threshold = thr;
      inv_keep = inv;
    }
  }

  __device__ __forceinline__ bool keep(int b, int h, int i, int j) const {
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(j) >> 2, i, h, b), k0, k1);
    const int w = j & 3;
    const uint32_t bits = w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
    return bits >= threshold;
  }
};

// ---------------------------------------------------------------------------
// Attention blocks: kAttnWarps warps, each walking its own query rows over the
// K and V of one (window or sequence, head) staged once in shared memory.
// ---------------------------------------------------------------------------

constexpr int kAttnWarps = 8;
constexpr int kAttnThreads = kAttnWarps * 32;

// K rows are padded by one 32-bit word so that the 32 lanes of a warp, each
// reading element d of its own key row, hit 32 different banks.
template <typename T>
__host__ __device__ constexpr int k_row_stride(int hd) {
  return hd + static_cast<int>(4 / sizeof(T));
}

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// Dynamic shared memory of one attention block: K (padded rows), V, and per
// warp one fp32 query row and one fp32 score row of length n.
template <typename T>
__host__ __device__ inline size_t attn_smem_bytes(int n, int hd) {
  return align16(size_t(n) * k_row_stride<T>(hd) * sizeof(T)) +
         align16(size_t(n) * hd * sizeof(T)) +
         align16(size_t(kAttnWarps) * hd * sizeof(float)) +
         size_t(kAttnWarps) * n * sizeof(float);
}

template <typename T>
struct AttnSmem {
  T* k;
  T* v;
  float* q;  // kAttnWarps rows of hd
  float* s;  // kAttnWarps rows of n

  __device__ AttnSmem(unsigned char* raw, int n, int hd) {
    size_t off = 0;
    k = reinterpret_cast<T*>(raw + off);
    off += align16(size_t(n) * k_row_stride<T>(hd) * sizeof(T));
    v = reinterpret_cast<T*>(raw + off);
    off += align16(size_t(n) * hd * sizeof(T));
    q = reinterpret_cast<float*>(raw + off);
    off += align16(size_t(kAttnWarps) * hd * sizeof(float));
    s = reinterpret_cast<float*>(raw + off);
  }
};

// One warp computes one output row of softmax(q.K^T + add0 + add1).V, with
// the numerics of the JAX kernels it replaces:
//   * q is multiplied by the scale in the storage type (the scale itself
//     rounded to T by the caller), as `q * jnp.asarray(scale, dtype)` does;
//   * scores, the additive terms and the softmax are fp32;
//   * with dropout on, the fp32 probability (b, h, i, j) is zeroed or scaled
//     by inv_keep (`_lane_sa_fwd_kernel`);
//   * the probabilities are rounded to T before P.V, which accumulates fp32;
//   * the output row is rounded once to T.
// add0 / add1 are rows of n fp32 values, or null. (b, h, i) name the row for
// the dropout counter.
template <typename T>
__device__ void attend_row(const T* __restrict__ q_row, float scale_t,
                           const AttnSmem<T>& sm, int n, int hd,
                           const float* __restrict__ add0,
                           const float* __restrict__ add1,
                           T* __restrict__ out_row, const Dropout& drop,
                           int b, int h, int i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* qb = sm.q + size_t(warp) * hd;
  float* sb = sm.s + size_t(warp) * n;
  const int ks = k_row_stride<T>(hd);

  for (int d = lane; d < hd; d += 32)
    qb[d] = to_float(from_float<T>(to_float(q_row[d]) * scale_t));
  __syncwarp();

  float mx = -CUDART_INF_F;
  for (int j = lane; j < n; j += 32) {
    const T* kr = sm.k + size_t(j) * ks;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(qb[d], to_float(kr[d]), acc);
    if (add0) acc += add0[j];
    if (add1) acc += add1[j];
    sb[j] = acc;
    mx = fmaxf(mx, acc);
  }
  mx = warp_max(mx);

  float sum = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(sb[j] - mx);
    sb[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < n; j += 32) {
    float p = sb[j] / sum;
    if (drop.on) p = drop.keep(b, h, i, j) ? p * drop.inv_keep : 0.f;
    sb[j] = to_float(from_float<T>(p));
  }
  __syncwarp();

  for (int d = lane; d < hd; d += 32) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(sb[j], to_float(sm.v[size_t(j) * hd + d]), acc);
    out_row[d] = from_float<T>(acc);
  }
  __syncwarp();  // the next row reuses qb and sb
}

}  // namespace emvm
