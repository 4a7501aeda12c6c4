// The window-attention backward that the direct kernel
// (window_attention.cu), the lane window kernel (lane_window_attention.cu)
// and the packed kernel (packed_window_attention.cu) share: one block of
// kAttnThreads threads walks a fixed sequence of windows that share one head
// and one mask slot, and for each window computes dq, dk, dv and adds its ds
// rows into the block's own fp32 dbias slice. Only the addressing differs
// between the callers; it comes in as three input bases q, k, v, three
// output bases gq, gk, gv (for dq, dk, dv, in the inputs' layout), dout,
// and a functor `addr(seg, step, t)`: the element offset of token t's head
// row in segment seg (0, 1, 2: q, k, v from their bases and dq, dk, dv from
// theirs; 3: dout) of the window the block visits at `step`. The direct and the lane
// window kernels pass x3, x3 + C, x3 + 2C as the bases of one (rows, 3C)
// array; the packed kernel the three (N, hd) head tiles of its
// (B_, 3nH, N, hd) array, or three separate arrays. The callers run this
// body for fp32 and for bf16 at hd other than 32; bf16 at hd 32 runs the
// tensor-core body of attention_bwd_mma.cuh, which has the same interface
// (the direct kernel's own one-pass body up to 256 keys:
// attention_bwd_onepass.cuh).
//
// Algebra and roundings of the JAX backward kernels (`_direct_bwd_kernel`,
// `_lane_bwd_kernel`, `_attn_bwd_kernel`): qs = q * scale in T; p =
// softmax(qs.k^T + bias + mask) in fp32; dv = round_T(p)^T.do; dp = do.v^T;
// ds = p * (dp - rowsum(dp * p)); dbias += ds (fp32); dq = (round_T(ds).k) *
// scale (the fp32 scale); dk = round_T(ds)^T.qs.
//
// Per window the block stages qs, k, v and do of its head in shared memory
// (rows padded by one word; every read of q, k, v, dout, bias and mask goes
// through __ldg, since the kernels' __restrict__ does not reliably reach
// this inlined body: without it the direct backward ran 6 % slower on the
// H100 than with its own copy of the body), then
//   pass 1, one warp per query row i: the score row, softmax (its max, sum
//     and rowsum(dp * p) kept in shared memory), ds, and dq_i;
//   pass 2, one warp per key column j, lanes over the query rows: p_ij and
//     ds_ij recomputed bit for bit as pass 1 computed them (same fma chain,
//     the stored max and sum), then dv_j and dk_j.
// dbias: the TPU kernels carry it across their sequential grid. Blocks here
// run in no order, so each block adds its ds rows into its own slice of a
// partial buffer, in its fixed window order, and sum_slices_kernel sums the
// slices in a fixed order. No atomics: a step is bit-identical from run to
// run.
#pragma once

#include "common.cuh"

namespace emvm {
namespace {

template <typename T>
__host__ __device__ inline size_t attention_bwd_smem_bytes(int n, int hd) {
  return 4 * align16(size_t(n) * k_row_stride<T>(hd) * sizeof(T)) +
         align16(3 * size_t(n) * sizeof(float)) + 2 * size_t(kAttnWarps) * n * sizeof(float);
}

// The windows step = first, first + stride, ... < steps of one (head, mask
// slot) pair. bias_h (n, n) is the head's bias, mask_w (n, n) the slot's
// mask or null, part (n, n) the block's dbias slice. Inlined into each
// kernel, so that `addr` compiles to the caller's own address code.
template <typename T, typename Addr>
__device__ __forceinline__ void attention_bwd_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias_h, const float* __restrict__ mask_w,
    const T* __restrict__ dout, T* __restrict__ gq, T* __restrict__ gk, T* __restrict__ gv,
    float* __restrict__ part, int n, int hd, int first, int steps, int stride, Addr addr,
    float scale_t, float scale_f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks = k_row_stride<T>(hd);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const size_t mat = align16(size_t(n) * ks * sizeof(T));
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* kk = reinterpret_cast<T*>(smem_raw + mat);
  T* vv = reinterpret_cast<T*>(smem_raw + 2 * mat);
  T* dd = reinterpret_cast<T*>(smem_raw + 3 * mat);
  float* row_max = reinterpret_cast<float*>(smem_raw + 4 * mat);
  float* row_sum = row_max + n;
  float* row_dp = row_sum + n;
  float* ra = reinterpret_cast<float*>(smem_raw + 4 * mat + align16(3 * size_t(n) * sizeof(float))) +
              size_t(warp) * 2 * n;
  float* rb = ra + n;

  for (int b = first; b < steps; b += stride) {
    const bool first_window = b == first;
    __syncthreads();  // the previous window is done with shared memory
    for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
      const int t = idx / hd, e = idx % hd;
      qs[t * ks + e] = from_float<T>(to_float(__ldg(q + addr(0, b, t) + e)) * scale_t);
      kk[t * ks + e] = __ldg(k + addr(1, b, t) + e);
      vv[t * ks + e] = __ldg(v + addr(2, b, t) + e);
      dd[t * ks + e] = __ldg(dout + addr(3, b, t) + e);
    }
    __syncthreads();

    // pass 1: query rows -> softmax statistics, ds rows, dq, the dbias slice
    for (int i = warp; i < n; i += kAttnWarps) {
      const T* qi = qs + i * ks;
      const T* di = dd + i * ks;
      const float* brow = bias_h + size_t(i) * n;
      const float* mrow = mask_w ? mask_w + size_t(i) * n : nullptr;
      float mx = -CUDART_INF_F;
      for (int j = lane; j < n; j += 32) {
        const T* kj = kk + j * ks;
        float acc = 0.f;
        for (int e = 0; e < hd; ++e) acc = fmaf(to_float(qi[e]), to_float(kj[e]), acc);
        acc += __ldg(brow + j);
        if (mrow) acc += __ldg(mrow + j);
        ra[j] = acc;
        mx = fmaxf(mx, acc);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float ex = expf(ra[j] - mx);
        ra[j] = ex;
        sum += ex;
      }
      sum = warp_sum(sum);
      float dsum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = ra[j] / sum;
        const T* vj = vv + j * ks;
        float dp = 0.f;
        for (int e = 0; e < hd; ++e) dp = fmaf(to_float(di[e]), to_float(vj[e]), dp);
        ra[j] = p;
        rb[j] = dp;
        dsum += dp * p;
      }
      dsum = warp_sum(dsum);
      float* prow = part + size_t(i) * n;
      for (int j = lane; j < n; j += 32) {
        const float ds = ra[j] * (rb[j] - dsum);
        prow[j] = first_window ? ds : prow[j] + ds;
        rb[j] = to_float(from_float<T>(ds));
      }
      if (lane == 0) {
        row_max[i] = mx;
        row_sum[i] = sum;
        row_dp[i] = dsum;
      }
      __syncwarp();
      T* dq = gq + addr(0, b, i);
      for (int e = lane; e < hd; e += 32) {
        float acc = 0.f;
        for (int j = 0; j < n; ++j) acc = fmaf(rb[j], to_float(kk[j * ks + e]), acc);
        dq[e] = from_float<T>(acc * scale_f);
      }
      __syncwarp();
    }
    __syncthreads();  // row statistics complete

    // pass 2: key columns -> dk, dv
    for (int j = warp; j < n; j += kAttnWarps) {
      const T* kj = kk + j * ks;
      const T* vj = vv + j * ks;
      for (int i = lane; i < n; i += 32) {
        const T* qi = qs + i * ks;
        const T* di = dd + i * ks;
        float acc = 0.f;
        for (int e = 0; e < hd; ++e) acc = fmaf(to_float(qi[e]), to_float(kj[e]), acc);
        acc += __ldg(bias_h + size_t(i) * n + j);
        if (mask_w) acc += __ldg(mask_w + size_t(i) * n + j);
        const float p = expf(acc - row_max[i]) / row_sum[i];
        float dp = 0.f;
        for (int e = 0; e < hd; ++e) dp = fmaf(to_float(di[e]), to_float(vj[e]), dp);
        ra[i] = to_float(from_float<T>(p));
        rb[i] = to_float(from_float<T>(p * (dp - row_dp[i])));
      }
      __syncwarp();
      T* dk = gk + addr(1, b, j);
      T* dv = gv + addr(2, b, j);
      for (int e = lane; e < hd; e += 32) {
        float ak = 0.f, av = 0.f;
        for (int i = 0; i < n; ++i) {
          av = fmaf(ra[i], to_float(dd[i * ks + e]), av);
          ak = fmaf(rb[i], to_float(qs[i * ks + e]), ak);
        }
        dk[e] = from_float<T>(ak);
        dv[e] = from_float<T>(av);
      }
      __syncwarp();
    }
  }
}

// dbias[h, i, j] = sum over slices s of part[s, h, i, j], s in order.
__global__ void sum_slices_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int slices, long long per_slice) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= per_slice) return;
  float acc = 0.f;
  for (int s = 0; s < slices; ++s) acc += part[s * per_slice + k];
  out[k] = acc;
}

// Chunks of the backward grid: enough (head, slot, chunk) blocks to fill the
// card `waves` times over (this body: twice; the tensor-core body of
// attention_bwd_mma.cuh, whose blocks are half as large: 4 times), at most
// one chunk per window of a slot.
inline int attention_bwd_chunks(int steps, int nh, int slots, int waves = 2) {
  const int want = (waves * 132 + nh * slots - 1) / (nh * slots);
  return want < 1 ? 1 : (want > steps ? steps : want);
}

// The fixed-order sum of the slices of part into dbias (per_slice floats).
inline int launch_sum_slices(const float* part, float* dbias, int slices, long long per_slice,
                             cudaStream_t stream) {
  sum_slices_kernel<<<static_cast<unsigned>((per_slice + 255) / 256), 256, 0, stream>>>(
      part, dbias, slices, per_slice);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace emvm
