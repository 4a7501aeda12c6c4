// lane_self_attention forward (with or without attention-probability
// dropout) and backward: BERT multi-head attention read straight from the
// fused qkv GEMM output.
//
// Replaces: empirical_mvm_tpu/ops/window_attention.py `_lane_sa_fwd_kernel`
// and `_lane_sa_bwd_kernel` (reached from `lane_self_attention` through
// `_lane_sa_call`). Same function: x3 (B, L, 3D) with the last axis ordered
// (3, nH, hd), an fp32 additive mask of (B, L, L) values, out (B, L, D):
//   out[b, :, h] = dropout(softmax(q * scale . k^T + mask[b])) . v
// The mask is addressed through a batch stride and a row stride, so a
// (B, 1, L) padding mask broadcast over the query rows (row stride 0) is
// read without being expanded in device memory. Dropout is inverted dropout
// on the fp32 probabilities before they are rounded for P.V, its keep mask
// drawn by Philox from (seed, offset) and the element index (common.cuh), so
// the backward regenerates it. The TPU kernels drew from the core's own
// generator and had to share one block partition between forward and
// backward (`_lane_sa_g`); a counter-based draw has no such constraint.
//
// Bound on the H100: at the fusion shapes (L = 232 to 275, D = 768, hd = 64,
// bf16) one (sequence, head) does 4 * L^2 * hd operations forward (10 *
// L^2 * hd backward) on 8 * L * hd bytes of x3 and out (14 * L * hd backward:
// x3, do, dx3), 120 to 180 operations per byte against the card's ~295, so
// the floor is memory. This version runs far above that floor, because its
// products run on the CUDA cores, not the tensor cores.
// Design (first, simple version), forward: one 256-thread block per (query
// tile of 64 rows, head, sequence). The block stages K and V of its head
// (L x hd, 35 KB each in bf16) in shared memory, and each of its 8 warps
// walks query rows of the tile: dot products, fp32 softmax, dropout, P.V,
// all bounded by L, which is not a power of two.
// Backward, two kernels per call, each over (tile of 64, head, sequence):
//   rows: K and V resident; per query row the scores, softmax, dp = do.v^T
//     under the keep mask, ds = p * (dp - rowsum(dp * p)), dq = (round(ds).k)
//     * scale, and the row's max, sum and rowsum(dp * p) to a scratch buffer;
//   columns: qs = q * scale and do resident; per key column p and ds
//     recomputed bit for bit as the rows kernel computed them (same fma
//     chain, the stored statistics), then dv = round(p_drop)^T.do and
//     dk = round(ds)^T.qs.
// Holding Q, K, V and dO of one head at once would need 4 * L * hd * 4 bytes
// in fp32 (238 KB at L = 232), above the 227 KB a block may have; each
// kernel holds two.
// Those two backward kernels run fp32, and bf16 at an hd the tensor cores do
// not take. bf16 at hd 32, 64 or 128 (BERT-base: 64) runs the tensor-core
// backward of the tiled self-attention (self_attention_mma.cuh, row 11's
// body) on x3's strides: a statistics pass (the forward's pass 1: the rows'
// max and sum, which this forward does not save), then its rows kernel
// (D = rowsum(dp * p), then ds and dq) and columns kernel (dk, dv). Same
// roundings; the keep mask from the same Philox counter (j / 4, i, h, b).
#include "common.cuh"

namespace emvm {

// self_attention_tiled.cu, where the tensor-core body's kernels are
// instantiated
bool tensor_core_body(int dtype, int hd);
int lane_self_attention_bwd_mma(const void* x3, const void* mask, long long mask_sb,
                                long long mask_sr, const void* dout, void* dx3, void* scratch,
                                int b, int l, int dm, int nh, float scale_t, float scale_f,
                                const void* seed, unsigned threshold, float inv_keep,
                                cudaStream_t stream);
size_t lane_self_attention_bwd_mma_smem(int hd);

namespace {

constexpr int kQueryTile = 64;

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    lane_self_attention_fwd_kernel(const T* __restrict__ x3, const float* __restrict__ mask,
                                   long long mask_sb, long long mask_sr,
                                   T* __restrict__ out, int l, int dm, int nh,
                                   float scale_t, const int* __restrict__ seed,
                                   unsigned threshold, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = dm / nh;
  const AttnSmem<T> sm(smem_raw, l, hd);
  const size_t d3 = size_t(3) * dm;
  const T* xb = x3 + size_t(b) * l * d3;

  const int ks = k_row_stride<T>(hd);
  for (int idx = threadIdx.x; idx < l * hd; idx += blockDim.x) {
    const int j = idx / hd, e = idx % hd;
    const T* src = xb + size_t(j) * d3 + h * hd + e;
    sm.k[size_t(j) * ks + e] = src[dm];
    sm.v[size_t(j) * hd + e] = src[2 * dm];
  }
  __syncthreads();

  const float* mask_b = mask + b * mask_sb;
  const Dropout drop(seed, threshold, inv_keep);
  const int row_end = min(l, (tile + 1) * kQueryTile);
  for (int i = tile * kQueryTile + (threadIdx.x >> 5); i < row_end; i += kAttnWarps) {
    attend_row<T>(xb + size_t(i) * d3 + h * hd, scale_t, sm, l, hd, mask_b + i * mask_sr,
                  nullptr, out + (size_t(b) * l + i) * dm + h * hd, drop, b, h, i);
  }
}

template <typename T>
int launch(const void* x3, const void* mask, long long mask_sb, long long mask_sr, void* out,
           int b, int l, int dm, int nh, float scale_t, const void* seed, unsigned threshold,
           float inv_keep, cudaStream_t stream) {
  const size_t smem = attn_smem_bytes<T>(l, dm / nh);
  auto kernel = lane_self_attention_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((l + kQueryTile - 1) / kQueryTile, nh, b);
  kernel<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(x3), static_cast<const float*>(mask), mask_sb, mask_sr,
      static_cast<T*>(out), l, dm, nh, scale_t, static_cast<const int*>(seed), threshold,
      inv_keep);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Shared memory of either backward kernel: two (L x hd) matrices with padded
// rows, the three row statistics, and per warp two fp32 rows of hd and two
// of L.
template <typename T>
__host__ __device__ inline size_t lane_bwd_smem_bytes(int l, int hd) {
  return 2 * align16(size_t(l) * k_row_stride<T>(hd) * sizeof(T)) +
         align16(3 * size_t(l) * sizeof(float)) +
         size_t(kAttnWarps) * (2 * hd + 2 * l) * sizeof(float);
}

struct LaneBwdSmem {
  unsigned char* mat0;
  unsigned char* mat1;
  float* stats;  // 3 rows of L
  float* va;     // this warp's hd floats
  float* vb;
  float* ra;     // this warp's L floats
  float* rb;

  template <typename T>
  __device__ static LaneBwdSmem carve(unsigned char* raw, int l, int hd) {
    LaneBwdSmem s;
    const size_t mat = align16(size_t(l) * k_row_stride<T>(hd) * sizeof(T));
    s.mat0 = raw;
    s.mat1 = raw + mat;
    s.stats = reinterpret_cast<float*>(raw + 2 * mat);
    float* w = reinterpret_cast<float*>(raw + 2 * mat + align16(3 * size_t(l) * sizeof(float))) +
               size_t(threadIdx.x >> 5) * (2 * hd + 2 * l);
    s.va = w;
    s.vb = w + hd;
    s.ra = w + 2 * hd;
    s.rb = w + 2 * hd + l;
    return s;
  }
};

// Rows kernel: dq and the row statistics (max, sum, rowsum(dp * p)) of every
// query row; stats is (B, nH, 3, L) fp32.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    lane_self_attention_bwd_rows_kernel(const T* __restrict__ x3,
                                        const float* __restrict__ mask, long long mask_sb,
                                        long long mask_sr, const T* __restrict__ dout,
                                        T* __restrict__ dx3, float* __restrict__ stats, int l,
                                        int dm, int nh, float scale_t, float scale_f,
                                        const int* __restrict__ seed, unsigned threshold,
                                        float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = dm / nh, ks = k_row_stride<T>(hd);
  const int lane = threadIdx.x & 31;
  const LaneBwdSmem sm = LaneBwdSmem::carve<T>(smem_raw, l, hd);
  T* kk = reinterpret_cast<T*>(sm.mat0);
  T* vv = reinterpret_cast<T*>(sm.mat1);
  const size_t d3 = size_t(3) * dm;
  const T* xb = x3 + size_t(b) * l * d3;
  for (int idx = threadIdx.x; idx < l * hd; idx += blockDim.x) {
    const int j = idx / hd, e = idx % hd;
    const T* src = xb + size_t(j) * d3 + h * hd + e;
    kk[j * ks + e] = src[dm];
    vv[j * ks + e] = src[2 * dm];
  }
  __syncthreads();

  const Dropout drop(seed, threshold, inv_keep);
  const float* mask_b = mask + b * mask_sb;
  float* st = stats + (size_t(b) * nh + h) * 3 * l;
  const int row_end = min(l, (tile + 1) * kQueryTile);
  for (int i = tile * kQueryTile + (threadIdx.x >> 5); i < row_end; i += kAttnWarps) {
    const T* qrow = xb + size_t(i) * d3 + h * hd;
    const T* drow = dout + (size_t(b) * l + i) * dm + h * hd;
    for (int e = lane; e < hd; e += 32) {
      sm.va[e] = to_float(from_float<T>(to_float(qrow[e]) * scale_t));
      sm.vb[e] = to_float(drow[e]);
    }
    __syncwarp();
    const float* mrow = mask_b + i * mask_sr;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < l; j += 32) {
      const T* kj = kk + j * ks;
      float acc = 0.f;
      for (int e = 0; e < hd; ++e) acc = fmaf(sm.va[e], to_float(kj[e]), acc);
      acc += mrow[j];
      sm.ra[j] = acc;
      mx = fmaxf(mx, acc);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < l; j += 32) {
      const float ex = expf(sm.ra[j] - mx);
      sm.ra[j] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    float dsum = 0.f;
    for (int j = lane; j < l; j += 32) {
      const float p = sm.ra[j] / sum;
      const T* vj = vv + j * ks;
      float dp = 0.f;
      for (int e = 0; e < hd; ++e) dp = fmaf(sm.vb[e], to_float(vj[e]), dp);
      if (drop.on) dp = drop.keep(b, h, i, j) ? dp * drop.inv_keep : 0.f;
      sm.ra[j] = p;
      sm.rb[j] = dp;
      dsum += dp * p;
    }
    dsum = warp_sum(dsum);
    for (int j = lane; j < l; j += 32)
      sm.rb[j] = to_float(from_float<T>(sm.ra[j] * (sm.rb[j] - dsum)));
    if (lane == 0) {
      st[i] = mx;
      st[l + i] = sum;
      st[2 * l + i] = dsum;
    }
    __syncwarp();
    T* dq = dx3 + (size_t(b) * l + i) * d3 + h * hd;
    for (int e = lane; e < hd; e += 32) {
      float acc = 0.f;
      for (int j = 0; j < l; ++j) acc = fmaf(sm.rb[j], to_float(kk[j * ks + e]), acc);
      dq[e] = from_float<T>(acc * scale_f);
    }
    __syncwarp();
  }
}

// Columns kernel: dk and dv of every key column, from the rows kernel's
// statistics.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    lane_self_attention_bwd_cols_kernel(const T* __restrict__ x3,
                                        const float* __restrict__ mask, long long mask_sb,
                                        long long mask_sr, const T* __restrict__ dout,
                                        T* __restrict__ dx3, const float* __restrict__ stats,
                                        int l, int dm, int nh, float scale_t,
                                        const int* __restrict__ seed, unsigned threshold,
                                        float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = dm / nh, ks = k_row_stride<T>(hd);
  const int lane = threadIdx.x & 31;
  const LaneBwdSmem sm = LaneBwdSmem::carve<T>(smem_raw, l, hd);
  T* qs = reinterpret_cast<T*>(sm.mat0);
  T* dd = reinterpret_cast<T*>(sm.mat1);
  const size_t d3 = size_t(3) * dm;
  const T* xb = x3 + size_t(b) * l * d3;
  const float* st = stats + (size_t(b) * nh + h) * 3 * l;
  for (int idx = threadIdx.x; idx < l * hd; idx += blockDim.x) {
    const int i = idx / hd, e = idx % hd;
    qs[i * ks + e] = from_float<T>(to_float(xb[size_t(i) * d3 + h * hd + e]) * scale_t);
    dd[i * ks + e] = dout[(size_t(b) * l + i) * dm + h * hd + e];
  }
  for (int k = threadIdx.x; k < 3 * l; k += blockDim.x) sm.stats[k] = st[k];
  __syncthreads();
  const float* row_max = sm.stats;
  const float* row_sum = sm.stats + l;
  const float* row_dp = sm.stats + 2 * l;

  const Dropout drop(seed, threshold, inv_keep);
  const float* mask_b = mask + b * mask_sb;
  const int col_end = min(l, (tile + 1) * kQueryTile);
  for (int j = tile * kQueryTile + (threadIdx.x >> 5); j < col_end; j += kAttnWarps) {
    const T* kj = xb + size_t(j) * d3 + dm + h * hd;
    for (int e = lane; e < hd; e += 32) {
      sm.va[e] = to_float(kj[e]);
      sm.vb[e] = to_float(kj[dm + e]);
    }
    __syncwarp();
    for (int i = lane; i < l; i += 32) {
      const T* qi = qs + i * ks;
      const T* di = dd + i * ks;
      float acc = 0.f;
      for (int e = 0; e < hd; ++e) acc = fmaf(to_float(qi[e]), sm.va[e], acc);
      acc += mask_b[i * mask_sr + j];
      const float p = expf(acc - row_max[i]) / row_sum[i];
      float dp = 0.f;
      for (int e = 0; e < hd; ++e) dp = fmaf(to_float(di[e]), sm.vb[e], dp);
      float pd = p;
      if (drop.on) {
        const bool keep = drop.keep(b, h, i, j);
        pd = keep ? p * drop.inv_keep : 0.f;
        dp = keep ? dp * drop.inv_keep : 0.f;
      }
      sm.ra[i] = to_float(from_float<T>(pd));
      sm.rb[i] = to_float(from_float<T>(p * (dp - row_dp[i])));
    }
    __syncwarp();
    T* dk = dx3 + (size_t(b) * l + j) * d3 + dm + h * hd;
    T* dv = dk + dm;
    for (int e = lane; e < hd; e += 32) {
      float ak = 0.f, av = 0.f;
      for (int i = 0; i < l; ++i) {
        av = fmaf(sm.ra[i], to_float(dd[i * ks + e]), av);
        ak = fmaf(sm.rb[i], to_float(qs[i * ks + e]), ak);
      }
      dk[e] = from_float<T>(ak);
      dv[e] = from_float<T>(av);
    }
    __syncwarp();
  }
}

template <typename T>
int launch_bwd(const void* x3, const void* mask, long long mask_sb, long long mask_sr,
               const void* dout, void* dx3, void* stats, int b, int l, int dm, int nh,
               float scale_t, float scale_f, const void* seed, unsigned threshold,
               float inv_keep, cudaStream_t stream) {
  const size_t smem = lane_bwd_smem_bytes<T>(l, dm / nh);
  auto rows = lane_self_attention_bwd_rows_kernel<T>;
  auto cols = lane_self_attention_bwd_cols_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((l + kQueryTile - 1) / kQueryTile, nh, b);
  rows<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(x3), static_cast<const float*>(mask), mask_sb, mask_sr,
      static_cast<const T*>(dout), static_cast<T*>(dx3), static_cast<float*>(stats), l, dm, nh,
      scale_t, scale_f, static_cast<const int*>(seed), threshold, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cols<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(x3), static_cast<const float*>(mask), mask_sb, mask_sr,
      static_cast<const T*>(dout), static_cast<T*>(dx3), static_cast<const float*>(stats), l,
      dm, nh, scale_t, static_cast<const int*>(seed), threshold, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace emvm

// mask_sb / mask_sr: element strides of the mask's batch and query-row axes
// (its key axis must be contiguous). scale_t is the softmax scale already
// rounded to the storage dtype. seed: two int32 (seed, offset) in device
// memory, or null for no dropout; threshold = floor(p * 2^32), inv_keep =
// 1 / (1 - p).
extern "C" int emvm_lane_self_attention_fwd(int dtype, const void* x3, const void* mask,
                                            long long mask_sb, long long mask_sr, void* out,
                                            int b, int l, int dm, int nh, float scale_t,
                                            const void* seed, unsigned threshold,
                                            float inv_keep, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case emvm::kFloat32:
      return emvm::launch<float>(x3, mask, mask_sb, mask_sr, out, b, l, dm, nh, scale_t, seed,
                                 threshold, inv_keep, s);
    case emvm::kBFloat16:
      return emvm::launch<__nv_bfloat16>(x3, mask, mask_sb, mask_sr, out, b, l, dm, nh,
                                         scale_t, seed, threshold, inv_keep, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward: dx3 (x3's shape and dtype) from do (B, L, D). stats is fp32
// scratch of 3 * B * nH * L floats (the CUDA-core body's (B, nH, 3, L) row
// statistics; the tensor-core body's (B, nH, 2, L) max and sum, then the
// (B, nH, L) rowsums D); scale_f is the fp32 scale for dq.
extern "C" int emvm_lane_self_attention_bwd(int dtype, const void* x3, const void* mask,
                                            long long mask_sb, long long mask_sr,
                                            const void* dout, void* dx3, void* stats, int b,
                                            int l, int dm, int nh, float scale_t, float scale_f,
                                            const void* seed, unsigned threshold,
                                            float inv_keep, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (nh > 0 && dm % nh == 0 && emvm::tensor_core_body(dtype, dm / nh))
    return emvm::lane_self_attention_bwd_mma(x3, mask, mask_sb, mask_sr, dout, dx3, stats, b,
                                             l, dm, nh, scale_t, scale_f, seed, threshold,
                                             inv_keep, s);
  switch (dtype) {
    case emvm::kFloat32:
      return emvm::launch_bwd<float>(x3, mask, mask_sb, mask_sr, dout, dx3, stats, b, l, dm,
                                     nh, scale_t, scale_f, seed, threshold, inv_keep, s);
    case emvm::kBFloat16:
      return emvm::launch_bwd<__nv_bfloat16>(x3, mask, mask_sb, mask_sr, dout, dx3, stats, b,
                                             l, dm, nh, scale_t, scale_f, seed, threshold,
                                             inv_keep, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" size_t emvm_lane_self_attention_bwd_smem_bytes(int dtype, int l, int hd) {
  if (emvm::tensor_core_body(dtype, hd)) return emvm::lane_self_attention_bwd_mma_smem(hd);
  return dtype == emvm::kFloat32 ? emvm::lane_bwd_smem_bytes<float>(l, hd)
                                 : emvm::lane_bwd_smem_bytes<__nv_bfloat16>(l, hd);
}
