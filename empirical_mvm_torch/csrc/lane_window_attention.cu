// lane_window_attention forward: window attention read from the
// partitioned qkv GEMM output.
//
// Replaces: empirical_mvm_tpu/ops/window_attention.py `_lane_fwd_kernel`
// over the grid `_lane_fwd` gives it (`_lane_specs`; the mask add is
// `_lane_mask_add`). Same function: x3 (B_, n, 3C), last axis ordered
// (3, nH, hd); bias (nH, n, n) fp32; mask (nW, n, n) fp32 or absent
// (unshifted blocks). For every window b_ and head h:
//   out[b_, :, h] = softmax(q * scale . k^T + bias[h] + mask[b_ % nW]) . v
// with out (B_, n, C) in x3's dtype. The TPU kernel's t-sliced form (f
// frames folded into one window, each attending only within itself; its
// `_lane_tsliced_specs`) is this function on the per-frame windows:
// `WindowAttention3D` partitions a per-frame swin frame by frame and calls
// this kernel on (B * D * nW_hw, 49, 3C) with the (D * nW_hw, n, n) mask.
//
// Bound on the H100: memory. At the frozen 2D teacher's shapes (n = 49,
// hd = 32, bf16) one (window, head) does 4 * n^2 * hd = 0.31 MFLOP on
// 8 * n * hd = 12.5 KB of x3 and out (bias and mask are shared by every
// window), about 25 operations per byte against the card's ~295. This
// version runs its products on the CUDA cores and stays above that floor.
// Design (first, simple version): the TPU kernel walks window-group
// programs with every head unrolled inside; here one 256-thread block per
// (head, window), heads fastest so that the blocks of one window run close
// together and share its x3 rows in L2. The block stages its window's K and
// V (n x hd, K rows padded one word) in shared memory and its 8 warps walk
// the query rows with `attend_row` (common.cuh), the routine of the direct
// kernel: q * scale rounded to the storage type, fp32 scores, bias, mask
// and softmax, probabilities rounded before P.V. Every loop bounds itself
// by n (49 is not a power of two).
#include "common.cuh"

namespace emvm {
namespace {

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    lane_window_attention_fwd_kernel(const T* __restrict__ x3,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ mask,
                                     T* __restrict__ out, int n, int c, int nh, int nw,
                                     float scale_t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = static_cast<int>(blockIdx.x % nh);
  const size_t win = blockIdx.x / nh;             // b_
  const int hd = c / nh;
  const size_t c3 = size_t(3) * c;
  const AttnSmem<T> sm(smem_raw, n, hd);
  const T* xs = x3 + win * n * c3 + h * hd;       // row 0 of the window, head h

  const int ks = k_row_stride<T>(hd);
  for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
    const int t = idx / hd, e = idx % hd;
    const T* src = xs + size_t(t) * c3 + e;
    sm.k[size_t(t) * ks + e] = src[c];
    sm.v[size_t(t) * hd + e] = src[2 * c];
  }
  __syncthreads();

  const float* bias_h = bias + size_t(h) * n * n;
  const float* mask_w = mask ? mask + (win % nw) * n * n : nullptr;
  T* os = out + win * n * c + h * hd;
  const Dropout no_drop(nullptr, 0u, 1.f);
  for (int i = threadIdx.x >> 5; i < n; i += kAttnWarps) {
    attend_row<T>(xs + size_t(i) * c3, scale_t, sm, n, hd, bias_h + size_t(i) * n,
                  mask_w ? mask_w + size_t(i) * n : nullptr, os + size_t(i) * c, no_drop, 0,
                  h, i);
  }
}

template <typename T>
int launch(const void* x3, const void* bias, const void* mask, void* out, long long windows,
           int n, int c, int nh, int nw, float scale_t, cudaStream_t stream) {
  const long long blocks = windows * nh;
  if (windows < 1 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = attn_smem_bytes<T>(n, c / nh);
  auto kernel = lane_window_attention_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kAttnThreads, smem, stream>>>(
      static_cast<const T*>(x3), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<T*>(out), n, c, nh, nw, scale_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace emvm

// windows = B_ windows of n tokens; nw = the mask's window count (ignored when mask is null). scale_t is the
// softmax scale already rounded to the storage dtype.
extern "C" int emvm_lane_window_attention_fwd(int dtype, const void* x3, const void* bias,
                                              const void* mask, void* out, long long windows,
                                              int n, int c, int nh, int nw,
                                              float scale_t, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case emvm::kFloat32:
      return emvm::launch<float>(x3, bias, mask, out, windows, n, c, nh, nw, scale_t, s);
    case emvm::kBFloat16:
      return emvm::launch<__nv_bfloat16>(x3, bias, mask, out, windows, n, c, nh, nw,
                                         scale_t, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
