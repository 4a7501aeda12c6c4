// direct_window_attention forward (here) and backward (below): 3D
// shifted-window attention read straight from the qkv GEMM output in the
// feature-map layout, written back to it.
//
// Replaces: empirical_mvm_tpu/ops/window_attention.py `_direct_fwd_kernel`
// (reached from `direct_window_attention` through `_direct_fwd`). Same
// function: for every window of one temporal extent (D == wd) and every head,
//   out = softmax(q * scale . k^T + bias[h] + mask[w]) . v
// with x3 (B, D, Hp, Wp, 3C), last axis ordered (3, nH, hd), bias (nH, N, N)
// fp32, mask (nW, N, N) fp32 or absent, out (B, D, Hp, Wp, C). Windows are
// numbered row-major as (h-strip, w) and the tokens of a window row-major as
// (t, i, j), the order `_shift_attn_mask` builds its masks in.
//
// Bound on the H100: memory, by a small margin. At the swin shapes (N = 245,
// hd = 32, bf16) one window-head does 4 * N^2 * hd = 7.7 MFLOP on 8 * N * hd
// = 63 KB of x3 and out (bias and mask are shared by every batch row), about
// 120 operations per byte against the card's ~295, so the floor is the bytes
// of x3 and out over 3.35 TB/s. This version runs far above that floor,
// because its products run on the CUDA cores, not the tensor cores.
// Design (first, simple version): one 256-thread block per (head, window,
// batch). The block computes each token's 5D address itself (no window
// partition or reverse through device memory), stages K and V of its head
// (N x hd, 16 KB each in bf16) in shared memory, and each of its 8 warps
// walks query rows, doing the dot products, the fp32 softmax and P.V on the
// CUDA cores. N is not a power of two; every loop bounds itself by N.
// Tensor cores (mma/wgmma over 64-row tiles) are later work.
#include "attention_bwd.cuh"
#include "common.cuh"

namespace emvm {
namespace {

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    direct_window_attention_fwd_kernel(const T* __restrict__ x3,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ mask,
                                       T* __restrict__ out, int d, int hp, int wp, int c,
                                       int nh, int wh, int ww, float scale_t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, w = blockIdx.y, b = blockIdx.z;
  const int hd = c / nh;
  const int hw = wh * ww;
  const int n = d * hw;
  const int strip = w / (wp / ww), col = w % (wp / ww);
  const AttnSmem<T> sm(smem_raw, n, hd);

  // row index of window token t in the (B, D, Hp, Wp) feature map
  auto token_row = [&](int t) -> size_t {
    const int tt = t / hw, r = t % hw;
    return ((size_t(b) * d + tt) * hp + strip * wh + r / ww) * size_t(wp) + col * ww + r % ww;
  };

  const size_t c3 = size_t(3) * c;
  const int ks = k_row_stride<T>(hd);
  for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
    const int t = idx / hd, e = idx % hd;
    const T* src = x3 + token_row(t) * c3 + h * hd + e;
    sm.k[size_t(t) * ks + e] = src[c];
    sm.v[size_t(t) * hd + e] = src[2 * c];
  }
  __syncthreads();

  const float* bias_h = bias + size_t(h) * n * n;
  const float* mask_w = mask ? mask + size_t(w) * n * n : nullptr;
  const Dropout no_drop(nullptr, 0u, 1.f);
  for (int t = threadIdx.x >> 5; t < n; t += kAttnWarps) {
    const size_t r = token_row(t);
    attend_row<T>(x3 + r * c3 + h * hd, scale_t, sm, n, hd, bias_h + size_t(t) * n,
                  mask_w ? mask_w + size_t(t) * n : nullptr, out + r * c + h * hd, no_drop,
                  b, h, t);
  }
}

template <typename T>
int launch(const void* x3, const void* bias, const void* mask, void* out, int b, int d,
           int hp, int wp, int c, int nh, int wh, int ww, float scale_t,
           cudaStream_t stream) {
  const int n = d * wh * ww;
  const size_t smem = attn_smem_bytes<T>(n, c / nh);
  auto kernel = direct_window_attention_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nh, (hp / wh) * (wp / ww), b);
  kernel<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(x3), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<T*>(out), d, hp, wp, c, nh, wh, ww,
      scale_t);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward.
//
// Replaces: empirical_mvm_tpu/ops/window_attention.py `_direct_bwd_kernel`
// (reached from `direct_window_attention`'s VJP `_direct_bwd`). Same algebra
// and roundings: qs = q * scale in T; p = softmax(qs.k^T + bias + mask) in
// fp32; dv = round_T(p)^T.do; dp = do.v^T; ds = p * (dp - rowsum(dp * p));
// dbias[h] = sum over batch and windows of ds (fp32); dq = (round_T(ds).k) *
// scale (the fp32 scale); dk = round_T(ds)^T.qs. dx3 has x3's layout.
//
// Bound on the H100: at the swin shapes (N = 196, hd = 32) one window-head
// does about 10 * N^2 * hd operations (2.5x the forward) on 14 * N * hd
// bytes of x3, do and dx3 in bf16, about 140 per byte against the card's
// ~295, so the floor is the bytes over 3.35 TB/s; this version, on CUDA
// cores, is far above it.
//
// Design: one 256-thread block per (head, window, batch chunk), running
// `attention_bwd_block` (attention_bwd.cuh, shared with the lane window
// backward) over the batches of its chunk, each token's 5D address computed
// in place; dbias from per-block fp32 slices summed in a fixed order.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    direct_window_attention_bwd_kernel(const T* __restrict__ x3,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ mask,
                                       const T* __restrict__ dout, T* __restrict__ dx3,
                                       float* __restrict__ dbias_part, int bsz, int d, int hp,
                                       int wp, int c, int nh, int wh, int ww, float scale_t,
                                       float scale_f) {
  const int h = blockIdx.x, w = blockIdx.y, chunk = blockIdx.z, nchunk = gridDim.z;
  const int nw = gridDim.y;
  const int hw = wh * ww;
  const int n = d * hw;
  const int strip = w / (wp / ww), col = w % (wp / ww);
  const int hd = c / nh;
  // offset of head h of window token t of batch b in the (B, D, Hp, Wp)
  // feature map: in x3 and dx3 from the q, k or v column base, or in dout
  auto addr = [=](int seg, int b, int t) -> size_t {
    const int tt = t / hw, r = t % hw;
    const size_t row =
        ((size_t(b) * d + tt) * hp + strip * wh + r / ww) * size_t(wp) + col * ww + r % ww;
    return row * (seg == 3 ? c : 3 * c) + h * hd;
  };
  attention_bwd_block<T>(x3, x3 + c, x3 + 2 * c, bias + size_t(h) * n * n,
                         mask ? mask + size_t(w) * n * n : nullptr, dout, dx3, dx3 + c,
                         dx3 + 2 * c, dbias_part + ((size_t(chunk) * nw + w) * nh + h) * n * n,
                         n, hd, chunk, bsz, nchunk, addr, scale_t, scale_f);
}

template <typename T>
int launch_bwd(const void* x3, const void* bias, const void* mask, const void* dout, void* dx3,
               void* dbias, void* part, int b, int d, int hp, int wp, int c, int nh, int wh,
               int ww, float scale_t, float scale_f, cudaStream_t stream) {
  const int n = d * wh * ww;
  const int nw = (hp / wh) * (wp / ww);
  const size_t smem = attention_bwd_smem_bytes<T>(n, c / nh);
  auto kernel = direct_window_attention_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = attention_bwd_chunks(b, nh, nw);
  kernel<<<dim3(nh, nw, chunks), kAttnThreads, smem, stream>>>(
      static_cast<const T*>(x3), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const T*>(dout), static_cast<T*>(dx3),
      static_cast<float*>(part), b, d, hp, wp, c, nh, wh, ww, scale_t, scale_f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_slices(static_cast<const float*>(part), static_cast<float*>(dbias),
                           chunks * nw, static_cast<long long>(nh) * n * n, stream);
}

}  // namespace
}  // namespace emvm

// mask may be null (unshifted blocks). scale_t is the softmax scale already
// rounded to the storage dtype.
extern "C" int emvm_direct_window_attention_fwd(int dtype, const void* x3, const void* bias,
                                                const void* mask, void* out, int b, int d,
                                                int hp, int wp, int c, int nh, int wh,
                                                int ww, float scale_t, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case emvm::kFloat32:
      return emvm::launch<float>(x3, bias, mask, out, b, d, hp, wp, c, nh, wh, ww, scale_t, s);
    case emvm::kBFloat16:
      return emvm::launch<__nv_bfloat16>(x3, bias, mask, out, b, d, hp, wp, c, nh, wh, ww,
                                         scale_t, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" size_t emvm_attention_smem_bytes(int dtype, int n, int hd) {
  return dtype == emvm::kFloat32 ? emvm::attn_smem_bytes<float>(n, hd)
                                 : emvm::attn_smem_bytes<__nv_bfloat16>(n, hd);
}

// Backward: dx3 (x3's shape and dtype) and dbias (nH, N, N) fp32. part is
// fp32 scratch of emvm_direct_window_attention_bwd_scratch(...) floats.
// scale_t is the softmax scale rounded to the storage dtype (for q * scale),
// scale_f the fp32 scale (for dq).
extern "C" int emvm_direct_window_attention_bwd(int dtype, const void* x3, const void* bias,
                                                const void* mask, const void* dout, void* dx3,
                                                void* dbias, void* part, int b, int d, int hp,
                                                int wp, int c, int nh, int wh, int ww,
                                                float scale_t, float scale_f, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case emvm::kFloat32:
      return emvm::launch_bwd<float>(x3, bias, mask, dout, dx3, dbias, part, b, d, hp, wp, c,
                                     nh, wh, ww, scale_t, scale_f, s);
    case emvm::kBFloat16:
      return emvm::launch_bwd<__nv_bfloat16>(x3, bias, mask, dout, dx3, dbias, part, b, d, hp,
                                             wp, c, nh, wh, ww, scale_t, scale_f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" long long emvm_direct_window_attention_bwd_scratch(int b, int d, int hp, int wp,
                                                              int nh, int wh, int ww) {
  const int nw = (hp / wh) * (wp / ww);
  const long long n = static_cast<long long>(d) * wh * ww;
  return static_cast<long long>(emvm::attention_bwd_chunks(b, nh, nw)) * nw * nh * n * n;
}

extern "C" size_t emvm_direct_window_attention_bwd_smem_bytes(int dtype, int n, int hd) {
  return dtype == emvm::kFloat32 ? emvm::attention_bwd_smem_bytes<float>(n, hd)
                                 : emvm::attention_bwd_smem_bytes<__nv_bfloat16>(n, hd);
}
