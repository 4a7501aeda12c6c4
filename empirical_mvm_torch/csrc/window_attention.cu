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
// of x3 and out over 3.35 TB/s.
// Design: one block per (head, window, batch). The block computes each
// token's 5D address itself (no window partition or reverse through device
// memory). bf16 at hd = 32 (every Swin's head) and N <= 256 runs the
// tensor-core body (attention_fwd_mma.cuh, 128 threads: K and V staged by
// cp.async, S and P.V by mma.sync, the bias and mask rows read once and
// coalesced); fp32, and bf16 at other hd or N, the CUDA-core one: K and V of
// the head (N x hd) staged in shared memory and 8 warps walking the query
// rows with `attend_row` (common.cuh), the dot products, the fp32 softmax and
// P.V on the CUDA cores. N is not a power of two; every loop bounds itself
// by N.
#include "attention_bwd.cuh"
#include "attention_bwd_mma.cuh"
#include "attention_fwd_mma.cuh"
#include "common.cuh"

namespace emvm {
namespace {

// KI: the key iterations of the tensor-core body (win_fwd_mma::key_iters),
// or 0 for the CUDA-core body
template <typename T, int KI>
__global__ void __launch_bounds__(KI ? win_fwd_mma::kThreads : kAttnThreads,
                                  KI ? win_fwd_mma::kMinBlocks : 1)
    direct_window_attention_fwd_kernel(const T* __restrict__ x3,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ mask,
                                       T* __restrict__ out, int d, int hp, int wp, int c,
                                       int nh, int wh, int ww, float scale_t) {
  const int h = blockIdx.x, w = blockIdx.y, b = blockIdx.z;
  const int hd = c / nh;
  const int hw = wh * ww;
  const int n = d * hw;
  const int strip = w / (wp / ww), col = w % (wp / ww);

  // row index of window token t in the (B, D, Hp, Wp) feature map
  auto token_row = [&](int t) -> size_t {
    const int tt = t / hw, r = t % hw;
    return ((size_t(b) * d + tt) * hp + strip * wh + r / ww) * size_t(wp) + col * ww + r % ww;
  };
  const size_t c3 = size_t(3) * c;
  const float* bias_h = bias + size_t(h) * n * n;
  const float* mask_w = mask ? mask + size_t(w) * n * n : nullptr;
  if constexpr (KI > 0) {
    // offset of head h of token t: in x3 from the q, k or v column base, or in out
    auto addr = [=](int seg, int t) -> size_t {
      return token_row(t) * (seg == 3 ? size_t(c) : c3) + h * hd;
    };
    win_fwd_mma::attention_fwd_block<KI>(x3, x3 + c, x3 + 2 * c, bias_h, mask_w, out, n, addr,
                                         scale_t);
  } else {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const AttnSmem<T> sm(smem_raw, n, hd);
    const int ks = k_row_stride<T>(hd);
    for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
      const int t = idx / hd, e = idx % hd;
      const T* src = x3 + token_row(t) * c3 + h * hd + e;
      sm.k[size_t(t) * ks + e] = src[c];
      sm.v[size_t(t) * hd + e] = src[2 * c];
    }
    __syncthreads();

    const Dropout no_drop(nullptr, 0u, 1.f);
    for (int t = threadIdx.x >> 5; t < n; t += kAttnWarps) {
      const size_t r = token_row(t);
      attend_row<T>(x3 + r * c3 + h * hd, scale_t, sm, n, hd, bias_h + size_t(t) * n,
                    mask_w ? mask_w + size_t(t) * n : nullptr, out + r * c + h * hd, no_drop,
                    b, h, t);
    }
  }
}

template <typename T, int KI = 0>
int launch(const void* x3, const void* bias, const void* mask, void* out, int b, int d,
           int hp, int wp, int c, int nh, int wh, int ww, float scale_t,
           cudaStream_t stream) {
  const int n = d * wh * ww;
  if (KI && !(sa_mma::aligned16(x3) && sa_mma::aligned16(out) && c % 8 == 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = KI ? win_fwd_mma::smem_bytes(n) : attn_smem_bytes<T>(n, c / nh);
  auto kernel = direct_window_attention_fwd_kernel<T, KI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nh, (hp / wh) * (wp / ww), b);
  kernel<<<grid, KI ? win_fwd_mma::kThreads : kAttnThreads, smem, stream>>>(
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
// ~295, so the floor is the bytes over 3.35 TB/s; both bodies are far above
// it (the tensor-core one by its bias, mask and dbias traffic, PERF.md).
//
// Design: one block per (head, window, batch chunk), running the shared
// body over the batches of its chunk, each token's 5D address computed in
// place; dbias from per-block fp32 slices summed in a fixed order. bf16 at
// hd = 32 (every Swin's head) runs the tensor-core body
// (attention_bwd_mma.cuh, 128 threads); fp32 and other hd the CUDA-core one
// (attention_bwd.cuh, 256 threads), both shared with the lane window and
// packed backwards.
// ---------------------------------------------------------------------------

template <typename T, bool kMma>
__global__ void __launch_bounds__(kMma ? win_mma::kThreads : kAttnThreads,
                                  kMma ? win_mma::kMinBlocks : 1)
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
  const float* bias_h = bias + size_t(h) * n * n;
  const float* mask_w = mask ? mask + size_t(w) * n * n : nullptr;
  float* part = dbias_part + ((size_t(chunk) * nw + w) * nh + h) * n * n;
  if constexpr (kMma)
    win_mma::attention_bwd_block(x3, x3 + c, x3 + 2 * c, bias_h, mask_w, dout, dx3, dx3 + c,
                                 dx3 + 2 * c, part, n, chunk, bsz, nchunk, addr, scale_t,
                                 scale_f);
  else
    attention_bwd_block<T>(x3, x3 + c, x3 + 2 * c, bias_h, mask_w, dout, dx3, dx3 + c,
                           dx3 + 2 * c, part, n, hd, chunk, bsz, nchunk, addr, scale_t,
                           scale_f);
}

template <typename T, bool kMma = false>
int launch_bwd(const void* x3, const void* bias, const void* mask, const void* dout, void* dx3,
               void* dbias, void* part, int b, int d, int hp, int wp, int c, int nh, int wh,
               int ww, float scale_t, float scale_f, cudaStream_t stream) {
  const int n = d * wh * ww;
  const int nw = (hp / wh) * (wp / ww);
  if (kMma && !(sa_mma::aligned16(x3) && sa_mma::aligned16(dout) && sa_mma::aligned16(dx3)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = kMma ? win_mma::smem_bytes(n) : attention_bwd_smem_bytes<T>(n, c / nh);
  auto kernel = direct_window_attention_bwd_kernel<T, kMma>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = attention_bwd_chunks(b, nh, nw, kMma ? win_mma::kWaves : 2);
  kernel<<<dim3(nh, nw, chunks), kMma ? win_mma::kThreads : kAttnThreads, smem, stream>>>(
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
// rounded to the storage dtype. bf16 at hd 32 and N <= 256 runs the
// tensor-core body (win_fwd_mma::takes), the rest attend_row.
extern "C" int emvm_direct_window_attention_fwd(int dtype, const void* x3, const void* bias,
                                                const void* mask, void* out, int b, int d,
                                                int hp, int wp, int c, int nh, int wh,
                                                int ww, float scale_t, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int n = d * wh * ww;
  if (nh > 0 && c % nh == 0 && emvm::win_fwd_mma::takes(dtype, c / nh, n)) {
    const int ki = emvm::win_fwd_mma::key_iters(n);
    auto fwd = ki == 4    ? emvm::launch<__nv_bfloat16, 4>
               : ki == 13 ? emvm::launch<__nv_bfloat16, 13>
                          : emvm::launch<__nv_bfloat16, 16>;
    return fwd(x3, bias, mask, out, b, d, hp, wp, c, nh, wh, ww, scale_t, s);
  }
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

// Shared memory of a block of the CUDA-core forwards (attend_row: the direct,
// lane window, packed, lane_attention and lane self-attention kernels).
extern "C" size_t emvm_attention_smem_bytes(int dtype, int n, int hd) {
  return dtype == emvm::kFloat32 ? emvm::attn_smem_bytes<float>(n, hd)
                                 : emvm::attn_smem_bytes<__nv_bfloat16>(n, hd);
}

// Shared memory of a block of the direct, packed or lane window forward or
// of lane_attention, in the body that dtype, hd and n pick.
extern "C" size_t emvm_window_attention_fwd_smem_bytes(int dtype, int n, int hd) {
  if (emvm::win_fwd_mma::takes(dtype, hd, n)) return emvm::win_fwd_mma::smem_bytes(n);
  return emvm_attention_smem_bytes(dtype, n, hd);
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
  if (nh > 0 && c % nh == 0 && emvm::win_mma::takes(dtype, c / nh))
    return emvm::launch_bwd<__nv_bfloat16, true>(x3, bias, mask, dout, dx3, dbias, part, b, d,
                                                 hp, wp, c, nh, wh, ww, scale_t, scale_f, s);
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

// Floats of scratch enough for either body (the tensor-core body's chunks
// are at least the CUDA-core body's).
extern "C" long long emvm_direct_window_attention_bwd_scratch(int b, int d, int hp, int wp,
                                                              int nh, int wh, int ww) {
  const int nw = (hp / wh) * (wp / ww);
  const long long n = static_cast<long long>(d) * wh * ww;
  return static_cast<long long>(emvm::attention_bwd_chunks(b, nh, nw, emvm::win_mma::kWaves)) *
         nw * nh * n * n;
}

// Dynamic shared memory of the backward's block, in the body dtype and hd
// pick.
extern "C" size_t emvm_direct_window_attention_bwd_smem_bytes(int dtype, int n, int hd) {
  if (emvm::win_mma::takes(dtype, hd)) return emvm::win_mma::smem_bytes(n);
  return dtype == emvm::kFloat32 ? emvm::attention_bwd_smem_bytes<float>(n, hd)
                                 : emvm::attention_bwd_smem_bytes<__nv_bfloat16>(n, hd);
}
