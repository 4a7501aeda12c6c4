// lane_window_attention forward (here) and backward (below): window
// attention read from the partitioned qkv GEMM output.
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
// window), about 25 operations per byte against the card's ~295.
// Design: the TPU kernel walks window-group programs with every head
// unrolled inside; here one block per (head, window), heads fastest so that
// the blocks of one window run close together and share its x3 rows in L2.
// bf16 at hd = 32 (every Swin's head) and n <= 256 runs the tensor-core body
// of the direct and packed forwards (attention_fwd_mma.cuh, 128 threads: K
// and V staged by cp.async, S and P.V by mma.sync, the bias and mask rows
// read once and coalesced) on the lane layout: token t of window b_ is row
// b_ * n + t of x3 and out. fp32, and bf16 at other hd or n, the CUDA-core
// body: K (rows padded one word) and V of the head in shared memory, 8 warps
// walking the query rows with `attend_row` (common.cuh). Both: q * scale
// rounded to the storage type, fp32 scores, bias, mask and softmax,
// probabilities rounded before P.V. Every loop bounds itself by n (49 is not
// a power of two).
//
// The same kernel, instantiated with kScoreScale, is `lane_attention`:
// it replaces tools/lanebench.py `_lane_kernel` (its `pallas_call` in
// `lane_attention`), the benchmark tool's window attention off the qkv
// GEMM output. Same x3, bias and out; its mask is always given, (nW, n, n)
// with window b_ taking mask[b_ % nW] (nW = 1: one mask for every window).
// It differs from the kernel above in one rounding: q is not scaled; the
// fp32 score q.k is multiplied by the fp32 scale, then bias and mask are
// added (both bodies' kScoreScale). The TPU kernel's g windows a grid step
// are TPU blocking and have no counterpart. At the tool's Swin-base stage
// shapes (n = 196, hd = 32, bf16) one (window, head) does 4 * n^2 * hd =
// 4.9 MFLOP on 8 * n * hd = 50 KB of x3 and out, about 98 operations per
// byte: memory bound on the card's ~295, as above.
#include "attention_bwd.cuh"
#include "attention_bwd_mma.cuh"
#include "attention_fwd_mma.cuh"
#include "common.cuh"

namespace emvm {
namespace {

// KI: the key iterations of the tensor-core body (win_fwd_mma::key_iters),
// or 0 for the CUDA-core body
template <typename T, bool kScoreScale, int KI>
__global__ void __launch_bounds__(KI ? win_fwd_mma::kThreads : kAttnThreads,
                                  KI ? win_fwd_mma::kMinBlocks : 1)
    lane_window_attention_fwd_kernel(const T* __restrict__ x3,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ mask,
                                     T* __restrict__ out, int n, int c, int nh, int nw,
                                     float scale_t) {
  const int h = static_cast<int>(blockIdx.x % nh);
  const size_t win = blockIdx.x / nh;             // b_
  const int hd = c / nh;
  const size_t c3 = size_t(3) * c;
  const float* bias_h = bias + size_t(h) * n * n;
  const float* mask_w = mask ? mask + (win % nw) * n * n : nullptr;
  if constexpr (KI > 0) {
    // offset of head h of token t: in x3 from the q, k or v column base, or in out
    auto addr = [=](int seg, int t) -> size_t {
      return (win * n + t) * (seg == 3 ? size_t(c) : c3) + h * hd;
    };
    win_fwd_mma::attention_fwd_block<KI, kScoreScale>(x3, x3 + c, x3 + 2 * c, bias_h, mask_w,
                                                      out, n, addr, scale_t);
  } else {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const AttnSmem<T> sm(smem_raw, n, hd);
    const T* xs = x3 + win * n * c3 + h * hd;     // row 0 of the window, head h

    const int ks = k_row_stride<T>(hd);
    for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
      const int t = idx / hd, e = idx % hd;
      const T* src = xs + size_t(t) * c3 + e;
      sm.k[size_t(t) * ks + e] = src[c];
      sm.v[size_t(t) * hd + e] = src[2 * c];
    }
    __syncthreads();

    T* os = out + win * n * c + h * hd;
    const Dropout no_drop(nullptr, 0u, 1.f);
    for (int i = threadIdx.x >> 5; i < n; i += kAttnWarps) {
      attend_row<T, kScoreScale>(xs + size_t(i) * c3, scale_t, sm, n, hd,
                                 bias_h + size_t(i) * n,
                                 mask_w ? mask_w + size_t(i) * n : nullptr, os + size_t(i) * c,
                                 no_drop, 0, h, i);
    }
  }
}

template <typename T, bool kScoreScale, int KI = 0>
int launch(const void* x3, const void* bias, const void* mask, void* out, long long windows,
           int n, int c, int nh, int nw, float scale_t, cudaStream_t stream) {
  const long long blocks = windows * nh;
  if (windows < 1 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (KI && !(sa_mma::aligned16(x3) && sa_mma::aligned16(out) && c % 8 == 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = KI ? win_fwd_mma::smem_bytes(n) : attn_smem_bytes<T>(n, c / nh);
  auto kernel = lane_window_attention_fwd_kernel<T, kScoreScale, KI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), KI ? win_fwd_mma::kThreads : kAttnThreads, smem,
           stream>>>(static_cast<const T*>(x3), static_cast<const float*>(bias),
                     static_cast<const float*>(mask), static_cast<T*>(out), n, c, nh, nw,
                     scale_t);
  return static_cast<int>(cudaGetLastError());
}

// The forward of either entry in the body that dtype, hd and n pick
// (win_fwd_mma::takes): bf16 at hd 32 and n <= 256 on the tensor cores, the
// rest on attend_row.
template <bool kScoreScale>
int launch_fwd(int dtype, const void* x3, const void* bias, const void* mask, void* out,
               long long windows, int n, int c, int nh, int nw, float scale_t,
               cudaStream_t stream) {
  if (nh > 0 && c % nh == 0 && win_fwd_mma::takes(dtype, c / nh, n)) {
    const int ki = win_fwd_mma::key_iters(n);
    auto fwd = ki == 4    ? launch<__nv_bfloat16, kScoreScale, 4>
               : ki == 13 ? launch<__nv_bfloat16, kScoreScale, 13>
                          : launch<__nv_bfloat16, kScoreScale, 16>;
    return fwd(x3, bias, mask, out, windows, n, c, nh, nw, scale_t, stream);
  }
  switch (dtype) {
    case kFloat32:
      return launch<float, kScoreScale>(x3, bias, mask, out, windows, n, c, nh, nw, scale_t,
                                        stream);
    case kBFloat16:
      return launch<__nv_bfloat16, kScoreScale>(x3, bias, mask, out, windows, n, c, nh, nw,
                                                scale_t, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// Backward.
//
// Replaces: empirical_mvm_tpu/ops/window_attention.py `_lane_bwd_kernel`
// over the grid `_lane_bwd` gives it (t-sliced or not). Same algebra and
// roundings as the direct backward (attention_bwd.cuh): dx3 (B_, n, 3C) in
// x3's dtype, dbias (nH, n, n) fp32 summed over all B_ windows (the TPU
// kernel's sum over windows and t-slices). The TPU wrapper's packed
// fallback (`_packed_bwd` when the VMEM budget is exceeded) has no
// counterpart: this kernel covers every shape itself.
//
// Bound on the H100: memory. At the trained 2D swin's shapes (n = 49,
// hd = 32, bf16) one (window, head) does about 10 * n^2 * hd = 0.77 MFLOP on
// 14 * n * hd = 22 KB of x3, do and dx3, about 35 operations per byte
// against the card's ~295.
//
// Design (first, simple version): the body of the direct backward,
// `attention_bwd_block`, on blocks (head, mask slot, chunk of periods):
// window b_ is row b_ of x3 and takes mask[b_ % nW], so the block of slot s
// walks the windows p * nW + s of the periods p of its chunk. Chunks fill the
// card about twice over (`attention_bwd_chunks`); each block adds into its
// own dbias slice and a second kernel sums the chunks * nW slices of every
// head in a fixed order (no atomics). The stage-0 shifted block of a
// 4-frame clip has nW = 4 x 64 = 256 slots: 1,024 blocks of one chunk, and
// 9.8 MB of slices. bf16 at hd = 32 runs the tensor-core body
// (attention_bwd_mma.cuh) on the same blocks, 128 threads each.
// ---------------------------------------------------------------------------

template <typename T, bool kMma>
__global__ void __launch_bounds__(kMma ? win_mma::kThreads : kAttnThreads,
                                  kMma ? win_mma::kMinBlocks : 1)
    lane_window_attention_bwd_kernel(const T* __restrict__ x3,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ mask,
                                     const T* __restrict__ dout, T* __restrict__ dx3,
                                     float* __restrict__ dbias_part, int periods, int n, int c,
                                     int nh, float scale_t, float scale_f) {
  const int h = blockIdx.x, slot = blockIdx.y, chunk = blockIdx.z, nchunk = gridDim.z;
  const int nw = gridDim.y;
  const int hd = c / nh;
  // offset of head h of token t of window (period p, slot) in the (B_ * n)
  // rows: in x3 and dx3 from the q, k or v column base, or in dout
  auto addr = [=](int seg, int p, int t) -> size_t {
    const size_t row = (size_t(p) * nw + slot) * n + t;
    return row * (seg == 3 ? c : 3 * c) + h * hd;
  };
  const float* bias_h = bias + size_t(h) * n * n;
  const float* mask_w = mask ? mask + size_t(slot) * n * n : nullptr;
  float* part = dbias_part + ((size_t(chunk) * nw + slot) * nh + h) * n * n;
  if constexpr (kMma)
    win_mma::attention_bwd_block(x3, x3 + c, x3 + 2 * c, bias_h, mask_w, dout, dx3, dx3 + c,
                                 dx3 + 2 * c, part, n, chunk, periods, nchunk, addr, scale_t,
                                 scale_f);
  else
    attention_bwd_block<T>(x3, x3 + c, x3 + 2 * c, bias_h, mask_w, dout, dx3, dx3 + c,
                           dx3 + 2 * c, part, n, hd, chunk, periods, nchunk, addr, scale_t,
                           scale_f);
}

template <typename T, bool kMma = false>
int launch_bwd(const void* x3, const void* bias, const void* mask, const void* dout, void* dx3,
               void* dbias, void* part, long long windows, int n, int c, int nh, int nw,
               float scale_t, float scale_f, cudaStream_t stream) {
  if (!mask) nw = 1;
  if (windows < 1 || nw < 1 || windows % nw || windows / nw > 0x7fffffffLL || nw > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (kMma && !(sa_mma::aligned16(x3) && sa_mma::aligned16(dout) && sa_mma::aligned16(dx3)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int periods = static_cast<int>(windows / nw);
  const size_t smem = kMma ? win_mma::smem_bytes(n) : attention_bwd_smem_bytes<T>(n, c / nh);
  auto kernel = lane_window_attention_bwd_kernel<T, kMma>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = attention_bwd_chunks(periods, nh, nw, kMma ? win_mma::kWaves : 2);
  kernel<<<dim3(nh, nw, chunks), kMma ? win_mma::kThreads : kAttnThreads, smem, stream>>>(
      static_cast<const T*>(x3), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const T*>(dout), static_cast<T*>(dx3),
      static_cast<float*>(part), periods, n, c, nh, scale_t, scale_f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_slices(static_cast<const float*>(part), static_cast<float*>(dbias),
                           chunks * nw, static_cast<long long>(nh) * n * n, stream);
}

}  // namespace
}  // namespace emvm

// windows = B_ windows of n tokens; nw = the mask's window count (ignored
// when mask is null). scale_t is the softmax scale already rounded to the
// storage dtype. bf16 at hd 32 and n <= 256 runs the tensor-core body, the
// rest attend_row; the shared memory of a block is
// emvm_window_attention_fwd_smem_bytes (window_attention.cu).
extern "C" int emvm_lane_window_attention_fwd(int dtype, const void* x3, const void* bias,
                                              const void* mask, void* out, long long windows,
                                              int n, int c, int nh, int nw,
                                              float scale_t, void* stream) {
  return emvm::launch_fwd<false>(dtype, x3, bias, mask, out, windows, n, c, nh, nw, scale_t,
                                 static_cast<cudaStream_t>(stream));
}

// lane_attention (tools/lanebench.py `_lane_kernel`): mask (nw, n, n) is
// required; scale is the fp32 scale that multiplies the fp32 scores. The
// bodies as for emvm_lane_window_attention_fwd.
extern "C" int emvm_lane_attention_fwd(int dtype, const void* x3, const void* bias,
                                       const void* mask, void* out, long long windows, int n,
                                       int c, int nh, int nw, float scale, void* stream) {
  if (!mask || nw < 1) return static_cast<int>(cudaErrorInvalidValue);
  return emvm::launch_fwd<true>(dtype, x3, bias, mask, out, windows, n, c, nh, nw, scale,
                                static_cast<cudaStream_t>(stream));
}

// Backward: dx3 (x3's shape and dtype) and dbias (nH, n, n) fp32. nw is the
// mask's window count (taken as 1 when mask is null). part is fp32 scratch
// of emvm_lane_window_attention_bwd_scratch(...) floats. scale_t is the
// softmax scale rounded to the storage dtype (for q * scale), scale_f the
// fp32 scale (for dq).
extern "C" int emvm_lane_window_attention_bwd(int dtype, const void* x3, const void* bias,
                                              const void* mask, const void* dout, void* dx3,
                                              void* dbias, void* part, long long windows, int n,
                                              int c, int nh, int nw, float scale_t,
                                              float scale_f, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (nh > 0 && c % nh == 0 && emvm::win_mma::takes(dtype, c / nh))
    return emvm::launch_bwd<__nv_bfloat16, true>(x3, bias, mask, dout, dx3, dbias, part,
                                                 windows, n, c, nh, nw, scale_t, scale_f, s);
  switch (dtype) {
    case emvm::kFloat32:
      return emvm::launch_bwd<float>(x3, bias, mask, dout, dx3, dbias, part, windows, n, c, nh,
                                     nw, scale_t, scale_f, s);
    case emvm::kBFloat16:
      return emvm::launch_bwd<__nv_bfloat16>(x3, bias, mask, dout, dx3, dbias, part, windows,
                                             n, c, nh, nw, scale_t, scale_f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// nw as for emvm_lane_window_attention_bwd: 1 for an unshifted block. Enough
// for either body.
extern "C" long long emvm_lane_window_attention_bwd_scratch(long long windows, int n, int nh,
                                                            int nw) {
  if (nw < 1 || windows < nw) return 0;
  const int periods = static_cast<int>(windows / nw);
  return static_cast<long long>(
             emvm::attention_bwd_chunks(periods, nh, nw, emvm::win_mma::kWaves)) *
         nw * nh * n * n;
}

extern "C" size_t emvm_lane_window_attention_bwd_smem_bytes(int dtype, int n, int hd) {
  if (emvm::win_mma::takes(dtype, hd)) return emvm::win_mma::smem_bytes(n);
  return dtype == emvm::kFloat32 ? emvm::attention_bwd_smem_bytes<float>(n, hd)
                                 : emvm::attention_bwd_smem_bytes<__nv_bfloat16>(n, hd);
}
