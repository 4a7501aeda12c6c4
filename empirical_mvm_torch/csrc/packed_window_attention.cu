// packed_window_attention forward (here) and backward (below): window
// attention on q, k and v held as (N, hd) head tiles, one tile per (window,
// segment, head).
//
// Replaces: empirical_mvm_tpu/ops/window_attention.py `_attn_kernel` and
// `_attn_bwd_kernel`, over the grids that `packed_window_attention`
// (`_packed_fwd`, `_packed_bwd`) and `fused_window_attention`
// (`_fwd_pallas`, `_bwd_pallas`) give them. Same function: for every window
// b_ and head h,
//   out[b_, h] = softmax(q[b_, h] * scale . k[b_, h]^T + bias[h]
//                        + mask[b_ % nW]) . v[b_, h]
// with q, k, v (N, hd) tiles, bias (nH, N, N) fp32, mask (nW, N, N) fp32 or
// absent (the JAX `has_mask=False`), out (B_, nH, N, hd) in the inputs'
// dtype. The packed layout is one (B_, 3nH, N, hd) array, q, k and v of
// head h at head slots h, nH + h and 2nH + h; the fused layout is three
// (B_, nH, N, hd) arrays. The C entry points take the q, k and v base
// pointers and the stride between windows (3nH * N * hd or nH * N * hd
// elements), so one kernel serves both. The TPU kernels' window and head
// tiling (`_tiles`, `_packed_specs`, `_FWD_UNITS`, `_BWD_UNITS`) sizes VMEM
// blocks and has no counterpart here.
//
// Bound on the H100: memory. At the C = 96 Video Swin's shapes (N = 196,
// hd = 32, bf16) one (window, head) does 4 * N^2 * hd = 4.9 MFLOP on
// 8 * N * hd = 50 KB of q, k, v and out (bias and mask are shared by every
// window), about 98 operations per byte against the card's ~295.
// Design: one block per (head, window), heads fastest. bf16 at hd = 32 and
// N <= 256 runs the tensor-core body (attention_fwd_mma.cuh, 128 threads: K
// and V staged by cp.async, S and P.V by mma.sync, the bias and mask rows
// read once and coalesced); fp32, and bf16 at other hd or N, the CUDA-core
// one: K (rows padded one word) and V of the tile in shared memory, 8 warps
// walking the query rows with `attend_row` (common.cuh), the routine of the
// direct and lane window kernels. Both: q * scale rounded to the storage
// type, fp32 scores, bias, mask and softmax, probabilities rounded before
// P.V. Every loop bounds itself by N (196 and 49 are no powers of two).
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
    packed_window_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v, long long window_stride,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ mask, T* __restrict__ out,
                                       int n, int hd, int nh, int nw, float scale_t) {
  const int h = static_cast<int>(blockIdx.x % nh);
  const size_t win = blockIdx.x / nh;             // b_
  const size_t tile = win * window_stride + size_t(h) * n * hd;
  const float* bias_h = bias + size_t(h) * n * n;
  const float* mask_w = mask ? mask + (win % nw) * n * n : nullptr;
  const size_t out_tile = (win * nh + h) * n * hd;
  if constexpr (KI > 0) {
    // offset of token t: in q, k, v from the segment's base, or in out
    auto addr = [=](int seg, int t) -> size_t {
      return (seg == 3 ? out_tile : tile) + size_t(t) * hd;
    };
    win_fwd_mma::attention_fwd_block<KI>(q, k, v, bias_h, mask_w, out, n, addr, scale_t);
  } else {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const AttnSmem<T> sm(smem_raw, n, hd);
    const int ks = k_row_stride<T>(hd);
    for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
      const int t = idx / hd, e = idx % hd;
      sm.k[size_t(t) * ks + e] = k[tile + idx];
      sm.v[size_t(t) * hd + e] = v[tile + idx];
    }
    __syncthreads();

    const T* qs = q + tile;
    T* os = out + out_tile;
    const Dropout no_drop(nullptr, 0u, 1.f);
    for (int i = threadIdx.x >> 5; i < n; i += kAttnWarps) {
      attend_row<T>(qs + size_t(i) * hd, scale_t, sm, n, hd, bias_h + size_t(i) * n,
                    mask_w ? mask_w + size_t(i) * n : nullptr, os + size_t(i) * hd, no_drop, 0,
                    h, i);
    }
  }
}

template <typename T, int KI = 0>
int launch(const void* q, const void* k, const void* v, long long window_stride,
           const void* bias, const void* mask, void* out, long long windows, int n, int nh,
           int hd, int nw, float scale_t, cudaStream_t stream) {
  const long long blocks = windows * nh;
  if (windows < 1 || blocks > 0x7fffffffLL || (mask && nw < 1))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (KI && !(sa_mma::aligned16(q) && sa_mma::aligned16(k) && sa_mma::aligned16(v) &&
              sa_mma::aligned16(out) && window_stride % 8 == 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = KI ? win_fwd_mma::smem_bytes(n) : attn_smem_bytes<T>(n, hd);
  auto kernel = packed_window_attention_fwd_kernel<T, KI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), KI ? win_fwd_mma::kThreads : kAttnThreads, smem,
           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      window_stride, static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<T*>(out), n, hd, nh, mask ? nw : 1, scale_t);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward.
//
// Replaces: empirical_mvm_tpu/ops/window_attention.py `_attn_bwd_kernel`
// (through `_packed_bwd` and `_bwd_pallas`). Same algebra and roundings as
// the direct and lane window backwards (attention_bwd.cuh): dq, dk, dv in
// the inputs' layout and dtype (for the packed layout one (B_, 3nH, N, hd)
// dqkv), dbias (nH, N, N) fp32 summed over all B_ windows (the TPU kernel
// carries it across its sequential grid).
//
// Bound on the H100: memory. At N = 196, hd = 32, bf16 one (window, head)
// does about 10 * N^2 * hd = 12.3 MFLOP on 14 * N * hd = 88 KB of q, k, v,
// do, dq, dk and dv, about 140 operations per byte against the card's ~295.
//
// Design (first, simple version): `attention_bwd_block` on blocks (head,
// mask slot, chunk of periods), as the lane window backward: window b_ takes
// mask[b_ % nW], so the block of slot s walks the windows p * nW + s of the
// periods p of its chunk; its addressing is the tile offset b_ * stride +
// h * N * hd + t * hd in q, k, v and their gradients, and (b_ * nH + h) * N
// * hd + t * hd in dout. Each block adds into its own dbias slice and
// sum_slices_kernel sums the chunks * nW slices of every head in a fixed
// order (no atomics). bf16 at hd = 32 runs the tensor-core body
// (attention_bwd_mma.cuh) on the same blocks, 128 threads each.
// ---------------------------------------------------------------------------

template <typename T, bool kMma>
__global__ void __launch_bounds__(kMma ? win_mma::kThreads : kAttnThreads,
                                  kMma ? win_mma::kMinBlocks : 1)
    packed_window_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v, long long window_stride,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ mask,
                                       const T* __restrict__ dout, T* __restrict__ dq,
                                       T* __restrict__ dk, T* __restrict__ dv,
                                       float* __restrict__ dbias_part, int periods, int n,
                                       int hd, float scale_t, float scale_f) {
  const int h = blockIdx.x, slot = blockIdx.y, chunk = blockIdx.z, nchunk = gridDim.z;
  const int nh = gridDim.x, nw = gridDim.y;
  // offset of token t of window (period p, slot), head h: in q, k, v and
  // their gradients from the segment's base, or in dout
  auto addr = [=](int seg, int p, int t) -> size_t {
    const size_t win = size_t(p) * nw + slot;
    const size_t row = size_t(h) * n + t;
    return seg == 3 ? (win * nh * n + row) * hd : win * window_stride + row * hd;
  };
  const float* bias_h = bias + size_t(h) * n * n;
  const float* mask_w = mask ? mask + size_t(slot) * n * n : nullptr;
  float* part = dbias_part + ((size_t(chunk) * nw + slot) * nh + h) * n * n;
  if constexpr (kMma)
    win_mma::attention_bwd_block(q, k, v, bias_h, mask_w, dout, dq, dk, dv, part, n, chunk,
                                 periods, nchunk, addr, scale_t, scale_f);
  else
    attention_bwd_block<T>(q, k, v, bias_h, mask_w, dout, dq, dk, dv, part, n, hd, chunk,
                           periods, nchunk, addr, scale_t, scale_f);
}

template <typename T, bool kMma = false>
int launch_bwd(const void* q, const void* k, const void* v, void* dq, void* dk, void* dv,
               long long window_stride, const void* bias, const void* mask, const void* dout,
               void* dbias, void* part, long long windows, int n, int nh, int hd, int nw,
               float scale_t, float scale_f, cudaStream_t stream) {
  if (!mask) nw = 1;
  if (windows < 1 || nw < 1 || windows % nw || windows / nw > 0x7fffffffLL || nw > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (kMma && !(sa_mma::aligned16(q) && sa_mma::aligned16(k) && sa_mma::aligned16(v) &&
                sa_mma::aligned16(dq) && sa_mma::aligned16(dk) && sa_mma::aligned16(dv) &&
                sa_mma::aligned16(dout) && window_stride % 8 == 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int periods = static_cast<int>(windows / nw);
  const size_t smem = kMma ? win_mma::smem_bytes(n) : attention_bwd_smem_bytes<T>(n, hd);
  auto kernel = packed_window_attention_bwd_kernel<T, kMma>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = attention_bwd_chunks(periods, nh, nw, kMma ? win_mma::kWaves : 2);
  kernel<<<dim3(nh, nw, chunks), kMma ? win_mma::kThreads : kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      window_stride, static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(part), periods, n, hd, scale_t, scale_f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_slices(static_cast<const float*>(part), static_cast<float*>(dbias),
                           chunks * nw, static_cast<long long>(nh) * n * n, stream);
}

}  // namespace
}  // namespace emvm

// q, k, v: the (N, hd) tile of window 0, head 0 of each segment; window b_,
// head h of a segment starts window_stride * b_ + h * N * hd elements after
// its base. out (windows, nh, n, hd). mask (nw, n, n) or null; window b_
// takes mask[b_ % nw]. scale_t is the softmax scale already rounded to the
// storage dtype. bf16 at hd 32 and N <= 256 runs the tensor-core body
// (win_fwd_mma::takes), the rest attend_row; the shared memory of a block is
// emvm_window_attention_fwd_smem_bytes (window_attention.cu).
extern "C" int emvm_packed_window_attention_fwd(int dtype, const void* q, const void* k,
                                                const void* v, long long window_stride,
                                                const void* bias, const void* mask, void* out,
                                                long long windows, int n, int nh, int hd,
                                                int nw, float scale_t, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (emvm::win_fwd_mma::takes(dtype, hd, n)) {
    const int ki = emvm::win_fwd_mma::key_iters(n);
    auto fwd = ki == 4    ? emvm::launch<__nv_bfloat16, 4>
               : ki == 13 ? emvm::launch<__nv_bfloat16, 13>
                          : emvm::launch<__nv_bfloat16, 16>;
    return fwd(q, k, v, window_stride, bias, mask, out, windows, n, nh, hd, nw, scale_t, s);
  }
  switch (dtype) {
    case emvm::kFloat32:
      return emvm::launch<float>(q, k, v, window_stride, bias, mask, out, windows, n, nh, hd,
                                 nw, scale_t, s);
    case emvm::kBFloat16:
      return emvm::launch<__nv_bfloat16>(q, k, v, window_stride, bias, mask, out, windows, n,
                                         nh, hd, nw, scale_t, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward: dq, dk, dv in the layout of q, k, v (same window_stride) and
// dtype; dout (windows, nh, n, hd); dbias (nh, n, n) fp32. nw is the mask's
// window count (taken as 1 when mask is null). part is fp32 scratch of
// emvm_packed_window_attention_bwd_scratch(...) floats. scale_t is the
// softmax scale rounded to the storage dtype (for q * scale), scale_f the
// fp32 scale (for dq).
extern "C" int emvm_packed_window_attention_bwd(int dtype, const void* q, const void* k,
                                                const void* v, void* dq, void* dk, void* dv,
                                                long long window_stride, const void* bias,
                                                const void* mask, const void* dout,
                                                void* dbias, void* part, long long windows,
                                                int n, int nh, int hd, int nw, float scale_t,
                                                float scale_f, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (emvm::win_mma::takes(dtype, hd))
    return emvm::launch_bwd<__nv_bfloat16, true>(q, k, v, dq, dk, dv, window_stride, bias, mask,
                                                 dout, dbias, part, windows, n, nh, hd, nw,
                                                 scale_t, scale_f, s);
  switch (dtype) {
    case emvm::kFloat32:
      return emvm::launch_bwd<float>(q, k, v, dq, dk, dv, window_stride, bias, mask, dout,
                                     dbias, part, windows, n, nh, hd, nw, scale_t, scale_f, s);
    case emvm::kBFloat16:
      return emvm::launch_bwd<__nv_bfloat16>(q, k, v, dq, dk, dv, window_stride, bias, mask,
                                             dout, dbias, part, windows, n, nh, hd, nw,
                                             scale_t, scale_f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// nw as for emvm_packed_window_attention_bwd: 1 for an unshifted block. Enough
// for either body.
extern "C" long long emvm_packed_window_attention_bwd_scratch(long long windows, int n, int nh,
                                                              int nw) {
  if (nw < 1 || windows < nw) return 0;
  const int periods = static_cast<int>(windows / nw);
  return static_cast<long long>(
             emvm::attention_bwd_chunks(periods, nh, nw, emvm::win_mma::kWaves)) *
         nw * nh * n * n;
}

extern "C" size_t emvm_packed_window_attention_bwd_smem_bytes(int dtype, int n, int hd) {
  if (emvm::win_mma::takes(dtype, hd)) return emvm::win_mma::smem_bytes(n);
  return dtype == emvm::kFloat32 ? emvm::attention_bwd_smem_bytes<float>(n, hd)
                                 : emvm::attention_bwd_smem_bytes<__nv_bfloat16>(n, hd);
}
