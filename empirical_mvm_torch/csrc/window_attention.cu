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
#include <algorithm>
#include <climits>
#include <mutex>

#include "attention_bwd.cuh"
#include "attention_bwd_onepass.cuh"
#include "attention_fwd_mma.cuh"
#include "common.cuh"

namespace emvm {
namespace {

// KI: the key iterations of the tensor-core body (win_fwd_mma::key_iters),
// or 0 for the CUDA-core body. stats (B, nW, nH, 2, N) or null: the
// tensor-core body's row max and sum, for the one-pass backward.
template <typename T, int KI>
__global__ void __launch_bounds__(KI ? win_fwd_mma::kThreads : kAttnThreads,
                                  KI ? win_fwd_mma::kMinBlocks : 1)
    direct_window_attention_fwd_kernel(const T* __restrict__ x3,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ mask,
                                       T* __restrict__ out, float* __restrict__ stats, int d,
                                       int hp, int wp, int c, int nh, int wh, int ww,
                                       float scale_t) {
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
    win_fwd_mma::attention_fwd_block<KI>(
        x3, x3 + c, x3 + 2 * c, bias_h, mask_w, out, n, addr, scale_t,
        stats ? stats + ((size_t(b) * gridDim.y + w) * nh + h) * 2 * n : nullptr);
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
int launch(const void* x3, const void* bias, const void* mask, void* out, void* stats, int b,
           int d, int hp, int wp, int c, int nh, int wh, int ww, float scale_t,
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
      static_cast<const float*>(mask), static_cast<T*>(out), static_cast<float*>(stats), d, hp,
      wp, c, nh, wh, ww, scale_t);
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
// ~295, so the floor is the bytes over 3.35 TB/s; every body is far above
// it (the one-pass body by the latency of its per-tile chains at 13 warps
// an SM and of its bias and mask loads; PERF.md).
//
// Design: one block per (head, window, batch chunk), running a body over
// the batches of its chunk, each token's 5D address computed in place;
// dbias from per-block fp32 slices summed in a fixed order. bf16 at hd = 32
// (every Swin's head) and N <= 256 runs the one-pass tensor-core body from
// the forward's row statistics (attention_bwd_onepass.cuh: one warp per 16
// keys, 416 threads at N = 196, the dbias slice in shared memory where it
// fits; a small kernel first copies the bias and mask in its tile order);
// fp32, and bf16 at other hd or N, the CUDA-core one (attention_bwd.cuh,
// 256 threads), shared with the lane window and packed backwards.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kAttnThreads, 1)
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
  attention_bwd_block<T>(x3, x3 + c, x3 + 2 * c, bias_h, mask_w, dout, dx3, dx3 + c,
                         dx3 + 2 * c, part, n, hd, chunk, bsz, nchunk, addr, scale_t, scale_f);
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
  const int chunks = attention_bwd_chunks(b, nh, nw, 2);
  kernel<<<dim3(nh, nw, chunks), kAttnThreads, smem, stream>>>(
      static_cast<const T*>(x3), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const T*>(dout), static_cast<T*>(dx3),
      static_cast<float*>(part), b, d, hp, wp, c, nh, wh, ww, scale_t, scale_f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_slices(static_cast<const float*>(part), static_cast<float*>(dbias),
                           chunks * nw, static_cast<long long>(nh) * n * n, stream);
}

// The bias (nh, n, n) and the mask (nw, n, n, or null) copied in the
// one-pass body's tile order (win_bwd1::terms_index), tile_terms(n) floats a
// head or a slot: bias_t (nh, ...), then mask_t (nw, ...).
__global__ void direct_window_attention_bwd_kernel_terms(const float* __restrict__ bias,
                                                         const float* __restrict__ mask,
                                                         float* __restrict__ bias_t,
                                                         float* __restrict__ mask_t, int n, int nh,
                                                         int nw) {
  const size_t per = win_bwd1::tile_terms(n);
  const size_t total = per * (nh + (mask ? nw : 0));
  const int nb = win_bwd1::padded(n) / 16;
  for (size_t o = size_t(blockIdx.x) * blockDim.x + threadIdx.x; o < total;
       o += size_t(gridDim.x) * blockDim.x) {
    const size_t slice = o / per;
    int row, key;
    win_bwd1::terms_index(o - slice * per, nb, &row, &key);
    const bool ok = row < n && key < n;
    if (slice < size_t(nh))
      bias_t[o] = ok ? bias[(slice * n + row) * n + key] : -CUDART_INF_F;
    else
      mask_t[o - nh * per] = ok ? mask[((slice - nh) * n + row) * n + key] : 0.f;
  }
}

// The one-pass body (attention_bwd_onepass.cuh): kW warps of kS key blocks,
// the dbias slice in shared memory (kOnChip) or in part. bias_t, mask_t: the
// terms in tile order; stats (B, nW, nH, 2, N): the forward's row max and sum.
template <int kW, int kS, bool kOnChip>
__global__ void __launch_bounds__(kW * 32, kW == 4 ? 3 : 1)
    direct_window_attention_bwd_kernel_onepass(
        const __nv_bfloat16* __restrict__ x3, const float* __restrict__ bias_t,
        const float* __restrict__ mask_t, const float* __restrict__ stats,
        const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dx3,
        float* __restrict__ dbias_part, int bsz, int d, int hp, int wp, int c, int nh, int wh,
        int ww, float scale_t, float scale_f) {
  const int h = blockIdx.x, w = blockIdx.y, chunk = blockIdx.z, nchunk = gridDim.z;
  const int nw = gridDim.y;
  const int hw = wh * ww;
  const int n = d * hw;
  const int strip = w / (wp / ww), col = w % (wp / ww);
  const int hd = c / nh;
  auto addr = [=](int seg, int b, int t) -> size_t {
    const int tt = t / hw, r = t % hw;
    const size_t row =
        ((size_t(b) * d + tt) * hp + strip * wh + r / ww) * size_t(wp) + col * ww + r % ww;
    return row * (seg == 3 ? c : 3 * c) + h * hd;
  };
  const size_t per = win_bwd1::tile_terms(n);
  win_bwd1::attention_bwd_onepass<kW, kS, kOnChip>(
      x3, x3 + c, x3 + 2 * c, bias_t + h * per, mask_t ? mask_t + w * per : nullptr,
      stats + (size_t(w) * nh + h) * 2 * n, size_t(nw) * nh * 2 * n, dout, dx3, dx3 + c,
      dx3 + 2 * c, dbias_part + ((size_t(chunk) * nw + w) * nh + h) * n * n, n, chunk, bsz,
      nchunk, addr, scale_t, scale_f);
}

// The one-pass body's launch at n: the kernel of its warps and placement,
// its shared memory, and the batch chunks that spread b windows of each of
// the pairs (head, slot) over the card in the least time: the chunk count c
// in 1 ... b that minimises ceil(pairs c / resident blocks) * (ceil(b / c) +
// 1), a block's own cost (its slice cleared, written and summed) counted as
// one window's, the fewer chunks on a tie.
struct OnePass {
  decltype(&direct_window_attention_bwd_kernel_onepass<13, 1, true>) kernel;
  int threads;
  size_t smem;
  int chunks;
};

// Blocks of `kernel` the current card holds at once (SMs times blocks an SM),
// queried once a (device, kernel, shared memory): the occupancy query costs
// host time on every backward launch otherwise.
inline cudaError_t resident_blocks(const void* kernel, int threads, size_t smem,
                                   long long* slots) {
  struct Seen {
    int dev;
    const void* kernel;
    size_t smem;
    long long slots;
  };
  static std::mutex lock;
  static Seen seen[16];
  static int count = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < count; ++i) {
    if (seen[i].dev == dev && seen[i].kernel == kernel && seen[i].smem == smem) {
      *slots = seen[i].slots;
      return cudaSuccess;
    }
  }
  if ((err = allow_smem(kernel, smem)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
          cudaSuccess)
    return err;
  *slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (count < 16) seen[count++] = {dev, kernel, smem, *slots};
  return cudaSuccess;
}

// floats of the one-pass launch's dbias slices, rounded up to 64 (the tile
// terms after them are read 16 bytes at a time)
inline size_t onepass_slices(int chunks, int nw, int nh, int n) {
  return (size_t(chunks) * nw * nh * n * n + 63) & ~size_t(63);
}

inline cudaError_t onepass_plan(int n, int b, int pairs, OnePass* plan) {
  const bool on_chip = win_bwd1::on_chip(n);
  const int kw = win_bwd1::warps(n);
  plan->kernel = kw == 4    ? direct_window_attention_bwd_kernel_onepass<4, 1, true>
                 : kw == 13 ? (on_chip ? direct_window_attention_bwd_kernel_onepass<13, 1, true>
                                       : direct_window_attention_bwd_kernel_onepass<13, 1, false>)
                            : direct_window_attention_bwd_kernel_onepass<8, 2, false>;
  plan->threads = kw * 32;
  plan->smem = win_bwd1::smem_bytes(n, on_chip);
  long long slots = 0;
  const cudaError_t err = resident_blocks(reinterpret_cast<const void*>(plan->kernel),
                                          plan->threads, plan->smem, &slots);
  if (err != cudaSuccess) return err;
  long long best = -1;
  plan->chunks = 1;
  for (int ch = 1; ch <= b; ++ch) {
    const long long rounds = (static_cast<long long>(pairs) * ch + slots - 1) / slots;
    const long long cost = rounds * ((b + ch - 1) / ch + 1);
    if (best < 0 || cost < best) {
      best = cost;
      plan->chunks = ch;
    }
  }
  return cudaSuccess;
}

int launch_bwd_onepass(const void* x3, const void* bias, const void* mask, const void* stats,
                       const void* dout, void* dx3, void* dbias, void* part, int b, int d, int hp,
                       int wp, int c, int nh, int wh, int ww, float scale_t, float scale_f,
                       cudaStream_t stream) {
  const int n = d * wh * ww;
  const int nw = (hp / wh) * (wp / ww);
  if (!(sa_mma::aligned16(x3) && sa_mma::aligned16(dout) && sa_mma::aligned16(dx3) &&
        c % 8 == 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  // the body tables each token's offset within a clip as an int
  if (static_cast<long long>(d) * hp * wp * 3 * c > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  OnePass plan;
  cudaError_t err = onepass_plan(n, b, nh * nw, &plan);
  if (err == cudaSuccess) err = allow_smem(plan.kernel, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // part: the blocks' dbias slices, then the terms in tile order
  float* bias_t = static_cast<float*>(part) + onepass_slices(plan.chunks, nw, nh, n);
  float* mask_t = mask ? bias_t + nh * win_bwd1::tile_terms(n) : nullptr;
  const size_t terms = win_bwd1::tile_terms(n) * (nh + (mask ? nw : 0));
  const unsigned blocks = static_cast<unsigned>(std::min<size_t>((terms + 255) / 256, 4096));
  direct_window_attention_bwd_kernel_terms<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(bias), static_cast<const float*>(mask), bias_t, mask_t, n, nh,
      nw);
  plan.kernel<<<dim3(nh, nw, plan.chunks), plan.threads, plan.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x3), bias_t, mask_t, static_cast<const float*>(stats),
      static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dx3),
      static_cast<float*>(part), b, d, hp, wp, c, nh, wh, ww, scale_t, scale_f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_slices(static_cast<const float*>(part), static_cast<float*>(dbias),
                           plan.chunks * nw, static_cast<long long>(nh) * n * n, stream);
}

}  // namespace
}  // namespace emvm

// mask may be null (unshifted blocks). scale_t is the softmax scale already
// rounded to the storage dtype. bf16 at hd 32 and N <= 256 runs the
// tensor-core body (win_fwd_mma::takes), the rest attend_row. stats, last
// and optional (null: none), takes the tensor-core body's row max and sum
// (B, nW, nH, 2, N) fp32 for the one-pass backward.
extern "C" int emvm_direct_window_attention_fwd(int dtype, const void* x3, const void* bias,
                                                const void* mask, void* out, int b, int d,
                                                int hp, int wp, int c, int nh, int wh,
                                                int ww, float scale_t, void* stream,
                                                void* stats) {
  auto s = static_cast<cudaStream_t>(stream);
  const int n = d * wh * ww;
  if (nh > 0 && c % nh == 0 && emvm::win_fwd_mma::takes(dtype, c / nh, n)) {
    const int ki = emvm::win_fwd_mma::key_iters(n);
    auto fwd = ki == 4    ? emvm::launch<__nv_bfloat16, 4>
               : ki == 13 ? emvm::launch<__nv_bfloat16, 13>
                          : emvm::launch<__nv_bfloat16, 16>;
    return fwd(x3, bias, mask, out, stats, b, d, hp, wp, c, nh, wh, ww, scale_t, s);
  }
  switch (dtype) {
    case emvm::kFloat32:
      return emvm::launch<float>(x3, bias, mask, out, nullptr, b, d, hp, wp, c, nh, wh, ww,
                                 scale_t, s);
    case emvm::kBFloat16:
      return emvm::launch<__nv_bfloat16>(x3, bias, mask, out, nullptr, b, d, hp, wp, c, nh, wh,
                                         ww, scale_t, s);
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
// scale_f the fp32 scale (for dq). stats, last: the forward's row max and
// sum, which bf16 at hd 32 and N <= 256 (win_bwd1::takes, the one-pass
// body) requires and the CUDA-core body ignores (null there).
extern "C" int emvm_direct_window_attention_bwd(int dtype, const void* x3, const void* bias,
                                                const void* mask, const void* dout, void* dx3,
                                                void* dbias, void* part, int b, int d, int hp,
                                                int wp, int c, int nh, int wh, int ww,
                                                float scale_t, float scale_f, void* stream,
                                                const void* stats) {
  auto s = static_cast<cudaStream_t>(stream);
  if (nh > 0 && c % nh == 0 && emvm::win_bwd1::takes(dtype, c / nh, d * wh * ww)) {
    if (!stats) return static_cast<int>(cudaErrorInvalidValue);
    return emvm::launch_bwd_onepass(x3, bias, mask, stats, dout, dx3, dbias, part, b, d, hp, wp,
                                    c, nh, wh, ww, scale_t, scale_f, s);
  }
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

// Floats of scratch: with one_pass (last, 0 or 1) for the one-pass body (its
// slices, then the bias and mask in tile order), else for the CUDA-core
// body. -1: the one-pass plan failed.
extern "C" long long emvm_direct_window_attention_bwd_scratch(int b, int d, int hp, int wp,
                                                              int nh, int wh, int ww,
                                                              int one_pass) {
  const int nw = (hp / wh) * (wp / ww);
  const long long n = static_cast<long long>(d) * wh * ww;
  if (one_pass) {
    emvm::OnePass plan;
    if (emvm::onepass_plan(static_cast<int>(n), b, nh * nw, &plan) != cudaSuccess) return -1;
    return static_cast<long long>(
        emvm::onepass_slices(plan.chunks, nw, nh, static_cast<int>(n)) +
        emvm::win_bwd1::tile_terms(static_cast<int>(n)) * (nh + nw));
  }
  return static_cast<long long>(emvm::attention_bwd_chunks(b, nh, nw, 2)) * nw * nh * n * n;
}

// Dynamic shared memory of the backward's block, in the body dtype, hd and
// n pick.
extern "C" size_t emvm_direct_window_attention_bwd_smem_bytes(int dtype, int n, int hd) {
  if (emvm::win_bwd1::takes(dtype, hd, n))
    return emvm::win_bwd1::smem_bytes(n, emvm::win_bwd1::on_chip(n));
  return dtype == emvm::kFloat32 ? emvm::attention_bwd_smem_bytes<float>(n, hd)
                                 : emvm::attention_bwd_smem_bytes<__nv_bfloat16>(n, hd);
}

// Where the one-pass body sums a block's dbias at n keys: 1 in shared
// memory beside the window (win_bwd1::on_chip), 0 in the block's slice in
// device memory.
extern "C" int emvm_direct_window_attention_bwd_onchip(int n) {
  return emvm::win_bwd1::on_chip(n) ? 1 : 0;
}
