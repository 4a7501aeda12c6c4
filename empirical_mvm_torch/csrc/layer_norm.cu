// fused_layer_norm forward and backward: LayerNorm over the last axis of a
// (rows, C) array.
//
// Replaces: empirical_mvm_tpu/ops/layernorm.py `_ln_fwd_kernel` and
// `_ln_bwd_kernel` (reached from `fused_layer_norm` through `_ln_fwd_call`
// and its VJP `_fln_bwd`). Same numerics: fp32 mean, then fp32 variance of
// the centred values (two passes, not E[x^2] - E[x]^2),
// y = (x - mean) * rsqrt(var + eps) * gamma + beta in fp32, rounded once to
// the input's dtype. gamma and beta are fp32. The backward recomputes mean
// and rstd from x and, with xhat = (x - mean) * rstd and dxhat = dy * gamma,
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
//   dgamma = sum over rows of dy * xhat, dbeta = sum over rows of dy (fp32).
//
// Bound on the H100: memory. Forward, each element is read once and written
// once at about 8 fp32 operations; backward, x and dy are read and dx
// written at about 16. Both are far below the card's ~295 operations per
// byte, so the floors are 2 (forward) and 3 (backward) * rows * C *
// sizeof(T) bytes over 3.35 TB/s.
// Design: one warp per row, 8 rows per 256-thread block; a row of C = 768
// bf16 values is 1.5 KB, so the passes over it after the first read hit L1,
// and device memory sees each element once. dgamma and dbeta: the TPU
// kernel carries them across its sequential grid; blocks here run in no
// order. Each warp adds its rows' terms into its own fp32 columns in shared
// memory, the block sums its 8 warps in order into one partial row per
// block, and a second kernel sums the partials in block order: no atomics,
// so the sums are bit-identical from run to run.
#include "common.cuh"

namespace emvm {
namespace {

constexpr int kRowsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                          const float* __restrict__ beta, T* __restrict__ y,
                          long long rows, int c, float eps) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * c;
  T* yr = y + row * c;

  float s = 0.f;
  for (int k = lane; k < c; k += 32) s += to_float(xr[k]);
  const float mean = warp_sum(s) / c;

  float v = 0.f;
  for (int k = lane; k < c; k += 32) {
    const float d = to_float(xr[k]) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / c + eps);

  for (int k = lane; k < c; k += 32)
    yr[k] = from_float<T>((to_float(xr[k]) - mean) * rstd * gamma[k] + beta[k]);
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y, long long rows,
           int c, float eps, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  layer_norm_fwd_kernel<T><<<grid, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y), rows, c, eps);
  return static_cast<int>(cudaGetLastError());
}

// At most this many blocks in the backward, each over a contiguous range of
// rows, so that the partial rows stay few (4 blocks per SM of the H100).
constexpr int kLnBwdMaxBlocks = 4 * 132;

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ part, long long rows, int c, float eps,
                          long long rows_per_block) {
  extern __shared__ float acc[];  // kRowsPerBlock warps x (dgamma, dbeta) x C
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ag = acc + size_t(warp) * 2 * c;
  float* ab = ag + c;
  for (int k = lane; k < c; k += 32) ag[k] = ab[k] = 0.f;

  const long long first = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long last = min(rows, first + rows_per_block);
  for (long long row = first + warp; row < last; row += kRowsPerBlock) {
    const T* xr = x + row * c;
    const T* dyr = dy + row * c;
    float s = 0.f;
    for (int k = lane; k < c; k += 32) s += to_float(xr[k]);
    const float mean = warp_sum(s) / c;
    float v = 0.f;
    for (int k = lane; k < c; k += 32) {
      const float d = to_float(xr[k]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / c + eps);
    float m1 = 0.f, m2 = 0.f;
    for (int k = lane; k < c; k += 32) {
      const float xhat = (to_float(xr[k]) - mean) * rstd;
      const float dxhat = to_float(dyr[k]) * gamma[k];
      m1 += dxhat;
      m2 += dxhat * xhat;
    }
    m1 = warp_sum(m1) / c;
    m2 = warp_sum(m2) / c;
    T* dxr = dx + row * c;
    for (int k = lane; k < c; k += 32) {
      const float xhat = (to_float(xr[k]) - mean) * rstd;
      const float g = to_float(dyr[k]);
      dxr[k] = from_float<T>(rstd * (g * gamma[k] - m1 - xhat * m2));
      ag[k] += g * xhat;
      ab[k] += g;
    }
  }
  __syncthreads();
  float* out = part + size_t(blockIdx.x) * 2 * c;
  for (int k = threadIdx.x; k < 2 * c; k += blockDim.x) {
    float sum = 0.f;
    for (int w = 0; w < kRowsPerBlock; ++w) sum += acc[size_t(w) * 2 * c + k];
    out[k] = sum;
  }
}

// dgb[k] = sum over blocks of part[block, k], blocks in order; k < 2C.
__global__ void layer_norm_bwd_sum_kernel(const float* __restrict__ part,
                                          float* __restrict__ dgb, int blocks, int c2) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= c2) return;
  float sum = 0.f;
  for (int b = 0; b < blocks; ++b) sum += part[size_t(b) * c2 + k];
  dgb[k] = sum;
}

inline int ln_bwd_blocks(long long rows) {
  const long long want = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return static_cast<int>(want < kLnBwdMaxBlocks ? (want < 1 ? 1 : want) : kLnBwdMaxBlocks);
}

template <typename T>
int launch_bwd(const void* x, const void* gamma, const void* dy, void* dx, void* dgb,
               void* part, long long rows, int c, float eps, cudaStream_t stream) {
  const int blocks = ln_bwd_blocks(rows);
  const long long per_block = (rows + blocks - 1) / blocks;
  const size_t smem = size_t(kRowsPerBlock) * 2 * c * sizeof(float);
  auto kernel = layer_norm_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kRowsPerBlock * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(part), rows, c, eps, per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  layer_norm_bwd_sum_kernel<<<(2 * c + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dgb), blocks, 2 * c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace emvm

extern "C" int emvm_layer_norm_fwd(int dtype, const void* x, const void* gamma,
                                   const void* beta, void* y, long long rows, int c,
                                   float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case emvm::kFloat32:
      return emvm::launch<float>(x, gamma, beta, y, rows, c, eps, s);
    case emvm::kBFloat16:
      return emvm::launch<__nv_bfloat16>(x, gamma, beta, y, rows, c, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward: dx (x's dtype) and dgb = (dgamma, dbeta) as one (2, C) fp32
// array. part is fp32 scratch of emvm_layer_norm_bwd_scratch(rows, c) floats.
extern "C" int emvm_layer_norm_bwd(int dtype, const void* x, const void* gamma, const void* dy,
                                   void* dx, void* dgb, void* part, long long rows, int c,
                                   float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case emvm::kFloat32:
      return emvm::launch_bwd<float>(x, gamma, dy, dx, dgb, part, rows, c, eps, s);
    case emvm::kBFloat16:
      return emvm::launch_bwd<__nv_bfloat16>(x, gamma, dy, dx, dgb, part, rows, c, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" long long emvm_layer_norm_bwd_scratch(long long rows, int c) {
  return static_cast<long long>(emvm::ln_bwd_blocks(rows)) * 2 * c;
}

extern "C" const char* emvm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
