// fused_layer_norm forward: LayerNorm over the last axis of a (rows, C) array.
//
// Replaces: empirical_mvm_tpu/ops/layernorm.py `_ln_fwd_kernel` (reached from
// `fused_layer_norm` through `_ln_fwd_call`). Same numerics: fp32 mean, then
// fp32 variance of the centred values (two passes, not E[x^2] - E[x]^2),
// y = (x - mean) * rsqrt(var + eps) * gamma + beta in fp32, rounded once to
// the input's dtype. gamma and beta are fp32.
//
// Bound on the H100: memory. Each element is read once and written once and
// costs about 8 fp32 operations, far below the card's ~295 operations per
// byte, so the floor is 2 * rows * C * sizeof(T) bytes over 3.35 TB/s.
// Design: one warp per row, 8 rows per 256-thread block; a row of C = 768
// bf16 values is 1.5 KB, so the three passes over it (mean, variance,
// output) after the first read hit L1, and device memory sees one read and
// one write. No shared memory, no block-wide barrier.
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

extern "C" const char* emvm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
