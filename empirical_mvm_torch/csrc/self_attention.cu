// lane_self_attention forward (no dropout): BERT multi-head attention read
// straight from the fused qkv GEMM output.
//
// Replaces: empirical_mvm_tpu/ops/window_attention.py `_lane_sa_fwd_kernel`
// (reached from `lane_self_attention` through `_lane_sa_call`), for
// p_drop == 0. Same function: x3 (B, L, 3D) with the last axis ordered
// (3, nH, hd), an fp32 additive mask of (B, L, L) values, out (B, L, D):
//   out[b, :, h] = softmax(q * scale . k^T + mask[b]) . v
// The mask is addressed through a batch stride and a row stride, so a
// (B, 1, L) padding mask broadcast over the query rows (row stride 0) is
// read without being expanded in device memory.
//
// Bound on the H100: at the fusion shapes (L = 275, D = 768, hd = 64, bf16)
// one (sequence, head) does 4 * L^2 * hd = 19 MFLOP on 8 * L * hd = 141 KB of
// x3 and out, about 137 operations per byte against the card's ~295, so the
// floor is memory: the bytes of x3, out and the unique mask values over
// 3.35 TB/s. This version runs far above that floor, because its products
// run on the CUDA cores, not the tensor cores.
// Design (first, simple version): one 256-thread block per (query tile of
// 64 rows, head, sequence). The block stages K and V of its head (L x hd,
// 35 KB each in bf16) in shared memory, and each of its 8 warps walks query
// rows of the tile: dot products, fp32 softmax, P.V, all bounded by L, which
// is not a power of two. Tensor cores and fusing the tiles of one head
// (flash-style, one K/V load per head) are later work.
#include "common.cuh"

namespace emvm {
namespace {

constexpr int kQueryTile = 64;

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    lane_self_attention_fwd_kernel(const T* __restrict__ x3, const float* __restrict__ mask,
                                   long long mask_sb, long long mask_sr,
                                   T* __restrict__ out, int l, int dm, int nh,
                                   float scale_t) {
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
  const int row_end = min(l, (tile + 1) * kQueryTile);
  for (int i = tile * kQueryTile + (threadIdx.x >> 5); i < row_end; i += kAttnWarps) {
    attend_row<T>(xb + size_t(i) * d3 + h * hd, scale_t, sm, l, hd, mask_b + i * mask_sr,
                  nullptr, out + (size_t(b) * l + i) * dm + h * hd);
  }
}

template <typename T>
int launch(const void* x3, const void* mask, long long mask_sb, long long mask_sr, void* out,
           int b, int l, int dm, int nh, float scale_t, cudaStream_t stream) {
  const size_t smem = attn_smem_bytes<T>(l, dm / nh);
  auto kernel = lane_self_attention_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((l + kQueryTile - 1) / kQueryTile, nh, b);
  kernel<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(x3), static_cast<const float*>(mask), mask_sb, mask_sr,
      static_cast<T*>(out), l, dm, nh, scale_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace emvm

// mask_sb / mask_sr: element strides of the mask's batch and query-row axes
// (its key axis must be contiguous). scale_t is the softmax scale already
// rounded to the storage dtype.
extern "C" int emvm_lane_self_attention_fwd(int dtype, const void* x3, const void* mask,
                                            long long mask_sb, long long mask_sr, void* out,
                                            int b, int l, int dm, int nh, float scale_t,
                                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case emvm::kFloat32:
      return emvm::launch<float>(x3, mask, mask_sb, mask_sr, out, b, l, dm, nh, scale_t, s);
    case emvm::kBFloat16:
      return emvm::launch<__nv_bfloat16>(x3, mask, mask_sb, mask_sr, out, b, l, dm, nh,
                                         scale_t, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
