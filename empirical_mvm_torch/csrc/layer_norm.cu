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
//
// Two bodies. The vectorized body (`ln_vec_fwd_kernel`, `ln_vec_bwd_kernel`)
// takes the widths the paths run, each a template instantiation
// (`with_vec_shape`): bf16 at C = 128, 256, 512, 768, 1024 and 2048 (the
// backward up to 1024), fp32 at C = 768. Every other C (and a pointer that is not 16-byte aligned) takes
// the scalar body of the first slices (`layer_norm_fwd_kernel`,
// `layer_norm_bwd_kernel`). empirical_mvm_torch/ops/layernorm.py `_ln_body`
// mirrors the choice.
//
// The vectorized body: a group of G lanes holds one row, G = C *
// sizeof(T) / (16 V) (32, a whole warp, from bf16 C = 256 on; 16 at C =
// 128), each lane V 16-byte vectors of it: lane l holds the vectors v * G +
// l, so one load instruction of the group reads G * 16 contiguous bytes.
// The row is read once from device memory and kept in registers, packed as
// stored; the mean, the two-pass variance and the output come from those
// registers, and the output leaves in 16-byte stores. A lane's sums run over
// its vectors in order, then a butterfly over the group's lanes (`group_sum`),
// which leaves the same value in every lane. gamma and beta are staged once
// per block in shared memory in the lanes' order (float4 (v * F + h) * G +
// l, F = float4s per vector), so a group's read of them is conflict-free,
// and reused over every row the block walks.
//
// Forward: a grid of as many 256-thread blocks as fit on the SMs at once
// (the occupancy query; the launch bounds hold 4 a SM, 64 registers, up to
// 24 values a lane, 3 at C = 1024 bf16 and 2 at 2048), each group walking
// rows gridDim * 8 (G = 32) apart. With 4 blocks a SM, 32 rows are in flight
// per SM, 48 KB at C = 768 bf16: above the ~20 KB that 3.35 TB/s times a
// device memory latency of about 0.8 us asks of each of the 132 SMs.
//
// Backward (bf16 C = 128 to 1024, fp32 C = 768): x and dy are held packed
// after one 16-byte read each, and the group's next row is loaded while this
// one is reduced (two rows in flight a warp); mean and rstd come from x, then
// m1 = mean(dxhat) and m2 = mean(dxhat * xhat) in one pass (m2 needs xhat,
// so both wait for rstd and share its read of gamma), then dx leaves in
// 16-byte stores. dgamma and dbeta gather in each lane's fp32 registers over
// the rows its group walks, in row order. That holds about 160 registers a
// lane at C = 768 bf16, so the blocks are of 128 threads, 2 a SM there (4 at
// one vector a lane, 3 at two), and the grid is that many a SM (264 at C =
// 768: 8 warps a SM, each with its next row of x and dy in flight, 24 KB;
// 3 blocks a SM read no faster), each block over a contiguous range of
// rows; at the
// end the groups of a block add their registers in a fixed order (the
// half-warps by a shuffle, then warp 0, 1, 2, 3 in turn) into one partial
// row of (dgamma, dbeta) per block. The partials are then summed by a second
// kernel spread over the SMs (`layer_norm_bwd_sum_kernel`: 32 columns a
// block, each of 16 warps a slice of the partials in order, the slices'
// sums added in order) rather than by the last block to finish, which would
// read all 264 x 2C partials (1.6 MB at C = 768) through one SM. No atomics
// on values, so dgamma and dbeta are bit-identical from run to run on one
// card.
#include <cstdint>

#include "common.cuh"

namespace emvm {
namespace {

constexpr int kLnThreads = 256;     // forward
constexpr int kLnBwdThreads = 128;  // backward

// Blocks a SM: the launch bounds of each vectorized instantiation, by the
// values a lane holds of a row. The backward's grid is this many a SM.
constexpr int ln_fwd_blocks_per_sm(int values) { return values <= 24 ? 4 : values <= 32 ? 3 : 2; }
constexpr int ln_bwd_blocks_per_sm(int row_regs) {
  return row_regs <= 4 ? 4 : row_regs <= 8 ? 3 : 2;
}

// SMs of the current device, asked once a device
inline int sm_count() {
  static int count[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev >= 0 && dev < 64 ? count[dev] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (dev >= 0 && dev < 64) count[dev] = n;
  }
  return n;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---------------------------------------------------------------------------
// The scalar body (any C): one warp per row, 8 rows per block, three (four in
// the backward) passes over the row with loads of one element per lane.
// ---------------------------------------------------------------------------

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

// At most this many blocks in the scalar backward, each over a contiguous
// range of rows, so that the partial rows stay few (4 blocks per SM of the
// H100).
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

inline int ln_bwd_blocks(long long rows) {
  const long long want = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return static_cast<int>(want < kLnBwdMaxBlocks ? (want < 1 ? 1 : want) : kLnBwdMaxBlocks);
}

// dgb[k] = sum over blocks of part[block, k], k < c2, for either body: block
// x sums the columns 32x .. 32x + 31, warp w the partials [w * slice,
// (w + 1) * slice) in order, and warp 0 adds the 16 warps' sums in order.
constexpr int kSumWarps = 16;

__global__ void __launch_bounds__(kSumWarps * 32)
    layer_norm_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ dgb,
                              int blocks, int c2) {
  __shared__ float red[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * 32 + lane;
  const int slice = (blocks + kSumWarps - 1) / kSumWarps;
  const int b0 = warp * slice, b1 = min(blocks, b0 + slice);
  float s = 0.f;
  if (k < c2) {
#pragma unroll 8
    for (int b = b0; b < b1; ++b) s += part[size_t(b) * c2 + k];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && k < c2) {
    float t = red[0][lane];
    for (int w = 1; w < kSumWarps; ++w) t += red[w][lane];
    dgb[k] = t;
  }
}

int launch_sum(const void* part, void* dgb, int blocks, int c, cudaStream_t stream) {
  layer_norm_bwd_sum_kernel<<<(2 * c + 31) / 32, kSumWarps * 32, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dgb), blocks, 2 * c);
  return static_cast<int>(cudaGetLastError());
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
  return launch_sum(part, dgb, blocks, c, stream);
}

// ---------------------------------------------------------------------------
// The vectorized body.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// A 16-byte vector of T held as stored: element e as fp32, and E fp32
// values rounded once into a vector.
template <typename T>
struct LnVec;

template <>
struct LnVec<__nv_bfloat16> {
  static constexpr int kE = 8;
  __device__ __forceinline__ static float get(const uint4& u, int e) {
    const uint32_t w = word(u, e >> 1);  // element 2i in the low half
    return __uint_as_float(e & 1 ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ __forceinline__ static uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // nearest even
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static uint4 put(const float (&f)[kE]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

template <>
struct LnVec<float> {
  static constexpr int kE = 4;
  __device__ __forceinline__ static float get(const uint4& u, int e) {
    return __uint_as_float(word(u, e));
  }
  __device__ __forceinline__ static uint4 put(const float (&f)[kE]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// Sum over the G lanes of a group (G = 16 or 32 of a warp whose 32 lanes all
// call it): lane i adds lane i ^ o for o = G/2, ..., 1, so every lane ends
// with the same value.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int V, int G, int kThreads = kLnThreads>
struct LnShape {
  static constexpr int kE = LnVec<T>::kE;  // elements per 16-byte vector
  static constexpr int kF = kE / 4;        // float4s of gamma per vector
  static constexpr int kC = V * G * kE;
  static constexpr int kGroups = kThreads / G;  // rows a block holds at once
  static constexpr int kGroupsPerWarp = 32 / G;
  static_assert(G == 16 || G == 32, "a row is one warp or one half-warp");
};

// Stage a (C,) fp32 vector into shared memory in the lanes' order: float4 i
// (elements 4i .. 4i + 3) belongs to vector j = i / F, part h = i % F, of
// lane l = j % G as its vector v = j / G.
template <class S, int G>
__device__ __forceinline__ void stage_lane_order(const float* __restrict__ src, float4* dst) {
  for (int i = threadIdx.x; i < S::kC / 4; i += blockDim.x) {
    const int j = i / S::kF, h = i % S::kF;
    dst[((j / G) * S::kF + h) * G + j % G] = reinterpret_cast<const float4*>(src)[i];
  }
}

// A lane's V vectors of row ``row`` of p (C = V G E values a row); zeros
// past ``last``.
template <typename T, int V, int G>
__device__ __forceinline__ void load_row(const T* __restrict__ p, long long row, long long last,
                                         int l, uint4 (&out)[V]) {
  const uint4* r = reinterpret_cast<const uint4*>(p + row * LnShape<T, V, G>::kC);
  const bool ok = row < last;
#pragma unroll
  for (int v = 0; v < V; ++v) out[v] = ok ? r[v * G + l] : make_uint4(0, 0, 0, 0);
}

// (mean, rstd) of the row a group holds in xv: a lane's sums over its
// vectors in order, then the butterfly; the variance of the centred values.
template <typename T, int V, int G>
__device__ __forceinline__ float2 row_stats(const uint4 (&xv)[V], float eps) {
  using Vec = LnVec<T>;
  constexpr int E = Vec::kE, C = LnShape<T, V, G>::kC;
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int e = 0; e < E; ++e) s += Vec::get(xv[v], e);
  const float mean = group_sum<G>(s) / C;
  float q = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float d = Vec::get(xv[v], e) - mean;
      q = fmaf(d, d, q);
    }
  return make_float2(mean, rsqrtf(group_sum<G>(q) / C + eps));
}

template <typename T, int V, int G>
__global__ void __launch_bounds__(kLnThreads, ln_fwd_blocks_per_sm(V * LnVec<T>::kE))
    ln_vec_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y, long long rows,
                      float eps) {
  using S = LnShape<T, V, G>;
  using Vec = LnVec<T>;
  constexpr int E = S::kE, F = S::kF, C = S::kC;
  extern __shared__ float4 ln_smem[];
  float4* gs = ln_smem;             // gamma, lanes' order
  float4* bs = ln_smem + V * F * G;  // beta
  stage_lane_order<S, G>(gamma, gs);
  stage_lane_order<S, G>(beta, bs);
  __syncthreads();

  const int lane = threadIdx.x & 31, l = lane % G;
  // the warp's first group: the loop is uniform over the warp, whose lanes
  // all take part in the butterflies
  const long long stride = static_cast<long long>(gridDim.x) * S::kGroups;
  for (long long wrow = static_cast<long long>(blockIdx.x) * S::kGroups +
                        (threadIdx.x >> 5) * S::kGroupsPerWarp;
       wrow < rows; wrow += stride) {
    const long long row = wrow + lane / G;
    uint4 xv[V];
    load_row<T, V, G>(x, row, rows, l, xv);

    const float2 st = row_stats<T, V, G>(xv, eps);
    const float mean = st.x, rstd = st.y;
    if (row >= rows) continue;
    uint4* yr = reinterpret_cast<uint4*>(y + row * C);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float o[E];
#pragma unroll
      for (int h = 0; h < F; ++h) {
        const float4 g = gs[(v * F + h) * G + l], b = bs[(v * F + h) * G + l];
        const float ga[4] = {g.x, g.y, g.z, g.w}, ba[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          o[4 * h + u] = fmaf((Vec::get(xv[v], 4 * h + u) - mean) * rstd, ga[u], ba[u]);
      }
      yr[v * G + l] = Vec::put(o);
    }
  }
}

template <typename T, int V, int G>
__global__ void __launch_bounds__(kLnBwdThreads, ln_bwd_blocks_per_sm(4 * V))
    ln_vec_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                      long long rows, float eps, long long rows_per_block) {
  using S = LnShape<T, V, G, kLnBwdThreads>;
  using Vec = LnVec<T>;
  constexpr int E = S::kE, F = S::kF, C = S::kC;
  extern __shared__ float4 ln_smem[];
  float4* gs = ln_smem;                                       // gamma, lanes' order
  float* acc = reinterpret_cast<float*>(ln_smem + V * F * G);  // (dgamma, dbeta), 2C
  stage_lane_order<S, G>(gamma, gs);
  __syncthreads();

  const int lane = threadIdx.x & 31, l = lane % G, warp = threadIdx.x >> 5;
  float ag[V * E], ab[V * E];  // this lane's columns of dgamma and dbeta
#pragma unroll
  for (int k = 0; k < V * E; ++k) ag[k] = ab[k] = 0.f;

  const long long first = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long last = min(rows, first + rows_per_block);
  const long long row0 = first + warp * S::kGroupsPerWarp + lane / G;
  uint4 xv[V], dv[V];
  load_row<T, V, G>(x, row0, last, l, xv);
  load_row<T, V, G>(dy, row0, last, l, dv);
  for (long long wrow = first + warp * S::kGroupsPerWarp, row = row0; wrow < last;
       wrow += S::kGroups, row += S::kGroups) {
    // the group's next row is in flight while this one is reduced
    uint4 xn[V], dn[V];
    load_row<T, V, G>(x, row + S::kGroups, last, l, xn);
    load_row<T, V, G>(dy, row + S::kGroups, last, l, dn);
    const float2 st = row_stats<T, V, G>(xv, eps);
    const float mean = st.x, rstd = st.y;
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int h = 0; h < F; ++h) {
        const float4 g = gs[(v * F + h) * G + l];
        const float ga[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = 4 * h + u;
          const float dxhat = Vec::get(dv[v], e) * ga[u];
          const float xhat = (Vec::get(xv[v], e) - mean) * rstd;
          m1 += dxhat;
          m2 = fmaf(dxhat, xhat, m2);
        }
      }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {  // group_sum of both, interleaved
      m1 += __shfl_xor_sync(0xffffffffu, m1, o);
      m2 += __shfl_xor_sync(0xffffffffu, m2, o);
    }
    m1 /= C;
    m2 /= C;
    if (row < last) {
      uint4* dxr = reinterpret_cast<uint4*>(dx + row * C);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float o[E];
#pragma unroll
        for (int h = 0; h < F; ++h) {
          const float4 g = gs[(v * F + h) * G + l];
          const float ga[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = 4 * h + u;
            const float xhat = (Vec::get(xv[v], e) - mean) * rstd;
            const float gy = Vec::get(dv[v], e);
            o[e] = rstd * (gy * ga[u] - m1 - xhat * m2);
            ag[v * E + e] = fmaf(gy, xhat, ag[v * E + e]);
            ab[v * E + e] += gy;
          }
        }
        dxr[v * G + l] = Vec::put(o);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      xv[v] = xn[v];
      dv[v] = dn[v];
    }
  }

  // the block's partial row: half-warps (lower + upper), then warps in order
  if constexpr (G < 32) {
#pragma unroll
    for (int k = 0; k < V * E; ++k) {
      ag[k] += __shfl_xor_sync(0xffffffffu, ag[k], 16);
      ab[k] += __shfl_xor_sync(0xffffffffu, ab[k], 16);
    }
  }
  for (int w = 0; w < kLnBwdThreads / 32; ++w) {
    if (warp == w && lane < G) {
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int col = (v * G + l) * E + e;
          acc[col] = w ? acc[col] + ag[v * E + e] : ag[v * E + e];
          acc[C + col] = w ? acc[C + col] + ab[v * E + e] : ab[v * E + e];
        }
    }
    __syncthreads();
  }
  float* out = part + size_t(blockIdx.x) * 2 * C;
  for (int k = threadIdx.x; k < 2 * C; k += blockDim.x) out[k] = acc[k];
}

template <int V_, int G_>
struct Shape {
  static constexpr int V = V_, G = G_;
};

// Calls fn(Shape<V, G>{}) for the vectorized instantiation of (T, c) and
// returns true, or returns false for a C the vectorized body does not take.
// The backward stops at bf16 C = 1024: at 2048 a lane's 64 values of x and
// dy and of dgamma and dbeta would not fit in its 255 registers.
template <typename T, bool kBackward, typename Fn>
bool with_vec_shape(int c, Fn&& fn) {
  if constexpr (sizeof(T) == 4) {
    if (c == 768) return fn(Shape<6, 32>{}), true;
  } else {
    switch (c) {
      case 128: return fn(Shape<1, 16>{}), true;
      case 256: return fn(Shape<1, 32>{}), true;
      case 512: return fn(Shape<2, 32>{}), true;
      case 768: return fn(Shape<3, 32>{}), true;
      case 1024: return fn(Shape<4, 32>{}), true;
      case 2048:
        if constexpr (kBackward) return false;
        else return fn(Shape<8, 32>{}), true;
    }
  }
  return false;
}

template <typename T, bool kBackward>
bool vec_takes(int c) {
  return with_vec_shape<T, kBackward>(c, [](auto) {});
}

template <typename T, int V, int G>
int launch_vec_fwd(const void* x, const void* gamma, const void* beta, void* y,
                   long long rows, float eps, cudaStream_t stream) {
  using S = LnShape<T, V, G>;
  auto kernel = ln_vec_fwd_kernel<T, V, G>;
  const size_t smem = 2 * S::kC * sizeof(float);
  static const int per_sm = [&] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kLnThreads, smem);
    return n > 0 ? n : 1;
  }();
  const long long want = (rows + S::kGroups - 1) / S::kGroups;
  const long long most = static_cast<long long>(per_sm) * sm_count();
  kernel<<<static_cast<unsigned>(want < most ? want : most), kLnThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y), rows, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, int G>
int launch_vec_bwd(const void* x, const void* gamma, const void* dy, void* dx, void* dgb,
                   void* part, long long rows, float eps, cudaStream_t stream) {
  using S = LnShape<T, V, G, kLnBwdThreads>;
  const long long want = (rows + S::kGroups - 1) / S::kGroups;
  const long long most = static_cast<long long>(ln_bwd_blocks_per_sm(4 * V)) * sm_count();
  const long long grid = want < most ? want : most;
  const long long per_block = (rows + grid - 1) / grid;
  const int blocks = static_cast<int>((rows + per_block - 1) / per_block);
  ln_vec_bwd_kernel<T, V, G><<<blocks, kLnBwdThreads, 3 * S::kC * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(part), rows, eps, per_block);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum(part, dgb, blocks, S::kC, stream);
}

template <typename T>
int layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                   long long rows, int c, float eps, cudaStream_t stream) {
  int err = 0;
  const bool vec = aligned16(x) && aligned16(y) && aligned16(gamma) && aligned16(beta) &&
                   with_vec_shape<T, false>(c, [&](auto s) {
                     using Sh = decltype(s);
                     err = launch_vec_fwd<T, Sh::V, Sh::G>(x, gamma, beta, y, rows, eps, stream);
                   });
  return vec ? err : launch<T>(x, gamma, beta, y, rows, c, eps, stream);
}

template <typename T>
int layer_norm_bwd(const void* x, const void* gamma, const void* dy, void* dx, void* dgb,
                   void* part, long long rows, int c, float eps, cudaStream_t stream) {
  int err = 0;
  const bool vec = aligned16(x) && aligned16(dy) && aligned16(dx) && aligned16(gamma) &&
                   with_vec_shape<T, true>(c, [&](auto s) {
                     using Sh = decltype(s);
                     err = launch_vec_bwd<T, Sh::V, Sh::G>(x, gamma, dy, dx, dgb, part, rows,
                                                           eps, stream);
                   });
  return vec ? err : launch_bwd<T>(x, gamma, dy, dx, dgb, part, rows, c, eps, stream);
}

}  // namespace
}  // namespace emvm

extern "C" int emvm_layer_norm_fwd(int dtype, const void* x, const void* gamma,
                                   const void* beta, void* y, long long rows, int c,
                                   float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case emvm::kFloat32:
      return emvm::layer_norm_fwd<float>(x, gamma, beta, y, rows, c, eps, s);
    case emvm::kBFloat16:
      return emvm::layer_norm_fwd<__nv_bfloat16>(x, gamma, beta, y, rows, c, eps, s);
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
      return emvm::layer_norm_bwd<float>(x, gamma, dy, dx, dgb, part, rows, c, eps, s);
    case emvm::kBFloat16:
      return emvm::layer_norm_bwd<__nv_bfloat16>(x, gamma, dy, dx, dgb, part, rows, c, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Partial rows of either body: at most max(scalar blocks, 4 a SM) of 2C.
extern "C" long long emvm_layer_norm_bwd_scratch(long long rows, int c) {
  const long long vec = 4LL * emvm::sm_count();
  const long long scalar = emvm::ln_bwd_blocks(rows);
  return (vec > scalar ? vec : scalar) * 2 * c;
}

// Dynamic shared memory of one backward block: gamma and the (dgamma, dbeta)
// row (vectorized), or 8 warps' (dgamma, dbeta) rows (scalar).
extern "C" size_t emvm_layer_norm_bwd_smem_bytes(int dtype, int c) {
  const bool vec = dtype == emvm::kFloat32 ? emvm::vec_takes<float, true>(c)
                                           : emvm::vec_takes<__nv_bfloat16, true>(c);
  return (vec ? size_t(3) : size_t(emvm::kRowsPerBlock) * 2) * c * sizeof(float);
}

extern "C" const char* emvm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
