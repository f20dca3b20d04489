// Pieces shared by the LSTM recurrence's cluster kernels (lstm_fwd.cu, the
// forward, and lstm_bwd.cu, its BPTT sweep): the launch geometry, the
// resident w_h slice and the cluster launch.
//
// Geometry. One thread-block cluster of NC = kCluster CTAs per (direction,
// group of RB batch rows); ops/cuda_lstm.py:lstm_geometry picks RB, the
// launchers derive the rest from (H, RB). CTA q of a cluster owns the
// hidden units [q*U, q*U + U), U = H / NC, and keeps the four gate columns
// of those units, w_h[:, g*H + q*U + u] for g in [i, f, g, o] and u < U, in
// shared memory for the whole launch as w_sh[k][c], c = g*U + u, fp32
// whatever the IO type, rows padded to C + 4 floats (C = 4U) so that a
// float4 read of a row by 8 consecutive k is free of bank conflicts.
//   forward:  16*U threads; 4 k-slices of H/4 x C columns, then RB*U
//             owners of (row, unit) pairs; shared floats
//             H*(C+4) + 2*RB*H (h, two buffers) + 4*RB*C (k-slice partial
//             sums) + RB*U (c)
//   backward: H threads (one k each), RB*U owners; shared floats
//             H*(C+4) + RB*C (own dgates) + 2*RB*H (dh_prev partials from
//             every peer, two buffers) + RB*U (dc)
// All of it under the 227 KB a block may use: H <= 448 at NC = 16.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace lstm {

namespace cg = cooperative_groups;

constexpr int kCluster = 16;     // NC: CTAs per cluster (a non-portable size)
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr int kMaxThreads = 512;  // per CTA: 128 registers a thread

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_f(__half* p, float v) {
  *p = __float2half_rn(v);
}
__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Four consecutive values as floats: one 16-byte (fp32) or 8-byte (bf16,
// fp16) load; the caller checks the alignment.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Copy CTA q's gate columns of w_h [H, 4H] into w_sh [H][C + 4] (fp32).
// `vec` (U a multiple of 4 and w_h aligned for it) takes four values a load.
template <typename T>
__device__ void load_slice(const T* __restrict__ w_h, float* w_sh, int H,
                           int U, int q, bool vec) {
  const int C = 4 * U;
  const int ld = C + 4;
  const size_t four_h = 4 * static_cast<size_t>(H);
  if (vec) {
    const int C4 = C / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < H * C4; e += blockDim.x) {
      const int k = e / C4;
      const int c = (e - k * C4) * 4;
      const int g = c / U;
      const int u = c - g * U;
      *reinterpret_cast<float4*>(w_sh + k * ld + c) =
          load4(w_h + k * four_h + g * H + q * U + u);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < H * C; e += blockDim.x) {
      const int k = e / C;
      const int c = e - k * C;
      const int g = c / U;
      const int u = c - g * U;
      w_sh[k * ld + c] = load_f(w_h + k * four_h + g * H + q * U + u);
    }
  }
}

struct Geometry {
  int rows;     // RB, batch rows per cluster: 1, 2, 4 or 8
  int threads;  // per CTA
  int smem;     // dynamic shared-memory bytes per CTA
};

// The geometry of the forward (or the backward) for hidden width H and RB
// rows per cluster, laid out as the header says. False where the kernels
// do not take it: H not a multiple of 32 in [32, kMaxThreads], RB not in
// {1, 2, 4, 8}, or the CTA's shared memory over kMaxSmem.
inline bool make_geometry(int H, int RB, bool backward, Geometry* g) {
  if (H < 32 || H % 32 || H > kMaxThreads ||
      (RB != 1 && RB != 2 && RB != 4 && RB != 8)) {
    return false;
  }
  const long long U = H / kCluster, C = 4 * U;
  const long long floats =
      H * (C + 4) + 2LL * RB * H + RB * U + (backward ? RB * C : 4 * RB * C);
  *g = Geometry{RB, backward ? H : 16 * H / kCluster,
                static_cast<int>(4 * floats)};
  return g->smem <= kMaxSmem;
}

inline bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Let `kernel` take up to kMaxSmem dynamic shared bytes and run as
// clusters of kCluster CTAs (a non-portable size).
template <typename K>
cudaError_t set_attributes(K* kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// A launch of clusters of kCluster CTAs over grid (NC, groups, n_dir), with
// `threads` threads and `smem` dynamic shared bytes a CTA; `attr` holds the
// cluster dimension and must outlive the configuration.
inline cudaLaunchConfig_t cluster_config(int threads, int smem, int groups,
                                         int n_dir, cudaStream_t s,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, groups, n_dir);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch `kernel` as clusters of kCluster CTAs over grid (NC, groups,
// n_dir) with g.smem dynamic shared bytes. The kernel's attributes are set
// once per device and kept in `configured`, one bit a device, which the
// caller keeps for this kernel alone. Returns the first non-zero
// cudaError_t (a refused launch, cudaErrorClusterOutOfResources among
// them), else 0.
template <typename... KArgs, typename... Args>
int launch_cluster(void (*kernel)(KArgs...),
                   std::atomic<unsigned long long>& configured,
                   const Geometry& g, int groups, int n_dir, cudaStream_t s,
                   Args... args) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (!bit || !(configured.load(std::memory_order_relaxed) & bit)) {
    e = set_attributes(kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured.fetch_or(bit, std::memory_order_relaxed);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(g.threads, g.smem, groups, n_dir, s, &attr);
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `kernel` the current device runs side by side with
// one CTA an SM (the occupancy of a launch that asks for kMaxSmem shared
// bytes a CTA, so that no two CTAs share an SM whatever their threads): a
// cluster sits inside one GPC, so this is the number of GPCs with kCluster
// free SMs. A negative cudaError_t on failure.
template <typename... KArgs>
int clusters_at_once(void (*kernel)(KArgs...), int threads) {
  cudaError_t e = set_attributes(kernel);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(threads, kMaxSmem, 1, 1, nullptr, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace lstm
