// Fused Adam update over every parameter leaf in one launch.
//
// Replaces the TPU kernel maavss_tpu/ops/pallas_adam.py:_adam_kernel (the
// pl.pallas_call in adam_leaf_update, one call per leaf). Same formula, in
// this order, fp32:
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g^2
//   p' = p - lr * (m' / c1) / (sqrt(v' / c2) + eps)
// with c1 = 1 - b1^count, c2 = 1 - b2^count computed by the caller after the
// count increment, and the step's learning rate lr (a constant, or a
// schedule's value at the count before the increment), all three read from
// device memory (`bc` = [c1, c2, lr]), so that a CUDA graph that captured
// the launch reads each replay's values; the launch's arguments never
// change from step to step. (The TPU kernel takes lr as a Python constant,
// which is why the JAX package refuses an LR schedule with it.) m, v and p are updated
// in place (the TPU kernel aliases
// them to its outputs). A leaf without a gradient (null g pointer) is updated
// with g = 0, as optax does; its moments then decay.
//
// Design. The TPU version launches one grid per leaf. Here one launch covers
// all leaves: a small device table holds each leaf's g, m, v, p pointers
// and size, and a block map sends block i to (leaf, first element). Each
// block owns a contiguous chunk of one leaf, so every thread reads and
// writes neighbouring addresses; 16-byte vector loads where the chunk is
// aligned. The table is built once by the wrapper (the parameters and
// moments never move; the gradient pointers are re-sent only when they
// change, and must not change once a CUDA graph holds the launch).
//
// What bounds it on Hopper: bytes. 4 reads and 3 writes of 4 bytes per
// parameter, 1.03 GB for the 36.7 M-parameter fusion model, 0.31 ms at
// 3.35 TB/s; 8 FLOP-ish and a sqrt per element is far below the card's
// compute. The design keeps every access coalesced and the launch single.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adam_one(float g, float& m, float& v, float& p,
                                         const Hyper& h, float c1, float c2,
                                         float lr) {
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * (g * g);
  p = p - lr * (m / c1) / (sqrtf(v / c2) + h.eps);
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(const int64_t* __restrict__ ptrs, const int64_t* __restrict__ gptrs,
            const int64_t* __restrict__ sizes,
            const int32_t* __restrict__ block_leaf,
            const int64_t* __restrict__ block_start,
            const float* __restrict__ bc, int n_leaves, int chunk, Hyper h) {
  const float c1 = bc[0], c2 = bc[1], lr = bc[2];
  const int leaf = block_leaf[blockIdx.x];
  const int64_t start = block_start[blockIdx.x];
  const int64_t size = sizes[leaf];
  const int64_t end = start + chunk < size ? start + chunk : size;
  const float* g = reinterpret_cast<const float*>(gptrs[leaf]);
  float* m = reinterpret_cast<float*>(ptrs[leaf]);
  float* v = reinterpret_cast<float*>(ptrs[n_leaves + leaf]);
  float* p = reinterpret_cast<float*>(ptrs[2 * n_leaves + leaf]);
  const bool vec = ((reinterpret_cast<uintptr_t>(m + start) |
                     reinterpret_cast<uintptr_t>(v + start) |
                     reinterpret_cast<uintptr_t>(p + start) |
                     (g ? reinterpret_cast<uintptr_t>(g + start) : 0)) &
                    15) == 0;
  int64_t i = start;
  if (vec) {
    const int64_t n4 = (end - start) / 4;
    for (int64_t q = threadIdx.x; q < n4; q += blockDim.x) {
      const int64_t e = start + 4 * q;
      float4 mm = *reinterpret_cast<float4*>(m + e);
      float4 vv = *reinterpret_cast<float4*>(v + e);
      float4 pp = *reinterpret_cast<float4*>(p + e);
      float4 gg = g ? *reinterpret_cast<const float4*>(g + e)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      adam_one(gg.x, mm.x, vv.x, pp.x, h, c1, c2, lr);
      adam_one(gg.y, mm.y, vv.y, pp.y, h, c1, c2, lr);
      adam_one(gg.z, mm.z, vv.z, pp.z, h, c1, c2, lr);
      adam_one(gg.w, mm.w, vv.w, pp.w, h, c1, c2, lr);
      *reinterpret_cast<float4*>(m + e) = mm;
      *reinterpret_cast<float4*>(v + e) = vv;
      *reinterpret_cast<float4*>(p + e) = pp;
    }
    i = start + 4 * n4;
  }
  for (int64_t e = i + threadIdx.x; e < end; e += blockDim.x) {
    float mm = m[e], vv = v[e], pp = p[e];
    adam_one(g ? g[e] : 0.0f, mm, vv, pp, h, c1, c2, lr);
    m[e] = mm;
    v[e] = vv;
    p[e] = pp;
  }
}

}  // namespace

// ptrs: device int64 [3, n_leaves] (rows m, v, p); gptrs: device int64
// [n_leaves] (0 = no gradient); sizes: device int64 [n_leaves]; block_leaf
// (int32) and block_start (int64): device [n_blocks], block i updates
// elements [block_start[i], block_start[i] + chunk) of leaf block_leaf[i];
// bc: device fp32 [3], the bias corrections [c1, c2] and the learning rate
// of this step. Every leaf is fp32 and contiguous. Returns the cudaError_t
// of the launch.
extern "C" int maavss_adam(const void* ptrs, const void* gptrs,
                           const void* sizes, const void* block_leaf,
                           const void* block_start, const void* bc,
                           int n_leaves, int n_blocks, int chunk, float b1,
                           float omb1, float b2, float omb2, float eps,
                           void* stream) {
  if (n_leaves < 1 || n_blocks < 1 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Hyper h{b1, omb1, b2, omb2, eps};
  adam_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ptrs), static_cast<const int64_t*>(gptrs),
      static_cast<const int64_t*>(sizes),
      static_cast<const int32_t*>(block_leaf),
      static_cast<const int64_t*>(block_start), static_cast<const float*>(bc),
      n_leaves, chunk, h);
  return static_cast<int>(cudaGetLastError());
}
