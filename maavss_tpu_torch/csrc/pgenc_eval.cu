// Fused phasegram-encoder layer in eval mode: conv(1,9) / stride 2 / zero
// pad 4, BatchNorm with running statistics (eps 1e-5), tanh, in one pass.
//
// Replaces the TPU kernel maavss_tpu/ops/pallas_pgenc.py:_eval_kernel (the
// pl.pallas_call in fused_conv_bn_tanh_eval). Same contract and layout:
//   x [C, R, S] (R = batch*time rows), w2 [Co, 9*C] with column k*C + ci,
//   cbias, gamma, beta, mean, var [Co] fp32  ->  y [Co, R, S/2]
//   y[co,r,so] = tanh(gamma * (sum_{k,ci} w2[co,k*C+ci] * x[ci,r,2*so+k-4]
//                              + cbias - mean) * rsqrt(var + 1e-5) + beta)
// with fp32 sums and IO in x's type (fp32 or bf16).
//
// Design: one block per (row r, chunk of the Co*S/2 outputs of that row).
// The block stages the row's C x (S+8) zero-padded input in shared memory
// once; each thread then computes whole outputs, reading only the even
// input positions 2*so+k. So the stride-2 subsample is index arithmetic,
// which Mosaic on the TPU could not express and which costs nothing here.
// One launch shape serves the stack's first layer (C=1, S=4096) and its
// last (C=64, S=8): the staged row is C*(S+8) floats either way, and the
// output chunking keeps at least R blocks in flight.
//
// What bounds it on Hopper: at the serving shapes (R = 64) a layer moves
// under 1 MB and does 5 to 151 MFLOP in fp32 on the CUDA cores. The inner
// loop issues two loads per FMA (w2 through the read-only cache, x from
// shared memory), so the deep layers are bound by load issue, and the
// shallow ones by launch latency. Outputs of neighbouring threads are
// neighbouring addresses. Tensor cores (an implicit GEMM of
// [Co, 9C] x [9C, R*S/2]) are the later step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTaps = 9;
constexpr int kPad = 4;
constexpr int kThreads = 256;
constexpr int kOutputsPerThread = 4;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pgenc_eval_kernel(const T* __restrict__ x, const T* __restrict__ w2,
                  const float* __restrict__ cbias,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta,
                  const float* __restrict__ mean,
                  const float* __restrict__ var, T* __restrict__ y, int C,
                  int R, int S, int Co) {
  extern __shared__ float xs[];  // [C][S + 2*kPad]
  const int r = blockIdx.x;
  const int sp = S + 2 * kPad;
  for (int i = threadIdx.x; i < C * sp; i += blockDim.x) {
    const int ci = i / sp;
    const int s = i - ci * sp - kPad;
    xs[i] = (s >= 0 && s < S)
                ? load_f(x + (static_cast<size_t>(ci) * R + r) * S + s)
                : 0.0f;
  }
  __syncthreads();

  const int so_len = S / 2;
  const int total = Co * so_len;
  const int chunk = kThreads * kOutputsPerThread;
  const int begin = blockIdx.y * chunk;
  const int end = min(total, begin + chunk);
  for (int o = begin + threadIdx.x; o < end; o += blockDim.x) {
    const int co = o / so_len;
    const int so = o - co * so_len;
    const T* wr = w2 + static_cast<size_t>(co) * kTaps * C;
    const float* xk = xs + 2 * so;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      for (int ci = 0; ci < C; ++ci) {
        acc = fmaf(load_f(wr + k * C + ci), xk[ci * sp + k], acc);
      }
    }
    const float yc = acc + cbias[co];
    const float v =
        gamma[co] * (yc - mean[co]) * rsqrtf(var[co] + kEps) + beta[co];
    store_f(y + (static_cast<size_t>(co) * R + r) * so_len + so, tanhf(v));
  }
}

template <typename T>
int launch(const void* x, const void* w2, const float* cbias,
           const float* gamma, const float* beta, const float* mean,
           const float* var, void* y, int C, int R, int S, int Co,
           size_t smem, cudaStream_t stream) {
  auto kernel = pgenc_eval_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int chunk = kThreads * kOutputsPerThread;
  dim3 grid(R, (Co * (S / 2) + chunk - 1) / chunk);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w2), cbias, gamma, beta,
      mean, var, static_cast<T*>(y), C, R, S, Co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The row needs 4*C*(S+8) bytes of shared
// memory, which the wrapper checks against the per-block limit. Returns the
// cudaError_t of the launch.
extern "C" int maavss_pgenc_eval(const void* x, const void* w2,
                                 const void* cbias, const void* gamma,
                                 const void* beta, const void* mean,
                                 const void* var, void* y, int C, int R, int S,
                                 int Co, int dtype, void* stream) {
  if (C < 1 || R < 1 || Co < 1 || S < 2 || S % 2 != 0 || dtype < 0 ||
      dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(C) * (S + 2 * kPad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[5] = {static_cast<const float*>(cbias),
                       static_cast<const float*>(gamma),
                       static_cast<const float*>(beta),
                       static_cast<const float*>(mean),
                       static_cast<const float*>(var)};
  if (dtype == 0) {
    return launch<float>(x, w2, f[0], f[1], f[2], f[3], f[4], y, C, R, S, Co,
                         smem, s);
  }
  return launch<__nv_bfloat16>(x, w2, f[0], f[1], f[2], f[3], f[4], y, C, R,
                               S, Co, smem, s);
}
