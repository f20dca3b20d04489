// Fused phasegram-encoder layer in eval mode: conv(1,9) / stride 2 / zero
// pad 4, BatchNorm with running statistics (eps 1e-5), tanh, in one pass.
//
// Replaces the TPU kernel maavss_tpu/ops/pallas_pgenc.py:_eval_kernel (the
// pl.pallas_call in fused_conv_bn_tanh_eval). Same contract and layout:
//   x [C, R, S] (R = batch*time rows), w2 [Co, 9*C] with column k*C + ci,
//   cbias, gamma, beta, mean, var [Co] fp32  ->  y [Co, R, S/2]
//   y[co,r,so] = tanh(gamma * (sum_{k,ci} w2[co,k*C+ci] * x[ci,r,2*so+k-4]
//                              + cbias - mean) * rsqrt(var + 1e-5) + beta)
// with fp32 sums and IO in x's type (fp32, bf16 or fp16).
//
// Design: one block per tile of the register-tiled conv of pgenc_conv.cuh
// (the tile plan is ops/cuda_pgenc.py:pgenc_plan's, the same as K2-train's
// forward), the running-statistics affine and tanh applied to the sums in
// registers, y written once. The stride-2 subsample is index arithmetic.
//
// What bounds it on Hopper: the flagship's 10 layers at R = 64 do 580
// MFLOP in fp32 on the CUDA cores (8.7 us at 67 TFLOP/s) and move ~6 MB; a
// layer is a chain of one launch, one staging round trip to L2, the FMAs
// and the stores, so the ten launches and their stages bound it, not the
// FMA rate. The plan keeps about a block an SM busy at every layer:
// position and row tiles at the shallow layers (9-36-term sums over 131-262
// k outputs), the contraction split over groups of threads at the deep
// ones (576-term sums over 16-131 k outputs).

#include "pgenc_conv.cuh"

namespace {

using namespace pgenc;

template <typename T>
struct EvalArgs {
  const T* x;
  const T* w2;
  const float* cbias;
  const float* gamma;
  const float* beta;
  const float* mean;
  const float* var;
  T* y;
  Shape d;
  TilePlan p;
  bool vec;  // 16-byte (bf16, fp16: 8-byte) copies of x
};

template <typename T, int TC>
__global__ void __launch_bounds__(kMaxThreads)
conv_bn_eval_kernel(const EvalArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  const Shape& d = a.d;
  const TilePlan& p = a.p;
  const Role t = role_of(p);
  const Tile q = tile_at(p, blockIdx.x);
  // the thread's channels' affine, loaded while the tile stages
  float cb[TC], m[TC], g[TC], b[TC], inv[TC];
#pragma unroll
  for (int c = 0; c < TC; ++c) {
    const int co = min(q.c0 + t.cg * TC + c, d.Co - 1);
    cb[c] = a.cbias[co];
    m[c] = a.mean[co];
    g[c] = a.gamma[co];
    b[c] = a.beta[co];
    inv[c] = rsqrtf(a.var[co] + kEps);
  }
  stage_tile(a.x, a.w2, d, p, q, smem, a.vec);
  __syncthreads();
  float acc[TC][kTso];
  conv_tile<TC>(smem, d, p, t, acc);
  group_sum<TC>(smem, p, t, acc);
  const int r = q.r0 + t.rl;
  const int so0 = q.s0 + kTso * t.sq;
  if (t.g != 0 || r >= d.R || so0 >= d.So) return;
#pragma unroll
  for (int c = 0; c < TC; ++c) {
    const int co = q.c0 + t.cg * TC + c;
    if (co >= d.Co) break;
    float v[kTso];
#pragma unroll
    for (int j = 0; j < kTso; ++j) {
      v[j] = tanhf(g[c] * (acc[c][j] + cb[c] - m[c]) * inv[c] + b[c]);
    }
    store_run(a.y + (static_cast<size_t>(co) * d.R + r) * d.So, so0, d.So, v);
  }
}

template <typename T, int TC>
int launch(const EvalArgs<T>& a, cudaStream_t s) {
  static std::atomic<unsigned long long> configured{0};
  auto kernel = conv_bn_eval_kernel<T, TC>;
  cudaError_t e = configure(kernel, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<a.p.tiles, a.p.threads, a.p.smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const EvalArgs<T>& a, cudaStream_t s) {
  return a.p.tc == 4 ? launch<T, 4>(a, s) : launch<T, 2>(a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. (tc, bc, br, bs, g) is the
// tile plan of ops/cuda_pgenc.py:pgenc_plan; one block per tile on
// `stream`. Returns cudaErrorInvalidValue for a shape or plan the kernel
// does not take, else the launch's cudaError_t.
extern "C" int maavss_pgenc_eval(const void* x, const void* w2,
                                 const void* cbias, const void* gamma,
                                 const void* beta, const void* mean,
                                 const void* var, void* y, int C, int R, int S,
                                 int Co, int dtype, int tc, int bc, int br,
                                 int bs, int g, void* stream) {
  const Shape d{C, R, S, Co, S / 2};
  TilePlan p;
  if (C < 1 || R < 1 || Co < 1 || S < 2 || S % 2 != 0 || dtype < 0 ||
      dtype > 2 || !make_plan(d, tc, bc, br, bs, g, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[5] = {static_cast<const float*>(cbias),
                       static_cast<const float*>(gamma),
                       static_cast<const float*>(beta),
                       static_cast<const float*>(mean),
                       static_cast<const float*>(var)};
  return with_io(dtype, [&](auto io) {
    using T = typename decltype(io)::type;
    const EvalArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(w2),
                        f[0], f[1], f[2], f[3], f[4], static_cast<T*>(y), d, p,
                        S % 4 == 0 && aligned(x, 4 * sizeof(T))};
    return dispatch(a, s);
  });
}
