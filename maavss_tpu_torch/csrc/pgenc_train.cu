// Fused phasegram-encoder layer in train mode, forward and backward:
// conv(1,9) / stride 2 / zero pad 4, BatchNorm with the batch statistics
// (biased variance, eps 1e-5), tanh.
//
// Replaces the TPU kernels maavss_tpu/ops/pallas_pgenc.py:_fwd_kernel (the
// pl.pallas_call in _train_fwd) and :_bwd_kernel (the one in
// _train_vjp_bwd). Same contract and layout: x [C, R, S] (R = batch*time
// rows), w2 [Co, 9*C] with column k*C + ci, cbias, gamma, beta [Co] fp32.
//   forward:  yc = conv(x) + cbias            [Co, R, So], So = S/2
//             mu = sum(yc)/N, var = sum(yc^2)/N - mu^2   per channel, N = R*So
//             y = tanh(gamma * (yc - mu) * rsqrt(var + 1e-5) + beta)
//   backward: z = (yc - mu) * inv, out = tanh(gamma*z + beta),
//             dq = dy * (1 - out^2)
//             dgamma = sum(dq * z), dbeta = sum(dq)        per channel
//             dyc = (gamma*inv) * (dq - dbeta/N - z * (dgamma/N))
//             dx[ci,r,j] = sum_{co,k} w2[co,k*C+ci] * dyc[co,r,(j+4-k)/2]
//                          over the k with j+4-k even and in range
//             dw2[co,k*C+ci] = sum_{r,so} dyc[co,r,so] * xpad[ci,r,2so+k]
//             dcbias = 0 exactly (the bias cancels in yc - mu; the wrapper
//             returns zeros)
// with fp32 sums and statistics; x, w2, y, dy, dx, dw2 in x's type (fp32 or
// bf16).
//
// Design. The TPU kernels carry the per-channel sums (stats_ref, dgb_ref)
// and dW2 (dw_acc) across sequential grid steps in VMEM. Hopper's blocks run
// in parallel and in no order, so each cross-block sum is its own pass, in a
// fixed order, with no atomics (every run gives the same bits):
//   forward:  (1) conv -> fp32 yc scratch, one block per (row, output chunk),
//                 the zero-padded input row staged in shared memory, stride 2
//                 by index arithmetic (as csrc/pgenc_eval.cu);
//             (2) one block per channel sums yc and yc^2 over its contiguous
//                 R*So values (per-thread partials, then a shared-memory
//                 tree) and writes mu, var; E[y^2] - E[y]^2 as the TPU
//                 kernel and flax compute it;
//             (3) elementwise normalise + tanh -> y.
//   backward: (1) conv recomputed from x -> yc scratch (the TPU kernel also
//                 recomputes rather than storing residuals);
//             (2) one block per channel sums dq*z and dq -> dgamma, dbeta;
//             (3) dyc, elementwise, over yc in place;
//             (4) dx: one block per (row, input chunk) stages the row's dyc
//                 [Co, So] in shared memory; an output j gathers the taps k
//                 of its parity (the TPU kernel upsamples with zeros and
//                 untaps; a gather by parity is the same sum without the
//                 zeros);
//             (5) dw2 as a tiled product dyc [Co, R*So] x B [R*So, 9C],
//                 B gathered from x by (row, so, tap), the R*So axis split
//                 into P chunks so that enough blocks are in flight: one
//                 fp32 partial tile per (chunk, tile);
//             (6) dw2 = the partials summed over the chunks in order.
//
// What bounds it on Hopper: at R = 64 a layer's tensors are under 2 MB and
// stay in the 50 MB L2, so the floor from device memory (x and dy read once,
// y or dx written once) is a microsecond or two; the conv is 5 to 151 MFLOP
// of fp32 on the CUDA cores (twice that in the backward, for dx and dw2).
// The passes are short and dependent, so launch latency and the per-channel
// reductions (one block per channel, 2 to 64 blocks) bound the shallow
// layers; load issue bounds the deep ones, as in the eval kernel. Tensor
// cores (implicit GEMM) and fewer passes are the later step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTaps = 9;
constexpr int kPad = 4;
constexpr int kThreads = 256;
constexpr int kOutputsPerThread = 4;
constexpr int kStatThreads = 512;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Affine {
  const float* cbias;
  const float* gamma;
  const float* beta;
};

// Stage x's row r, zero-padded by kPad on both sides, as fp32 [C][S + 8].
template <typename T>
__device__ void stage_row(const T* __restrict__ x, float* xs, int C, int R,
                          int S, int r) {
  const int sp = S + 2 * kPad;
  for (int i = threadIdx.x; i < C * sp; i += blockDim.x) {
    const int ci = i / sp;
    const int s = i - ci * sp - kPad;
    xs[i] = (s >= 0 && s < S)
                ? load_f(x + (static_cast<size_t>(ci) * R + r) * S + s)
                : 0.0f;
  }
}

// yc = conv(x) + cbias -> fp32 [Co, R, So]; grid (R, output chunks).
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const T* __restrict__ x, const T* __restrict__ w2,
            const float* __restrict__ cbias, float* __restrict__ yc, int C,
            int R, int S, int Co) {
  extern __shared__ float xs[];
  const int r = blockIdx.x;
  const int sp = S + 2 * kPad;
  stage_row(x, xs, C, R, S, r);
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
    yc[(static_cast<size_t>(co) * R + r) * so_len + so] = acc + cbias[co];
  }
}

// Block-wide sum of two values in a fixed order; every thread gets the sums.
__device__ void block_sum2(float& a, float& b, float* red) {
  const int tid = threadIdx.x;
  red[tid] = a;
  red[blockDim.x + tid] = b;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if (tid < half) {
      red[tid] += red[tid + half];
      red[blockDim.x + tid] += red[blockDim.x + tid + half];
    }
    __syncthreads();
  }
  a = red[0];
  b = red[blockDim.x];
}

// mu, var per channel; grid Co.
__global__ void __launch_bounds__(kStatThreads)
stats_kernel(const float* __restrict__ yc, float* __restrict__ mu,
             float* __restrict__ var, int n) {
  __shared__ float red[2 * kStatThreads];
  const float* row = yc + static_cast<size_t>(blockIdx.x) * n;
  float s = 0.0f, ss = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = row[i];
    s += v;
    ss += v * v;
  }
  block_sum2(s, ss, red);
  if (threadIdx.x == 0) {
    const float m = s / static_cast<float>(n);
    mu[blockIdx.x] = m;
    var[blockIdx.x] = ss / static_cast<float>(n) - m * m;
  }
}

// y = tanh(gamma * (yc - mu) * inv + beta); one thread per element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ yc, const float* __restrict__ mu,
             const float* __restrict__ var, Affine aff, T* __restrict__ y,
             int n, int Co) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(n) * Co) return;
  const int co = static_cast<int>(i / n);
  const float inv = rsqrtf(var[co] + kEps);
  store_f(y + i,
          tanhf(aff.gamma[co] * (yc[i] - mu[co]) * inv + aff.beta[co]));
}

// dgamma = sum(dq * z), dbeta = sum(dq) per channel; grid Co.
template <typename T>
__global__ void __launch_bounds__(kStatThreads)
bwd_stats_kernel(const float* __restrict__ yc, const T* __restrict__ dy,
                 const float* __restrict__ mu, const float* __restrict__ var,
                 Affine aff, float* __restrict__ dgamma,
                 float* __restrict__ dbeta, int n) {
  __shared__ float red[2 * kStatThreads];
  const int co = blockIdx.x;
  const size_t base = static_cast<size_t>(co) * n;
  const float m = mu[co];
  const float inv = rsqrtf(var[co] + kEps);
  const float gamma = aff.gamma[co];
  const float beta = aff.beta[co];
  float sdg = 0.0f, sdb = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float z = (yc[base + i] - m) * inv;
    const float out = tanhf(gamma * z + beta);
    const float dq = load_f(dy + base + i) * (1.0f - out * out);
    sdg += dq * z;
    sdb += dq;
  }
  block_sum2(sdg, sdb, red);
  if (threadIdx.x == 0) {
    dgamma[co] = sdg;
    dbeta[co] = sdb;
  }
}

// dyc = (gamma*inv) * (dq - dbeta/N - z * (dgamma/N)), written over yc in
// place; one thread per element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dyc_kernel(float* __restrict__ yc, const T* __restrict__ dy,
           const float* __restrict__ mu, const float* __restrict__ var,
           Affine aff, const float* __restrict__ dgamma,
           const float* __restrict__ dbeta, int n, int Co) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(n) * Co) return;
  const int co = static_cast<int>(i / n);
  const float nf = static_cast<float>(n);
  const float inv = rsqrtf(var[co] + kEps);
  const float gamma = aff.gamma[co];
  const float z = (yc[i] - mu[co]) * inv;
  const float out = tanhf(gamma * z + aff.beta[co]);
  const float dq = load_f(dy + i) * (1.0f - out * out);
  yc[i] = (gamma * inv) * (dq - dbeta[co] / nf - z * (dgamma[co] / nf));
}

// dx [C, R, S]; grid (R, input chunks). blockIdx.x is the row, whose dyc
// [Co][So] is staged in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const float* __restrict__ dyc, const T* __restrict__ w2,
          T* __restrict__ dx, int C, int R, int S, int Co) {
  extern __shared__ float ds[];  // [Co][So]
  const int So = S / 2;
  const int r = blockIdx.x;
  for (int i = threadIdx.x; i < Co * So; i += blockDim.x) {
    const int co = i / So;
    ds[i] = dyc[(static_cast<size_t>(co) * R + r) * So + (i - co * So)];
  }
  __syncthreads();
  const int total = C * S;
  const int chunk = kThreads * kOutputsPerThread;
  const int begin = blockIdx.y * chunk;
  const int end = min(total, begin + chunk);
  const int nine_c = kTaps * C;
  for (int o = begin + threadIdx.x; o < end; o += blockDim.x) {
    const int ci = o / S;
    const int j = o - ci * S;
    float acc = 0.0f;
    for (int k = j & 1; k < kTaps; k += 2) {
      const int so = (j + kPad - k) >> 1;
      if (so < 0 || so >= So) continue;
      const T* wk = w2 + k * C + ci;
      for (int co = 0; co < Co; ++co) {
        acc = fmaf(load_f(wk + static_cast<size_t>(co) * nine_c),
                   ds[co * So + so], acc);
      }
    }
    store_f(dx + (static_cast<size_t>(ci) * R + r) * S + j, acc);
  }
}

// dw2 as a tiled product: dw2 [Co, 9C] = dyc [Co, K] x B [K, 9C] over the
// K = R*So (row, so) pairs, with B[(r, so), k*C + ci] = xpad[ci, r, 2so+k]
// gathered from x. Block (nt, mt, p) computes a kTM x kTN output tile over
// the p-th chunk of K (split K, so that enough blocks are in flight when
// Co x 9C is small) and writes it to partial[p]; each thread owns 2 x 4
// outputs and sums its chunk's terms in order.
constexpr int kTM = 32;
constexpr int kTN = 64;
constexpr int kTK = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dw2_tile_kernel(const float* __restrict__ dyc, const T* __restrict__ x,
                float* __restrict__ partial, int C, int R, int S, int Co,
                int k_chunk) {
  __shared__ float a_sh[kTK][kTM + 1];
  __shared__ float b_sh[kTK][kTN];
  const int So = S / 2;
  const int K = R * So;
  const int n_cols = kTaps * C;
  const int n0 = blockIdx.x * kTN;
  const int m0 = blockIdx.y * kTM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int tx = threadIdx.x % 16;  // columns tx*4 .. tx*4+3
  const int ty = threadIdx.x / 16;  // rows ty*2, ty*2+1
  float acc[2][4] = {};

  for (int kk0 = k_begin; kk0 < k_end; kk0 += kTK) {
    for (int e = threadIdx.x; e < kTK * kTM; e += kThreads) {
      const int i = e / kTK;
      const int t = e - i * kTK;
      const int kk = kk0 + t;
      a_sh[t][i] = (m0 + i < Co && kk < k_end)
                       ? dyc[static_cast<size_t>(m0 + i) * K + kk]
                       : 0.0f;
    }
    for (int e = threadIdx.x; e < kTK * kTN; e += kThreads) {
      const int jn = e / kTK;
      const int t = e - jn * kTK;
      const int kk = kk0 + t;
      const int n = n0 + jn;
      float v = 0.0f;
      if (n < n_cols && kk < k_end) {
        const int k = n / C;
        const int ci = n - k * C;
        const int r = kk / So;
        const int s = 2 * (kk - r * So) + k - kPad;
        if (s >= 0 && s < S) {
          v = load_f(x + (static_cast<size_t>(ci) * R + r) * S + s);
        }
      }
      b_sh[t][jn] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kTK; ++t) {
      const float a0 = a_sh[t][ty * 2];
      const float a1 = a_sh[t][ty * 2 + 1];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float b = b_sh[t][tx * 4 + c];
        acc[0][c] = fmaf(a0, b, acc[0][c]);
        acc[1][c] = fmaf(a1, b, acc[1][c]);
      }
    }
    __syncthreads();
  }
  float* out = partial + static_cast<size_t>(blockIdx.z) * Co * n_cols;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int co = m0 + ty * 2 + a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (co < Co && n < n_cols) out[static_cast<size_t>(co) * n_cols + n] =
          acc[a][c];
    }
  }
}

// dw2[o] = sum_p partial[p, o], p in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dw2_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dw2,
                  int n_out, int P) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  float s = 0.0f;
  for (int p = 0; p < P; ++p) s += partial[static_cast<size_t>(p) * n_out + o];
  store_f(dw2 + o, s);
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T>
int conv(const T* x, const T* w2, const float* cbias, float* yc, int C, int R,
         int S, int Co, cudaStream_t s) {
  const size_t smem = sizeof(float) * static_cast<size_t>(C) * (S + 2 * kPad);
  int e = set_smem(conv_kernel<T>, smem);
  if (e) return e;
  const int chunk = kThreads * kOutputsPerThread;
  dim3 grid(R, (Co * (S / 2) + chunk - 1) / chunk);
  conv_kernel<T><<<grid, kThreads, smem, s>>>(x, w2, cbias, yc, C, R, S, Co);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int train_fwd(const void* x, const void* w2, Affine aff, float* yc, void* y,
              float* mu, float* var, int C, int R, int S, int Co,
              cudaStream_t s) {
  int e = conv(static_cast<const T*>(x), static_cast<const T*>(w2), aff.cbias,
               yc, C, R, S, Co, s);
  if (e) return e;
  const int n = R * (S / 2);
  stats_kernel<<<Co, kStatThreads, 0, s>>>(yc, mu, var, n);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const size_t total = static_cast<size_t>(n) * Co;
  apply_kernel<T><<<(total + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      yc, mu, var, aff, static_cast<T*>(y), n, Co);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int train_bwd(const void* x_, const void* w2_, Affine aff, const float* mu,
              const float* var, const void* dy_, float* yc, float* partial,
              void* dx_, void* dw2_, float* dgamma, float* dbeta, int C,
              int R, int S, int Co, int P, cudaStream_t s) {
  const T* x = static_cast<const T*>(x_);
  const T* w2 = static_cast<const T*>(w2_);
  const T* dy = static_cast<const T*>(dy_);
  int e = conv(x, w2, aff.cbias, yc, C, R, S, Co, s);
  if (e) return e;
  const int So = S / 2;
  const int n = R * So;
  bwd_stats_kernel<T><<<Co, kStatThreads, 0, s>>>(yc, dy, mu, var, aff,
                                                  dgamma, dbeta, n);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;

  const size_t total = static_cast<size_t>(n) * Co;
  dyc_kernel<T><<<(total + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      yc, dy, mu, var, aff, dgamma, dbeta, n, Co);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;

  const size_t smem_dx = sizeof(float) * static_cast<size_t>(Co) * So;
  e = set_smem(dx_kernel<T>, smem_dx);
  if (e) return e;
  const int chunk = kThreads * kOutputsPerThread;
  dim3 grid_dx(R, (C * S + chunk - 1) / chunk);
  dx_kernel<T><<<grid_dx, kThreads, smem_dx, s>>>(yc, w2, static_cast<T*>(dx_),
                                                  C, R, S, Co);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;

  // split K into at most P chunks of whole kTK steps, none empty
  const int n_out = Co * kTaps * C;
  const int k_chunk = ((n + P - 1) / P + kTK - 1) / kTK * kTK;
  P = (n + k_chunk - 1) / k_chunk;
  dim3 grid_dw((kTaps * C + kTN - 1) / kTN, (Co + kTM - 1) / kTM, P);
  dw2_tile_kernel<T><<<grid_dw, kThreads, 0, s>>>(yc, x, partial, C, R, S, Co,
                                                  k_chunk);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  dw2_reduce_kernel<T><<<(n_out + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, static_cast<T*>(dw2_), n_out, P);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int C, int R, int S, int Co, int dtype) {
  return C < 1 || R < 1 || Co < 1 || S < 2 || S % 2 != 0 || dtype < 0 ||
         dtype > 1;
}

}  // namespace

// Train-mode forward. yc is an fp32 [Co, R, S/2] scratch; mu, var are fp32
// [Co] outputs. dtype: 0 = float32, 1 = bfloat16. Three kernels on `stream`.
// Returns the first non-zero cudaError_t, else 0.
extern "C" int maavss_pgenc_train_fwd(const void* x, const void* w2,
                                      const void* cbias, const void* gamma,
                                      const void* beta, void* yc, void* y,
                                      void* mu, void* var, int C, int R, int S,
                                      int Co, int dtype, void* stream) {
  if (bad_shape(C, R, S, Co, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Affine aff{static_cast<const float*>(cbias),
             static_cast<const float*>(gamma),
             static_cast<const float*>(beta)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ycf = static_cast<float*>(yc);
  float* muf = static_cast<float*>(mu);
  float* varf = static_cast<float*>(var);
  if (dtype == 0) {
    return train_fwd<float>(x, w2, aff, ycf, y, muf, varf, C, R, S, Co, s);
  }
  return train_fwd<__nv_bfloat16>(x, w2, aff, ycf, y, muf, varf, C, R, S, Co,
                                  s);
}

// Train-mode backward from x and the forward's (mu, var). yc is an fp32
// [Co, R, S/2] scratch, partial an fp32 [P, Co*9*C] scratch (at most P
// chunks of the R*S/2 axis for dw2); dx [C, R, S] and dw2 [Co, 9*C] in x's
// type, dgamma and dbeta fp32 [Co]. Six kernels on `stream`. Returns the first non-zero cudaError_t, else 0.
extern "C" int maavss_pgenc_train_bwd(
    const void* x, const void* w2, const void* cbias, const void* gamma,
    const void* beta, const void* mu, const void* var, const void* dy,
    void* yc, void* partial, void* dx, void* dw2, void* dgamma, void* dbeta,
    int C, int R, int S, int Co, int P, int dtype, void* stream) {
  if (bad_shape(C, R, S, Co, dtype) || P < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Affine aff{static_cast<const float*>(cbias),
             static_cast<const float*>(gamma),
             static_cast<const float*>(beta)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* muf = static_cast<const float*>(mu);
  const float* varf = static_cast<const float*>(var);
  float* ycf = static_cast<float*>(yc);
  float* pf = static_cast<float*>(partial);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  if (dtype == 0) {
    return train_bwd<float>(x, w2, aff, muf, varf, dy, ycf, pf, dx, dw2, dg,
                            db, C, R, S, Co, P, s);
  }
  return train_bwd<__nv_bfloat16>(x, w2, aff, muf, varf, dy, ycf, pf, dx, dw2,
                                  dg, db, C, R, S, Co, P, s);
}
