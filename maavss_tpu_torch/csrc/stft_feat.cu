// The STFT frontend in one launch: audio [B, S] fp32 -> features
// [B, 2, T, F] fp32, (re, im) or, under `polar`, (magnitude, phase).
//
// Replaces, on the --use_polar path, the TPU kernel of
// maavss_tpu/ops/pallas_kernels.py: _magphase_kernel (the pl.pallas_call in
// magphase) with the STFT in front of it, the way the JAX package's
// forward STFT leaves abs / angle to XLA to fuse into the transform
// (maavss_tpu/ops/stft.py). The same launch serves the default (re, im)
// features, so every train step and serving batch of both families runs it.
//
// What it computes, as ops/stft.py:stft_features_plain does: frames of N =
// fft_len samples every `hop`, centred (the signal reflect-padded by N / 2
// on both sides), times the periodic Hamming window, an N-point real DFT,
// divided by ||window|| when normalized; T = S / hop frames (the last frame
// dropped), F = N / 2 bins (the Nyquist bin trimmed) or N / 2 + 1.
//
// Design. A block takes one batch row and a tile of `ft` consecutive
// frames. It stages the tile's span of the signal in shared memory once
// (the frames overlap N / hop times), reflect-padding by index arithmetic:
// no padded copy. Each frame's N windowed samples become N / 2 complex
// values z[n] = x[2n] + i x[2n+1], stored in bit-reversed order; an
// in-place radix-2 decimation-in-time FFT of N / 2 points in shared memory,
// one __syncthreads() a stage; then the split step X[k] = E[k] + W_N^k O[k]
// with E = (Z[k] + conj Z[N/2-k]) / 2, O = (Z[k] - conj Z[N/2-k]) / 2i,
// which gives the DC and Nyquist bins an imaginary part of exactly 0. The
// window is ops/windows.hamming_window's fp32 table and the norm the plain
// path's fp32 value (both computed by the same PyTorch code on the device,
// cached per (N, device)); the twiddles exp(-2 pi i k / N), k < N / 2, are
// rounded from fp64. The epilogue scales by 1 / ||window|| (rounded as
// PyTorch's complex division by a real tensor rounds it, a product with the
// rounded reciprocal) and writes (re, im) or sqrtf(re*re + im*im) and
// atan2f(im, re), rounded as K4's magphase kernel rounds them
// (csrc/spectral.cu); each output row is a contiguous run of F floats.
//
// Bound on an H100: at the fusion flagship ([8, 6336] -> [8, 2, 96, 128])
// ~0.2 MB in and 0.79 MB out, ~0.3 us at 3.35 TB/s; 5 N log2 N FLOPs a
// frame are ~0.03 us at 67 TFLOP/s. The kernel is bound by its launch: the
// design is one launch in place of the dozen the plain path runs (window,
// norm, reflect pad, window product, cuFFT's rfft, the division, the
// stack, and K4's magphase launch under --use_polar).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinN = 16;
constexpr int kMaxN = 2048;
constexpr int kSmemMax = 48 * 1024;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

template <bool kPolar>
__global__ void __launch_bounds__(kThreads)
stft_feat_kernel(const float* __restrict__ audio, long long row_stride,
                 int s_len, int n, int log2h, int hop, int t_len, int f_len,
                 int ft, const float* __restrict__ window,
                 const float2* __restrict__ tw, float norm,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) float2 z[];  // [ft][n / 2], then the span
  const int half = n >> 1;
  float* span = reinterpret_cast<float*>(z + ft * half);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * ft;
  const int nf = min(ft, t_len - t0);
  const float* x = audio + b * row_stride;

  // the frames' samples of the padded signal, reflected into [0, S)
  const int span_len = (nf - 1) * hop + n;
  const long long start = static_cast<long long>(t0) * hop - half;
  for (int i = threadIdx.x; i < span_len; i += kThreads) {
    long long j = start + i;
    if (j < 0) j = -j;
    if (j >= s_len) j = 2LL * (s_len - 1) - j;
    span[i] = __ldg(x + j);
  }
  __syncthreads();

  // windowed even / odd samples as complex values, in bit-reversed order
  const int total = nf * half;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int f = e >> log2h, k = e & (half - 1);
    const float* sp = span + f * hop + 2 * k;
    z[(f << log2h) + (__brev(k) >> (32 - log2h))] =
        make_float2(__fmul_rn(sp[0], __ldg(window + 2 * k)),
                    __fmul_rn(sp[1], __ldg(window + 2 * k + 1)));
  }
  __syncthreads();

  // radix-2 decimation in time over n / 2 points, each frame in place
  const int per_frame = half >> 1;  // butterflies a stage
  for (int s = 0; s < log2h; ++s) {
    const int span_s = 1 << s;
    const int tw_step = n >> (s + 1);
    for (int e = threadIdx.x; e < nf * per_frame; e += kThreads) {
      const int f = e / per_frame, q = e - f * per_frame;
      const int pos = q & (span_s - 1);
      const int i0 = (f << log2h) + ((q >> s) << (s + 1)) + pos;
      const float2 a = z[i0];
      const float2 c = cmul(__ldg(tw + pos * tw_step), z[i0 + span_s]);
      z[i0] = make_float2(a.x + c.x, a.y + c.y);
      z[i0 + span_s] = make_float2(a.x - c.x, a.y - c.y);
    }
    __syncthreads();
  }

  // split step, scale, epilogue
  const float inv = norm > 0.0f ? __frcp_rn(norm) : 1.0f;
  const long long plane = static_cast<long long>(t_len) * f_len;
  float* o = out + static_cast<long long>(b) * 2 * plane +
             static_cast<long long>(t0) * f_len;
  for (int e = threadIdx.x; e < nf * f_len; e += kThreads) {
    const int f = e / f_len, k = e - f * f_len;
    const float2* zf = z + (f << log2h);
    float re, im;
    if (k == 0) {
      re = zf[0].x + zf[0].y;
      im = 0.0f;
    } else if (k == half) {
      re = zf[0].x - zf[0].y;
      im = 0.0f;
    } else {
      const float2 a = zf[k], c = zf[half - k];
      const float er = 0.5f * (a.x + c.x), ei = 0.5f * (a.y - c.y);
      const float orr = 0.5f * (a.y + c.y), oi = -0.5f * (a.x - c.x);
      const float2 w = __ldg(tw + k);
      re = er + (w.x * orr - w.y * oi);
      im = ei + (w.x * oi + w.y * orr);
    }
    if (norm > 0.0f) {
      re = __fmul_rn(re, inv);
      im = __fmul_rn(im, inv);
    }
    if (kPolar) {
      const float mag = sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
      const float ph = atan2f(im, re);
      re = mag;
      im = ph;
    }
    o[e] = re;
    o[plane + e] = im;
  }
}

}  // namespace

// audio: B rows of S samples, row r at audio + r * row_stride (floats);
// window [n] and tw [n / 2] (exp(-2 pi i k / n) as float2) on the device;
// norm > 0 divides by it (the window's L2 norm), 0 leaves the spectrum
// unscaled; out [B, 2, T, F] contiguous. n a power of two in [16, 2048],
// F = n / 2 or n / 2 + 1, S > n / 2. Returns the cudaError_t of the launch.
extern "C" int maavss_stft_feat(const float* audio, long long row_stride,
                                int b, int s_len, int n, int hop, int t_len,
                                int f_len, const float* window,
                                const void* tw, float norm, int polar,
                                float* out, void* stream) {
  if (n < kMinN || n > kMaxN || (n & (n - 1)) || hop < 1 || b < 1 ||
      b > 65535 || s_len <= n / 2 || t_len < 1 ||
      (f_len != n / 2 && f_len != n / 2 + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int log2h = 0;
  while ((1 << log2h) < n / 2) ++log2h;
  int ft = kMaxN / n < 32 ? kMaxN / n : 32;
  auto smem = [&](int frames) {
    return static_cast<long long>(frames) * (n / 2) * 8 +
           (static_cast<long long>(frames - 1) * hop + n) * 4;
  };
  while (ft > 1 && smem(ft) > kSmemMax) ft >>= 1;
  if (smem(ft) > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((t_len + ft - 1) / ft, b);
  const size_t bytes = static_cast<size_t>(smem(ft));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* twf = static_cast<const float2*>(tw);
  if (polar) {
    stft_feat_kernel<true><<<grid, kThreads, bytes, st>>>(
        audio, row_stride, s_len, n, log2h, hop, t_len, f_len, ft, window,
        twf, norm, out);
  } else {
    stft_feat_kernel<false><<<grid, kThreads, bytes, st>>>(
        audio, row_stride, s_len, n, log2h, hop, t_len, f_len, ft, window,
        twf, norm, out);
  }
  return static_cast<int>(cudaGetLastError());
}
