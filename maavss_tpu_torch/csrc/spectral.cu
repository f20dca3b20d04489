// Complex-mask and polar kernels (K4): elementwise passes over planar
// spectra [N, 2, T, F] fp32, channel 0 the real part (or the magnitude),
// channel 1 the imaginary part (or the phase).
//
// Replaces the TPU kernels of maavss_tpu/ops/pallas_kernels.py:
//   mask_mul  _mask_mul_kernel  (the pl.pallas_call in _mask_mul)
//             o = a * b, or a * conj(b) (the custom VJP's conjugated calls)
//   magphase  _magphase_kernel  (the one in magphase)
//             (re, im) -> (sqrt(re*re + im*im), atan2(im, re))
//   polar     _polar_kernel     (the one in polar_to_rect)
//             (mag, ph) -> (mag * cos(ph), mag * sin(ph)), written as the
//             interleaved complex64 spectrum [n, t, f_out] that the iSTFT's
//             irfft reads, with the bins f .. f_out-1 (the Nyquist bin the
//             features trim) written as 0; polar_to_rect is its real view
// On the models' paths the mask product runs inside the --mask_head head's
// kernel (csrc/mask_head.cu) and magphase inside the STFT's
// (csrc/stft_feat.cu); these launchers are the standalone forms.
// The arithmetic follows the TPU kernels' formulas. Every product and sum is
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn, which nvcc never
// contracts into an fma), in the order the plain PyTorch versions round
// them; atan2f, sqrtf and sincosf are the precise functions (no fast math).
//
// Design. The TPU kernels take one (T, F) tile per grid step from operands
// the caller has split into separate re and im arrays. Here each operand is
// one planar tensor described by three strides (in floats): between batch
// items, between the two planes, between rows along T; the last axis is
// contiguous. A window of a larger spectrogram (the fusion separator's
// x_full[:, :, win], the frames model's middle-frame columns) is then read
// in place, with no copy and no extra launch. One thread per four
// neighbouring frequency bins with 16-byte loads where F, the strides and
// the pointers allow it (F = 128 in the fusion model), else one per bin
// (F = 129 in the frames model).
//
// What bounds it on Hopper: bytes, in principle. Each complex element reads
// 8 bytes per input and writes 8: 24 B for mask_mul, 16 B for magphase and
// polar, with a handful of FLOPs (and one atan2f or sincosf). At the
// flagships' shapes the largest operand is 0.79 MB ([8, 2, 96, 129]), so
// the byte bound is under 1 us; a launch costs a few microseconds of
// fixed latency, so in practice these kernels are bound by the launch. The
// design keeps each to one launch over the whole operand. The spectrum
// form of the polar kernel takes the place of four more launches in the
// iSTFT (two plane copies, torch.complex, the Nyquist pad): one thread per
// output bin, 8-byte stores of (re, im), 8 + 8 bytes per bin.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct In {
  const float* p;  // plane 0 of item 0, row 0
  long long bs, ps, rs;
};

struct Out {
  float* p;
  long long bs, ps, rs;
};

struct MaskMul {
  static constexpr bool kBinary = true;
  bool conj;
  __device__ __forceinline__ void operator()(float ar, float ai, float br,
                                             float bi, float& o0,
                                             float& o1) const {
    if (conj) bi = -bi;
    o0 = __fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi));
    o1 = __fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br));
  }
};

struct MagPhase {
  static constexpr bool kBinary = false;
  __device__ __forceinline__ void operator()(float re, float im, float,
                                             float, float& mag,
                                             float& ph) const {
    mag = sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
    ph = atan2f(im, re);
  }
};

struct Polar {
  static constexpr bool kBinary = false;
  __device__ __forceinline__ void operator()(float mag, float ph, float,
                                             float, float& re,
                                             float& im) const {
    float s, c;
    sincosf(ph, &s, &c);
    re = __fmul_rn(mag, c);
    im = __fmul_rn(mag, s);
  }
};

__device__ __forceinline__ long long offset(long long bs, long long rs,
                                            long long item, long long row,
                                            long long col) {
  return item * bs + row * rs + col;
}

// V neighbouring bins per thread (V = 4: float4 loads and stores; V = 1).
template <int V, class Op>
__global__ void __launch_bounds__(kThreads)
planar_kernel(In a, In b, Out o, int n, int t, int fv, Op op) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long per_item = static_cast<long long>(t) * fv;
  if (i >= n * per_item) return;
  const long long item = i / per_item;
  const long long rem = i - item * per_item;
  const long long row = rem / fv;
  const long long col = (rem - row * fv) * V;
  const long long ea = offset(a.bs, a.rs, item, row, col);
  const long long eb = offset(b.bs, b.rs, item, row, col);
  const long long eo = offset(o.bs, o.rs, item, row, col);
  if constexpr (V == 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(a.p + ea);
    const float4 a1 = *reinterpret_cast<const float4*>(a.p + ea + a.ps);
    float4 b0 = a0, b1 = a1;
    if constexpr (Op::kBinary) {
      b0 = *reinterpret_cast<const float4*>(b.p + eb);
      b1 = *reinterpret_cast<const float4*>(b.p + eb + b.ps);
    }
    float4 o0, o1;
    op(a0.x, a1.x, b0.x, b1.x, o0.x, o1.x);
    op(a0.y, a1.y, b0.y, b1.y, o0.y, o1.y);
    op(a0.z, a1.z, b0.z, b1.z, o0.z, o1.z);
    op(a0.w, a1.w, b0.w, b1.w, o0.w, o1.w);
    *reinterpret_cast<float4*>(o.p + eo) = o0;
    *reinterpret_cast<float4*>(o.p + eo + o.ps) = o1;
  } else {
    const float a0 = a.p[ea], a1 = a.p[ea + a.ps];
    float b0 = a0, b1 = a1;
    if constexpr (Op::kBinary) {
      b0 = b.p[eb];
      b1 = b.p[eb + b.ps];
    }
    float o0, o1;
    op(a0, a1, b0, b1, o0, o1);
    o.p[eo] = o0;
    o.p[eo + o.ps] = o1;
  }
}

// (mag, ph) planar [n, 2, t, f] -> interleaved complex [n, t, f_out],
// f_out >= f, bins f.. of each row 0; one thread per output bin.
__global__ void __launch_bounds__(kThreads)
spectrum_kernel(In a, float2* __restrict__ o, int t, int f, int f_out,
                unsigned total) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const unsigned row_all = i / f_out;  // item * t + row
  const int col = static_cast<int>(i - row_all * f_out);
  float2 v = make_float2(0.0f, 0.0f);
  if (col < f) {
    const unsigned item = row_all / t;
    const long long e = offset(a.bs, a.rs, item, row_all - item * t, col);
    Polar{}(a.p[e], a.p[e + a.ps], 0.0f, 0.0f, v.x, v.y);
  }
  o[i] = v;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool vec_ok(const In& x, int f) {
  return f % 4 == 0 && aligned16(x.p) && aligned16(x.p + x.ps) &&
         x.bs % 4 == 0 && x.rs % 4 == 0;
}

template <class Op>
int launch(In a, In b, Out o, int n, int t, int f, Op op, void* stream) {
  if (n < 1 || t < 1 || f < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  In oi{o.p, o.bs, o.ps, o.rs};
  const bool vec = vec_ok(a, f) && vec_ok(oi, f) &&
                   (!Op::kBinary || vec_ok(b, f));
  const int fv = vec ? f / 4 : f;
  const long long total = static_cast<long long>(n) * t * fv;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    planar_kernel<4, Op><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        a, b, o, n, t, fv, op);
  } else {
    planar_kernel<1, Op><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        a, b, o, n, t, fv, op);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every operand is a planar [n, 2, t, f] fp32 tensor given as a pointer to
// plane 0 of item 0, row 0, and its strides in floats between items (bs),
// planes (ps) and rows (rs); the last axis is contiguous. Each launcher
// returns the cudaError_t of its launch.

// o = a * b (conj_b = 0) or a * conj(b) (conj_b = 1).
extern "C" int maavss_mask_mul(const float* a, long long a_bs, long long a_ps,
                               long long a_rs, const float* b, long long b_bs,
                               long long b_ps, long long b_rs, float* o,
                               long long o_bs, long long o_ps, long long o_rs,
                               int n, int t, int f, int conj_b, void* stream) {
  return launch(In{a, a_bs, a_ps, a_rs}, In{b, b_bs, b_ps, b_rs},
                Out{o, o_bs, o_ps, o_rs}, n, t, f, MaskMul{conj_b != 0},
                stream);
}

// (re, im) -> (mag, phase).
extern "C" int maavss_magphase(const float* x, long long x_bs, long long x_ps,
                               long long x_rs, float* o, long long o_bs,
                               long long o_ps, long long o_rs, int n, int t,
                               int f, void* stream) {
  const In in{x, x_bs, x_ps, x_rs};
  return launch(in, in, Out{o, o_bs, o_ps, o_rs}, n, t, f, MagPhase{},
                stream);
}

// (mag, phase) planar -> the complex64 spectrum [n, t, f_out] (interleaved
// re, im; f_out - f trailing zero bins per row).
extern "C" int maavss_polar_spectrum(const float* x, long long x_bs,
                                     long long x_ps, long long x_rs, void* o,
                                     int n, int t, int f, int f_out,
                                     void* stream) {
  const long long total = static_cast<long long>(n) * t * f_out;
  if (n < 1 || t < 1 || f < 1 || f_out < f || total >= 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  spectrum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      In{x, x_bs, x_ps, x_rs}, static_cast<float2*>(o), t, f, f_out,
      static_cast<unsigned>(total));
  return static_cast<int>(cudaGetLastError());
}
