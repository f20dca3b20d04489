// Fused train-mode BatchNorm + 2x2 max pool + LeakyReLU(0.01): the tail of
// an eligible conv3d stage of the frames model's visual encoder, forward and
// backward, in four kernels (plus stats' one-block-per-channel combine).
//
// Replaces the TPU kernels of maavss_tpu/ops/pallas_epilogue.py:
//   stats      _stats_kernel       (the pl.pallas_call in _stats)
//   apply      _apply_kernel       (the one in _apply)
//   bwd reduce _bwd_reduce_kernel  (the first one in _fused_bwd)
//   bwd dy     _bwd_dy_kernel      (the second one in _fused_bwd)
// Same contract, on PyTorch's layout: y [B, C, T, H, W] (the conv3d output
// as cuDNN writes it, NCDHW, H and W even) in the IO type, fp32, bf16 or
// fp16;
// gamma, beta [C] fp32. out, sel, g and dy are in the IO type too; every sum
// and every BN expression runs in fp32, as the TPU kernels upcast their
// blocks (pallas_epilogue.py:151,171-176,200-203,217-242).
//   stats:   mu = sum(y)/N, var = sum(y^2)/N - mu^2 (biased, not clamped),
//            rstd = rsqrt(var + 1e-5) per channel, N = B*T*H*W
//   apply:   per 2x2 window, sel = max of the 4 raw values if gamma > 0,
//            else their min (the BN map is monotone in y with the sign of
//            gamma, and LeakyReLU is increasing, so pooling the raw values
//            selects the same element as pooling the activations);
//            out = leaky(gamma * (sel - mu) * rstd + beta)
//            -> out, sel [B, C, T, H/2, W/2]
//   bwd reduce (g = d out, g_mu, g_var the cotangents of mu and var):
//            xhat = (sel - mu) * rstd, o = gamma * xhat + beta,
//            dsel = g * (o >= 0 ? 1 : 0.01)
//            S1 = sum(dsel), S2 = sum(dsel * xhat) over the pooled domain;
//            dbeta = S1, dgamma = S2, and the per-channel constants
//            k = [gamma*S1/N, gamma*S2/N, g_mu/N - 2*g_var*mu/N, 2*g_var/N]
//   bwd dy:  dxhat = dsel * gamma at the window's selected element, 0 at
//            the other three; ties go to the first match in phase order
//            ph = 2*py + px, compared in fp32 after the exact upcast (the TPU
//            kernel's eq & ~prefix)
//            dy = rstd * (dxhat - k0 - xhat * k1) + k2 + y * k3
// The arithmetic follows the TPU kernels' order of operations.
//
// Design. The TPU kernels read a space-to-depth folded conv output ([N, 4C]
// rows, the 4 phases of a window in 4 lane groups) and carry the channel
// sums across sequential grid steps in VMEM scratch. Here:
//   - y is read in its native NCDHW layout: a pooled row reads two adjacent
//     input rows, one float2 from each, so a warp reads 256 contiguous bytes
//     of each row; there is no relayout.
//   - Blocks run in parallel and in no order, so each channel sum is a
//     fixed partition of the channel's values over `nblk` blocks writing
//     fp32 partials, then one block per channel combining them in a fixed
//     order. No atomics: every run gives the same bits.
//   - The channel's values are B contiguous segments of L = T*H*W values
//     ((b*C + c)*L); a block walks its share segment by segment, 16-byte
//     loads (4 floats, or 8 bf16 or fp16) where L and the chunk are
//     multiples of that count and y is 16-byte aligned. apply and dy read
//     a window row as one pair (a float2, a bf16x2 or a half2) where y
//     (and dy) are aligned to two values; a view at another offset takes
//     one value a load.
//   - In bf16 and fp16 the selection is exact: max and min compare the
//     upcast values (bf16 or fp16 -> fp32 is exact and order-preserving),
//     sel is the selected value itself, and out and dy round once, to
//     nearest even. The BatchNorm output o whose sign picks LeakyReLU's
//     slope is computed in fp32 from the upcast values in every IO type,
//     as the plain version computes it.
//   - dy runs one thread per window, the channel from the index.
//   - apply is tiled by plane (redesigned for Hopper): a block takes a band
//     of pooled rows of one (b, c, t) plane, so the channel, the plane's
//     offset and the four per-channel constants come once per block, with
//     no division per window; a thread takes 4 adjacent windows, one
//     16-byte load of each input row (two in fp32), and writes out and sel
//     as one 8-byte (16-byte) store each. The plan (vector or scalar path,
//     grid, block, band) comes from the wrapper (ops/cuda_epilogue.py:
//     apply_plan); the launcher refuses a plan the pointers or W do not
//     allow. W/2 not a multiple of 4, or y, out or sel off their alignment,
//     take the scalar kernel: one thread per window, the channel and
//     offsets from the index.
//   - bwd reduce (redesigned for Hopper) reads g and sel 16 bytes a load
//     (8 bf16 or fp16, or 4 fp32) where aligned and divisible, else one
//     value a load; the channel's constants sit in registers; the block's
//     sums meet by warp shuffles in a fixed order. The channel's last block
//     to finish (found through a per-channel counter that it resets) sums
//     the channel's partials in a fixed order: one launch, where a second
//     launch of one block per channel measured 2-4 % slower on an H100.
//
// What bounds it on Hopper: bytes. Every pass is a stream over the conv
// output or its pooled quarter with a few FLOPs per element: stats reads y
// (4 B per element of y), apply reads y and writes out and sel (6 B), bwd
// reduce reads g and sel (2 B), dy reads y, g, sel and writes dy (10 B):
// 22 B per element of y in fp32, 2.2 GB per window at the frames flagship's
// stages 0 and 1, 0.66 ms at 3.35 TB/s; half of that in bf16 and fp16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(f16 v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ f16 from_f<f16>(float v) {
  return __float2half_rn(v);
}

constexpr int kThreads = 256;
constexpr float kSlope = 0.01f;
constexpr float kEps = 1e-5f;

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

// (y, y^2) of one element.
struct StatsOp {
  template <typename T>
  __device__ void operator()(const T* y, const T*, long long i, int,
                             float& s, float& ss) const {
    const float v = to_f(y[i]);
    s += v;
    ss += v * v;
  }
};

// Partial channel sums: grid (nblk, C). Block j of channel c sums the
// values [j*chunk, min(n, (j+1)*chunk)) of the channel's n = B*L values,
// value i at ((i/L)*C + c)*L + i%L, and writes
// partial[(c*pstride + poff + j)*2 + 0/1] (pstride = nblk, poff = 0 but in
// the split route, which leaves the other slots to other ranks).
// VEC > 1 reads 16 bytes a load (VEC = 16 / sizeof(T)) and needs L, chunk
// and the pointer's offset multiples of VEC (the launcher checks).
template <int VEC, typename Op, typename T>
__global__ void __launch_bounds__(kThreads)
partials_kernel(const T* __restrict__ a, const T* __restrict__ b,
                Op op, float* __restrict__ partial, int C, long long L,
                long long n, long long chunk, int pstride, int poff) {
  __shared__ float red[2 * kThreads];
  const int c = blockIdx.y;
  const long long begin = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = min(n, begin + chunk);
  float s = 0.0f, ss = 0.0f;
  for (long long s0 = begin; s0 < end;) {
    const long long seg = s0 / L;
    const long long seg_end = min(end, (seg + 1) * L);
    // element i of the channel (seg*L <= i < seg_end) lies at base + i
    const long long base = (seg * C + c) * L - seg * L;
    const T* pa = a + base;
    const T* pb = b ? b + base : nullptr;
#pragma unroll 4
    for (long long i = s0 + static_cast<long long>(threadIdx.x) * VEC;
         i < seg_end; i += static_cast<long long>(blockDim.x) * VEC) {
      if constexpr (VEC > 1) {
        const uint4 raw = *reinterpret_cast<const uint4*>(pa + i);
        const T* vv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < VEC; ++k) op(vv, static_cast<const T*>(nullptr),
                                         k, c, s, ss);
      } else {
        op(pa, pb, i, c, s, ss);
      }
    }
    s0 = seg_end;
  }
  block_sum2(s, ss, red);
  if (threadIdx.x == 0) {
    float* out =
        partial + (static_cast<size_t>(c) * pstride + poff + blockIdx.x) * 2;
    out[0] = s;
    out[1] = ss;
  }
}

// Sum channel c's nblk partials in a fixed order; grid C.
__device__ void combine(const float* partial, int nblk, float& s, float& ss,
                        float* red) {
  const float* p = partial + static_cast<size_t>(blockIdx.x) * nblk * 2;
  s = 0.0f;
  ss = 0.0f;
  for (int j = threadIdx.x; j < nblk; j += blockDim.x) {
    s += p[2 * j];
    ss += p[2 * j + 1];
  }
  block_sum2(s, ss, red);
}

__global__ void __launch_bounds__(kThreads)
stats_combine_kernel(const float* __restrict__ partial, int nblk, float ntot,
                     float* __restrict__ mu, float* __restrict__ var,
                     float* __restrict__ rstd) {
  __shared__ float red[2 * kThreads];
  float s, ss;
  combine(partial, nblk, s, ss, red);
  if (threadIdx.x == 0) {
    const int c = blockIdx.x;
    const float m = s / ntot;
    const float v = ss / ntot - m * m;
    mu[c] = m;
    var[c] = v;
    rstd[c] = rsqrtf(v + kEps);
  }
}

// 16 bytes at p (16-byte aligned), through the read-only path. (Measured:
// L1::no_allocate on these loads, and st.global.cs on apply's sel, made
// apply and bwd reduce no faster and up to 9 % slower on an H100;
// tools/k5_probe_torch.py builds that variant.)
__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

// Sum of a and b over the warp, in a fixed order, in lane 0.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
}

// Block-wide sum of a and b in a fixed order, in thread 0: each warp by
// shuffles, then warp 0 over the warps' sums. red holds 64 floats.
__device__ __forceinline__ void block_sum2_shfl(float& a, float& b,
                                                float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_sum2(a, b);
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    a = lane < nw ? red[lane] : 0.0f;
    b = lane < nw ? red[32 + lane] : 0.0f;
    warp_sum2(a, b);
  }
}

// The per-channel vectors of the backward reduce.
struct BwdArgs {
  const float* gamma;
  const float* beta;
  const float* mu;
  const float* rstd;
  const float* g_mu;
  const float* g_var;
};

// The normalised selected value xhat = (s - mu) * rstd and the BatchNorm
// output o = gamma * xhat + beta the backward reads LeakyReLU's slope from,
// each operation rounded on its own as the plain version writes them (no
// contraction into an FMA): where o rounds to within an ulp of 0, its sign
// and so the slope that scales the gradient are then the plain version's.
__device__ __forceinline__ float bn_xhat(float s, float mu, float rstd) {
  return __fmul_rn(__fsub_rn(s, mu), rstd);
}

__device__ __forceinline__ float bn_out(float xhat, float gm, float bt) {
  return __fadd_rn(__fmul_rn(gm, xhat), bt);
}

// (dsel, dsel * xhat) of one pooled element added to (s1, s2), from its
// g and sel and the channel's gamma, beta, mu, rstd.
__device__ __forceinline__ void bwd_acc(float g, float s, float gm, float bt,
                                        float mu, float rstd, float& s1,
                                        float& s2) {
  const float xhat = bn_xhat(s, mu, rstd);
  const float o = bn_out(xhat, gm, bt);
  const float dsel = g * (o >= 0.0f ? 1.0f : kSlope);
  s1 += dsel;
  s2 += dsel * xhat;
}

// Channel c's nblk partials summed in a fixed order (thread t takes j = t,
// t + blockDim, ...; then block_sum2_shfl), and its dgamma, dbeta and k
// written by thread 0. Reads the partials through L2: other blocks of this
// launch wrote them.
__device__ void bwd_finish(const float* partial, int nblk, int c, int C,
                           float ntot, const BwdArgs& args,
                           float* __restrict__ dgamma,
                           float* __restrict__ dbeta, float* __restrict__ k,
                           float* red) {
  const float* p = partial + static_cast<size_t>(c) * nblk * 2;
  float s1 = 0.0f, s2 = 0.0f;
  for (int j = threadIdx.x; j < nblk; j += blockDim.x) {
    s1 += __ldcg(p + 2 * j);
    s2 += __ldcg(p + 2 * j + 1);
  }
  block_sum2_shfl(s1, s2, red);
  if (threadIdx.x == 0) {
    const float gm = args.gamma[c];
    dbeta[c] = s1;
    dgamma[c] = s2;
    k[c] = gm * s1 / ntot;
    k[C + c] = gm * s2 / ntot;
    k[2 * C + c] =
        args.g_mu[c] / ntot - 2.0f * args.g_var[c] * args.mu[c] / ntot;
    k[3 * C + c] = 2.0f * args.g_var[c] / ntot;
  }
}

// Backward partial sums (S1, S2) of channel c = blockIdx.y over the values
// [j*chunk, min(n, (j+1)*chunk)) of its n = B*L pooled values, j =
// blockIdx.x, laid out as in partials_kernel; written to
// partial[(c*nblk + j)*2 + 0/1]. VEC > 1 reads g and sel 16 bytes a load
// and needs L, chunk and both pointers' offsets multiples of VEC (the
// launcher checks). The channel's last block to finish, counted in
// count[c] (0 between launches), also runs bwd_finish and resets count[c].
// FINISH false (the split route) writes partial[(c*pstride + poff + j)*2 +
// 0/1] and stops there: the sums are finished over a data group by
// bwd_finish_kernel.
template <int VEC, typename T, bool FINISH = true>
__global__ void __launch_bounds__(kThreads)
bwd_partials_kernel(const T* __restrict__ g, const T* __restrict__ sel,
                    BwdArgs args, float* partial, unsigned* count,
                    float* __restrict__ dgamma, float* __restrict__ dbeta,
                    float* __restrict__ k, int C,
                    long long L, long long n, long long chunk, int nblk,
                    int pstride = 0, int poff = 0) {
  __shared__ float red[64];
  __shared__ bool last;
  const int c = blockIdx.y;
  const float gm = args.gamma[c], bt = args.beta[c], mu = args.mu[c],
              rstd = args.rstd[c];
  const long long begin = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = min(n, begin + chunk);
  float s1 = 0.0f, s2 = 0.0f;
  for (long long s0 = begin; s0 < end;) {
    const long long seg = s0 / L;
    const long long seg_end = min(end, (seg + 1) * L);
    // element i of the channel (seg*L <= i < seg_end) lies at base + i
    const long long base = (seg * C + c) * L - seg * L;
    const T* pg = g + base;
    const T* ps = sel + base;
#pragma unroll 4
    for (long long i = s0 + static_cast<long long>(threadIdx.x) * VEC;
         i < seg_end; i += static_cast<long long>(blockDim.x) * VEC) {
      if constexpr (VEC > 1) {
        const uint4 rg = ld16(pg + i);
        const uint4 rs = ld16(ps + i);
        const T* vg = reinterpret_cast<const T*>(&rg);
        const T* vs = reinterpret_cast<const T*>(&rs);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          bwd_acc(to_f(vg[e]), to_f(vs[e]), gm, bt, mu, rstd, s1, s2);
        }
      } else {
        bwd_acc(to_f(pg[i]), to_f(ps[i]), gm, bt, mu, rstd, s1, s2);
      }
    }
    s0 = seg_end;
  }
  block_sum2_shfl(s1, s2, red);
  if constexpr (!FINISH) {
    if (threadIdx.x == 0) {
      float* out = partial +
                   (static_cast<size_t>(c) * pstride + poff + blockIdx.x) * 2;
      out[0] = s1;
      out[1] = s2;
    }
    return;
  }
  if (threadIdx.x == 0) {
    float* out = partial + (static_cast<size_t>(c) * nblk + blockIdx.x) * 2;
    out[0] = s1;
    out[1] = s2;
  }
  if (threadIdx.x == 0) {
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(count + c, 1u) == static_cast<unsigned>(nblk - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  bwd_finish(partial, nblk, c, C, 4.0f * static_cast<float>(n), args, dgamma,
             dbeta, k, red);
  if (threadIdx.x == 0) count[c] = 0;
}

// The split route's finish of the backward sums, grid C: channel c's
// partials [c][nparts][2] summed in a fixed order (every rank's, for the
// constants k over `ntot` pooled values a channel, with the cotangents
// g_mu and g_var already summed over the data group), and its own
// [poff, poff + nblk) alone for dgamma and dbeta (this rank's sums; the
// gradient all-reduce sums them).
__global__ void __launch_bounds__(kThreads)
bwd_finish_kernel(const float* __restrict__ partial, int nparts, int poff,
                  int nblk, BwdArgs args, float* __restrict__ dgamma,
                  float* __restrict__ dbeta, float* __restrict__ k, int C,
                  float ntot) {
  __shared__ float red[64];
  const int c = blockIdx.x;
  const float* p = partial + static_cast<size_t>(c) * nparts * 2;
  float l1 = 0.0f, l2 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int j = threadIdx.x; j < nblk; j += blockDim.x) {
    l1 += p[2 * (poff + j)];
    l2 += p[2 * (poff + j) + 1];
  }
  block_sum2_shfl(l1, l2, red);
  __syncthreads();  // warp 0 has read red
  for (int j = threadIdx.x; j < nparts; j += blockDim.x) {
    s1 += p[2 * j];
    s2 += p[2 * j + 1];
  }
  block_sum2_shfl(s1, s2, red);
  if (threadIdx.x == 0) {
    const float gm = args.gamma[c];
    dbeta[c] = l1;
    dgamma[c] = l2;
    k[c] = gm * s1 / ntot;
    k[C + c] = gm * s2 / ntot;
    k[2 * C + c] =
        args.g_mu[c] / ntot - 2.0f * args.g_var[c] * args.mu[c] / ntot;
    k[3 * C + c] = 2.0f * args.g_var[c] / ntot;
  }
}

// Window geometry: pooled index -> (plane, i, j), the channel of the plane
// and the offset of the window's top-left input element.
struct Window {
  long long plane;
  int c;
  long long in_off;
};

__device__ __forceinline__ Window window_of(long long idx, int C, int T,
                                            int H, int W) {
  const int w2 = W / 2;
  const long long hw2 = static_cast<long long>(H / 2) * w2;
  Window win;
  win.plane = idx / hw2;
  const int rem = static_cast<int>(idx - win.plane * hw2);
  const int i = rem / w2;
  const int j = rem - i * w2;
  win.c = static_cast<int>((win.plane / T) % C);
  win.in_off = win.plane * H * W + static_cast<long long>(2 * i) * W + 2 * j;
  return win;
}

struct Affine {
  const float* gamma;
  const float* beta;
  const float* mu;
  const float* rstd;
};

// The two values of a window row at p (an even offset), upcast: one pair
// load (float2, bf16x2, half2) when `vec` (the base pointer aligned to two
// values), else one value a load.
__device__ __forceinline__ float2 load_pair(const float* p, bool vec) {
  return vec ? *reinterpret_cast<const float2*>(p) : make_float2(p[0], p[1]);
}

__device__ __forceinline__ float2 load_pair(const bf16* p, bool vec) {
  return vec ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p))
             : make_float2(__bfloat162float(p[0]), __bfloat162float(p[1]));
}

__device__ __forceinline__ float2 load_pair(const f16* p, bool vec) {
  return vec ? __half22float2(*reinterpret_cast<const __half2*>(p))
             : make_float2(__half2float(p[0]), __half2float(p[1]));
}

__device__ __forceinline__ void store_pair(float* p, float a, float b,
                                           bool vec) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    p[1] = b;
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b,
                                           bool vec) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    p[1] = __float2bfloat16_rn(b);
  }
}

__device__ __forceinline__ void store_pair(f16* p, float a, float b,
                                           bool vec) {
  if (vec) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
  } else {
    p[0] = __float2half_rn(a);
    p[1] = __float2half_rn(b);
  }
}

// A window's max if gamma > 0, else its min, from its two rows.
__device__ __forceinline__ float pool2x2(float2 r0, float2 r1, float gm) {
  return gm > 0.0f ? fmaxf(fmaxf(r0.x, r0.y), fmaxf(r1.x, r1.y))
                   : fminf(fminf(r0.x, r0.y), fminf(r1.x, r1.y));
}

// leaky(gamma * (s - mu) * rstd + beta), rounded as written (one product,
// then one fused multiply-add), so both apply kernels give the same bits.
__device__ __forceinline__ float bn_leaky(float s, float gm, float mu,
                                          float rstd, float bt) {
  const float o = __fmaf_rn(__fmul_rn(gm, s - mu), rstd, bt);
  return o >= 0.0f ? o : kSlope * o;
}

// apply's scalar path: one thread per window.
template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ y, Affine aff, T* __restrict__ out,
             T* __restrict__ sel, long long n_pool, int C, int T_, int H,
             int W, bool vec) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_pool) return;
  const Window win = window_of(idx, C, T_, H, W);
  const float gm = aff.gamma[win.c];
  const float s = pool2x2(load_pair(y + win.in_off, vec),
                          load_pair(y + win.in_off + W, vec), gm);
  out[idx] = from_f<T>(
      bn_leaky(s, gm, aff.mu[win.c], aff.rstd[win.c], aff.beta[win.c]));
  sel[idx] = from_f<T>(s);  // exact: s is one of the window's values
}

// The 8 values of 4 adjacent windows' row at p (16-byte aligned), upcast.
__device__ __forceinline__ void load_row8(const float* p, float (&v)[8]) {
  const uint4 a = ld16(p);
  const uint4 b = ld16(p + 4);
  const unsigned u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __uint_as_float(u[e]);
}

__device__ __forceinline__ void load_row8(const bf16* p, float (&v)[8]) {
  const uint4 a = ld16(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load_row8(const f16* p, float (&v)[8]) {
  const uint4 a = ld16(p);
  const __half2* h = reinterpret_cast<const __half2*>(&a);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __half22float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

// 4 values to p (aligned to 4 values) as one store.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned*>(&lo);
  q.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

__device__ __forceinline__ void store4(f16* p, const float (&v)[4]) {
  const __half2 lo = __floats2half2_rn(v[0], v[1]);
  const __half2 hi = __floats2half2_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned*>(&lo);
  q.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

// apply's vector path: grid (planes, bands), block (bx, by). Block (p, b)
// takes the pooled rows [b*band, min(H/2, (b+1)*band)) of plane p = (n*C +
// c)*T + t; its threads step along a row by bx groups of 4 windows and
// across rows by by. Needs W/2 a multiple of 4, y 16-byte aligned and out
// and sel aligned to 4 values (the launcher checks). Same arithmetic as
// apply_kernel, so the same bits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_vec_kernel(const T* __restrict__ y, Affine aff, T* __restrict__ out,
                 T* __restrict__ sel, int C, int T_, int H, int W,
                 int band) {
  const long long plane = blockIdx.x;
  const int c = static_cast<int>((plane / T_) % C);
  const float gm = aff.gamma[c], mu = aff.mu[c], rstd = aff.rstd[c],
              bt = aff.beta[c];
  const int h2 = H / 2, w2 = W / 2, groups = w2 / 4;
  const T* yp = y + plane * H * W;
  const long long pooled = plane * h2 * w2;
  T* op = out + pooled;
  T* sp = sel + pooled;
  const int row_end = min(h2, static_cast<int>(blockIdx.y + 1) * band);
  for (int r = blockIdx.y * band + threadIdx.y; r < row_end;
       r += blockDim.y) {
    const T* row = yp + static_cast<long long>(2 * r) * W;
    for (int q = threadIdx.x; q < groups; q += blockDim.x) {
      float a[8], b[8];
      load_row8(row + 8 * q, a);
      load_row8(row + W + 8 * q, b);
      float o[4], s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = pool2x2(make_float2(a[2 * j], a[2 * j + 1]),
                       make_float2(b[2 * j], b[2 * j + 1]), gm);
        o[j] = bn_leaky(s[j], gm, mu, rstd, bt);
      }
      const long long at = static_cast<long long>(r) * w2 + 4 * q;
      store4(op + at, o);
      store4(sp + at, s);  // exact: each s is one of its window's values
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dy_kernel(const T* __restrict__ y, const T* __restrict__ g,
          const T* __restrict__ sel, Affine aff,
          const float* __restrict__ k, T* __restrict__ dy,
          long long n_pool, int C, int T_, int H, int W, bool vec) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_pool) return;
  const Window win = window_of(idx, C, T_, H, W);
  const int c = win.c;
  const float mu = aff.mu[c];
  const float rstd = aff.rstd[c];
  const float gm = aff.gamma[c];
  const float s = to_f(sel[idx]);
  const float o = bn_out(bn_xhat(s, mu, rstd), gm, aff.beta[c]);
  const float dsg = to_f(g[idx]) * (o >= 0.0f ? 1.0f : kSlope) * gm;
  const float k0 = k[c], k1 = k[C + c], k2 = k[2 * C + c], k3 = k[3 * C + c];
  const float2 r0 = load_pair(y + win.in_off, vec);
  const float2 r1 = load_pair(y + win.in_off + W, vec);
  float v[4] = {r0.x, r0.y, r1.x, r1.y};  // phase order 2*py + px
  bool found = false;
#pragma unroll
  for (int ph = 0; ph < 4; ++ph) {
    const bool hit = !found && v[ph] == s;
    found = found || hit;
    const float dxhat = hit ? dsg : 0.0f;
    const float xhat = (v[ph] - mu) * rstd;
    v[ph] = rstd * (dxhat - k0 - xhat * k1) + k2 + v[ph] * k3;
  }
  store_pair(dy + win.in_off, v[0], v[1], vec);
  store_pair(dy + win.in_off + W, v[2], v[3], vec);
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

bool bad_geometry(int B, int C, int T, int H, int W) {
  return B < 1 || C < 1 || T < 1 || H < 2 || W < 2 || H % 2 || W % 2;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// The launchers' dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.
// with_io(dtype, f) calls f(Io<T>{}) with T the code's IO type.
template <typename T>
struct Io {
  using type = T;
};
template <typename F>
int with_io(int dtype, F&& f) {
  if (dtype == 0) return f(Io<float>{});
  if (dtype == 1) return f(Io<bf16>{});
  return f(Io<f16>{});
}

// The partials launch at slots (pstride, poff), then, with `finish`, the
// one-block-a-channel combine over nblk partials (the fused route).
template <typename T>
int stats_impl(const void* y, float* pf, void* mu, void* var, void* rstd,
               int C, long long L, long long n, int nblk, long long chunk,
               cudaStream_t s, int pstride, int poff, bool finish) {
  constexpr int kVec = 16 / sizeof(T);
  const T* yt = static_cast<const T*>(y);
  // 16-byte loads need y 16-byte aligned and L and chunk multiples of the
  // values a load holds; otherwise one value a load
  if (aligned(y, 16) && L % kVec == 0 && chunk % kVec == 0) {
    partials_kernel<kVec, StatsOp, T><<<dim3(nblk, C), kThreads, 0, s>>>(
        yt, nullptr, StatsOp{}, pf, C, L, n, chunk, pstride, poff);
  } else {
    partials_kernel<1, StatsOp, T><<<dim3(nblk, C), kThreads, 0, s>>>(
        yt, nullptr, StatsOp{}, pf, C, L, n, chunk, pstride, poff);
  }
  int e = static_cast<int>(cudaGetLastError());
  if (e || !finish) return e;
  stats_combine_kernel<<<C, kThreads, 0, s>>>(
      pf, nblk, static_cast<float>(n), static_cast<float*>(mu),
      static_cast<float*>(var), static_cast<float*>(rstd));
  return static_cast<int>(cudaGetLastError());
}

// apply on the plan the wrapper made (ops/cuda_epilogue.py:apply_plan):
// windows 4, the vector path, grid (planes, bands) of blocks (bx, by), each
// taking `band` pooled rows; windows 1, the scalar path, grid gx of blocks
// bx, with pair loads when `pairs`. A plan the geometry or the pointers do
// not allow is refused.
template <typename T>
int apply_impl(const void* y, Affine aff, void* out, void* sel, int B, int C,
               int T_, int H, int W, int windows, int pairs, dim3 grid,
               dim3 block, int band, cudaStream_t s) {
  const long long planes = static_cast<long long>(B) * C * T_;
  const long long n_pool = planes * (H / 2) * (W / 2);
  const unsigned four = 4 * sizeof(T);  // the bytes of 4 values
  const bool fits = block.x >= 1 && block.y >= 1 && block.z == 1 &&
                    block.x * block.y <= kThreads && grid.z == 1;
  if (windows == 4 && fits && (W / 2) % 4 == 0 && aligned(y, 16) &&
      aligned(out, four) && aligned(sel, four) && grid.x == planes &&
      band >= 1 && grid.y >= 1 && grid.y <= 65535 &&
      static_cast<long long>(grid.y) * band >= H / 2) {
    apply_vec_kernel<T><<<grid, block, 0, s>>>(
        static_cast<const T*>(y), aff, static_cast<T*>(out),
        static_cast<T*>(sel), C, T_, H, W, band);
  } else if (windows == 1 && fits && block.y == 1 && grid.y == 1 &&
             static_cast<long long>(grid.x) * block.x >= n_pool &&
             (!pairs || aligned(y, 2 * sizeof(T)))) {
    apply_kernel<T><<<grid, block, 0, s>>>(
        static_cast<const T*>(y), aff, static_cast<T*>(out),
        static_cast<T*>(sel), n_pool, C, T_, H, W, pairs != 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_reduce_impl(const void* g, const void* sel, BwdArgs args, float* pf,
                    unsigned* count, float* dgamma, float* dbeta, float* k,
                    int C, long long L, long long n, long long chunk,
                    int nblk, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* gt = static_cast<const T*>(g);
  const T* st = static_cast<const T*>(sel);
  const dim3 grid(nblk, C);
  // 16-byte loads need g and sel 16-byte aligned and L and chunk multiples
  // of the values a load holds; otherwise one value a load
  if (aligned(g, 16) && aligned(sel, 16) && L % kVec == 0 &&
      chunk % kVec == 0) {
    bwd_partials_kernel<kVec, T><<<grid, kThreads, 0, s>>>(
        gt, st, args, pf, count, dgamma, dbeta, k, C, L, n, chunk, nblk);
  } else {
    bwd_partials_kernel<1, T><<<grid, kThreads, 0, s>>>(
        gt, st, args, pf, count, dgamma, dbeta, k, C, L, n, chunk, nblk);
  }
  return static_cast<int>(cudaGetLastError());
}

// The split route's bwd partials: this rank's g and sel into its slots
// (pstride, poff) of partial, no finish.
template <typename T>
int bwd_partials_impl(const void* g, const void* sel, BwdArgs args,
                      float* pf, int C, long long L, long long n,
                      long long chunk, int nblk, int pstride, int poff,
                      cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* gt = static_cast<const T*>(g);
  const T* st = static_cast<const T*>(sel);
  const dim3 grid(nblk, C);
  if (aligned(g, 16) && aligned(sel, 16) && L % kVec == 0 &&
      chunk % kVec == 0) {
    bwd_partials_kernel<kVec, T, false><<<grid, kThreads, 0, s>>>(
        gt, st, args, pf, nullptr, nullptr, nullptr, nullptr, C, L, n, chunk,
        nblk, pstride, poff);
  } else {
    bwd_partials_kernel<1, T, false><<<grid, kThreads, 0, s>>>(
        gt, st, args, pf, nullptr, nullptr, nullptr, nullptr, C, L, n, chunk,
        nblk, pstride, poff);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dy_impl(const void* y, const void* g, const void* sel, Affine aff,
            const void* k, void* dy, long long n_pool, int C, int T_, int H,
            int W, cudaStream_t s) {
  dy_kernel<T><<<blocks_for(n_pool), kThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(g),
      static_cast<const T*>(sel), aff, static_cast<const float*>(k),
      static_cast<T*>(dy), n_pool, C, T_, H, W,
      aligned(y, 2 * sizeof(T)) && aligned(dy, 2 * sizeof(T)));
  return static_cast<int>(cudaGetLastError());
}

bool bad_dtype(int dtype) { return dtype < 0 || dtype > 2; }

}  // namespace

// In every launcher, `dtype` is the IO type of y, out, sel, g and dy: 0 fp32,
// 1 bf16, 2 fp16. Each returns the first non-zero cudaError_t, else 0.

// Batch statistics of y [B, C, T, H, W]: mu, var, rstd [C] fp32. partial is
// an fp32 [C, nblk, 2] scratch; chunk * nblk >= B*T*H*W, chunk a multiple of
// 4 (of 8 for bf16's and fp16's 16-byte loads). Two kernels on `stream`.
extern "C" int maavss_epilogue_stats(const void* y, void* partial, void* mu,
                                     void* var, void* rstd, int B, int C,
                                     int T, int H, int W, int nblk,
                                     long long chunk, int dtype,
                                     void* stream) {
  const long long L = static_cast<long long>(T) * H * W;
  const long long n = L * B;
  if (bad_geometry(B, C, T, H, W) || bad_dtype(dtype) || nblk < 1 ||
      chunk % 4 || chunk * nblk < n || C > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(partial);
  return with_io(dtype, [&](auto io) {
    using IO = typename decltype(io)::type;
    return stats_impl<IO>(y, pf, mu, var, rstd, C, L, n, nblk, chunk, s, nblk,
                          0, true);
  });
}

// The split route of the statistics, for a data group's global batch.
// maavss_epilogue_stats_partials: the partials of this rank's y into its
// slots of partial [C][pstride][2], block j at poff + j (pstride >= poff +
// nblk); one kernel. The caller fills the other slots (every rank's, by a
// collective); maavss_epilogue_stats_finish then sums a channel's first
// nparts partials in the fused combine's fixed order over `ntot` values
// into mu, var, rstd; one kernel of C blocks.
extern "C" int maavss_epilogue_stats_partials(
    const void* y, void* partial, int B, int C, int T, int H, int W,
    int nblk, long long chunk, int pstride, int poff, int dtype,
    void* stream) {
  const long long L = static_cast<long long>(T) * H * W;
  const long long n = L * B;
  if (bad_geometry(B, C, T, H, W) || bad_dtype(dtype) || nblk < 1 ||
      chunk % 4 || chunk * nblk < n || C > 65535 || poff < 0 ||
      pstride < poff + nblk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(partial);
  return with_io(dtype, [&](auto io) {
    using IO = typename decltype(io)::type;
    return stats_impl<IO>(y, pf, nullptr, nullptr, nullptr, C, L, n, nblk,
                          chunk, s, pstride, poff, false);
  });
}

extern "C" int maavss_epilogue_stats_finish(const void* partial, int nparts,
                                            long long ntot, void* mu,
                                            void* var, void* rstd, int C,
                                            void* stream) {
  if (nparts < 1 || ntot < 1 || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stats_combine_kernel<<<C, kThreads, 0, s>>>(
      static_cast<const float*>(partial), nparts, static_cast<float>(ntot),
      static_cast<float*>(mu), static_cast<float*>(var),
      static_cast<float*>(rstd));
  return static_cast<int>(cudaGetLastError());
}

// out, sel [B, C, T, H/2, W/2] from y and the per-channel gamma, beta, mu,
// rstd [C], on the plan (windows, pairs, grid, block, band) of
// ops/cuda_epilogue.py:apply_plan; cudaErrorInvalidValue for a plan the
// geometry or the pointers do not allow. One kernel on `stream`.
extern "C" int maavss_epilogue_apply(const void* y, const void* gamma,
                                     const void* beta, const void* mu,
                                     const void* rstd, void* out, void* sel,
                                     int B, int C, int T, int H, int W,
                                     int dtype, int windows, int pairs,
                                     int gx, int gy, int bx, int by, int band,
                                     void* stream) {
  if (bad_geometry(B, C, T, H, W) || bad_dtype(dtype) || gx < 1 || gy < 1 ||
      bx < 1 || by < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Affine aff{static_cast<const float*>(gamma), static_cast<const float*>(beta),
             static_cast<const float*>(mu), static_cast<const float*>(rstd)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(gx, gy), block(bx, by);
  return with_io(dtype, [&](auto io) {
    using IO = typename decltype(io)::type;
    return apply_impl<IO>(y, aff, out, sel, B, C, T, H, W, windows, pairs,
                          grid, block, band, s);
  });
}

// Pooled-domain sums of the backward: dgamma = S2, dbeta = S1 [C] and the
// constants k [4, C] (fp32), from g and sel [B, C, T, H/2, W/2] and the
// cotangents g_mu, g_var [C]. partial is an fp32 [C, nblk, 2] scratch;
// chunk * nblk >= B*T*(H/2)*(W/2); count is C unsigned counters, all 0,
// left 0. One kernel on `stream`.
extern "C" int maavss_epilogue_bwd_reduce(
    const void* g, const void* sel, const void* gamma, const void* beta,
    const void* mu, const void* rstd, const void* g_mu, const void* g_var,
    void* partial, void* count, void* dgamma, void* dbeta, void* k, int B,
    int C, int T, int H, int W, int nblk, long long chunk, int dtype,
    void* stream) {
  const long long L = static_cast<long long>(T) * (H / 2) * (W / 2);
  const long long n = L * B;
  if (bad_geometry(B, C, T, H, W) || bad_dtype(dtype) || nblk < 1 ||
      chunk < 1 || chunk * nblk < n || C > 65535 || count == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs args{static_cast<const float*>(gamma),
               static_cast<const float*>(beta),
               static_cast<const float*>(mu),
               static_cast<const float*>(rstd),
               static_cast<const float*>(g_mu),
               static_cast<const float*>(g_var)};
  float* pf = static_cast<float*>(partial);
  unsigned* cnt = static_cast<unsigned*>(count);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  float* kk = static_cast<float*>(k);
  return with_io(dtype, [&](auto io) {
    using IO = typename decltype(io)::type;
    return bwd_reduce_impl<IO>(g, sel, args, pf, cnt, dg, db, kk, C, L, n,
                               chunk, nblk, s);
  });
}

// The split route of the backward reduce, for a data group's global batch.
// maavss_epilogue_bwd_partials: the pooled-domain partial sums (S1, S2) of
// this rank's g and sel into its slots of partial [C][pstride][2], block j
// at poff + j (pstride >= poff + nblk); one kernel, no counter. The caller
// fills the other slots (every rank's) and sums g_mu and g_var over the
// group; maavss_epilogue_bwd_finish (C blocks) then forms k [4, C] from a
// channel's first nparts partials over `ntot` pooled values, and dgamma,
// dbeta from its own [poff, poff + nblk) alone.
extern "C" int maavss_epilogue_bwd_partials(
    const void* g, const void* sel, const void* gamma, const void* beta,
    const void* mu, const void* rstd, void* partial, int B, int C, int T,
    int H, int W, int nblk, long long chunk, int pstride, int poff, int dtype,
    void* stream) {
  const long long L = static_cast<long long>(T) * (H / 2) * (W / 2);
  const long long n = L * B;
  if (bad_geometry(B, C, T, H, W) || bad_dtype(dtype) || nblk < 1 ||
      chunk < 1 || chunk * nblk < n || C > 65535 || poff < 0 ||
      pstride < poff + nblk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs args{static_cast<const float*>(gamma),
               static_cast<const float*>(beta),
               static_cast<const float*>(mu),
               static_cast<const float*>(rstd), nullptr, nullptr};
  float* pf = static_cast<float*>(partial);
  return with_io(dtype, [&](auto io) {
    using IO = typename decltype(io)::type;
    return bwd_partials_impl<IO>(g, sel, args, pf, C, L, n, chunk, nblk,
                                 pstride, poff, s);
  });
}

extern "C" int maavss_epilogue_bwd_finish(
    const void* partial, int nparts, int poff, int nblk, const void* gamma,
    const void* mu, const void* g_mu, const void* g_var, void* dgamma,
    void* dbeta, void* k, int C, long long ntot, void* stream) {
  if (nparts < 1 || nblk < 1 || poff < 0 || poff + nblk > nparts ||
      C < 1 || ntot < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs args{static_cast<const float*>(gamma), nullptr,
               static_cast<const float*>(mu), nullptr,
               static_cast<const float*>(g_mu),
               static_cast<const float*>(g_var)};
  bwd_finish_kernel<<<C, kThreads, 0, s>>>(
      static_cast<const float*>(partial), nparts, poff, nblk, args,
      static_cast<float*>(dgamma), static_cast<float*>(dbeta),
      static_cast<float*>(k), C, static_cast<float>(ntot));
  return static_cast<int>(cudaGetLastError());
}

// dy [B, C, T, H, W] from y, g and sel [B, C, T, H/2, W/2], the per-channel
// vectors and the fp32 constants k [4, C] of maavss_epilogue_bwd_reduce. One
// kernel on `stream`.
extern "C" int maavss_epilogue_bwd_dy(const void* y, const void* g,
                                      const void* sel, const void* gamma,
                                      const void* beta, const void* mu,
                                      const void* rstd, const void* k,
                                      void* dy, int B, int C, int T, int H,
                                      int W, int dtype, void* stream) {
  if (bad_geometry(B, C, T, H, W) || bad_dtype(dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_pool =
      static_cast<long long>(B) * C * T * (H / 2) * (W / 2);
  Affine aff{static_cast<const float*>(gamma), static_cast<const float*>(beta),
             static_cast<const float*>(mu), static_cast<const float*>(rstd)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_io(dtype, [&](auto io) {
    using IO = typename decltype(io)::type;
    return dy_impl<IO>(y, g, sel, aff, k, dy, n_pool, C, T, H, W, s);
  });
}
