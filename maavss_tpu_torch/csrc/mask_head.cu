// K4's complex-mask product fused into the `a_fc1` head (the --mask_head
// audio head of both model families), forward and backward, fp32.
//
// Replaces, on the --mask_head path, the TPU kernel of
// maavss_tpu/ops/pallas_kernels.py: _mask_mul_kernel (the pl.pallas_call in
// _mask_mul) with the head's matrix product in front of it:
//
//   out = stft (x) (h W^T + b)
//
// h [M, K] (the fused latent), W [2P, K] (nn.Linear's [out, in]), b [2P] or
// none, stft a planar [M, 2, T, F] view with P = T*F; (x) is the complex
// product on planar (re, im): column j < P of the head is the real part of
// bin j (row t = j / F, bin f = j % F), column j + P its imaginary part.
// The JAX package leaves this multiply to XLA, which fuses it into the
// head's matmul; here the head's own kernel does it in its epilogue, and
// the mask never reaches device memory.
//
// Forward (head_fwd_kernel): a block owns a tile of kPairs column pairs
// (j, j + P), i.e. 2 * kPairs rows of W, and BM rows of h (BM = 8, 16, 32
// or 64 by M; a larger M takes more blocks along y). It streams its W rows
// and h's rows in K-stages of kBk floats through a kStages-deep ring of
// 16-byte cp.async copies. A lane holds one pair and a warp BM / 8 rows of
// h: per 4 values of K two 16-byte shared loads of W (conflict-free: rows
// padded to kLd floats) and one broadcast load of h per row feed 8 FMAs per
// row, summed in K order. The epilogue adds the bias and multiplies by the
// STFT, read in place through its (item, plane, row) strides, and writes
// the contiguous planar output; lanes hold consecutive bins, so the STFT
// reads and the stores are coalesced.
//
// Backward (head_bwd_kernel, then head_bwd_reduce_kernel): the same pair
// tiles, each split along K over a few blocks (a grid of ~4 blocks an SM).
// dA = g (x) conj(stft) is formed in shared memory from the cotangent and
// the STFT, never stored. A block writes dW of its own rows and K range
// whole (dW[r, k] = sum_m dA[m, r] h[m, k], m in order), the first split db
// (sum_m dA[m, r]), and its share of d_h = dA W over its 2 * kPairs rows
// into a partial [M, K range]; the second kernel sums the pair tiles'
// partials in one fixed order (8 warps over contiguous tile ranges, then
// the warps in order). No atomics, nothing to reset: two calls and a
// CUDA-graph replay give the same bits.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32): at the fusion flagship
// (K = 512, 2P = 16384) W is 33.5 MB, so the forward is bound by W's bytes
// up to M ~ 32 (~10.4 us; 4 M K 2P FLOPs reach it at M ~ 40) and by its
// FMAs above (M = 256: ~64 us); the backward by reading W and writing dW
// (~20 us) at M <= 32. The design reads each W byte once per BM rows of h,
// keeps the K-stages in flight to cover the memory latency, and does the
// mask product where the head's result already sits in registers: one
// launch forward in place of the head's GEMM and K4's launch, two backward
// in place of K4's conjugate launch, two GEMMs and the bias reduction.
// Products and sums of the complex product are rounded one by one
// (__fmul_rn / __fadd_rn / __fsub_rn, never contracted), as K4 and the plain
// PyTorch version round them; the dot products' order differs from cuBLAS'.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 32;          // column pairs (j, j + P) a block owns
constexpr int kRows = 2 * kPairs;   // W rows a block owns
// forward
constexpr int kBk = 32;             // K per stage
constexpr int kLd = kBk + 4;        // padded shared row, floats
constexpr int kStages = 5;
// backward
constexpr int kKc = 64;             // K per stage
constexpr int kMc = 32;             // rows of h per stage
constexpr int kLdK = kKc + 4;
constexpr int kLdA = kRows + 4;
constexpr int kBwdSmem = (kRows * kLdK + kMc * kLdK + kMc * kLdA) * 4;
constexpr int kBwdBlocks = 4 * 132;  // blocks in flight: 4 an H100 SM

struct Planar {
  const float* p;  // plane 0 of item 0, row 0
  long long bs, ps, rs;
};

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// W's row for tile row r of the pair tile starting at j0: r < kPairs the
// real part of pair j0 + r, else the imaginary part of pair j0 + r -
// kPairs; -1 past P.
__device__ __forceinline__ long long w_row(int r, int j0, int p) {
  const int j = j0 + (r & (kPairs - 1));
  if (j >= p) return -1;
  return r < kPairs ? j : static_cast<long long>(p) + j;
}

__device__ __forceinline__ void fma4(float& acc, const float4& a,
                                     const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
head_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ bias, Planar s,
                float* __restrict__ out, float* __restrict__ mask, int m_rows,
                int k_len, int p, int f_len) {
  constexpr int kTm = BM / kWarps;  // rows of h a warp holds
  constexpr int kStage = (BM + kRows) * kLd;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kPairs;
  const int m0 = blockIdx.y * BM;
  const int nk = (k_len + kBk - 1) / kBk;

  auto load = [&](int slot, int kt) {
    float* hd = smem + slot * kStage;
    float* wd = hd + BM * kLd;
    const int k0 = kt * kBk;
    for (int c = tid; c < (BM + kRows) * (kBk / 4); c += kThreads) {
      const int row = c / (kBk / 4);
      const int col = (c % (kBk / 4)) * 4;
      const int k = k0 + col;
      if (row < BM) {
        const int m = m0 + row;
        const bool ok = m < m_rows && k < k_len;
        cp16(hd + row * kLd + col,
             ok ? h + static_cast<long long>(m) * k_len + k : h, ok);
      } else {
        const int r = row - BM;
        const long long wr = w_row(r, j0, p);
        const bool ok = wr >= 0 && k < k_len;
        cp16(wd + r * kLd + col, ok ? w + wr * k_len + k : w, ok);
      }
    }
  };

  float acc_r[kTm], acc_i[kTm];
#pragma unroll
  for (int i = 0; i < kTm; ++i) acc_r[i] = acc_i[i] = 0.0f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free again
    const int next = kt + kStages - 1;
    if (next < nk) load(next % kStages, next);
    cp_commit();
    const float* hd = smem + (kt % kStages) * kStage;
    const float* wd = hd + BM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBk; kk += 4) {
      const float4 wr = *reinterpret_cast<const float4*>(wd + lane * kLd + kk);
      const float4 wi =
          *reinterpret_cast<const float4*>(wd + (kPairs + lane) * kLd + kk);
#pragma unroll
      for (int i = 0; i < kTm; ++i) {
        const float4 hv = *reinterpret_cast<const float4*>(
            hd + (warp + kWarps * i) * kLd + kk);
        fma4(acc_r[i], hv, wr);
        fma4(acc_i[i], hv, wi);
      }
    }
  }
  cp_wait<0>();

  const int j = j0 + lane;
  if (j >= p) return;
  const int t = j / f_len;
  const int f = j - t * f_len;
  const float b_r = bias ? __ldg(bias + j) : 0.0f;
  const float b_i = bias ? __ldg(bias + p + j) : 0.0f;
#pragma unroll
  for (int i = 0; i < kTm; ++i) {
    const int m = m0 + warp + kWarps * i;
    if (m >= m_rows) break;
    const float mr = bias ? __fadd_rn(acc_r[i], b_r) : acc_r[i];
    const float mi = bias ? __fadd_rn(acc_i[i], b_i) : acc_i[i];
    const float* sp = s.p + m * s.bs + t * s.rs + f;
    const float sr = __ldg(sp), si = __ldg(sp + s.ps);
    float* o = out + static_cast<long long>(m) * 2 * p;
    o[j] = __fsub_rn(__fmul_rn(sr, mr), __fmul_rn(si, mi));
    o[p + j] = __fadd_rn(__fmul_rn(sr, mi), __fmul_rn(si, mr));
    if (mask) {
      float* mo = mask + static_cast<long long>(m) * 2 * p;
      mo[j] = mr;
      mo[p + j] = mi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
head_bwd_kernel(Planar g, Planar s, const float* __restrict__ h,
                const float* __restrict__ w, float* __restrict__ dw,
                float* __restrict__ db, float* __restrict__ part, int m_rows,
                int k_len, int p, int f_len, int k_per) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                 // [kRows][kLdK]: W's rows, one K-stage
  float* hs = ws + kRows * kLdK;    // [kMc][kLdK]: h, one K-stage, kMc rows
  float* as = hs + kMc * kLdK;      // [kMc][kLdA]: dA of the tile's rows
  const int tid = threadIdx.x;
  const int kq = tid & 15;          // the thread's 4 values of K
  const int rq = tid >> 4;          // dW: rows rq + 16 i; d_h: rows rq + 16 i
  const int j0 = blockIdx.x * kPairs;
  float* my_part = part + static_cast<long long>(blockIdx.x) * m_rows * k_len;
  float db_acc = 0.0f;              // thread tid < kRows: tile row tid
  const int k_begin = blockIdx.y * k_per;
  const int k_end = min(k_len, k_begin + k_per);
  const bool db_block = db != nullptr && blockIdx.y == 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kKc) {
    for (int c = tid; c < kRows * (kKc / 4); c += kThreads) {
      const int row = c / (kKc / 4), col = (c % (kKc / 4)) * 4;
      const int k = k0 + col;
      const long long wr = w_row(row, j0, p);
      const bool ok = wr >= 0 && k < k_len;
      cp16(ws + row * kLdK + col, ok ? w + wr * k_len + k : w, ok);
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

    for (int mc = 0; mc < m_rows; mc += kMc) {
      const int mn = min(kMc, m_rows - mc);
      for (int c = tid; c < kMc * (kKc / 4); c += kThreads) {
        const int row = c / (kKc / 4), col = (c % (kKc / 4)) * 4;
        const int m = mc + row, k = k0 + col;
        const bool ok = row < mn && k < k_len;
        cp16(hs + row * kLdK + col,
             ok ? h + static_cast<long long>(m) * k_len + k : h, ok);
      }
      cp_commit();
      // dA = g (x) conj(stft), rounded as the plain conjugate product
      for (int e = tid; e < kMc * kPairs; e += kThreads) {
        const int mi = e / kPairs, q = e % kPairs;
        const int m = mc + mi, j = j0 + q;
        float ar = 0.0f, ai = 0.0f;
        if (mi < mn && j < p) {
          const int t = j / f_len, f = j - t * f_len;
          const float* gp = g.p + m * g.bs + t * g.rs + f;
          const float* sp = s.p + m * s.bs + t * s.rs + f;
          const float gr = __ldg(gp), gi = __ldg(gp + g.ps);
          const float sr = __ldg(sp), si = -__ldg(sp + s.ps);
          ar = __fsub_rn(__fmul_rn(gr, sr), __fmul_rn(gi, si));
          ai = __fadd_rn(__fmul_rn(gr, si), __fmul_rn(gi, sr));
        }
        as[mi * kLdA + q] = ar;
        as[mi * kLdA + kPairs + q] = ai;
      }
      cp_wait<0>();
      __syncthreads();
      if (db_block && k0 == k_begin && tid < kRows) {
        for (int mi = 0; mi < mn; ++mi) db_acc += as[mi * kLdA + tid];
      }
      // dW of rows rq + 16 i at K 4 kq .. 4 kq + 3, summed over m in order
      for (int mi = 0; mi < mn; ++mi) {
        const float4 hv =
            *reinterpret_cast<const float4*>(hs + mi * kLdK + 4 * kq);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = as[mi * kLdA + rq + 16 * i];
          acc[i][0] = fmaf(a, hv.x, acc[i][0]);
          acc[i][1] = fmaf(a, hv.y, acc[i][1]);
          acc[i][2] = fmaf(a, hv.z, acc[i][2]);
          acc[i][3] = fmaf(a, hv.w, acc[i][3]);
        }
      }
      // this block's share of d_h at rows mc + rq + 16 i, over its W rows
      float d[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) d[i][c] = 0.0f;
      for (int r = 0; r < kRows; ++r) {
        const float4 wv =
            *reinterpret_cast<const float4*>(ws + r * kLdK + 4 * kq);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float a = as[(rq + 16 * i) * kLdA + r];
          d[i][0] = fmaf(a, wv.x, d[i][0]);
          d[i][1] = fmaf(a, wv.y, d[i][1]);
          d[i][2] = fmaf(a, wv.z, d[i][2]);
          d[i][3] = fmaf(a, wv.w, d[i][3]);
        }
      }
      const int k = k0 + 4 * kq;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mi = rq + 16 * i;
        if (mi < mn && k < k_len) {
          *reinterpret_cast<float4*>(
              my_part + static_cast<long long>(mc + mi) * k_len + k) =
              make_float4(d[i][0], d[i][1], d[i][2], d[i][3]);
        }
      }
      __syncthreads();  // hs and as are refilled next
    }
    const int k = k0 + 4 * kq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long wr = w_row(rq + 16 * i, j0, p);
      if (wr >= 0 && k < k_len) {
        *reinterpret_cast<float4*>(dw + wr * k_len + k) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
  if (db_block && tid < kRows) {
    const long long wr = w_row(tid, j0, p);
    if (wr >= 0) db[wr] = db_acc;
  }
}

// d_h = sum over the nb blocks' partials, in one fixed order: a block takes
// 32 float4 columns of [M, K]; warp w sums blocks [w nb / 8, (w+1) nb / 8)
// in order, then warp 0 adds the warps' sums in order.
__global__ void __launch_bounds__(kThreads)
head_bwd_reduce_kernel(const float4* __restrict__ part, float4* __restrict__ dh,
                       int nb, long long cols) {
  __shared__ float4 sums[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long col = static_cast<long long>(blockIdx.x) * 32 + lane;
  const int b0 = warp * nb / kWarps, b1 = (warp + 1) * nb / kWarps;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (col < cols) {
    for (int b = b0; b < b1; ++b) {
      const float4 v = __ldg(part + b * cols + col);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float4 t = sums[0][lane];
    for (int i = 1; i < kWarps; ++i) {
      const float4 v = sums[i][lane];
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    dh[col] = t;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int BM>
int launch_fwd(const float* h, const float* w, const float* bias, Planar s,
               float* out, float* mask, int m, int k, int p, int f,
               cudaStream_t stream) {
  constexpr int smem = kStages * (BM + kRows) * kLd * 4;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        head_fwd_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((p + kPairs - 1) / kPairs, (m + BM - 1) / BM);
  head_fwd_kernel<BM><<<grid, kThreads, smem, stream>>>(h, w, bias, s, out,
                                                        mask, m, k, p, f);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int m, int k, int t, int f) {
  return m >= 1 && k >= 4 && k % 4 == 0 && t >= 1 && f >= 1 &&
         static_cast<long long>(t) * f <= 0x3fffffffLL;
}

}  // namespace

// out [M, 2, T, F] = stft (x) (h W^T + b), and the mask h W^T + b into
// mask [M, 2P] when mask is not null. h [M, K] and W [2P, K] contiguous and
// 16-byte aligned, K a multiple of 4; bias [2P] or null; stft planar
// [M, 2, T, F] given by its item / plane / row strides in floats (last axis
// contiguous). Returns the cudaError_t of the launch.
extern "C" int maavss_mask_head_fwd(const float* h, const float* w,
                                    const float* bias, const float* s,
                                    long long s_bs, long long s_ps,
                                    long long s_rs, float* out, float* mask,
                                    int m, int k, int t, int f,
                                    void* stream) {
  if (!shape_ok(m, k, t, f) || !aligned16(h) || !aligned16(w) ||
      (m + 63) / 64 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int p = t * f;
  const Planar sp{s, s_bs, s_ps, s_rs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 8) return launch_fwd<8>(h, w, bias, sp, out, mask, m, k, p, f, st);
  if (m <= 16) {
    return launch_fwd<16>(h, w, bias, sp, out, mask, m, k, p, f, st);
  }
  if (m <= 32) {
    return launch_fwd<32>(h, w, bias, sp, out, mask, m, k, p, f, st);
  }
  return launch_fwd<64>(h, w, bias, sp, out, mask, m, k, p, f, st);
}

// Floats of the partial d_h the backward needs as scratch.
extern "C" long long maavss_mask_head_bwd_scratch(int m, int k, int t,
                                                  int f) {
  const long long blocks =
      (static_cast<long long>(t) * f + kPairs - 1) / kPairs;
  return blocks * m * k;
}

// d_h [M, K], dW [2P, K] and, when db is not null, db [2P] of out =
// stft (x) (h W^T + b) for the cotangent g (planar [M, 2, T, F], strided as
// stft). part: maavss_mask_head_bwd_scratch floats. Two launches; returns
// the cudaError_t of the launches.
extern "C" int maavss_mask_head_bwd(const float* g, long long g_bs,
                                    long long g_ps, long long g_rs,
                                    const float* s, long long s_bs,
                                    long long s_ps, long long s_rs,
                                    const float* h, const float* w, float* dh,
                                    float* dw, float* db, float* part, int m,
                                    int k, int t, int f, void* stream) {
  if (!shape_ok(m, k, t, f) || !aligned16(h) || !aligned16(w) ||
      !aligned16(dh) || !aligned16(dw) || !aligned16(part)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int p = t * f;
  const int blocks = (p + kPairs - 1) / kPairs;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        head_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBwdSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  // split K over enough blocks to keep kBwdBlocks in flight: each split
  // writes its own columns of dW and of the partials, so no sum is added
  const int chunks = (k + kKc - 1) / kKc;
  int splits = (kBwdBlocks + blocks - 1) / blocks;
  if (splits > chunks) splits = chunks;
  const int per = (chunks + splits - 1) / splits;
  splits = (chunks + per - 1) / per;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  head_bwd_kernel<<<dim3(blocks, splits), kThreads, kBwdSmem, st>>>(
      Planar{g, g_bs, g_ps, g_rs}, Planar{s, s_bs, s_ps, s_rs}, h, w, dw, db,
      part, m, k, p, f, per * kKc);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long cols = static_cast<long long>(m) * k / 4;
  head_bwd_reduce_kernel<<<static_cast<unsigned>((cols + 31) / 32), kThreads,
                           0, st>>>(reinterpret_cast<const float4*>(part),
                                    reinterpret_cast<float4*>(dh), blocks,
                                    cols);
  return static_cast<int>(cudaGetLastError());
}
