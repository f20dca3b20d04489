// The register-tiled conv(1,9) / stride 2 / zero pad 4 of the fused
// phasegram-encoder layer, shared by K2-eval (pgenc_eval.cu) and K2-train's
// forward (pgenc_train.cu), with the copy helpers both sources use.
//
//   yc[co,r,so] = sum_{ci,k} w2[co,k*C+ci] * x[ci,r,2*so+k-4] + cbias[co]
//   x [C, R, S], w2 [Co, 9C] (column k*C + ci), yc [Co, R, So], So = S/2
//
// Tile plan (ops/cuda_pgenc.py:pgenc_plan picks it per layer shape; the
// launchers take it and check it with make_plan). A block owns a tile of bc
// output channels x br rows x bs output positions. A thread holds tc output
// channels x kTso consecutive positions of one row in registers, summed
// over one of g groups of input channels (ci = g0, g0 + g, ...). The block
// stages its rows' zero-padded x, [C][br][2*bs + 8] (positions 2*s0 - 4
// on), and its w2 slice, [C][9][bc], in shared memory once by cp.async
// (16-byte copies of x where S % 4 == 0 and x is aligned for them, 4-byte
// copies otherwise). Per input channel a thread then reads a run of
// 2*kTso + 7 x values (four float4 reads) that serves all 9 taps of its
// kTso outputs, and one float4 (float2) of w2 per tap that serves kTso of
// them: 9 * tc * kTso FMAs for 4 + 9 shared loads. With g > 1 the groups'
// sums are added in a fixed tree in shared memory, so every sum has one
// order and two runs give the same bits.
//
// The tiles are numbered channel block first: tile t = cb * per_cb + p, p =
// rb * n_sb + sb.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace pgenc {

constexpr int kTaps = 9;
constexpr int kPad = 4;
constexpr float kEps = 1e-5f;
constexpr int kTso = 4;           // consecutive outputs a thread holds
constexpr int kMaxThreads = 256;  // per block
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxBc = 32;        // output channels a tile holds
// dynamic shared bytes a block may use: the 227 KB of an H100 block less
// 4 KB for the kernels' static arrays
constexpr int kMaxDynSmem = 232448 - 4096;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float load_f(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ void store_f(__half* p, float v) {
  *p = __float2half_rn(v);
}

// Four consecutive values as fp32 (16-byte fp32 or 8-byte bf16 and fp16
// loads).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
  const float2 a = __half22float2(h[0]);
  const float2 b = __half22float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Four consecutive values from fp32 (16-byte store) or to bf16 or fp16
// (8-byte).
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(__half* p, const float (&v)[4]) {
  const __half2 lo = __floats2half2_rn(v[0], v[1]);
  const __half2 hi = __floats2half2_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Stage one fp32 value of global memory into shared memory: fp32 sources
// by cp.async (4 bytes, zero-filled when !ok), so that a thread has all its
// copies of a stage in flight at once; bf16 and fp16 sources by a load and
// a store.
// cp_wait() completes the thread's copies; a __syncthreads() must follow.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.0f;
}
__device__ __forceinline__ void stage(float* dst, const __half* src,
                                      bool ok) {
  *dst = ok ? __half2float(*src) : 0.0f;
}
// The same for four consecutive values (16-byte cp.async; 8-byte bf16 and
// fp16 loads), all in range or none; src and dst 16-byte (bf16, fp16:
// 8-byte) aligned.
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void stage4(float* dst, const __nv_bfloat16* src,
                                       bool ok) {
  *reinterpret_cast<float4*>(dst) =
      ok ? load4(src) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ void stage4(float* dst, const __half* src,
                                       bool ok) {
  *reinterpret_cast<float4*>(dst) =
      ok ? load4(src) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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
  if (dtype == 1) return f(Io<__nv_bfloat16>{});
  return f(Io<__half>{});
}

struct Shape {
  int C, R, S, Co, So;
};

// A tile plan and what follows from it for one layer shape.
struct TilePlan {
  int tc, bc, br, bs, g;  // chosen (pgenc_plan)
  int nsg, nto;  // position groups a row; threads of one contraction
                 // group, (bc / tc) * br * nsg
  int threads;            // g * nto rounded up to whole warps
  int xl;                 // staged x row: 2*bs + 8 floats
  int n_sb, per_cb, tiles;
  int smem;               // dynamic shared bytes
};

inline bool pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }

// Fill `p` from the chosen (tc, bc, br, bs, g) for shape `d`, exactly as
// ops/cuda_pgenc.py:plan_of does; false if the plan is not one the
// kernels take (tc 2 or 4; bc a multiple of tc up to kMaxBc; br, g powers
// of 2 and g <= C; bs a power of 2 >= kTso; at most kMaxThreads threads and
// kMaxDynSmem shared bytes).
inline bool make_plan(const Shape& d, int tc, int bc, int br, int bs, int g,
                      TilePlan* p) {
  if ((tc != 2 && tc != 4) || bc < tc || bc % tc || bc > kMaxBc ||
      !pow2(br) || !pow2(bs) || bs < kTso || !pow2(g) || g > d.C) {
    return false;
  }
  p->tc = tc;
  p->bc = bc;
  p->br = br;
  p->bs = bs;
  p->g = g;
  p->nsg = bs / kTso;
  const long long nto = static_cast<long long>(bc / tc) * br * p->nsg;
  if (nto * g > kMaxThreads) return false;
  p->nto = static_cast<int>(nto);
  p->threads = (p->nto * g + 31) / 32 * 32;
  p->xl = 2 * bs + 2 * kPad;
  p->n_sb = (d.So + bs - 1) / bs;
  const long long per_cb =
      static_cast<long long>((d.R + br - 1) / br) * p->n_sb;
  const long long tiles = per_cb * ((d.Co + bc - 1) / bc);
  if (tiles > 0x7fffffffLL) return false;
  p->per_cb = static_cast<int>(per_cb);
  p->tiles = static_cast<int>(tiles);
  const long long stage =
      static_cast<long long>(d.C) * (br * p->xl + kTaps * bc);
  const long long red = g > 1 ? static_cast<long long>(g) * p->nto * tc *
                                    kTso
                              : 0;
  const long long smem = 4 * (stage > red ? stage : red);
  if (smem > kMaxDynSmem) return false;
  p->smem = static_cast<int>(smem);
  return true;
}

// What a thread of the block computes.
struct Role {
  int g, ot, sq, rl, cg;  // group, thread in group, position group, row,
                          // channel group
  bool active;            // g < plan.g (the rest pad the block to warps)
};

__device__ __forceinline__ Role role_of(const TilePlan& p) {
  Role t;
  const int tid = threadIdx.x;
  t.g = tid / p.nto;
  t.ot = tid - t.g * p.nto;
  t.sq = t.ot % p.nsg;
  t.rl = (t.ot / p.nsg) % p.br;
  t.cg = t.ot / (p.nsg * p.br);
  t.active = t.g < p.g;
  return t;
}

struct Tile {
  int cb, p;       // channel block, index in it
  int c0, r0, s0;  // first output channel, row, position
};

__device__ __forceinline__ Tile tile_at(const TilePlan& p, int t) {
  Tile q;
  q.cb = t / p.per_cb;
  q.p = t - q.cb * p.per_cb;
  const int rb = q.p / p.n_sb;
  q.c0 = q.cb * p.bc;
  q.r0 = rb * p.br;
  q.s0 = (q.p - rb * p.n_sb) * p.bs;
  return q;
}

// Stage the tile's x rows, xs [C][br][xl] (position 2*s0 - 4 + q at q,
// zero outside [0, S) and beyond the last row), and its w2 slice,
// ws [C][9][bc] (zero beyond Co), then wait for the copies; a
// __syncthreads() must follow. `vec`: S % 4 == 0 and x aligned for 16-byte
// (bf16: 8-byte) copies. From 32 input channels a warp stages one (output
// channel, tap) row of w2 at a time, its lanes the input channels, and
// divides no index by a runtime value (the deep layers' w2 slices are
// 2-4x their x; tools/pgenc_fwd_probe_torch.py); below that the
// copies are spread over all threads.
template <typename T>
__device__ void stage_tile(const T* __restrict__ x, const T* __restrict__ w2,
                           const Shape& d, const TilePlan& p, const Tile& q,
                           float* smem, bool vec) {
  float* xs = smem;
  float* ws = smem + d.C * p.br * p.xl;
  const int rows = d.C * p.br;
  const int per = vec ? p.xl / 4 : p.xl;  // copies per staged row
  const int w = vec ? 4 : 1;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int row = i / per;
    const int qx = (i - row * per) * w;
    const int ci = row / p.br;
    const int r = q.r0 + row - ci * p.br;
    const int pos = 2 * q.s0 - kPad + qx;
    const bool ok = r < d.R && pos >= 0 && pos < d.S;
    const T* src = x + (ok ? (static_cast<size_t>(ci) * d.R + r) * d.S + pos
                           : 0);
    if (vec) {
      stage4(xs + row * p.xl + qx, src, ok);
    } else {
      stage(xs + row * p.xl + qx, src, ok);
    }
  }
  const int nine_c = kTaps * d.C;
  if (d.C >= 32) {
    const int lane = threadIdx.x % 32, nwarp = blockDim.x / 32;
    for (int ck = threadIdx.x / 32; ck < p.bc * kTaps; ck += nwarp) {
      const int col = ck / kTaps;
      const int k = ck - col * kTaps;
      const bool ok = q.c0 + col < d.Co;
      const T* src =
          w2 + (ok ? static_cast<size_t>(q.c0 + col) * nine_c + k * d.C : 0);
      float* dst = ws + k * p.bc + col;
      for (int ci = lane; ci < d.C; ci += 32) {
        stage(dst + ci * kTaps * p.bc, src + (ok ? ci : 0), ok);
      }
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < p.bc * nine_c; i += blockDim.x) {
      const int col = i / nine_c;
      const int kc = i - col * nine_c;
      const int k = kc / d.C;
      const int ci = kc - k * d.C;
      const bool ok = q.c0 + col < d.Co;
      stage(ws + (ci * kTaps + k) * p.bc + col,
            w2 + (ok ? static_cast<size_t>(q.c0 + col) * nine_c + kc : 0),
            ok);
    }
  }
  cp_wait();
}

template <int TC>
__device__ __forceinline__ void load_w(const float* p, float (&w)[TC]);
template <>
__device__ __forceinline__ void load_w<4>(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}
template <>
__device__ __forceinline__ void load_w<2>(const float* p, float (&w)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  w[0] = v.x;
  w[1] = v.y;
}

// The thread's TC x kTso sums over its group's input channels, from the
// staged tile. Output j of the thread's run and tap k read the staged x at
// 8*sq + 2*j + k.
template <int TC>
__device__ __forceinline__ void conv_tile(const float* smem, const Shape& d,
                                          const TilePlan& p, const Role& t,
                                          float (&acc)[TC][kTso]) {
#pragma unroll
  for (int c = 0; c < TC; ++c) {
#pragma unroll
    for (int j = 0; j < kTso; ++j) acc[c][j] = 0.0f;
  }
  if (!t.active) return;
  const float* xs = smem + t.rl * p.xl + 2 * kTso * t.sq;
  const float* ws = smem + d.C * p.br * p.xl + t.cg * TC;
  const int x_step = p.g * p.br * p.xl;
  const int w_step = p.g * kTaps * p.bc;
  xs += t.g * p.br * p.xl;
  ws += t.g * kTaps * p.bc;
  for (int ci = t.g; ci < d.C; ci += p.g, xs += x_step, ws += w_step) {
    float xv[2 * kTso + 8];
#pragma unroll
    for (int h = 0; h < (2 * kTso + 8) / 4; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(xs + 4 * h);
      xv[4 * h] = v.x;
      xv[4 * h + 1] = v.y;
      xv[4 * h + 2] = v.z;
      xv[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      float w[TC];
      load_w<TC>(ws + k * p.bc, w);
#pragma unroll
      for (int j = 0; j < kTso; ++j) {
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          acc[c][j] = fmaf(w[c], xv[2 * j + k], acc[c][j]);
        }
      }
    }
  }
}

// With g > 1: add the groups' sums in a fixed tree over the group index, in
// shared memory over the stage (which must be consumed); group 0's threads
// then hold the tile's sums. Every thread of the block calls it.
template <int TC>
__device__ void group_sum(float* red, const TilePlan& p, const Role& t,
                          float (&acc)[TC][kTso]) {
  if (p.g == 1) return;
  const int n = TC * kTso * p.nto;  // floats of one group
  __syncthreads();
  if (t.active) {
#pragma unroll
    for (int c = 0; c < TC; ++c) {
#pragma unroll
      for (int j = 0; j < kTso; ++j) {
        red[t.g * n + (c * kTso + j) * p.nto + t.ot] = acc[c][j];
      }
    }
  }
  __syncthreads();
  for (int half = p.g / 2; half > 0; half >>= 1) {
    for (int i = threadIdx.x; i < half * n; i += blockDim.x) {
      red[i] += red[i + half * n];
    }
    __syncthreads();
  }
  if (t.g == 0) {
#pragma unroll
    for (int c = 0; c < TC; ++c) {
#pragma unroll
      for (int j = 0; j < kTso; ++j) {
        acc[c][j] = red[(c * kTso + j) * p.nto + t.ot];
      }
    }
  }
}

// Store a thread's run of kTso outputs at row[so0 ..] (so0 < So): one
// vector store where So % 4 == 0 (the run is then whole and aligned), else
// the values inside [0, So) one by one.
template <typename T>
__device__ __forceinline__ void store_run(T* row, int so0, int So,
                                          const float (&v)[kTso]) {
  if (So % kTso == 0) {
    store4(row + so0, v);
  } else {
#pragma unroll
    for (int j = 0; j < kTso; ++j) {
      if (so0 + j < So) store_f(row + so0 + j, v[j]);
    }
  }
}

// Set the kernel's dynamic shared memory limit to kMaxDynSmem once per
// device, keeping the devices done in `configured` (one bit a device).
template <typename K>
inline cudaError_t configure(K kernel,
                             std::atomic<unsigned long long>& configured) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (bit && (configured.load(std::memory_order_relaxed) & bit)) {
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxDynSmem);
  if (e == cudaSuccess) configured.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

}  // namespace pgenc
