// LSTM recurrence backward (BPTT), for one or two directions in one launch,
// plus the dW_h product as a second kernel.
//
// Replaces the TPU kernel maavss_tpu/ops/pallas_lstm.py:_bwd_kernel (the
// pl.pallas_call in _vjp_bwd). Same contract per direction, in the module's
// batch-major layout: from w_h [H, 4H], the forward's saved ys, cs [B, T, H]
// and fp32 gate activations acts [B, T, 4H] = [i | f | g | o] (lstm_fwd.cu
// writes them, so nothing is recomputed), and the cotangent dys [B, T, H]:
//   dh = dys[t] + dh_next;  dc = dh * o * (1 - tanh(c)^2) + dc_next
//   dgates = [dc*g*i(1-i) | dc*c_prev*f(1-f) | dc*i*(1-g^2) | dh*tanh(c)*o(1-o)]
//   dxw[t] = dgates;  dh_prev = dgates @ w_h^T;  dc_prev = dc * f
//   dW_h = sum over (b, t) of h_prev^T dgates
// with fp32 carries and sums whatever the IO type (fp32, bf16 or fp16). The
// forward direction sweeps t = T-1 .. 0 with h_prev = ys[t-1]; a reverse
// direction (forward run t = T-1 .. 0 by indexing, csrc/lstm_fwd.cu) sweeps
// t = 0 .. T-1 with h_prev = ys[t+1]; h_prev and c_prev are 0 at the first
// step of the forward run.
//
// What bounds it on Hopper: as the forward, the chain of T dependent steps
// at a batch of 1 to 32 rows. Only dh_prev = dgates @ w_h^T is on it; the
// gate activations come from the forward. The dW_h product, about
// 2*B*T*H*4H FLOP (34 MFLOP at B*T = 64), is off the chain.
//
// Design. Sweep kernel (the geometry is in lstm_cluster.cuh): one cluster
// of NC CTAs per (direction, RB batch rows), CTA q keeping the same slice of
// w_h as the forward (the gate columns of its U hidden units, 64 KB fp32 at
// H = 256, NC = 16) in shared memory for the whole launch. Per step:
//   - the owner of a (row, unit) pair adds the NC partial sums of its
//     dh_next in rank order, computes the pair's four dgates (acts, cs and
//     dys of the step prefetched the step before), keeps dc in shared
//     memory and writes dxw (and an fp32 copy of dgates for dW_h below fp32);
//   - thread k multiplies the CTA's RB x 4U dgates by row k of its slice:
//     its share of dh_prev[:, k] over the CTA's own columns, stored as RB
//     consecutive floats into the next receive buffer of k's owner CTA
//     through distributed shared memory (double-buffered);
//   - one cluster barrier, the only one on the chain.
// The TPU kernel sums dW_h across sequential grid steps in a VMEM scratch;
// Hopper's blocks run in no order, so dW_h is a second kernel over the fp32
// dgates: a tiled product h_prev^T [H, B*T] x dgates [B*T, 4H], each output
// summed over the B*T rows in one fixed order. No atomics: every run gives
// the same bits.

#include "lstm_cluster.cuh"

#include <type_traits>

namespace {

using lstm::cg::cluster_group;
using lstm::load_f;
using lstm::store_f;

constexpr int kTile = 64;      // dW_h output tile (kTile x kTile)
constexpr int kTileK = 32;     // rows of B*T per shared-memory stage
constexpr int kTileThreads = 256;

struct Direction {
  const float* acts;
  const void* w_h;
  const void* ys;
  const void* cs;
  const void* dys;
  void* dxw;
  float* dg;  // fp32 dgates [B, T, 4H]; the same buffer as dxw in fp32
  void* dwh;
  int reverse;
};

template <typename T, int RB>
__global__ void __launch_bounds__(lstm::kMaxThreads)
lstm_bwd_sweep_kernel(Direction d0, Direction d1, int B, int T_len, int H,
                      bool vec_w) {
  cluster_group cluster = lstm::cg::this_cluster();
  constexpr int NC = lstm::kCluster;
  const int q = static_cast<int>(cluster.block_rank());
  const Direction d = blockIdx.z == 0 ? d0 : d1;
  const float* __restrict__ acts = d.acts;
  const T* __restrict__ cs = static_cast<const T*>(d.cs);
  const T* __restrict__ dys = static_cast<const T*>(d.dys);
  T* __restrict__ dxw = static_cast<T*>(d.dxw);

  const int U = H / NC;
  const int C = 4 * U;
  const int ld = C + 4;
  extern __shared__ float4 smem4[];
  float* w_sh = reinterpret_cast<float*>(smem4);  // [H][ld]
  float* dg_sh = w_sh + H * ld;                   // [RB][C]
  float* recv = dg_sh + RB * C;                   // [2][NC][U][RB]
  float* dc_sh = recv + 2 * RB * H;               // [RB][U]
  const int tid = threadIdx.x;

  lstm::load_slice(static_cast<const T*>(d.w_h), w_sh, H, U, q, vec_w);
  for (int e = tid; e < RB * H; e += blockDim.x) recv[e] = 0.0f;  // buffer 0
  for (int e = tid; e < RB * U; e += blockDim.x) dc_sh[e] = 0.0f;

  // owner role: pair (r, u), hidden unit q*U + u of batch row b
  const bool owner = tid < RB * U;
  const int r = tid / U;
  const int u = tid - r * U;
  const int unit = q * U + u;
  const int b = blockIdx.y * RB + r;
  const bool live = owner && b < B;
  const size_t four_h = 4 * static_cast<size_t>(H);
  // the step's inputs, fetched one step ahead: i, f, g, o, c, c_prev, dy
  float in[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  auto fetch = [&](int step) {
    const int t = d.reverse ? step : T_len - 1 - step;
    const int tp = d.reverse ? t + 1 : t - 1;
    const size_t row = static_cast<size_t>(b) * T_len + t;
    const float* a = acts + row * four_h + unit;
#pragma unroll
    for (int g = 0; g < 4; ++g) in[g] = __ldg(a + g * H);
    in[4] = load_f(cs + row * H + unit);
    in[5] = tp >= 0 && tp < T_len
                ? load_f(cs + (static_cast<size_t>(b) * T_len + tp) * H + unit)
                : 0.0f;
    in[6] = load_f(dys + row * H + unit);
  };
  if (live) fetch(0);
  const int k = tid;  // product role: dh_prev[:, k] over the own columns
  const int k_owner = k / U;
  const float* w_row = w_sh + k * ld;
  cluster.sync();  // slices and dh_next = 0 in place; every peer has started

  for (int step = 0; step < T_len; ++step) {
    const int t = d.reverse ? step : T_len - 1 - step;
    const int cur = step & 1;
    if (owner) {
      const float* rv = recv + cur * RB * H + u * RB + r;
      float dh_next = 0.0f;
      for (int p = 0; p < NC; ++p) dh_next += rv[p * U * RB];
      float g4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (live) {
        const float i = in[0], f = in[1], g = in[2], o = in[3];
        const float tanh_c = tanhf(in[4]);
        const float dh = in[6] + dh_next;
        const float d_o = dh * tanh_c;
        const float dc = dh * o * (1.0f - tanh_c * tanh_c) + dc_sh[tid];
        g4[0] = dc * g * i * (1.0f - i);
        g4[1] = dc * in[5] * f * (1.0f - f);
        g4[2] = dc * i * (1.0f - g * g);
        g4[3] = d_o * o * (1.0f - o);
        dc_sh[tid] = dc * f;
        const size_t row = static_cast<size_t>(b) * T_len + t;
        T* dx = dxw + row * four_h + unit;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) store_f(dx + gi * H, g4[gi]);
        if (!std::is_same<T, float>::value) {
          float* dgr = d.dg + row * four_h + unit;
#pragma unroll
          for (int gi = 0; gi < 4; ++gi) dgr[gi * H] = g4[gi];
        }
        if (step + 1 < T_len) fetch(step + 1);
      }
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) dg_sh[r * C + gi * U + u] = g4[gi];
    }
    if (step + 1 == T_len) break;  // dh_prev of the first step is unused
    __syncthreads();  // the CTA's dgates are complete

    float acc[RB];
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) acc[rr] = 0.0f;
#pragma unroll 2
    for (int cc = 0; cc < C; cc += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(w_row + cc);
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        const float4 gv =
            *reinterpret_cast<const float4*>(dg_sh + rr * C + cc);
        acc[rr] = fmaf(gv.x, wv.x, acc[rr]);
        acc[rr] = fmaf(gv.y, wv.y, acc[rr]);
        acc[rr] = fmaf(gv.z, wv.z, acc[rr]);
        acc[rr] = fmaf(gv.w, wv.w, acc[rr]);
      }
    }
    float* dst = cluster.map_shared_rank(recv, k_owner) +
                 ((1 - cur) * NC + q) * U * RB + (k - k_owner * U) * RB;
    if constexpr (RB == 1) {
      dst[0] = acc[0];
    } else if constexpr (RB == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
    } else {
#pragma unroll
      for (int rr = 0; rr < RB; rr += 4) {
        *reinterpret_cast<float4*>(dst + rr) =
            make_float4(acc[rr], acc[rr + 1], acc[rr + 2], acc[rr + 3]);
      }
    }
    // every owner has its dh_next partials, and every CTA is done with its
    // dgates and the current receive buffer, which the next step overwrites
    cluster.sync();
  }
}

// Four consecutive values as floats: one vector load when `vec`.
template <typename T>
__device__ __forceinline__ float4 load4_or(const T* p, bool vec) {
  if (vec) return lstm::load4(p);
  return make_float4(load_f(p), load_f(p + 1), load_f(p + 2), load_f(p + 3));
}

// dW_h[k, m] = sum_n h_prev[n, k] * dg[n, m] over the n = b*T + t rows, with
// h_prev[b*T + t] = ys[b, t -/+ 1] (0 where that is outside [0, T)). One
// kTile x kTile output tile per block, 4 x 4 outputs per thread, each summed
// over n in order. The rows come in stages of kTileK, two float4 of each
// operand per thread, loaded into registers while the stage before is
// summed from shared memory (double-buffered), so a stage costs its
// arithmetic and not a memory latency. `vec`: ys and dg aligned for vector
// loads (else four 4-byte loads).
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
lstm_bwd_dwh_kernel(Direction d0, Direction d1, int B, int T_len, int H,
                    bool vec) {
  const Direction d = blockIdx.z == 0 ? d0 : d1;
  const T* __restrict__ ys = static_cast<const T*>(d.ys);
  const float* __restrict__ dg = d.dg;
  T* __restrict__ dwh = static_cast<T*>(d.dwh);
  const int four_h = 4 * H;
  const int N = B * T_len;
  const int k0 = blockIdx.y * kTile;
  const int m0 = blockIdx.x * kTile;
  constexpr int kQuads = kTile / 4;  // float4 per tile row
  constexpr int kPer = kTileK * kQuads / kTileThreads;  // float4 per thread

  __shared__ float4 a_sh[2][kTileK][kQuads];  // h_prev[n, k0 + 4i .. +3]
  __shared__ float4 b_sh[2][kTileK][kQuads];  // dg[n, m0 + 4i .. +3]
  const int tid = threadIdx.x;
  const int tx = tid % kQuads;  // 4 consecutive m per thread
  const int ty = tid / kQuads;  // 4 consecutive k per thread
  float4 ra[kPer], rb[kPer];
  auto fetch = [&](int n0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kTileThreads;
      const int n = n0 + e / kQuads;
      const int i4 = (e % kQuads) * 4;
      ra[j] = rb[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (n < N) {
        const int b = n / T_len;
        const int t = n - b * T_len;
        const int tp = d.reverse ? t + 1 : t - 1;
        if (tp >= 0 && tp < T_len && k0 + i4 < H) {
          ra[j] = load4_or(
              ys + (static_cast<size_t>(b) * T_len + tp) * H + k0 + i4, vec);
        }
        if (m0 + i4 < four_h) {
          rb[j] = load4_or(dg + static_cast<size_t>(n) * four_h + m0 + i4,
                           vec);
        }
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kTileThreads;
      a_sh[buf][e / kQuads][e % kQuads] = ra[j];
      b_sh[buf][e / kQuads][e % kQuads] = rb[j];
    }
  };
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
  }

  fetch(0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int n0 = 0; n0 < N; n0 += kTileK) {
    const bool more = n0 + kTileK < N;
    if (more) fetch(n0 + kTileK);
#pragma unroll 8
    for (int nn = 0; nn < kTileK; ++nn) {
      const float4 a4 = a_sh[buf][nn][ty];
      const float4 b4 = b_sh[buf][nn][tx];
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
      }
    }
    if (more) stash(buf ^ 1);  // last read in the stage before the barrier
    __syncthreads();
    buf ^= 1;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int k = k0 + ty * 4 + a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = m0 + tx * 4 + c;
      if (k < H && m < four_h) {
        store_f(dwh + static_cast<size_t>(k) * four_h + m, acc[a][c]);
      }
    }
  }
}

// One cluster launch of lstm_bwd_sweep_kernel<T, RB>; its attributes are
// set on its first launch on each device.
template <typename T, int RB>
int sweep_rows(Direction d0, Direction d1, int n_dir, int B, int T_len, int H,
               const lstm::Geometry& g, bool vec, cudaStream_t s) {
  static std::atomic<unsigned long long> configured{0};
  return lstm::launch_cluster(lstm_bwd_sweep_kernel<T, RB>, configured, g,
                              (B + RB - 1) / RB, n_dir, s, d0, d1, B, T_len,
                              H, vec);
}

template <typename T>
int launch(Direction d0, Direction d1, int n_dir, int B, int T_len, int H,
           const lstm::Geometry& g, cudaStream_t s) {
  const int U = H / lstm::kCluster;
  const bool vec = U % 4 == 0 && lstm::aligned(d0.w_h, 4 * sizeof(T)) &&
                   lstm::aligned(d1.w_h, 4 * sizeof(T));
  int e;
  switch (g.rows) {
    case 1:
      e = sweep_rows<T, 1>(d0, d1, n_dir, B, T_len, H, g, vec, s);
      break;
    case 2:
      e = sweep_rows<T, 2>(d0, d1, n_dir, B, T_len, H, g, vec, s);
      break;
    case 4:
      e = sweep_rows<T, 4>(d0, d1, n_dir, B, T_len, H, g, vec, s);
      break;
    default:
      e = sweep_rows<T, 8>(d0, d1, n_dir, B, T_len, H, g, vec, s);
  }
  if (e) return e;
  const bool vec_dwh = lstm::aligned(d0.ys, 4 * sizeof(T)) &&
                       lstm::aligned(d1.ys, 4 * sizeof(T)) &&
                       lstm::aligned(d0.dg, 16) && lstm::aligned(d1.dg, 16);
  dim3 grid_w((4 * H + kTile - 1) / kTile, (H + kTile - 1) / kTile, n_dir);
  lstm_bwd_dwh_kernel<T><<<grid_w, kTileThreads, 0, s>>>(d0, d1, B, T_len, H,
                                                         vec_dwh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. n_dir is 1 or 2; the
// second direction's pointers are ignored when n_dir == 1. acts is the
// forward's fp32 [B, T, 4H]; dg an fp32 [B, T, 4H] buffer for dgates, dxw
// itself in fp32. rows is
// ops/cuda_lstm.py:lstm_geometry's; threads and shared bytes follow from
// (H, rows). Two launches on `stream`: the sweep (clusters), then the dW_h
// product. Returns the first non-zero cudaError_t, else 0.
extern "C" int maavss_lstm_bwd(
    const void* acts0, const void* wh0, const void* ys0, const void* cs0,
    const void* dys0, void* dxw0, void* dg0, void* dwh0, int rev0,
    const void* acts1, const void* wh1, const void* ys1, const void* cs1,
    const void* dys1, void* dxw1, void* dg1, void* dwh1, int rev1, int n_dir,
    int B, int T_len, int H, int dtype, int rows, void* stream) {
  lstm::Geometry g;
  if (n_dir < 1 || n_dir > 2 || B < 1 || T_len < 1 || dtype < 0 ||
      dtype > 2 || !lstm::make_geometry(H, rows, true, &g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Direction d0{static_cast<const float*>(acts0), wh0, ys0, cs0, dys0, dxw0,
               static_cast<float*>(dg0), dwh0, rev0};
  Direction d1 = n_dir == 2
                     ? Direction{static_cast<const float*>(acts1), wh1, ys1,
                                 cs1, dys1, dxw1, static_cast<float*>(dg1),
                                 dwh1, rev1}
                     : d0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(d0, d1, n_dir, B, T_len, H, g, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(d0, d1, n_dir, B, T_len, H, g, s);
  }
  return launch<__half>(d0, d1, n_dir, B, T_len, H, g, s);
}
