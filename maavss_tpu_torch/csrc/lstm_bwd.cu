// LSTM recurrence backward (BPTT), for one or two directions in one launch,
// plus the dW_h product as a second kernel.
//
// Replaces the TPU kernel maavss_tpu/ops/pallas_lstm.py:_bwd_kernel (the
// pl.pallas_call in _vjp_bwd). Same contract per direction, in the module's
// batch-major layout: from xw [B, T, 4H], w_h [H, 4H] and the forward's
// saved ys, cs [B, T, H], and the cotangent dys [B, T, H]:
//   recompute gates_t = xw[t] + h_prev @ w_h (gate columns [i | f | g | o])
//   dh = dys[t] + dh_next;  dc = dh * o * (1 - tanh(c)^2) + dc_next
//   dgates = [dc*g*i(1-i) | dc*c_prev*f(1-f) | dc*i*(1-g^2) | dh*tanh(c)*o(1-o)]
//   dxw[t] = dgates;  dh_prev = dgates @ w_h^T;  dc_prev = dc * f
//   dW_h = sum over (b, t) of h_prev^T dgates
// with fp32 carries and sums whatever the IO type (fp32 or bf16). The
// forward direction sweeps t = T-1 .. 0 with h_prev = ys[t-1]; a reverse
// direction (forward run t = T-1 .. 0 by indexing, csrc/lstm_fwd.cu) sweeps
// t = 0 .. T-1 with h_prev = ys[t+1]; h_prev and c_prev are 0 at the first
// step of the forward run.
//
// Design. Sweep kernel: one block of H threads per (RB batch rows,
// direction), as the forward. Thread j owns hidden unit j: it recomputes its
// four gate dot products over h_prev (staged in shared memory; w_h read by
// columns j, j+H, ..., coalesced across the warp), keeps dc in a register and
// writes its four dgates. dh_prev = dgates @ w_h^T reads w_h by rows: warp w
// takes rows k = w, w + H/32, ..., its lanes walk the row's 4H consecutive
// entries (coalesced) and a shuffle tree sums them, so every sum has a fixed
// order. The TPU kernel sums dW_h across sequential grid steps in a VMEM
// scratch; Hopper's blocks run in no order, so dW_h is a second kernel over
// the fp32 dgates the sweep wrote (dxw itself in fp32, a scratch in bf16):
// a tiled product h_prev^T [H, B*T] x dgates [B*T, 4H], each output summed
// over the B*T rows in one fixed order. No atomics: every run gives the same
// bits.
//
// What bounds it on Hopper: as the forward, the chain of T dependent steps at
// a batch of 8 to 32 rows. Each step streams w_h twice (1 MB fp32 at H=256,
// columns for the gates and rows for dh_prev) from L2 into one SM, so a step
// costs about 2 MB over one SM's L2 bandwidth. The dW_h product is about
// 2*B*T*H*4H FLOP (34 MFLOP at B*T = 64) on the CUDA cores, small beside
// the chain.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int kRowsPerBlock = 2;
constexpr int kTile = 64;      // dW_h output tile (kTile x kTile)
constexpr int kTileK = 16;     // rows of B*T per shared-memory stage
constexpr int kTileThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

struct Direction {
  const void* xw;
  const void* w_h;
  const void* ys;
  const void* cs;
  const void* dys;
  void* dxw;
  float* dg;  // fp32 dgates [B, T, 4H]; the same buffer as dxw in fp32
  void* dwh;
  int reverse;
};

template <typename T>
__global__ void lstm_bwd_sweep_kernel(Direction d0, Direction d1, int B,
                                      int T_len, int H) {
  const Direction d = blockIdx.y == 0 ? d0 : d1;
  const T* __restrict__ xw = static_cast<const T*>(d.xw);
  const T* __restrict__ w_h = static_cast<const T*>(d.w_h);
  const T* __restrict__ ys = static_cast<const T*>(d.ys);
  const T* __restrict__ cs = static_cast<const T*>(d.cs);
  const T* __restrict__ dys = static_cast<const T*>(d.dys);
  T* __restrict__ dxw = static_cast<T*>(d.dxw);
  float* __restrict__ dg = d.dg;

  extern __shared__ float smem[];
  float* h_sh = smem;                           // [RB][H]   h_prev
  float* dhn_sh = h_sh + kRowsPerBlock * H;     // [RB][H]   dh_next
  float* dg_sh = dhn_sh + kRowsPerBlock * H;    // [RB][4H]  dgates
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int n_warps = H >> 5;
  const int b0 = blockIdx.x * kRowsPerBlock;
  const int four_h = 4 * H;

  float dc_next[kRowsPerBlock];
#pragma unroll
  for (int r = 0; r < kRowsPerBlock; ++r) {
    dc_next[r] = 0.0f;
    dhn_sh[r * H + j] = 0.0f;
  }

  for (int step = 0; step < T_len; ++step) {
    const int t = d.reverse ? step : T_len - 1 - step;
    const int tp = d.reverse ? t + 1 : t - 1;
    const bool has_prev = tp >= 0 && tp < T_len;
    float c_prev[kRowsPerBlock];
#pragma unroll
    for (int r = 0; r < kRowsPerBlock; ++r) {
      const int b = b0 + r;
      float hp = 0.0f, cp = 0.0f;
      if (b < B && has_prev) {
        const size_t row = static_cast<size_t>(b) * T_len + tp;
        hp = load_f(ys + row * H + j);
        cp = load_f(cs + row * H + j);
      }
      h_sh[r * H + j] = hp;
      c_prev[r] = cp;
    }
    __syncthreads();  // h_prev staged; dh_next of the last step complete

    float acc[kRowsPerBlock][4];
#pragma unroll
    for (int r = 0; r < kRowsPerBlock; ++r) {
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
    }
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const T* wk = w_h + static_cast<size_t>(k) * four_h + j;
      const float w0 = load_f(wk);
      const float w1 = load_f(wk + H);
      const float w2 = load_f(wk + 2 * H);
      const float w3 = load_f(wk + 3 * H);
#pragma unroll
      for (int r = 0; r < kRowsPerBlock; ++r) {
        const float hk = h_sh[r * H + k];
        acc[r][0] = fmaf(hk, w0, acc[r][0]);
        acc[r][1] = fmaf(hk, w1, acc[r][1]);
        acc[r][2] = fmaf(hk, w2, acc[r][2]);
        acc[r][3] = fmaf(hk, w3, acc[r][3]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerBlock; ++r) {
      const int b = b0 + r;
      float g_i = 0.0f, g_f = 0.0f, g_g = 0.0f, g_o = 0.0f;
      if (b < B) {
        const size_t row = static_cast<size_t>(b) * T_len + t;
        const T* x = xw + row * four_h + j;
        const float i = sigmoid_f(load_f(x) + acc[r][0]);
        const float f = sigmoid_f(load_f(x + H) + acc[r][1]);
        const float g = tanhf(load_f(x + 2 * H) + acc[r][2]);
        const float o = sigmoid_f(load_f(x + 3 * H) + acc[r][3]);
        const float c = load_f(cs + row * H + j);
        const float tanh_c = tanhf(c);
        const float dh = load_f(dys + row * H + j) + dhn_sh[r * H + j];
        const float d_o = dh * tanh_c;
        const float dc = dh * o * (1.0f - tanh_c * tanh_c) + dc_next[r];
        const float d_i = dc * g;
        const float d_g = dc * i;
        const float d_f = dc * c_prev[r];
        g_i = d_i * i * (1.0f - i);
        g_f = d_f * f * (1.0f - f);
        g_g = d_g * (1.0f - g * g);
        g_o = d_o * o * (1.0f - o);
        dc_next[r] = dc * f;
        T* dx = dxw + row * four_h + j;
        store_f(dx, g_i);
        store_f(dx + H, g_f);
        store_f(dx + 2 * H, g_g);
        store_f(dx + 3 * H, g_o);
        if (!std::is_same<T, float>::value) {
          float* dgr = dg + row * four_h + j;
          dgr[0] = g_i;
          dgr[H] = g_f;
          dgr[2 * H] = g_g;
          dgr[3 * H] = g_o;
        }
      }
      float* dgs = dg_sh + r * four_h + j;
      dgs[0] = g_i;
      dgs[H] = g_f;
      dgs[2 * H] = g_g;
      dgs[3 * H] = g_o;
    }
    __syncthreads();  // dgates complete; every thread has read dh_next

    // dh_prev[k] = sum_m dgates[m] * w_h[k, m]: warp per row k, lanes on m
    for (int k = warp; k < H; k += n_warps) {
      const T* wr = w_h + static_cast<size_t>(k) * four_h;
      float s[kRowsPerBlock];
#pragma unroll
      for (int r = 0; r < kRowsPerBlock; ++r) s[r] = 0.0f;
      for (int m = lane; m < four_h; m += 32) {
        const float w = load_f(wr + m);
#pragma unroll
        for (int r = 0; r < kRowsPerBlock; ++r) {
          s[r] = fmaf(dg_sh[r * four_h + m], w, s[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerBlock; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
        }
        if (lane == 0) dhn_sh[r * H + k] = s[r];
      }
    }
    __syncthreads();  // dh_prev complete before the next step reads it
  }
}

// dW_h[k, m] = sum_n h_prev[n, k] * dg[n, m] over the n = b*T + t rows, with
// h_prev[b*T + t] = ys[b, t -/+ 1] (0 where that is outside [0, T)).
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
lstm_bwd_dwh_kernel(Direction d0, Direction d1, int B, int T_len, int H) {
  const Direction d = blockIdx.z == 0 ? d0 : d1;
  const T* __restrict__ ys = static_cast<const T*>(d.ys);
  const float* __restrict__ dg =
      std::is_same<T, float>::value ? static_cast<const float*>(d.dxw) : d.dg;
  T* __restrict__ dwh = static_cast<T*>(d.dwh);
  const int four_h = 4 * H;
  const int N = B * T_len;
  const int k0 = blockIdx.y * kTile;
  const int m0 = blockIdx.x * kTile;

  __shared__ float a_sh[kTileK][kTile];  // h_prev[n, k0 + i]
  __shared__ float b_sh[kTileK][kTile];  // dg[n, m0 + i]
  const int tx = threadIdx.x % 16;  // 4 consecutive m per thread
  const int ty = threadIdx.x / 16;  // 4 consecutive k per thread
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
  }

  for (int n0 = 0; n0 < N; n0 += kTileK) {
    for (int e = threadIdx.x; e < kTileK * kTile; e += kTileThreads) {
      const int nn = e / kTile;
      const int ii = e - nn * kTile;
      const int n = n0 + nn;
      float hv = 0.0f, gv = 0.0f;
      if (n < N) {
        const int b = n / T_len;
        const int t = n - b * T_len;
        const int tp = d.reverse ? t + 1 : t - 1;
        if (tp >= 0 && tp < T_len && k0 + ii < H) {
          hv = load_f(ys + (static_cast<size_t>(b) * T_len + tp) * H + k0 +
                      ii);
        }
        if (m0 + ii < four_h) gv = dg[static_cast<size_t>(n) * four_h + m0 + ii];
      }
      a_sh[nn][ii] = hv;
      b_sh[nn][ii] = gv;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < kTileK; ++nn) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = a_sh[nn][ty * 4 + a];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = b_sh[nn][tx * 4 + c];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
      }
    }
    __syncthreads();
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

template <typename T>
int launch(Direction d0, Direction d1, int n_dir, int B, int T_len, int H,
           cudaStream_t s) {
  dim3 grid((B + kRowsPerBlock - 1) / kRowsPerBlock, n_dir);
  const size_t smem = sizeof(float) * kRowsPerBlock * 6 * H;
  lstm_bwd_sweep_kernel<T><<<grid, H, smem, s>>>(d0, d1, B, T_len, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid_w((4 * H + kTile - 1) / kTile, (H + kTile - 1) / kTile, n_dir);
  lstm_bwd_dwh_kernel<T><<<grid_w, kTileThreads, 0, s>>>(d0, d1, B, T_len, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. n_dir is 1 or 2; the second direction's
// pointers are ignored when n_dir == 1. dg is an fp32 [B, T, 4H] scratch for
// the bf16 path (ignored in fp32, where dxw holds the fp32 dgates). Two
// kernels are launched on `stream`: the sweep, then the dW_h product.
// Returns the first non-zero cudaError_t, else 0.
extern "C" int maavss_lstm_bwd(
    const void* xw0, const void* wh0, const void* ys0, const void* cs0,
    const void* dys0, void* dxw0, void* dg0, void* dwh0, int rev0,
    const void* xw1, const void* wh1, const void* ys1, const void* cs1,
    const void* dys1, void* dxw1, void* dg1, void* dwh1, int rev1, int n_dir,
    int B, int T_len, int H, int dtype, void* stream) {
  if (n_dir < 1 || n_dir > 2 || B < 1 || T_len < 1 || H < 32 || H > 1024 ||
      H % 32 != 0 || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Direction d0{xw0, wh0, ys0, cs0, dys0, dxw0, static_cast<float*>(dg0),
               dwh0, rev0};
  Direction d1 = n_dir == 2
                     ? Direction{xw1, wh1, ys1, cs1, dys1, dxw1,
                                 static_cast<float*>(dg1), dwh1, rev1}
                     : d0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(d0, d1, n_dir, B, T_len, H, s);
  return launch<__nv_bfloat16>(d0, d1, n_dir, B, T_len, H, s);
}
