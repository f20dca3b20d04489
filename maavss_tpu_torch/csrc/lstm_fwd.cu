// LSTM recurrence, forward only, for one or two directions in one launch.
//
// Replaces the TPU kernel maavss_tpu/ops/pallas_lstm.py:_fwd_kernel (the
// pl.pallas_call in _forward). Same contract per direction:
//   gates_t = xw[t] + h_{t-1} @ w_h        gate columns [i | f | g | o]
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)           h_0 = c_0 = 0
// with an fp32 carry and fp32 sums whatever the IO type (fp32 or bf16).
// Layouts are the module's own, batch-major, so no transpose is needed
// around the call: xw [B, T, 4H], w_h [H, 4H] (flax layout, row k holds the
// four gates' weights of h[k]), ys and cs [B, T, H]. A reverse direction
// walks t = T-1 .. 0 by indexing and writes ys at the original t, which is
// flip(lstm(flip(xw))) without a copy.
//
// Design: one block of H threads per (RB batch rows, direction). Thread j
// owns hidden unit j: it keeps c[r][j] in registers, computes its four gate
// dot products over h_{t-1} (kept in shared memory) and writes h_t back.
// Two barriers per step. The h @ w_h product is done here, not by a library.
//
// What bounds it on Hopper: a chain of T dependent steps at tiny batch.
// Each step streams all of w_h (1 MB fp32 at H=256) from L2 into one SM,
// so a step costs about 1 MB / (L2->SM bandwidth of one SM) and the T steps
// cannot overlap. RB rows share each w_h read; more blocks (smaller RB) put
// more SMs on the batch. Keeping w_h on chip across steps needs it split
// over a thread-block cluster, with h exchanged through distributed shared
// memory each step: that is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRowsPerBlock = 2;

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
  void* ys;
  void* cs;
  int reverse;
};

template <typename T>
__global__ void lstm_fwd_kernel(Direction d0, Direction d1, int B, int T_len,
                                int H) {
  const Direction d = blockIdx.y == 0 ? d0 : d1;
  const T* __restrict__ xw = static_cast<const T*>(d.xw);
  const T* __restrict__ w_h = static_cast<const T*>(d.w_h);
  T* __restrict__ ys = static_cast<T*>(d.ys);
  T* __restrict__ cs = static_cast<T*>(d.cs);

  extern __shared__ float h_sh[];  // [kRowsPerBlock][H]
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * kRowsPerBlock;
  const int four_h = 4 * H;

  float c[kRowsPerBlock];
#pragma unroll
  for (int r = 0; r < kRowsPerBlock; ++r) {
    c[r] = 0.0f;
    h_sh[r * H + j] = 0.0f;
  }
  __syncthreads();

  for (int step = 0; step < T_len; ++step) {
    const int t = d.reverse ? T_len - 1 - step : step;
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
    __syncthreads();  // every thread has read h_{t-1} before it is replaced
#pragma unroll
    for (int r = 0; r < kRowsPerBlock; ++r) {
      const int b = b0 + r;
      if (b < B) {
        const size_t row = (static_cast<size_t>(b) * T_len + t);
        const T* x = xw + row * four_h + j;
        const float gi = sigmoid_f(load_f(x) + acc[r][0]);
        const float gf = sigmoid_f(load_f(x + H) + acc[r][1]);
        const float gg = tanhf(load_f(x + 2 * H) + acc[r][2]);
        const float go = sigmoid_f(load_f(x + 3 * H) + acc[r][3]);
        c[r] = gf * c[r] + gi * gg;
        const float h = go * tanhf(c[r]);
        h_sh[r * H + j] = h;
        store_f(ys + row * H + j, h);
        if (cs != nullptr) store_f(cs + row * H + j, c[r]);
      }
    }
    __syncthreads();  // h_t complete before the next step reads it
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. n_dir is 1 or 2; the second direction's
// pointers are ignored when n_dir == 1. cs pointers may be null. Returns the
// cudaError_t of the launch.
extern "C" int maavss_lstm_fwd(const void* xw0, const void* wh0, void* ys0,
                               void* cs0, int rev0, const void* xw1,
                               const void* wh1, void* ys1, void* cs1, int rev1,
                               int n_dir, int B, int T_len, int H, int dtype,
                               void* stream) {
  if (n_dir < 1 || n_dir > 2 || B < 1 || T_len < 1 || H < 32 || H > 1024 ||
      H % 32 != 0 || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Direction d0{xw0, wh0, ys0, cs0, rev0};
  Direction d1 = n_dir == 2 ? Direction{xw1, wh1, ys1, cs1, rev1} : d0;
  dim3 grid((B + kRowsPerBlock - 1) / kRowsPerBlock, n_dir);
  dim3 block(H);
  size_t smem = sizeof(float) * kRowsPerBlock * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    lstm_fwd_kernel<float><<<grid, block, smem, s>>>(d0, d1, B, T_len, H);
  } else {
    lstm_fwd_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(d0, d1, B, T_len,
                                                             H);
  }
  return static_cast<int>(cudaGetLastError());
}
