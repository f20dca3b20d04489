// LSTM recurrence, forward only, for one or two directions in one launch.
//
// Replaces the TPU kernel maavss_tpu/ops/pallas_lstm.py:_fwd_kernel (the
// pl.pallas_call in _forward). Same contract per direction:
//   gates_t = xw[t] + h_{t-1} @ w_h        gate columns [i | f | g | o]
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)           h_0 = c_0 = 0
// with an fp32 carry and fp32 sums whatever the IO type (fp32, bf16 or fp16).
// Layouts are the module's own, batch-major, so no transpose is needed
// around the call: xw [B, T, 4H], w_h [H, 4H] (flax layout, row k holds the
// four gates' weights of h[k]), ys and cs [B, T, H]. A reverse direction
// walks t = T-1 .. 0 by indexing and writes ys at the original t, which is
// flip(lstm(flip(xw))) without a copy. When the caller asks for them (a
// non-null acts: training), it also writes the fp32 gate activations
// acts [B, T, 4H] = [sigmoid(i) | sigmoid(f) | tanh(g) | sigmoid(o)], which
// the backward (lstm_bwd.cu) reads in place of a recompute.
//
// What bounds it on Hopper: the chain of T dependent steps at a batch of 1
// to 32 rows, not bytes or FLOPs (2*T*B*H*4H FLOP, 34 MFLOP at B = 8, T = 8,
// H = 256 for both directions: 0.5 us at the fp32 peak). A step is a
// [RB, H] x [H, 4H] product whose operand w_h (1 MB fp32 at H = 256) does
// not fit one SM, then an exchange of h across the SMs that share it.
//
// Design (the geometry is in lstm_cluster.cuh): one cluster of NC CTAs per
// (direction, RB batch rows); CTA q keeps its 4U gate columns of w_h in
// shared memory for the whole launch (64 KB fp32 at H = 256, NC = 16),
// loaded once. Per step, each CTA:
//   - multiplies h_{t-1} (in its own shared memory) by its slice: thread
//     (c, s) sums column c over the k-slice s of H/4 rows for all RB rows,
//     reading h as broadcast float4s; the four k-slice partials go through
//     shared memory and the owner of a (row, unit) pair adds them in a
//     fixed order, so every run gives the same bits;
//   - applies the cell update to its RB x U pairs, c kept in shared memory
//     by the pair's owner thread, xw of the next step prefetched;
//   - stores h_t into every peer's next h buffer through distributed shared
//     memory (double-buffered), writes ys, cs (and acts) to global memory
//     off the chain;
//   - one cluster barrier, the only one on the chain.
// The h @ w_h product is done here, not by a library.

#include "lstm_cluster.cuh"

namespace {

using lstm::cg::cluster_group;

struct Direction {
  const void* xw;
  const void* w_h;
  void* ys;
  void* cs;
  float* acts;  // null: not written
  int reverse;
};

template <typename T, int RB>
__global__ void __launch_bounds__(lstm::kMaxThreads)
lstm_fwd_kernel(Direction d0, Direction d1, int B, int T_len, int H,
                bool vec_w) {
  cluster_group cluster = lstm::cg::this_cluster();
  constexpr int NC = lstm::kCluster;
  const int q = static_cast<int>(cluster.block_rank());
  const Direction d = blockIdx.z == 0 ? d0 : d1;
  const T* __restrict__ xw = static_cast<const T*>(d.xw);
  T* __restrict__ ys = static_cast<T*>(d.ys);
  T* __restrict__ cs = static_cast<T*>(d.cs);
  float* __restrict__ acts = d.acts;

  const int U = H / NC;
  const int C = 4 * U;
  const int ld = C + 4;
  const int KS = H / 4;  // rows of w_h per k-slice
  extern __shared__ float4 smem4[];
  float* w_sh = reinterpret_cast<float*>(smem4);  // [H][ld]
  float* h_sh = w_sh + H * ld;                    // [2][RB][H]
  float* part = h_sh + 2 * RB * H;                // [4][RB][C]
  float* c_sh = part + 4 * RB * C;                // [RB][U]
  const int tid = threadIdx.x;

  lstm::load_slice(static_cast<const T*>(d.w_h), w_sh, H, U, q, vec_w);
  for (int e = tid; e < RB * H; e += blockDim.x) h_sh[e] = 0.0f;
  for (int e = tid; e < RB * U; e += blockDim.x) c_sh[e] = 0.0f;

  // owner role: pair (r, u), hidden unit q*U + u of batch row b
  const bool owner = tid < RB * U;
  const int r = tid / U;
  const int unit = q * U + (tid - r * U);
  const int b = blockIdx.y * RB + r;
  const bool live = owner && b < B;
  const size_t four_h = 4 * static_cast<size_t>(H);
  float xv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto fetch_xw = [&](int step) {
    const int t = d.reverse ? T_len - 1 - step : step;
    const T* x = xw + (static_cast<size_t>(b) * T_len + t) * four_h + unit;
#pragma unroll
    for (int g = 0; g < 4; ++g) xv[g] = lstm::load_f(x + g * H);
  };
  if (live) fetch_xw(0);
  // product role: column c of the slice over k in [s*KS, (s+1)*KS)
  const int c = tid % C;
  const int s = tid / C;
  const float* w_col = w_sh + s * KS * ld + c;
  cluster.sync();  // slices and h_0 in place; every peer has started

  for (int step = 0; step < T_len; ++step) {
    const int t = d.reverse ? T_len - 1 - step : step;
    const int cur = step & 1;
    const float* h_cur = h_sh + cur * RB * H + s * KS;
    float acc[RB];
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) acc[rr] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < KS; k += 4) {
      const float w0 = w_col[k * ld];
      const float w1 = w_col[(k + 1) * ld];
      const float w2 = w_col[(k + 2) * ld];
      const float w3 = w_col[(k + 3) * ld];
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        const float4 hv =
            *reinterpret_cast<const float4*>(h_cur + rr * H + k);
        acc[rr] = fmaf(hv.x, w0, acc[rr]);
        acc[rr] = fmaf(hv.y, w1, acc[rr]);
        acc[rr] = fmaf(hv.z, w2, acc[rr]);
        acc[rr] = fmaf(hv.w, w3, acc[rr]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) part[(s * RB + rr) * C + c] = acc[rr];
    __syncthreads();  // the four k-slice partials are complete

    if (owner) {
      const int u = unit - q * U;
      float a[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float* p = part + r * C + g * U + u;
        const float hw = ((p[0] + p[RB * C]) + p[2 * RB * C]) + p[3 * RB * C];
        a[g] = xv[g] + hw;
      }
      const float gi = lstm::sigmoid_f(a[0]);
      const float gf = lstm::sigmoid_f(a[1]);
      const float gg = tanhf(a[2]);
      const float go = lstm::sigmoid_f(a[3]);
      const float cn = gf * c_sh[tid] + gi * gg;
      c_sh[tid] = cn;
      const float h = go * tanhf(cn);
      if (step + 1 < T_len) {
        const int nxt = (1 - cur) * RB * H + r * H + unit;
        for (int p = 0; p < NC; ++p) {
          cluster.map_shared_rank(h_sh, p)[nxt] = h;
        }
      }
      if (live) {
        const size_t row = static_cast<size_t>(b) * T_len + t;
        lstm::store_f(ys + row * H + unit, h);
        lstm::store_f(cs + row * H + unit, cn);
        if (acts) {
          float* act = acts + row * four_h + unit;
          act[0] = gi;
          act[H] = gf;
          act[2 * H] = gg;
          act[3 * H] = go;
        }
        if (step + 1 < T_len) fetch_xw(step + 1);
      }
    }
    // h_t is in every peer's next buffer, and every CTA is done with the
    // current one, which the next step's stores overwrite
    if (step + 1 < T_len) cluster.sync();
  }
}

// One cluster launch of lstm_fwd_kernel<T, RB>; its attributes are set on
// its first launch on each device.
template <typename T, int RB>
int launch_rows(Direction d0, Direction d1, int n_dir, int B, int T_len,
                int H, const lstm::Geometry& g, bool vec, cudaStream_t s) {
  static std::atomic<unsigned long long> configured{0};
  return lstm::launch_cluster(lstm_fwd_kernel<T, RB>, configured, g,
                              (B + RB - 1) / RB, n_dir, s, d0, d1, B, T_len,
                              H, vec);
}

template <typename T>
int launch(Direction d0, Direction d1, int n_dir, int B, int T_len, int H,
           const lstm::Geometry& g, cudaStream_t s) {
  const int U = H / lstm::kCluster;
  const bool vec = U % 4 == 0 && lstm::aligned(d0.w_h, 4 * sizeof(T)) &&
                   lstm::aligned(d1.w_h, 4 * sizeof(T));
  switch (g.rows) {
    case 1:
      return launch_rows<T, 1>(d0, d1, n_dir, B, T_len, H, g, vec, s);
    case 2:
      return launch_rows<T, 2>(d0, d1, n_dir, B, T_len, H, g, vec, s);
    case 4:
      return launch_rows<T, 4>(d0, d1, n_dir, B, T_len, H, g, vec, s);
    default:
      return launch_rows<T, 8>(d0, d1, n_dir, B, T_len, H, g, vec, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. n_dir is 1 or 2; the
// second direction's pointers are ignored when n_dir == 1. acts is fp32
// [B, T, 4H], or null where the gate activations are not wanted. rows is
// ops/cuda_lstm.py:lstm_geometry's; threads and shared bytes follow from
// (H, rows). One cluster launch on `stream`. Returns its cudaError_t.
extern "C" int maavss_lstm_fwd(const void* xw0, const void* wh0, void* ys0,
                               void* cs0, void* acts0, int rev0,
                               const void* xw1, const void* wh1, void* ys1,
                               void* cs1, void* acts1, int rev1, int n_dir,
                               int B, int T_len, int H, int dtype, int rows,
                               void* stream) {
  lstm::Geometry g;
  if (n_dir < 1 || n_dir > 2 || B < 1 || T_len < 1 || dtype < 0 ||
      dtype > 2 || !lstm::make_geometry(H, rows, false, &g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Direction d0{xw0, wh0, ys0, cs0, static_cast<float*>(acts0), rev0};
  Direction d1 = n_dir == 2 ? Direction{xw1, wh1, ys1, cs1,
                                        static_cast<float*>(acts1), rev1}
                            : d0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(d0, d1, n_dir, B, T_len, H, g, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(d0, d1, n_dir, B, T_len, H, g, s);
  }
  return launch<__half>(d0, d1, n_dir, B, T_len, H, g, s);
}

// How many clusters of K1's kernels the current device runs side by side,
// one CTA an SM (lstm::clusters_at_once, asked of the forward with 256
// threads; the answer is the GPCs' and holds for the backward sweep and
// every H). ops/cuda_lstm.py:lstm_geometry picks the rows per cluster so
// that no more clusters than this run at once where the batch allows. A
// negative cudaError_t on failure.
extern "C" int maavss_lstm_clusters_at_once() {
  return lstm::clusters_at_once(lstm_fwd_kernel<float, 1>, 256);
}
