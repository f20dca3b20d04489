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
//             dcbias = 0 exactly (the bias cancels in yc - mu)
// with fp32 sums and statistics; x, w2, y, dy, dx, dw2 in x's type (fp32,
// bf16 or fp16).
//
// Forward, one launch. The TPU kernel carries the per-channel sums across
// its sequential grid in VMEM; Hopper's blocks run in parallel, so the
// forward is one cooperative launch of at most the blocks the card keeps
// resident, with one grid barrier between the register-tiled conv of
// pgenc_conv.cuh, which writes yc and each tile's per-channel partial
// sums, and the normalise + tanh, which reads the partials in one fixed
// order (conv_bn_train_kernel, below). yc is returned: it is the
// backward's residual.
//
// Backward, two launches, every sum in a fixed order (two runs give the
// same bits). The TPU kernel recomputes the conv from x to spare VMEM; here
// the forward's fp32 yc is kept (7.3 MB per scan window of the fusion
// flagship's 10 layers at R = 64), so the backward reads yc, dy, x, w2 and
// the per-channel vectors, and never writes over yc (autograd saves it; a
// second backward must read it again).
//   (1) bn_bwd_kernel: one thread-block cluster of P <= 8 blocks of 1024
//       threads per channel (P from the channel's R*So values, 4096 per
//       block, read four at a time). Each block sums dq*z and dq over its
//       slice; the partials combine in rank order through distributed
//       shared memory, so every block holds the channel's dgamma and dbeta
//       and writes dyc over its slice into a buffer of its own. dyc is
//       written once because both products read it; forming it in each
//       would repeat the tanh and read yc and dy twice. Rank 0 writes
//       (0, dgamma, dbeta); block (0, 0) zeroes the tile counters of (2).
//   (2) grads_kernel: dx and dw2 in one grid, blocks [0, nbx) for dx, the
//       rest for dw2.
//       dx, per block a tile of rows x input channels x output pairs
//       (j = 2m, 2m+1): w2's column block and the rows' dyc window are
//       staged in shared memory, 32 output channels at a time; each thread
//       holds 4 channels x TM pairs in registers (the even output takes the
//       five even taps, the odd one the four odd taps, over dyc[m-2..m+2]).
//       dw2 = dyc [Co, R*So] x taps [R*So, 9C]: per block a tile of output
//       x input channels (all 9 taps); a K stage stages dyc for the tile's
//       output channels and the x rows (padded by 4) for its input
//       channels, and a thread reads its 9 taps from the staged row by
//       offset 2*so + k, with no division per element. K is split over G
//       thread groups in a block, combined in a fixed tree in shared
//       memory, and over `splits` blocks (about 264 dw2 blocks in all, so
//       that the shallow layers' [2, 9]- and [4, 18]-sized outputs over
//       131k and 65k terms are read by the whole card): each writes its
//       partial tile, and the last of a tile's blocks to count itself in
//       (an atomic counter, zeroed by (1)) sums the partial tiles in a
//       fixed tree over the split index. Which block is last varies; the
//       order of the sums does not.
//       Every stage is copied by cp.async, 16 bytes where the rows and the
//       operands' alignment allow (a view at an odd offset takes 4-byte
//       copies; bf16 and fp16 operands are loaded and converted), so that
//       a thread has all its copies of a stage in flight at once and a
//       stage costs one memory latency.
//       The dx grid aims at >= 132 blocks (TM = 1 when TM = 2 gives fewer).
//
// What bounds it on Hopper: the work is the two products, 2*Co*9C*R*So
// FLOPs each, fp32 on the CUDA cores (1.16 GFLOP over the flagship's 10
// layers at R = 64: 0.017 ms at 67 TFLOP/s), and x, yc, dy read and dx, dw2
// written once (about 31 MB: 0.009 ms at 3.35 TB/s). At R = 64 every
// layer's tensors sit in the 50 MB L2; the 20 launches of a 10-layer
// backward, each a chain of dependent stages (stage, compute, tree, count
// in, sum), and the deep layers' dx on 16-64 blocks bound it.
//
// What bounds the forward: the flagship's 10 layers at R = 64 do 580 MFLOP
// (8.7 us at 67 TFLOP/s fp32) and move ~7 MB; each layer is a chain of one
// launch, a stage from L2, the FMAs, a grid barrier and the stores, so the
// ten launches and barriers bound it (see pgenc_eval.cu for the tile plan).

#include "pgenc_conv.cuh"

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

using namespace pgenc;

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

// K2-train's forward, one cooperative launch. Phase 1: the block walks its
// share of the tiles, [t0, t1) in tile order; for each it stages, sums,
// writes yc = sums + cbias, and writes the tile's per-channel sum and sum of
// squares of yc (the thread's run, then its channel group's threads by a
// fixed xor butterfly, then its warps in order) to partial [Co][2][per_cb].
// grid.sync(). Phase 2: for each channel block it meets, the block sums
// that channel block's partials, all its channels at once, in one fixed
// order (channel_stats), so every block gets the same bits, and
// mu = s / N, var = ss / N - mu^2
// (biased, as the TPU kernel and flax); the block that owns the channel
// block's tile 0 writes them out. It then normalises its tiles: the last
// from the sums it still holds in registers, the others from the yc it
// wrote (read back through L2), and writes y. No counter: the grid barrier
// is the launch's own, so a replayed CUDA graph needs no reset.
template <typename T>
struct TrainArgs {
  const T* x;
  const T* w2;
  const float* cbias;
  const float* gamma;
  const float* beta;
  float* yc;
  T* y;
  float* mu;
  float* var;
  float* partial;  // [Co][2][pstride]: tile p's at poff + p
  Shape d;
  TilePlan p;
  bool vec;  // 16-byte (bf16, fp16: 8-byte) copies of x
  int pstride;    // partials a (channel, sum) row holds
  int poff;       // where this launch's tiles write in a row
  int nparts;     // partials of a row the statistics sum
  long long ntot; // values a channel's statistics cover
};

// acc += cbias; yc written; the tile's per-channel partial sums written.
// Every thread of the block calls it.
template <typename T, int TC>
__device__ void tile_sums(const TrainArgs<T>& a, const Role& t, const Tile& q,
                          const float (&cb)[TC], float (&acc)[TC][kTso],
                          float (&wsum)[kMaxWarps][2 * 4]) {
  const Shape& d = a.d;
  const TilePlan& p = a.p;
  const int r = q.r0 + t.rl;
  const int so0 = q.s0 + kTso * t.sq;
  const bool mine = t.g == 0 && r < d.R && so0 < d.So;
  float s[TC], ss[TC];
#pragma unroll
  for (int c = 0; c < TC; ++c) {
    s[c] = 0.0f;
    ss[c] = 0.0f;
    const int co = q.c0 + t.cg * TC + c;
    if (!mine || co >= d.Co) continue;
#pragma unroll
    for (int j = 0; j < kTso; ++j) {
      acc[c][j] += cb[c];
      if (so0 + j < d.So) {
        s[c] += acc[c][j];
        ss[c] += acc[c][j] * acc[c][j];
      }
    }
    store_run(a.yc + (static_cast<size_t>(co) * d.R + r) * d.So, so0, d.So,
              acc[c]);
  }
  // the npc threads of a channel group are consecutive and aligned to npc
  const int npc = p.br * p.nsg;
  const int width = npc < 32 ? npc : 32;
  for (int off = 1; off < width; off <<= 1) {
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      s[c] += __shfl_xor_sync(0xffffffffu, s[c], off);
      ss[c] += __shfl_xor_sync(0xffffffffu, ss[c], off);
    }
  }
  float* part = a.partial;
  if (npc <= 32) {
    if (t.g != 0 || (t.ot & (npc - 1)) != 0) return;
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int co = q.c0 + t.cg * TC + c;
      if (co >= d.Co) break;
      part[static_cast<size_t>(2 * co) * a.pstride + a.poff + q.p] = s[c];
      part[static_cast<size_t>(2 * co + 1) * a.pstride + a.poff + q.p] =
          ss[c];
    }
    return;
  }
  const int warp = threadIdx.x / 32;
  if (t.g == 0 && threadIdx.x % 32 == 0) {
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      wsum[warp][2 * c] = s[c];
      wsum[warp][2 * c + 1] = ss[c];
    }
  }
  __syncthreads();
  const int col = threadIdx.x;
  if (col >= p.bc || q.c0 + col >= d.Co) return;
  const int wpc = npc / 32;  // warps of a channel group
  const int w0 = col / TC * wpc, c = col % TC;
  float st = 0.0f, sst = 0.0f;
  for (int w = 0; w < wpc; ++w) {
    st += wsum[w0 + w][2 * c];
    sst += wsum[w0 + w][2 * c + 1];
  }
  const int co = q.c0 + col;
  part[static_cast<size_t>(2 * co) * a.pstride + a.poff + q.p] = st;
  part[static_cast<size_t>(2 * co + 1) * a.pstride + a.poff + q.p] = sst;
}

// The statistics of the tile's channel block from every tile's partials
// into cmu, cinv (and mu, var out from the block that owns tile 0 of the
// channel block). The block's threads split into runs of L lanes (L a
// power of 2 that depends on the plan alone), run c for the block's
// channel c: lane l adds partials l, l + L, ... in order, then the run's
// lanes meet in a fixed xor butterfly and, where a run spans warps, its
// warps in order. So every block gets the same bits for a channel. Every
// thread of the block calls it.
constexpr int kBatch = 8;  // partials a lane loads at once

template <typename T>
__device__ void channel_stats(const TrainArgs<T>& a, const Tile& q,
                              float (&csum)[kMaxWarps][2], float* cmu,
                              float* cinv, float* cgam, float* cbet) {
  const Shape& d = a.d;
  const TilePlan& p = a.p;
  int runs = 1;
  while (runs < p.bc) runs <<= 1;
  int lanes = 1;
  while (2 * lanes * runs <= static_cast<int>(blockDim.x)) lanes <<= 1;
  const int c = threadIdx.x / lanes, l = threadIdx.x % lanes;
  const bool mine = c < min(p.bc, d.Co - q.c0);
  __syncthreads();  // every warp is done normalising the previous tile
  if (mine && l == 0) {
    cgam[c] = a.gamma[q.c0 + c];
    cbet[c] = a.beta[q.c0 + c];
  }
  float s = 0.0f, ss = 0.0f;
  if (mine) {
    // kBatch partials in flight at once, then added in index order
    const float* ps = a.partial + static_cast<size_t>(2 * (q.c0 + c)) *
                                      a.pstride;
    for (int i0 = l; i0 < a.nparts; i0 += kBatch * lanes) {
      float v[kBatch], vv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * lanes;
        v[u] = i < a.nparts ? __ldcg(ps + i) : 0.0f;
        vv[u] = i < a.nparts ? __ldcg(ps + a.pstride + i) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        s += v[u];
        ss += vv[u];
      }
    }
  }
  for (int off = 1; off < lanes && off < 32; off <<= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (lanes > 32) {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
      csum[warp][0] = s;
      csum[warp][1] = ss;
    }
    __syncthreads();
    if (mine && l == 0) {
      s = 0.0f;
      ss = 0.0f;
      for (int w = warp; w < warp + lanes / 32; ++w) {
        s += csum[w][0];
        ss += csum[w][1];
      }
    }
  }
  if (mine && l == 0) {
    const float n = static_cast<float>(a.ntot);
    const float m = s / n;
    const float v = ss / n - m * m;
    cmu[c] = m;
    cinv[c] = rsqrtf(v + kEps);
    if (q.p == 0) {
      a.mu[q.c0 + c] = m;
      a.var[q.c0 + c] = v;
    }
  }
  __syncthreads();
}

// y = tanh(gamma * (yc - mu) * inv + beta) over the thread's run of the
// tile, from the sums it holds (`held`) or from the yc it wrote.
template <typename T, int TC>
__device__ void normalise(const TrainArgs<T>& a, const Role& t, const Tile& q,
                          const float (&acc)[TC][kTso], bool held,
                          const float* cmu, const float* cinv,
                          const float* cgam, const float* cbet) {
  const Shape& d = a.d;
  const int r = q.r0 + t.rl;
  const int so0 = q.s0 + kTso * t.sq;
  if (t.g != 0 || r >= d.R || so0 >= d.So) return;
#pragma unroll
  for (int c = 0; c < TC; ++c) {
    const int cl = t.cg * TC + c;
    const int co = q.c0 + cl;
    if (co >= d.Co) break;
    const size_t row = (static_cast<size_t>(co) * d.R + r) * d.So;
    float v[kTso];
    if (held) {
#pragma unroll
      for (int j = 0; j < kTso; ++j) v[j] = acc[c][j];
    } else if (d.So % kTso == 0) {
      const float4 u = __ldcg(reinterpret_cast<const float4*>(a.yc + row +
                                                              so0));
      v[0] = u.x;
      v[1] = u.y;
      v[2] = u.z;
      v[3] = u.w;
    } else {
#pragma unroll
      for (int j = 0; j < kTso; ++j) {
        v[j] = so0 + j < d.So ? __ldcg(a.yc + row + so0 + j) : 0.0f;
      }
    }
    const float g = cgam[cl], b = cbet[cl], m = cmu[cl], inv = cinv[cl];
#pragma unroll
    for (int j = 0; j < kTso; ++j) v[j] = tanhf(g * (v[j] - m) * inv + b);
    store_run(a.y + row, so0, d.So, v);
  }
}

// The phases a launch of conv_bn_train_kernel runs: the conv with the
// tiles' partial sums, the statistics and the normalise, or both with the
// grid barrier between (the one cooperative launch).
constexpr int kConv = 1;
constexpr int kApply = 2;
constexpr int kFused = kConv | kApply;

template <typename T, int TC, int PHASE>
__global__ void __launch_bounds__(kMaxThreads)
conv_bn_train_kernel(const TrainArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float wsum[kMaxWarps][2 * 4];
  __shared__ float csum[kMaxWarps][2];
  __shared__ float cmu[kMaxBc], cinv[kMaxBc], cgam[kMaxBc], cbet[kMaxBc];
  const TilePlan& p = a.p;
  const Role t = role_of(p);
  const long long n = p.tiles;
  const int t0 = static_cast<int>(blockIdx.x * n / gridDim.x);
  const int t1 = static_cast<int>((blockIdx.x + 1) * n / gridDim.x);
  float acc[TC][kTso] = {};
  for (int ti = t0; ti < t1 && (PHASE & kConv); ++ti) {
    const Tile q = tile_at(p, ti);
    float cbias[TC];  // loaded while the tile stages
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      cbias[c] = a.cbias[min(q.c0 + t.cg * TC + c, a.d.Co - 1)];
    }
    __syncthreads();  // the previous tile's shared memory is consumed
    stage_tile(a.x, a.w2, a.d, p, q, smem, a.vec);
    __syncthreads();
    conv_tile<TC>(smem, a.d, p, t, acc);
    group_sum<TC>(smem, p, t, acc);
    tile_sums<T, TC>(a, t, q, cbias, acc, wsum);
  }
  if constexpr (PHASE == kFused) cg::this_grid().sync();
  int cb = -1;
  for (int ti = t0; ti < t1 && (PHASE & kApply); ++ti) {
    const Tile q = tile_at(p, ti);
    if (q.cb != cb) {
      channel_stats(a, q, csum, cmu, cinv, cgam, cbet);
      cb = q.cb;
    }
    normalise<T, TC>(a, t, q, acc, PHASE == kFused && ti == t1 - 1, cmu,
                     cinv, cgam, cbet);
  }
}

constexpr int kBnThreads = 1024;
constexpr int kGradThreads = 256;
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr int kBnPerBlock = 4096;  // values of a channel per BN block
constexpr int kDxChunk = 32;       // output channels staged per dx pass
constexpr int kTargetBlocks = 132;
constexpr int kDwBlocks = 264;     // dw2 blocks to aim at: two per SM
constexpr size_t kStageBytes = 100 * 1024;  // dw2's K stage

struct BnChannel {
  float m, inv, g, b;
  // z and dq of one value
  __device__ __forceinline__ void terms(float y, float d, float& z,
                                        float& dq) const {
    z = (y - m) * inv;
    const float out = tanhf(g * z + b);
    dq = d * (1.0f - out * out);
  }
};

// What a launch of bn_bwd_kernel does: the sums and dyc (the fused
// route), the sums alone, or dyc alone from sums it is given.
constexpr int kBnFused = 0;
constexpr int kBnSums = 1;
constexpr int kBnDyc = 2;

// BN backward, grid (P, Co), cluster (P, 1, 1): the cluster of channel co
// sums dq*z and dq, then writes dyc over the channel; rank 0 writes
// vec3 [3, Co] = (0, dgamma, dbeta). Each block takes a slice of the
// channel's n values, four at a time when `vec` (n % 4 == 0 and yc, dy
// aligned for it). Block (0, 0) also zeroes the grads kernel's n_count tile
// counters. MODE kBnSums stops once vec3 is written (and zeroes no
// counter); MODE kBnDyc, launched without a cluster, takes the sums from
// `sums` [2, Co] (dgamma's, then dbeta's) over `ntot` values a channel in
// place of its own: the split route, whose sums are a data group's.
template <typename T, int MODE>
__global__ void __launch_bounds__(kBnThreads)
bn_bwd_kernel(const float* __restrict__ yc, const T* __restrict__ dy,
              const float* __restrict__ mu, const float* __restrict__ var,
              const float* __restrict__ gamma,
              const float* __restrict__ beta, float* __restrict__ dyc,
              float* __restrict__ vec3, int* __restrict__ counts,
              int n_count, int n, int Co, bool vec,
              const float* __restrict__ sums, float ntot) {
  __shared__ float red[2 * kBnThreads];
  __shared__ float part[2];
  __shared__ float tot[2];
  // a cluster spans the blocks of one channel, in x
  const int P = static_cast<int>(gridDim.x);
  const int rank = static_cast<int>(blockIdx.x);
  const int co = blockIdx.y;
  if (MODE != kBnSums && co == 0 && rank == 0) {
    for (int i = threadIdx.x; i < n_count; i += blockDim.x) counts[i] = 0;
  }
  const int per = ((n + P - 1) / P + 3) / 4 * 4;
  const int begin = min(n, rank * per);
  const int end = min(n, begin + per);
  const BnChannel ch{mu[co], rsqrtf(var[co] + kEps), gamma[co], beta[co]};
  const float* y = yc + static_cast<size_t>(co) * n;
  const T* d = dy + static_cast<size_t>(co) * n;
  float* out = dyc + static_cast<size_t>(co) * n;
  const int step = vec ? 4 * blockDim.x : blockDim.x;
  const int first = begin + (vec ? 4 : 1) * threadIdx.x;
  float z, dq, dgn, dbn;
  if constexpr (MODE == kBnDyc) {
    dgn = sums[co] / ntot;
    dbn = sums[Co + co] / ntot;
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    float sdg = 0.0f, sdb = 0.0f;
#pragma unroll 4
    for (int i = first; i < end; i += step) {
      if (vec) {
        const float4 yv = load4(y + i);
        const float4 dv = load4(d + i);
        ch.terms(yv.x, dv.x, z, dq);
        sdg += dq * z;
        sdb += dq;
        ch.terms(yv.y, dv.y, z, dq);
        sdg += dq * z;
        sdb += dq;
        ch.terms(yv.z, dv.z, z, dq);
        sdg += dq * z;
        sdb += dq;
        ch.terms(yv.w, dv.w, z, dq);
        sdg += dq * z;
        sdb += dq;
      } else {
        ch.terms(y[i], load_f(d + i), z, dq);
        sdg += dq * z;
        sdb += dq;
      }
    }
    block_sum2(sdg, sdb, red);
    if (threadIdx.x == 0) {
      part[0] = sdg;
      part[1] = sdb;
    }
    cluster.sync();
    if (threadIdx.x == 0) {
      float dg = 0.0f, db = 0.0f;
      for (int q = 0; q < P; ++q) {
        const float* pq = cluster.map_shared_rank(part, q);
        dg += pq[0];
        db += pq[1];
      }
      tot[0] = dg;
      tot[1] = db;
      if (rank == 0) {
        vec3[co] = 0.0f;
        vec3[Co + co] = dg;
        vec3[2 * Co + co] = db;
      }
    }
    cluster.sync();  // no block leaves while another reads its partials
    if constexpr (MODE == kBnSums) return;
    const float nf = static_cast<float>(n);
    dgn = tot[0] / nf;
    dbn = tot[1] / nf;
  }
  const float ginv = ch.g * ch.inv;
#pragma unroll 4
  for (int i = first; i < end; i += step) {
    if (vec) {
      const float4 yv = load4(y + i);
      const float4 dv = load4(d + i);
      float4 o;
      ch.terms(yv.x, dv.x, z, dq);
      o.x = ginv * (dq - dbn - z * dgn);
      ch.terms(yv.y, dv.y, z, dq);
      o.y = ginv * (dq - dbn - z * dgn);
      ch.terms(yv.z, dv.z, z, dq);
      o.z = ginv * (dq - dbn - z * dgn);
      ch.terms(yv.w, dv.w, z, dq);
      o.w = ginv * (dq - dbn - z * dgn);
      *reinterpret_cast<float4*>(out + i) = o;
    } else {
      ch.terms(y[i], load_f(d + i), z, dq);
      out[i] = ginv * (dq - dbn - z * dgn);
    }
  }
}

struct Dims {
  int C, R, S, Co, So;
  bool vec;  // x and w2 allow 16-byte (bf16, fp16: 8-byte) loads
};

// dx blocks: threads tm (pairs) x tc (groups of 4 input channels) x br
// (rows), tm fastest; nb_* blocks along pairs, channels and rows.
struct DxPlan {
  int tm, tc, br;
  int nb_m, nb_c, nb_r;
  int blocks;  // nb_m * nb_c * nb_r
  int kc;      // output channels per staged pass
};

// dw2 blocks: a tile of bmo output x bci input channels (x 9 taps), the K
// axis (R*So) cut into nt stages of 2^kr_log rows x 2^ks_log so's (n_seg
// segments per row), split over `splits` blocks per tile, whose partial
// tiles the last block of the tile to finish sums in split order.
struct DwPlan {
  int bmo, bci, n_ct, tiles, splits, splits_p2;  // splits_p2: next power of 2
  int ks_log, kr_log, n_seg, nt;
};

template <typename T, int TM>
__device__ void dx_role(const float* __restrict__ dyc,
                        const T* __restrict__ w2, T* __restrict__ dx,
                        const Dims d, const DxPlan p, int b, float* smem) {
  const int bm = b % p.nb_m;
  const int bc = (b / p.nb_m) % p.nb_c;
  const int brow = b / (p.nb_m * p.nb_c);
  const int BM = TM * p.tm;  // output pairs per block
  const int BC = 4 * p.tc;   // input channels per block (a power of 2)
  const int DL = BM + 8;     // staged dyc row: so = m0 - 4 .. m0 + BM + 3
  const int m0 = bm * BM, c0 = bc * BC, r0 = brow * p.br;
  float* ws = smem;                       // [kc][9][BC]
  float* ds = smem + p.kc * kTaps * BC;   // [kc][br][DL]
  const int tid = threadIdx.x;
  const int tmid = tid % p.tm;
  const int tcid = (tid / p.tm) % p.tc;
  const int trid = tid / (p.tm * p.tc);
  const int nine_c = kTaps * d.C;
  // whole groups of 4 where rows of w2 and dyc allow 16-byte copies
  const bool vw = d.vec && d.C % 4 == 0;
  const bool vd = d.So % 4 == 0 && BM % 4 == 0;
  float acc_e[4][TM] = {}, acc_o[4][TM] = {};
  for (int co0 = 0; co0 < d.Co; co0 += p.kc) {
    const int kc_n = min(p.kc, d.Co - co0);
    __syncthreads();  // the previous pass is consumed
    if (vw) {
      const int g4 = BC / 4;
#pragma unroll 4
      for (int i = tid; i < kc_n * kTaps * g4; i += blockDim.x) {
        const int cg = i & (g4 - 1);
        const int kk = i / g4;
        const int kc = kk / kTaps;
        const int ci = c0 + 4 * cg;
        const bool ok = ci < d.C;
        stage4(ws + kk * BC + 4 * cg,
               w2 + (ok ? static_cast<size_t>(co0 + kc) * nine_c +
                              (kk - kc * kTaps) * d.C + ci
                        : 0),
               ok);
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < kc_n * kTaps * BC; i += blockDim.x) {
        const int ci = c0 + (i & (BC - 1));
        const int kk = i / BC;
        const int kc = kk / kTaps;
        const bool ok = ci < d.C;
        stage(ws + i,
              w2 + (ok ? static_cast<size_t>(co0 + kc) * nine_c +
                             (kk - kc * kTaps) * d.C + ci
                       : 0),
              ok);
      }
    }
    const int per = vd ? DL / 4 : DL;  // copies per staged row
#pragma unroll 4
    for (int i = tid; i < kc_n * p.br * per; i += blockDim.x) {
      const int kr = i / per;
      const int q = (i - kr * per) * (vd ? 4 : 1);
      const int kc = kr / p.br;
      const int r = r0 + kr - kc * p.br;
      const int so = m0 - 4 + q;
      const bool ok = r < d.R && so >= 0 && so < d.So;
      const float* src =
          dyc + (ok ? (static_cast<size_t>(co0 + kc) * d.R + r) * d.So + so
                    : 0);
      if (vd) {
        stage4(ds + kr * DL + q, src, ok);
      } else {
        stage(ds + kr * DL + q, src, ok);
      }
    }
    cp_wait();
    __syncthreads();
    for (int kc = 0; kc < kc_n; ++kc) {
      float w[kTaps][4];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(
            ws + (kc * kTaps + k) * BC + tcid * 4);
        w[k][0] = v.x;
        w[k][1] = v.y;
        w[k][2] = v.z;
        w[k][3] = v.w;
      }
      const float* drow = ds + (kc * p.br + trid) * DL + tmid * TM + 2;
      float dv[TM + 4];
#pragma unroll
      for (int q = 0; q < TM + 4; ++q) dv[q] = drow[q];
      // pair m: dx[2m] = sum_t w[2t] dyc[m+2-t], dx[2m+1] = sum_t w[2t+1]
      // dyc[m+2-t]; dyc[m+2-t] is dv[i + 4 - t]
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int t = 0; t < 5; ++t) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc_e[c][i] = fmaf(w[2 * t][c], dv[i + 4 - t], acc_e[c][i]);
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc_o[c][i] = fmaf(w[2 * t + 1][c], dv[i + 4 - t], acc_o[c][i]);
          }
        }
      }
    }
  }
  const int r = r0 + trid;
  if (r >= d.R) return;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int ci = c0 + tcid * 4 + c;
    if (ci >= d.C) continue;
    T* row = dx + (static_cast<size_t>(ci) * d.R + r) * d.S;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + tmid * TM + i;
      if (m < d.So) {
        store_f(row + 2 * m, acc_e[c][i]);
        store_f(row + 2 * m + 1, acc_o[c][i]);
      }
    }
  }
}

// One split of one dw2 tile; `partial` holds tiles x splits fp32 tiles,
// `counts` one counter per tile (zeroed by the BN kernel).
template <typename T, int TMO, int TCI>
__device__ void dw_role(const float* __restrict__ dyc,
                        const T* __restrict__ x, T* __restrict__ dw2,
                        float* __restrict__ partial, int* __restrict__ counts,
                        const Dims d, const DwPlan p, int tile, int split,
                        float* smem) {
  __shared__ bool last;
  const int KS = 1 << p.ks_log;
  const int KR = 1 << p.kr_log;
  const int ke_log = p.ks_log + p.kr_log;
  const int KE = 1 << ke_log;
  const int AS = KE + 4;                // staged dyc row stride
  const int XL = 2 * KS + 2 * kPad;     // staged x row: positions 2*s0-4 ..
  const int XCS = KR * XL + 4;          // per input channel
  float* as = smem;                     // [bmo][AS]
  float* xs = smem + p.bmo * AS;        // [bci][KR][XL] (+4)
  const int co0 = (tile / p.n_ct) * p.bmo;
  const int ci0 = (tile % p.n_ct) * p.bci;
  const int n_om = p.bmo / TMO;
  const int nto = n_om * (p.bci / TCI);
  const int G = blockDim.x / nto;       // K groups in the block
  const int ot = threadIdx.x % nto;
  const int g = threadIdx.x / nto;
  const int om = ot % n_om;
  const int oc = ot / n_om;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarp = blockDim.x / 32;
  // 16-byte copies: dyc rows of whole groups of 4 so's, x rows of 4 s's
  const bool va = d.So % 4 == 0 && KS >= 4;
  const bool vx = d.vec && d.S % 4 == 0 && KS >= 2;
  float acc[TMO][TCI][kTaps] = {};
  const int st_end = (split + 1) * p.nt / p.splits;
  for (int st = split * p.nt / p.splits; st < st_end; ++st) {
    const int rb = (st / p.n_seg) * KR;
    const int s0 = (st % p.n_seg) * KS;
    __syncthreads();  // the previous stage is consumed
    const int a_log = va ? ke_log - 2 : ke_log;
    const int a_w = va ? 4 : 1;
#pragma unroll 4
    for (int i = threadIdx.x; i < (p.bmo << a_log); i += blockDim.x) {
      const int col = i >> a_log;
      const int e = (i & ((1 << a_log) - 1)) * a_w;
      const int r = rb + (e >> p.ks_log);
      const int so = s0 + (e & (KS - 1));
      const int co = co0 + col;
      const bool ok = co < d.Co && r < d.R && so < d.So;
      const float* src =
          dyc + (ok ? (static_cast<size_t>(co) * d.R + r) * d.So + so : 0);
      if (va) {
        stage4(as + col * AS + e, src, ok);
      } else {
        stage(as + col * AS + e, src, ok);
      }
    }
    const int x_w = vx ? 4 : 1;
    for (int row = warp; row < p.bci * KR; row += nwarp) {
      const int cl = row >> p.kr_log;
      const int rr = row & (KR - 1);
      const int ci = ci0 + cl, r = rb + rr;
      float* dst = xs + cl * XCS + rr * XL;
      const bool row_ok = ci < d.C && r < d.R;
      const size_t base = row_ok ? (static_cast<size_t>(ci) * d.R + r) * d.S
                                 : 0;
#pragma unroll 4
      for (int q = lane * x_w; q < XL; q += 32 * x_w) {
        const int s = 2 * s0 - kPad + q;
        const bool ok = row_ok && s >= 0 && s < d.S;
        const T* src = x + (ok ? base + s : 0);
        if (vx) {
          stage4(dst + q, src, ok);
        } else {
          stage(dst + q, src, ok);
        }
      }
    }
    cp_wait();
    __syncthreads();
    for (int e = g; e < KE; e += G) {
      const int rr = e >> p.ks_log;
      const int s = e & (KS - 1);
      float a[TMO];
#pragma unroll
      for (int i = 0; i < TMO; ++i) a[i] = as[(om * TMO + i) * AS + e];
#pragma unroll
      for (int j = 0; j < TCI; ++j) {
        const float* xr = xs + (oc * TCI + j) * XCS + rr * XL + 2 * s;
        float xv[kTaps];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 v = *reinterpret_cast<const float2*>(xr + 2 * h);
          xv[2 * h] = v.x;
          xv[2 * h + 1] = v.y;
        }
        xv[8] = xr[8];
#pragma unroll
        for (int i = 0; i < TMO; ++i) {
#pragma unroll
          for (int k = 0; k < kTaps; ++k) {
            acc[i][j][k] = fmaf(a[i], xv[k], acc[i][j][k]);
          }
        }
      }
    }
  }
  // the block's G partial tiles red[g][o], o = (co_l * bci + ci_l) * 9 + k,
  // summed in a fixed tree, then written as this split's partial tile
  const int nout = p.bmo * p.bci * kTaps;
  float* red = smem;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TMO; ++i) {
#pragma unroll
    for (int j = 0; j < TCI; ++j) {
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        red[g * nout + ((om * TMO + i) * p.bci + oc * TCI + j) * kTaps + k] =
            acc[i][j][k];
      }
    }
  }
  __syncthreads();
  for (int half = G / 2; half > 0; half >>= 1) {
    for (int i = threadIdx.x; i < half * nout; i += blockDim.x) {
      red[i] += red[i + half * nout];
    }
    __syncthreads();
  }
  float* mine = partial + (static_cast<size_t>(tile) * p.splits + split) *
                              nout;
  for (int o = threadIdx.x; o < nout; o += blockDim.x) mine[o] = red[o];
  __threadfence();  // this split's tile is visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counts + tile, 1) == p.splits - 1;
  __syncthreads();
  if (!last) return;
  // the last split of the tile sums the splits' tiles [splits][nout] in a
  // fixed tree over the split axis (zero-padded to splits_p2); the tiles
  // come in by 16-byte cp.async (through L2, where the other blocks wrote
  // them) when nout % 4 == 0, all in flight at once
  __threadfence();
  const float* all = partial + static_cast<size_t>(tile) * p.splits * nout;
  const int n_all = p.splits * nout;
  if (nout % 4 == 0) {
#pragma unroll 4
    for (int i = 4 * threadIdx.x; i < n_all; i += 4 * blockDim.x) {
      stage4(red + i, all + i, true);
    }
  } else {
#pragma unroll 8
    for (int i = threadIdx.x; i < n_all; i += blockDim.x) {
      red[i] = __ldcg(all + i);
    }
  }
  for (int i = n_all + threadIdx.x; i < p.splits_p2 * nout;
       i += blockDim.x) {
    red[i] = 0.0f;
  }
  cp_wait();
  __syncthreads();
  for (int half = p.splits_p2 / 2; half > 0; half >>= 1) {
    for (int i = threadIdx.x; i < half * nout; i += blockDim.x) {
      red[i] += red[i + half * nout];
    }
    __syncthreads();
  }
  for (int o = threadIdx.x; o < nout; o += blockDim.x) {
    const float sum = red[o];
    const int col = o / (p.bci * kTaps);
    const int rem = o - col * p.bci * kTaps;
    const int cl = rem / kTaps;
    const int k = rem - cl * kTaps;
    const int co = co0 + col, ci = ci0 + cl;
    if (co < d.Co && ci < d.C) {
      store_f(dw2 + static_cast<size_t>(co) * kTaps * d.C + k * d.C + ci, sum);
    }
  }
}

// dx blocks first, then dw2's tiles x splits.
template <typename T, int TM, int TMO, int TCI>
__global__ void __launch_bounds__(kGradThreads)
grads_kernel(const float* __restrict__ dyc, const T* __restrict__ x,
             const T* __restrict__ w2, T* __restrict__ dx,
             T* __restrict__ dw2, float* __restrict__ partial,
             int* __restrict__ counts, Dims d, DxPlan px, DwPlan pw) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  if (b < px.blocks) {
    dx_role<T, TM>(dyc, w2, dx, d, px, b, smem);
    return;
  }
  const int t = b - px.blocks;
  dw_role<T, TMO, TCI>(dyc, x, dw2, partial, counts, d, pw, t / pw.splits,
                       t % pw.splits, smem);
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// Sets conv_bn_train_kernel<T, TC, PHASE>'s shared memory limit, once a
// device.
template <typename T, int TC, int PHASE = kFused>
cudaError_t configure_train() {
  static std::atomic<unsigned long long> configured{0};
  return configure(conv_bn_train_kernel<T, TC, PHASE>, configured);
}

// Blocks of conv_bn_train_kernel<T, TC> the current device keeps resident
// at (threads, smem): the largest cooperative grid.
template <typename T, int TC>
int train_resident(int threads, int smem, int* n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = configure_train<T, TC>();
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv_bn_train_kernel<T, TC, kFused>, threads, smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *n = per_sm * sms;
  return 0;
}

// One cooperative launch of `grid` blocks; the runtime refuses a grid over
// the resident count (cudaErrorCooperativeLaunchTooLarge), and it is not
// run another way.
template <typename T, int TC>
int train_fwd(const TrainArgs<T>& a, int grid, cudaStream_t s) {
  int e = static_cast<int>(configure_train<T, TC>());
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(a.p.threads);
  cfg.dynamicSmemBytes = a.p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = static_cast<int>(
      cudaLaunchKernelEx(&cfg, conv_bn_train_kernel<T, TC, kFused>, a));
  // read (and so clear) the launch's error even when refused, so that a
  // later launcher's cudaGetLastError does not see it
  const int last = static_cast<int>(cudaGetLastError());
  return e ? e : last;
}

template <typename T>
int train_fwd(const TrainArgs<T>& a, int grid, cudaStream_t s) {
  return a.p.tc == 4 ? train_fwd<T, 4>(a, grid, s)
                     : train_fwd<T, 2>(a, grid, s);
}

// One phase of the split route (PHASE kConv or kApply), an ordinary launch
// of one block a tile: no grid barrier, so no residency limit. The apply
// phase stages nothing and takes no dynamic shared memory.
template <typename T, int TC, int PHASE>
int train_phase(const TrainArgs<T>& a, cudaStream_t s) {
  const size_t smem = PHASE == kConv ? a.p.smem : 0;
  int e = static_cast<int>(configure_train<T, TC, PHASE>());
  if (e) return e;
  conv_bn_train_kernel<T, TC, PHASE>
      <<<a.p.tiles, a.p.threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PHASE>
int train_phase(const TrainArgs<T>& a, cudaStream_t s) {
  return a.p.tc == 4 ? train_phase<T, 4, PHASE>(a, s)
                     : train_phase<T, 2, PHASE>(a, s);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

int pow2ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

int log2i(int v) {  // v a power of 2
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

DxPlan dx_plan(const Dims& d, int tm_pairs) {
  DxPlan p;
  p.tm = std::min(pow2ceil(ceil_div(d.So, tm_pairs)), 64);
  p.tc = std::min(pow2ceil(ceil_div(d.C, 4)), kGradThreads / p.tm);
  p.br = kGradThreads / (p.tm * p.tc);
  p.nb_m = ceil_div(d.So, tm_pairs * p.tm);
  p.nb_c = ceil_div(d.C, 4 * p.tc);
  p.nb_r = ceil_div(d.R, p.br);
  p.blocks = p.nb_m * p.nb_c * p.nb_r;
  p.kc = std::min(kDxChunk, d.Co);
  return p;
}

size_t dx_smem(const DxPlan& p, int tm_pairs) {
  return sizeof(float) * p.kc *
         (kTaps * 4 * p.tc + p.br * (tm_pairs * p.tm + 8));
}

size_t dw_stage_bytes(int bmo, int bci, int ke, int ks) {
  return sizeof(float) * (static_cast<size_t>(bmo) * (ke + 4) +
                          static_cast<size_t>(bci) *
                              ((ke / ks) * (2 * ks + 2 * kPad) + 4));
}

// Tiles as large as 16 x 8 channels, halved (the larger side first) while
// fewer than 16 tiles; about kDwBlocks blocks split K (as many as the last
// block's tree over the splits fits in 100 KB); a K stage as large as
// 100 KB of shared memory and the block's share of K allow.
DwPlan dw_plan(const Dims& d, int tmo, int tci) {
  DwPlan p;
  p.bmo = std::max(tmo, std::min(pow2ceil(d.Co), 16));
  p.bci = std::max(tci, std::min(pow2ceil(d.C), 8));
  auto tiles = [&]() {
    return ceil_div(d.Co, p.bmo) * ceil_div(d.C, p.bci);
  };
  while (tiles() < 16 && (p.bmo > tmo || p.bci > tci)) {
    if (p.bci > tci && (p.bci / tci > p.bmo / tmo || p.bmo == tmo)) {
      p.bci /= 2;
    } else {
      p.bmo /= 2;
    }
  }
  p.n_ct = ceil_div(d.C, p.bci);
  p.tiles = tiles();
  p.splits = ceil_div(kDwBlocks, p.tiles);
  const int ks = std::min(pow2ceil(d.So), 64);
  p.ks_log = log2i(ks);
  p.n_seg = ceil_div(d.So, ks);
  const long long k_pad = static_cast<long long>(d.R) * p.n_seg * ks;
  const long long share = (k_pad + p.splits - 1) / p.splits;
  int ke = std::max(ks, pow2ceil(static_cast<int>(std::min(share, 4096LL))));
  while (ke > ks && dw_stage_bytes(p.bmo, p.bci, ke, ks) > kStageBytes) {
    ke /= 2;
  }
  p.kr_log = log2i(ke / ks);
  p.nt = ceil_div(d.R, ke / ks) * p.n_seg;
  // the last block's tree over the splits fits in kStageBytes
  const int nout = p.bmo * p.bci * kTaps;
  p.splits = std::max(1, std::min(p.splits, p.nt));
  while (p.splits > 1 &&
         sizeof(float) * pow2ceil(p.splits) * nout > kStageBytes) {
    --p.splits;
  }
  p.splits_p2 = pow2ceil(p.splits);
  return p;
}

size_t dw_smem(const DwPlan& p, int tmo, int tci) {
  const int ks = 1 << p.ks_log;
  const size_t stage = dw_stage_bytes(p.bmo, p.bci, ks << p.kr_log, ks);
  const size_t red = sizeof(float) * kGradThreads * tmo * tci * kTaps;
  const size_t splits = sizeof(float) * p.splits_p2 * p.bmo * p.bci * kTaps;
  return std::max(stage, std::max(red, splits));
}

// The plans of one layer; narrow layers (Co <= 2 or C = 1) take 2 x 1 dw2
// thread tiles, the others 4 x 2; dx takes 2 pairs a thread when that
// still gives kTargetBlocks blocks, else 1.
struct BwdPlan {
  Dims d;
  DxPlan px;
  DwPlan pw;
  bool narrow, tm2;
  size_t dyc_floats, partial_floats;  // scratch: dyc, partial tiles, counts
};

BwdPlan bwd_plan(int C, int R, int S, int Co) {
  BwdPlan b;
  b.d = Dims{C, R, S, Co, S / 2, false};
  b.narrow = Co <= 2 || C == 1;
  b.px = dx_plan(b.d, 2);
  b.tm2 = b.px.blocks >= kTargetBlocks;
  if (!b.tm2) b.px = dx_plan(b.d, 1);
  b.pw = b.narrow ? dw_plan(b.d, 2, 1) : dw_plan(b.d, 4, 2);
  // dyc, then the partial tiles from a 16-byte boundary
  b.dyc_floats = (static_cast<size_t>(Co) * R * b.d.So + 3) / 4 * 4;
  b.partial_floats = static_cast<size_t>(b.pw.tiles) * b.pw.splits *
                     b.pw.bmo * b.pw.bci * kTaps;
  return b;
}

size_t scratch_bytes(const BwdPlan& b) {
  return sizeof(float) * (b.dyc_floats + b.partial_floats) +
         sizeof(int) * b.pw.tiles;
}

template <typename T, int TM, int TMO, int TCI>
int launch_grads(const float* dyc, const T* x, const T* w2, T* dx, T* dw2,
                 float* partial, int* counts, const BwdPlan& b,
                 cudaStream_t s) {
  const size_t smem = std::max(dx_smem(b.px, TM), dw_smem(b.pw, TMO, TCI));
  auto kernel = grads_kernel<T, TM, TMO, TCI>;
  int e = set_smem(kernel, smem);
  if (e) return e;
  const int blocks = b.px.blocks + b.pw.tiles * b.pw.splits;
  kernel<<<blocks, kGradThreads, smem, s>>>(dyc, x, w2, dx, dw2, partial,
                                            counts, b.d, b.px, b.pw);
  return static_cast<int>(cudaGetLastError());
}

// One launch of bn_bwd_kernel<T, MODE>, grid (P1, Co): clustered in x,
// except kBnDyc, which exchanges nothing.
template <typename T, int MODE>
int bn_launch(const float* yc, const T* dy, const float* mu,
              const float* var, const float* gamma, const float* beta,
              float* dyc, float* vec3, int* counts, int n_count, int n,
              int Co, const float* sums, float ntot, cudaStream_t s) {
  const bool bn_vec =
      n % 4 == 0 && aligned(yc, 16) && aligned(dy, 4 * sizeof(T));
  const int P1 = std::max(1, std::min(kMaxCluster, ceil_div(n, kBnPerBlock)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P1, Co);
  cfg.blockDim = dim3(kBnThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = P1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = MODE == kBnDyc ? 0 : 1;
  int e = static_cast<int>(cudaLaunchKernelEx(
      &cfg, bn_bwd_kernel<T, MODE>, yc, dy, mu, var, gamma, beta, dyc, vec3,
      counts, n_count, n, Co, bn_vec, sums, ntot));
  if (e) return e;
  return static_cast<int>(cudaGetLastError());
}

// The grads kernel of the plan `b`, from dyc in the scratch.
template <typename T>
int grads_launch(const BwdPlan& b, const float* dyc, const T* x, const T* w2,
                 T* dx, T* dw2, float* partial, int* counts, cudaStream_t s) {
  if (b.tm2) {
    return b.narrow ? launch_grads<T, 2, 2, 1>(dyc, x, w2, dx, dw2, partial,
                                               counts, b, s)
                    : launch_grads<T, 2, 4, 2>(dyc, x, w2, dx, dw2, partial,
                                               counts, b, s);
  }
  return b.narrow ? launch_grads<T, 1, 2, 1>(dyc, x, w2, dx, dw2, partial,
                                             counts, b, s)
                  : launch_grads<T, 1, 4, 2>(dyc, x, w2, dx, dw2, partial,
                                             counts, b, s);
}

// The train backward: bn_bwd_kernel, then the grads kernel. With `sums`
// (the split route's second half) the BN launch writes dyc from those
// global sums over `ntot` values; without, it forms them itself (the
// fused route) and writes vec3.
template <typename T>
int train_bwd(const void* x_, const void* w2_, const float* yc,
              const float* gamma, const float* beta, const float* mu,
              const float* var, const void* dy_, void* scratch, void* dx_,
              void* dw2_, float* vec3, int C, int R, int S, int Co,
              const float* sums, long long ntot, cudaStream_t s) {
  const T* x = static_cast<const T*>(x_);
  const T* w2 = static_cast<const T*>(w2_);
  const T* dy = static_cast<const T*>(dy_);
  T* dx = static_cast<T*>(dx_);
  T* dw2 = static_cast<T*>(dw2_);
  BwdPlan b = bwd_plan(C, R, S, Co);
  // a view at an odd offset takes the one-value copies (dyc and the
  // partial tiles lie in the scratch, 16-byte aligned)
  const size_t v4 = 4 * sizeof(T);
  b.d.vec = aligned(x, v4) && aligned(w2, v4);
  float* dyc = static_cast<float*>(scratch);
  float* partial = dyc + b.dyc_floats;
  int* counts = reinterpret_cast<int*>(partial + b.partial_floats);
  const int n = R * b.d.So;
  const int e =
      sums == nullptr
          ? bn_launch<T, kBnFused>(yc, dy, mu, var, gamma, beta, dyc, vec3,
                                   counts, b.pw.tiles, n, Co, nullptr,
                                   static_cast<float>(n), s)
          : bn_launch<T, kBnDyc>(yc, dy, mu, var, gamma, beta, dyc, nullptr,
                                 counts, b.pw.tiles, n, Co, sums,
                                 static_cast<float>(ntot), s);
  if (e) return e;
  return grads_launch<T>(b, dyc, x, w2, dx, dw2, partial, counts, s);
}

bool bad_shape(int C, int R, int S, int Co, int dtype) {
  return C < 1 || R < 1 || Co < 1 || S < 2 || S % 2 != 0 || dtype < 0 ||
         dtype > 2;
}

}  // namespace

// Train-mode forward, one cooperative launch of `grid` blocks (at least 1,
// at most the tiles and the blocks the device keeps resident: see
// maavss_pgenc_train_resident). (tc, bc, br, bs, g) is the tile plan of
// ops/cuda_pgenc.py:pgenc_plan. yc is an fp32 [Co, R, S/2] output, the
// backward's residual; mu, var fp32 [Co] outputs; partial an fp32 scratch
// of 2 * Co * per_cb floats (per_cb: the plan's tiles of one channel
// block). dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns
// cudaErrorInvalidValue
// for a shape, plan or grid the kernel does not take, else the launch's
// cudaError_t.
extern "C" int maavss_pgenc_train_fwd(
    const void* x, const void* w2, const void* cbias, const void* gamma,
    const void* beta, void* yc, void* y, void* mu, void* var, void* partial,
    int C, int R, int S, int Co, int dtype, int tc, int bc, int br, int bs,
    int g, int grid, void* stream) {
  const Shape d{C, R, S, Co, S / 2};
  TilePlan p;
  if (bad_shape(C, R, S, Co, dtype) || !make_plan(d, tc, bc, br, bs, g, &p) ||
      grid < 1 || grid > p.tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[3] = {static_cast<const float*>(cbias),
                       static_cast<const float*>(gamma),
                       static_cast<const float*>(beta)};
  float* out[4] = {static_cast<float*>(yc), static_cast<float*>(mu),
                   static_cast<float*>(var), static_cast<float*>(partial)};
  const long long n = static_cast<long long>(R) * d.So;
  return with_io(dtype, [&](auto io) {
    using T = typename decltype(io)::type;
    const TrainArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(w2),
                         f[0], f[1], f[2], out[0], static_cast<T*>(y), out[1],
                         out[2], out[3], d, p,
                         S % 4 == 0 && aligned(x, 4 * sizeof(T)), p.per_cb, 0,
                         p.per_cb, n};
    return train_fwd(a, grid, s);
  });
}

// The split route of the train forward, for statistics over more than
// this launch's rows (a data group's global batch): maavss_pgenc_train_conv
// writes yc and the tiles' per-channel partial sums into its slots of a
// partial array [Co][2][pstride], tile p of a channel block at poff + p
// (pstride >= poff + per_cb), with no grid barrier; the caller fills the
// other slots (every rank's partials, by a collective), and
// maavss_pgenc_train_apply sums a row's first `nparts` partials in the
// fused launch's fixed order, over `ntot` values a channel, into mu and
// var, and writes y from yc. One ordinary launch each, one block a tile;
// the same plan as maavss_pgenc_train_fwd. cudaErrorInvalidValue for a
// shape, plan or layout they do not take.
extern "C" int maavss_pgenc_train_conv(
    const void* x, const void* w2, const void* cbias, void* yc,
    void* partial, int C, int R, int S, int Co, int dtype, int tc, int bc,
    int br, int bs, int g, int pstride, int poff, void* stream) {
  const Shape d{C, R, S, Co, S / 2};
  TilePlan p;
  if (bad_shape(C, R, S, Co, dtype) || !make_plan(d, tc, bc, br, bs, g, &p) ||
      poff < 0 || pstride < poff + p.per_cb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cb = static_cast<const float*>(cbias);
  float* ycf = static_cast<float*>(yc);
  float* pf = static_cast<float*>(partial);
  return with_io(dtype, [&](auto io) {
    using T = typename decltype(io)::type;
    const TrainArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(w2),
                         cb, nullptr, nullptr, ycf, nullptr, nullptr, nullptr,
                         pf, d, p, S % 4 == 0 && aligned(x, 4 * sizeof(T)),
                         pstride, poff, 0, 0};
    return train_phase<T, kConv>(a, s);
  });
}

extern "C" int maavss_pgenc_train_apply(
    const void* yc, const void* gamma, const void* beta, const void* partial,
    void* y, void* mu, void* var, int C, int R, int S, int Co, int dtype,
    int tc, int bc, int br, int bs, int g, int nparts, long long ntot,
    void* stream) {
  const Shape d{C, R, S, Co, S / 2};
  TilePlan p;
  if (bad_shape(C, R, S, Co, dtype) || !make_plan(d, tc, bc, br, bs, g, &p) ||
      nparts < p.per_cb || ntot < static_cast<long long>(R) * d.So) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float* ycf = const_cast<float*>(static_cast<const float*>(yc));
  float* pf = const_cast<float*>(static_cast<const float*>(partial));
  float* muf = static_cast<float*>(mu);
  float* varf = static_cast<float*>(var);
  return with_io(dtype, [&](auto io) {
    using T = typename decltype(io)::type;
    const TrainArgs<T> a{nullptr, nullptr, nullptr, gm, bt, ycf,
                         static_cast<T*>(y), muf, varf, pf, d, p, false,
                         nparts, 0, nparts, ntot};
    return train_phase<T, kApply>(a, s);
  });
}

// The blocks of the train forward's kernel for tc and dtype that the
// current device keeps resident at `threads` threads and `smem` dynamic
// shared bytes (the plan's): the largest grid maavss_pgenc_train_fwd takes.
// A negative cudaError_t on failure.
extern "C" int maavss_pgenc_train_resident(int tc, int dtype, int threads,
                                           int smem) {
  if ((tc != 2 && tc != 4) || dtype < 0 || dtype > 2 || threads < 32 ||
      threads > kMaxThreads || smem < 0 || smem > kMaxDynSmem) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  int n = 0;
  const int e = with_io(dtype, [&](auto io) {
    using T = typename decltype(io)::type;
    return tc == 4 ? train_resident<T, 4>(threads, smem, &n)
                   : train_resident<T, 2>(threads, smem, &n);
  });
  return e ? -e : n;
}

// Bytes of the fp32/int scratch `maavss_pgenc_train_bwd` needs for a layer:
// dyc [Co, R, S/2], dw2's partial tiles and the tiles' counters.
extern "C" long long maavss_pgenc_train_bwd_scratch(int C, int R, int S,
                                                    int Co) {
  if (bad_shape(C, R, S, Co, 0)) return -1;
  return static_cast<long long>(scratch_bytes(bwd_plan(C, R, S, Co)));
}

// Train-mode backward from the forward's fp32 yc [Co, R, S/2] (read only)
// and (mu, var). scratch holds maavss_pgenc_train_bwd_scratch bytes (16-byte
// aligned); dx [C, R, S] and dw2 [Co, 9*C] in x's type; vec3 an fp32
// [3, Co] output (dcbias = 0, dgamma, dbeta). dtype: 0 = float32,
// 1 = bfloat16, 2 = float16. Two kernels on `stream`. Returns the first
// non-zero cudaError_t, else 0.
extern "C" int maavss_pgenc_train_bwd(
    const void* x, const void* w2, const void* yc, const void* gamma,
    const void* beta, const void* mu, const void* var, const void* dy,
    void* scratch, void* dx, void* dw2, void* vec3, int C, int R, int S,
    int Co, int dtype, void* stream) {
  if (bad_shape(C, R, S, Co, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[5] = {static_cast<const float*>(yc),
                       static_cast<const float*>(gamma),
                       static_cast<const float*>(beta),
                       static_cast<const float*>(mu),
                       static_cast<const float*>(var)};
  float* v3 = static_cast<float*>(vec3);
  return with_io(dtype, [&](auto io) {
    using T = typename decltype(io)::type;
    return train_bwd<T>(x, w2, f[0], f[1], f[2], f[3], f[4], dy, scratch, dx,
                        dw2, v3, C, R, S, Co, nullptr, 0, s);
  });
}

// The split route of the train backward, for BatchNorm statistics over more
// than this launch's rows. maavss_pgenc_train_bwd_sums: the BN launch's
// per-channel sums of this launch's rows alone, into vec3 [3, Co] = (0,
// dgamma, dbeta); one clustered launch. The caller sums vec3[1:3] over the
// data group into `sums` [2, Co], then maavss_pgenc_train_bwd_apply writes
// dyc from those sums over `ntot` values a channel (an unclustered BN
// launch that also zeroes the tile counters) and runs the unchanged grads
// kernel: dx and dw2 as maavss_pgenc_train_bwd gives them. dgamma and
// dbeta stay this launch's own sums (the gradient all-reduce sums them).
// scratch as maavss_pgenc_train_bwd's. Returns the first non-zero
// cudaError_t, else 0.
extern "C" int maavss_pgenc_train_bwd_sums(
    const void* yc, const void* gamma, const void* beta, const void* mu,
    const void* var, const void* dy, void* vec3, int R, int S, int Co,
    int dtype, void* stream) {
  if (bad_shape(1, R, S, Co, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = R * (S / 2);
  const float* f[5] = {static_cast<const float*>(yc),
                       static_cast<const float*>(gamma),
                       static_cast<const float*>(beta),
                       static_cast<const float*>(mu),
                       static_cast<const float*>(var)};
  float* v3 = static_cast<float*>(vec3);
  return with_io(dtype, [&](auto io) {
    using T = typename decltype(io)::type;
    return bn_launch<T, kBnSums>(f[0], static_cast<const T*>(dy), f[3], f[4],
                                 f[1], f[2], nullptr, v3, nullptr, 0, n, Co,
                                 nullptr, static_cast<float>(n), s);
  });
}

extern "C" int maavss_pgenc_train_bwd_apply(
    const void* x, const void* w2, const void* yc, const void* gamma,
    const void* beta, const void* mu, const void* var, const void* dy,
    const void* sums, long long ntot, void* scratch, void* dx, void* dw2,
    int C, int R, int S, int Co, int dtype, void* stream) {
  if (bad_shape(C, R, S, Co, dtype) || sums == nullptr ||
      ntot < static_cast<long long>(R) * (S / 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[5] = {static_cast<const float*>(yc),
                       static_cast<const float*>(gamma),
                       static_cast<const float*>(beta),
                       static_cast<const float*>(mu),
                       static_cast<const float*>(var)};
  const float* sm = static_cast<const float*>(sums);
  return with_io(dtype, [&](auto io) {
    using T = typename decltype(io)::type;
    return train_bwd<T>(x, w2, f[0], f[1], f[2], f[3], f[4], dy, scratch, dx,
                        dw2, nullptr, C, R, S, Co, sm, ntot, s);
  });
}
