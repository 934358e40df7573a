// Multi-threshold statistics (paper §4.1, the THRESHOLD running threshold
// θ), for Hopper: a batched kernel (one row per query) that also takes in
// the small steps around it on both of its paths, and a single-row one that
// also runs the whole θ-bisection in one launch.
//
// Replaces the Pallas kernels theta_stats_batch
// (src/repro/kernels/theta_stats.py:132, grid (Q, λ-tiles) accumulating into
// the [1, T] output block across sequential λ steps) and theta_stats
// (theta_stats.py:65, grid (λ-tiles,) accumulating into the [T] outputs),
// the statistics of the θ-bisection ops.threshold_bisect, whose rounds the
// single-row kernel takes in too.
//
//   counts[q, t] = #{b : x[q, b] >= θ[q, t]}
//   recsum[q, t] = Σ_{b : x[q, b] >= θ[q, t]} x[q, b]
//
// counts are exact; recsum adds the same f32 terms as the reference in
// another (fixed) order, so it agrees to f32 rounding (the tests hold it
// with rtol=1e-5).  The batched kernel's design is described above
// theta_batch_kernel, the single-row one's above theta_bisect_kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#define NT_BATCH_THREADS 256  // a block of the batched kernel's cluster
#define NT_BATCH_CLUSTER 8    // the most blocks a query row is spread over
#define NT_BISECT_CLUSTER 8  // blocks a single row is spread over
#define NT_BISECT_G 16       // thresholds a pass over the slice keeps in registers
#define NT_BISECT_THREADS 128  // a block of the cluster
// a block's slice is kept in shared memory up to this many floats (40 KB,
// λ ≤ 81,920); a longer one is re-read from global memory at every pass
#define NT_BISECT_SMEM_FLOATS 10240

namespace {

namespace cg = cooperative_groups;

// Single row: the θ-bisection of ops.threshold_bisect in one launch, and one
// round of statistics at given thresholds (theta_stats) on the same kernel.
//
// A row (λ = 12,208 f32 on the path, 48.8 KB) is spread over one thread
// block cluster of 8 (Hopper).  Block r loads its contiguous slice
// [r·⌈λ/8⌉, (r+1)·⌈λ/8⌉) once into its shared memory (up to
// NT_BISECT_SMEM_FLOATS floats; a longer slice is re-read from global
// memory, mostly L2, at every pass) and runs every round on it.  A round
// takes its T thresholds NT_BISECT_G at a time (computed once a block into
// shared memory, then into every thread's registers; any T >= 1: a larger
// T makes more passes over the slice).  For each group the block
// reduces its exact counts and f32 partial sums in a fixed order (a
// butterfly of warp shuffles that leaves each threshold's warp total on two
// lanes, then the warps' totals in order) and writes them into the shared
// memory of every block of the cluster (distributed shared memory).
// After one cluster barrier every block adds the 8 partials in rank order,
// so all 8 hold the same recsum bits, take the same bracket step and need
// no broadcast; there are no atomics, so the bits are the same every run.
// The exchange buffer alternates between two halves from group to group:
// a block writes a half again only after the next barrier, which every
// block passes only once it has read that half.
//
// The bracket arithmetic is ops.threshold_bisect's in f32 and in its order
// (src/repro/kernels/ops.py:77-90), each step a correctly rounded
// operation (-fmad=false; the division is __fdiv_rn, not a reciprocal
// multiply):
//   ths[t] = lo + (hi − lo)·(t + 1) / T,  lo₀ = 0,  hi₀ = f32(1) + f32(1e-6)
//   ok[t] = recsum[t]·rpb >= k; idx = the largest ok t, or 0
//   lo' = any ok ? ths[idx] : lo
//   hi' = idx == T − 1 ? hi : (any ok ? min(ths[min(idx + 1, T − 1)], hi) : ths[0])
// Rank 0 writes each round's thresholds and sums (the trace), and lo, hi.
// Blocks of 128 threads: at λ = 12,208 a thread holds 12 values of its
// slice, and fewer warps make the per-group reductions shorter.
//
// Bound on an H100: λ·4 bytes read once plus the outputs; 2·T·rounds
// compare-and-adds per element (96·λ at T = 16, 3 rounds) are far below
// the f32 rate, so bytes bound it: 15 ns at λ = 12,208.  What is left is
// one launch, the rounds' reductions and their cluster barriers, where the
// reference's loop took 3 launches of the statistics and some 18 tensor
// operations a round in between.
struct BisectParams {
  const float* x;       // [λ] the row
  int64_t lam;
  const float* thetas;  // [T] given thresholds (one round of statistics), or null: bisect
  int rounds, T;        // T thresholds a round (the bisection's fanout)
  float k, rpb;         // the bisection's target and records per block
  float* counts;        // [rounds, T] or null
  float* recsum;        // [rounds, T]
  float* ths;           // [rounds, T] or null: each round's thresholds
  float* lohi;          // [2] or null: the final bracket [lo, hi)
};

// ths[t] of the bracket [lo, hi) with T steps, as the reference computes it
__device__ __forceinline__ float grid_point(float lo, float hi, int t, int T) {
  return __fadd_rn(lo, __fdiv_rn(__fmul_rn(__fsub_rn(hi, lo), (float)(t + 1)), (float)T));
}

// One step of a warp's butterfly over G = 16 values a lane: lanes that
// differ in bit 2W swap halves of their first 2W values and add, so each
// keeps W of them, summed over both
template <int W>
__device__ __forceinline__ void butterfly(unsigned int (&cnt)[NT_BISECT_G],
                                          float (&sum)[NT_BISECT_G], int lane) {
  const bool upper = lane & (2 * W);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const unsigned int cs = upper ? cnt[j] : cnt[j + W];
    const float ss = upper ? sum[j] : sum[j + W];
    cnt[j] = (upper ? cnt[j + W] : cnt[j]) + __shfl_xor_sync(0xffffffffu, cs, 2 * W);
    sum[j] = (upper ? sum[j + W] : sum[j]) + __shfl_xor_sync(0xffffffffu, ss, 2 * W);
  }
}

__global__ void __cluster_dims__(NT_BISECT_CLUSTER, 1, 1) __launch_bounds__(NT_BISECT_THREADS)
theta_bisect_kernel(const BisectParams p) {
  extern __shared__ float s_x[];  // this block's slice, when it fits
  constexpr int G = NT_BISECT_G, NW = NT_BISECT_THREADS / 32;
  static_assert(G == 16, "the butterfly leaves threshold t on lanes 2t and 2t + 1");
  __shared__ unsigned int x_cnt[2][NT_BISECT_CLUSTER][G];  // every rank's partials
  __shared__ float x_sum[2][NT_BISECT_CLUSTER][G];
  __shared__ unsigned int w_cnt[NW][G];  // per-warp partials
  __shared__ float w_sum[NW][G];
  __shared__ float s_th[G];  // the group's thresholds
  __shared__ int s_best;     // the round's largest ok threshold so far, or -1

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = p.T;
  const int64_t per = (p.lam + NT_BISECT_CLUSTER - 1) / NT_BISECT_CLUSTER;
  const int64_t e0 = min((int64_t)rank * per, p.lam);
  const int64_t ne = min(e0 + per, p.lam) - e0;
  const float* xr = p.x + e0;
  const bool cached = per <= NT_BISECT_SMEM_FLOATS;

  // no block writes another's shared memory before all have started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (cached)
    for (int64_t i = tid; i < ne; i += NT_BISECT_THREADS) s_x[i] = xr[i];
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  __syncthreads();

  float lo = 0.0f, hi = __fadd_rn(1.0f, 1e-6f);
  int buf = 0;
  for (int r = 0; r < p.rounds; ++r) {
    for (int g0 = 0; g0 < T; g0 += G) {
      const int ng = min(G, T - g0);
      if (tid < G)
        s_th[tid] = tid >= ng ? 0.0f : p.thetas ? p.thetas[g0 + tid] : grid_point(lo, hi, g0 + tid, T);
      __syncthreads();
      float th[G], sum[G];
      unsigned int cnt[G];
#pragma unroll
      for (int t = 0; t < G; ++t) {
        th[t] = s_th[t];
        cnt[t] = 0u;
        sum[t] = 0.0f;
      }
      for (int64_t i = tid; i < ne; i += NT_BISECT_THREADS) {
        const float v = cached ? s_x[i] : xr[i];
#pragma unroll
        for (int t = 0; t < G; ++t) {
          if (v >= th[t]) {
            cnt[t] += 1u;
            sum[t] += v;
          }
        }
      }
      // the warp's totals by a butterfly that halves the values a lane holds
      // at each step (8 + 4 + 2 + 1 exchanges, then one more): lanes 2t and
      // 2t + 1 end with threshold t's total, in a fixed order
      butterfly<8>(cnt, sum, lane);
      butterfly<4>(cnt, sum, lane);
      butterfly<2>(cnt, sum, lane);
      butterfly<1>(cnt, sum, lane);
      cnt[0] += __shfl_xor_sync(0xffffffffu, cnt[0], 1);
      sum[0] += __shfl_xor_sync(0xffffffffu, sum[0], 1);
      if ((lane & 1) == 0) {
        w_cnt[warp][lane >> 1] = cnt[0];
        w_sum[warp][lane >> 1] = sum[0];
      }
      __syncthreads();
      for (int i = tid; i < NT_BISECT_CLUSTER * G; i += NT_BISECT_THREADS) {
        // the block's partial of threshold t (its warps in order), into slot
        // `rank` of block q's buffer: 8 threads add the same terms alike
        const int q = i / G, t = i % G;
        unsigned int c = 0u;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          c += w_cnt[w][t];
          s = s + w_sum[w][t];
        }
        cluster.map_shared_rank(&x_cnt[buf][rank][0], q)[t] = c;
        cluster.map_shared_rank(&x_sum[buf][rank][0], q)[t] = s;
      }
      cluster.sync();
      if (warp == 0) {  // the cluster's totals, in rank order, the same in every block
        bool ok = false;
        if (lane < ng) {
          unsigned int c = 0u;
          float s = 0.0f;
#pragma unroll
          for (int q = 0; q < NT_BISECT_CLUSTER; ++q) {
            c += x_cnt[buf][q][lane];
            s = s + x_sum[buf][q][lane];
          }
          ok = __fmul_rn(s, p.rpb) >= p.k;
          if (rank == 0) {
            const int64_t o = (int64_t)r * T + g0 + lane;
            p.recsum[o] = s;
            if (p.counts) p.counts[o] = (float)c;
            if (p.ths) p.ths[o] = s_th[lane];
          }
        }
        const unsigned int m = __ballot_sync(0xffffffffu, ok);
        // groups come in ascending order: the last with an ok holds the largest
        if (lane == 0 && (g0 == 0 || m)) s_best = m ? g0 + 31 - __clz((int)m) : -1;
      }
      buf ^= 1;
      __syncthreads();
    }
    // the bracket step, in every thread alike
    const int best = s_best;
    const bool any_ok = best >= 0;
    const int idx = any_ok ? best : 0;
    const float new_lo = any_ok ? grid_point(lo, hi, idx, T) : lo;
    const float new_hi =
        any_ok ? fminf(grid_point(lo, hi, min(idx + 1, T - 1), T), hi) : grid_point(lo, hi, 0, T);
    hi = idx == T - 1 ? hi : new_hi;
    lo = new_lo;
  }
  if (p.lohi && rank == 0 && tid == 0) {
    p.lohi[0] = lo;
    p.lohi[1] = hi;
  }
}

int launch_bisect(const BisectParams& p, cudaStream_t s) {
  if (p.T < 1 || p.rounds < 1) return (int)cudaErrorInvalidValue;
  const int64_t per = (p.lam + NT_BISECT_CLUSTER - 1) / NT_BISECT_CLUSTER;
  const size_t smem = per <= NT_BISECT_SMEM_FLOATS ? (size_t)per * sizeof(float) : 0;
  theta_bisect_kernel<<<NT_BISECT_CLUSTER, NT_BISECT_THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// Batched: the statistics of Q rows, and the two paths' steps around them.
//
// A row (λ = 12,208 f32 on the path) is spread over one thread block
// cluster of C blocks, C = 1, 2, 4 or 8 chosen at launch so that Q·C blocks
// cover the card's SMs (C = 2 at the wave's Q = 64, 8 for a single row).
// Block r of a row's cluster walks its contiguous slice [r·⌈λ/C⌉, ...)
// with coalesced loads, keeping G thresholds in registers (G = 16, or 1
// for the wave round's single θ): exact counts and f32 partial sums.  The
// block reduces them in a fixed order (the butterfly above for G = 16, a
// shuffle reduction for G = 1, then its warps in order) and writes its
// partials into block 0's shared memory (distributed shared memory); after
// one cluster barrier block 0 adds the C partials in rank order and writes
// the row's outputs.  No atomics, so the bits are the same every run.
// Thresholds beyond G take more passes, G at a time, the exchange buffer
// alternating halves as in the single-row kernel.
//
// Three modes, each the f32 operations of its caller in its caller's order
// (-fmad=false, correctly rounded intrinsics):
//  GIVEN   thresholds [Q, T] -> counts, recsum [Q, T] (theta_stats_batch).
//  WAVE    the device wave's round (kernels/plan_wave.py): θ_q is the cut's
//          last sorted density, sorted[q, n_cut[q] − 1], or 0 without a cut;
//          the kernel writes θ_q, theta_count[q] = has_cut ? count : 0 and
//          expected[q] = has_cut ? recsum·rpb : 0.  Only θ_q·1 is taken:
//          the reference's round reads no other multiple of θ.
//  BISECT  one launch of the sharded θ-bisection (core/sharded.py): every
//          block first applies the previous round's bracket step to the
//          carried lo, hi, n_sel, exp of its row, from that round's
//          all-reduced [Q, 2T] statistics (counts, then sums):
//            ths[t] = lo + (hi − lo)·((t + 1) / T)       (a true division)
//            ok[t] = recsum[t]·rpb >= k; idx = the largest ok t
//            any ok:  n_sel = counts[idx], exp = recsum[idx]·rpb,
//                     lo = ths[idx], hi = idx < T − 1 ? ths[idx + 1] : hi
//            none:    hi = ths[0]
//          (the first launch starts from lo = 0, hi = hi0, n_sel = exp = 0),
//          then takes this round's statistics at the new thresholds into the
//          same [Q, 2T] buffer, which the caller all-reduces; block 0 writes
//          the new carry.  Every block reads the carry and the statistics
//          before the cluster barrier and block 0 writes them after it, so
//          the buffers are updated in place.  A last launch with the
//          statistics off (C = 1) applies the final step.
//
// Bound on an H100 (3.35 TB/s): the [Q, λ] rows read once (4·Q·λ bytes)
// plus the small inputs and outputs; 2·T compare-and-adds per element are
// far below the f32 rate at T ≤ 16, so bytes bound it: ~1 µs at the wave's
// shape, where one launch, its cluster barrier and the fixed-order
// reductions are what is left.
enum { MODE_GIVEN = 0, MODE_WAVE = 1, MODE_BISECT = 2 };

struct BatchParams {
  const float* x;  // [Q, λ] rows
  int64_t lam;
  int T, mode;
  const float* thetas;  // GIVEN: [Q, T]
  float* counts;        // GIVEN: [Q, T]
  float* recsum;        // GIVEN: [Q, T]
  const float* sorted;  // WAVE: [Q, λ] the rows sorted descending
  const int32_t* n_cut; // WAVE: [Q] the cut's prefix length
  float* theta;         // WAVE: [Q] θ_q
  float* theta_count;   // WAVE: [Q]
  float* expected;      // WAVE: [Q]
  float rpb;            // WAVE, BISECT: records per block
  const float* ks;      // BISECT: [Q] record targets
  float hi0;            // BISECT: the first bracket's top
  int first, stats;     // BISECT: no step before this launch; statistics on
  float* lo;            // BISECT: [Q] the carry, in and out
  float* hi;
  int32_t* n_sel;
  float* exp;
  float* st;            // BISECT: [Q, 2T] in: last round's, out: this round's
};

// ths[t] of the sharded bisection's bracket [lo, hi) with T steps
__device__ __forceinline__ float shard_point(float lo, float hi, int t, int T) {
  return __fadd_rn(lo, __fmul_rn(__fsub_rn(hi, lo), __fdiv_rn((float)(t + 1), (float)T)));
}

template <int G>
__global__ void __launch_bounds__(NT_BATCH_THREADS) theta_batch_kernel(const __grid_constant__ BatchParams p) {
  constexpr int NW = NT_BATCH_THREADS / 32;
  static_assert(G == 16 || G == 1, "a group is 16 thresholds, or the wave round's one");
  __shared__ unsigned int x_cnt[2][NT_BATCH_CLUSTER][G];  // every block's partials, in block 0
  __shared__ float x_sum[2][NT_BATCH_CLUSTER][G];
  __shared__ unsigned int w_cnt[NW][G];  // per-warp partials
  __shared__ float w_sum[NW][G];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t q = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = p.T;
  const int64_t lam = p.lam;
  const float* xr = p.x + q * lam;

  // the thresholds' inputs, in every thread alike
  float lo = 0.0f, hi = p.hi0, ex = 0.0f, theta = 0.0f;
  int ns = 0;
  bool has_cut = false;
  if (p.mode == MODE_WAVE) {
    const int n = p.n_cut[q];
    has_cut = n > 0;
    theta = has_cut ? p.sorted[q * lam + n - 1] : 0.0f;
  } else if (p.mode == MODE_BISECT && !p.first) {
    // the previous round's bracket step, by every warp from the same inputs
    lo = p.lo[q];
    hi = p.hi[q];
    ns = p.n_sel[q];
    ex = p.exp[q];
    const float k = p.ks[q];
    const float* cq = p.st + q * 2 * T;
    const float* sq = cq + T;
    int best = -1;
    for (int t0 = 0; t0 < T; t0 += 32) {
      const int t = t0 + lane;
      const bool ok = t < T && __fmul_rn(sq[t], p.rpb) >= k;
      const unsigned int m = __ballot_sync(0xffffffffu, ok);
      if (m) best = t0 + 31 - __clz((int)m);
    }
    if (best >= 0) {
      ns = (int)cq[best];
      ex = __fmul_rn(sq[best], p.rpb);
      const float th_at = shard_point(lo, hi, best, T);
      hi = best < T - 1 ? shard_point(lo, hi, best + 1, T) : hi;
      lo = th_at;
    } else {
      hi = shard_point(lo, hi, 0, T);
    }
  }
  if (p.mode == MODE_BISECT && !p.stats) {  // the last step alone (C = 1)
    if (tid == 0) {
      p.lo[q] = lo;
      p.hi[q] = hi;
      p.n_sel[q] = ns;
      p.exp[q] = ex;
    }
    return;
  }

  // no block writes block 0's shared memory before all have started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int64_t per = (lam + C - 1) / C;
  const int64_t e0 = min((int64_t)rank * per, lam);
  const int64_t e1 = min(e0 + per, lam);
  int buf = 0;
  for (int g0 = 0; g0 < T; g0 += G) {
    const int ng = min(G, T - g0);
    float th[G], sum[G];
    unsigned int cnt[G];
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const int tt = min(g0 + t, T - 1);
      th[t] = p.mode == MODE_GIVEN ? p.thetas[q * T + tt]
            : p.mode == MODE_WAVE  ? theta
                                   : shard_point(lo, hi, tt, T);
      cnt[t] = 0u;
      sum[t] = 0.0f;
    }
    for (int64_t i = e0 + tid; i < e1; i += NT_BATCH_THREADS) {
      const float v = xr[i];
#pragma unroll
      for (int t = 0; t < G; ++t) {
        if (v >= th[t]) {
          cnt[t] += 1u;
          sum[t] += v;
        }
      }
    }
    if constexpr (G == 16) {
      // lanes 2t and 2t + 1 end with threshold t's warp total
      butterfly<8>(cnt, sum, lane);
      butterfly<4>(cnt, sum, lane);
      butterfly<2>(cnt, sum, lane);
      butterfly<1>(cnt, sum, lane);
      cnt[0] += __shfl_xor_sync(0xffffffffu, cnt[0], 1);
      sum[0] += __shfl_xor_sync(0xffffffffu, sum[0], 1);
      if ((lane & 1) == 0) {
        w_cnt[warp][lane >> 1] = cnt[0];
        w_sum[warp][lane >> 1] = sum[0];
      }
    } else {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        cnt[0] += __shfl_xor_sync(0xffffffffu, cnt[0], off);
        sum[0] += __shfl_xor_sync(0xffffffffu, sum[0], off);
      }
      if (lane == 0) {
        w_cnt[warp][0] = cnt[0];
        w_sum[warp][0] = sum[0];
      }
    }
    __syncthreads();
    if (g0 == 0) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (tid < G) {  // the block's partial of threshold t (its warps in order)
      unsigned int c = 0u;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        c += w_cnt[w][tid];
        s = s + w_sum[w][tid];
      }
      cluster.map_shared_rank(&x_cnt[buf][rank][0], 0)[tid] = c;
      cluster.map_shared_rank(&x_sum[buf][rank][0], 0)[tid] = s;
    }
    cluster.sync();
    if (rank == 0 && tid < ng) {  // the row's totals, in rank order
      unsigned int c = 0u;
      float s = 0.0f;
      for (int r = 0; r < C; ++r) {
        c += x_cnt[buf][r][tid];
        s = s + x_sum[buf][r][tid];
      }
      const int t = g0 + tid;
      if (p.mode == MODE_GIVEN) {
        p.counts[q * T + t] = (float)c;
        p.recsum[q * T + t] = s;
      } else if (p.mode == MODE_WAVE) {
        p.theta[q] = theta;
        p.theta_count[q] = has_cut ? (float)c : 0.0f;
        p.expected[q] = has_cut ? __fmul_rn(s, p.rpb) : 0.0f;
      } else {
        p.st[q * 2 * T + t] = (float)c;
        p.st[q * 2 * T + T + t] = s;
      }
    }
    buf ^= 1;
  }
  if (p.mode == MODE_BISECT && rank == 0 && tid == 0) {  // after the barrier: see above
    p.lo[q] = lo;
    p.hi[q] = hi;
    p.n_sel[q] = ns;
    p.exp[q] = ex;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 132;
  return n;
}

// blocks a row is spread over: the least power of two (at most 8) that
// gives the wave three quarters of a block per SM or more
int cluster_for(int64_t nq) {
  const int64_t want = (int64_t)sm_count() * 3 / 4;
  int c = 1;
  while (c < NT_BATCH_CLUSTER && nq * c < want) c *= 2;
  return c;
}

int launch_batch(const BatchParams& p, int64_t nq, int c, cudaStream_t s) {
  if (nq == 0) return 0;
  if (p.T < 1 || nq * c > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nq * c), 1, 1);
  cfg.blockDim = dim3(NT_BATCH_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = p.mode == MODE_WAVE ? cudaLaunchKernelEx(&cfg, theta_batch_kernel<1>, p)
                                             : cudaLaunchKernelEx(&cfg, theta_batch_kernel<16>, p);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

}  // namespace

// x [λ], thetas [T] (any T >= 1) -> counts [T], recsum [T]: one launch
extern "C" int nt_theta_stats(const float* x, int64_t lam, const float* thetas, int64_t T,
                              float* counts, float* recsum, void* stream) {
  if (T > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const BisectParams p{x, lam, thetas, 1, (int)T, 0.0f, 0.0f, counts, recsum, nullptr, nullptr};
  return launch_bisect(p, (cudaStream_t)stream);
}

// The θ-bisection of x [λ]: rounds >= 1 rounds of fanout >= 1 thresholds
// -> ths [rounds, fanout], recsum [rounds, fanout], lohi [2]: one launch
extern "C" int nt_theta_bisect(const float* x, int64_t lam, int64_t rounds, int64_t fanout,
                               float k, float rpb, float* ths, float* recsum, float* lohi,
                               void* stream) {
  if (rounds > 0x7fffffff || fanout > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const BisectParams p{x, lam, nullptr, (int)rounds, (int)fanout, k, rpb,
                       nullptr, recsum, ths, lohi};
  return launch_bisect(p, (cudaStream_t)stream);
}

// x [Q, λ], thetas [Q, T] (any T >= 1) -> counts [Q, T], recsum [Q, T]: one launch
extern "C" int nt_theta_stats_batch(
    const float* x, int64_t nq, int64_t lam, const float* thetas, int64_t T,
    float* counts, float* recsum, void* stream) {
  if (T > 0x7fffffff) return (int)cudaErrorInvalidValue;
  BatchParams p = {};
  p.x = x;
  p.lam = lam;
  p.T = (int)T;
  p.mode = MODE_GIVEN;
  p.thetas = thetas;
  p.counts = counts;
  p.recsum = recsum;
  return launch_batch(p, nq, cluster_for(nq), (cudaStream_t)stream);
}

// The device wave's θ-round: x [Q, λ] masked rows, sorted [Q, λ] the same
// sorted descending, n_cut [Q] -> theta, theta_count, expected [Q]: one launch
extern "C" int nt_theta_wave(const float* x, const float* sorted, const int32_t* n_cut,
                             int64_t nq, int64_t lam, float rpb, float* theta,
                             float* theta_count, float* expected, void* stream) {
  BatchParams p = {};
  p.x = x;
  p.lam = lam;
  p.T = 1;
  p.mode = MODE_WAVE;
  p.sorted = sorted;
  p.n_cut = n_cut;
  p.theta = theta;
  p.theta_count = theta_count;
  p.expected = expected;
  p.rpb = rpb;
  return launch_batch(p, nq, cluster_for(nq), (cudaStream_t)stream);
}

// One launch of the sharded θ-bisection on this rank's slab x [Q, λ_local]:
// the previous round's bracket step unless first, then (stats != 0) this
// round's local statistics into st [Q, 2·fanout]; the carry lo, hi, exp
// [Q] f32 and n_sel [Q] i32 updated in place.
extern "C" int nt_theta_bisect_batch(const float* x, int64_t nq, int64_t lam, const float* ks,
                                     int64_t fanout, float rpb, float hi0, int first, int stats,
                                     float* lo, float* hi, int32_t* n_sel, float* exp,
                                     float* st, void* stream) {
  if (fanout > 0x7fffffff) return (int)cudaErrorInvalidValue;
  BatchParams p = {};
  p.x = x;
  p.lam = lam;
  p.T = (int)fanout;
  p.mode = MODE_BISECT;
  p.rpb = rpb;
  p.ks = ks;
  p.hi0 = hi0;
  p.first = first;
  p.stats = stats;
  p.lo = lo;
  p.hi = hi;
  p.n_sel = n_sel;
  p.exp = exp;
  p.st = st;
  return launch_batch(p, nq, stats ? cluster_for(nq) : 1, (cudaStream_t)stream);
}
