// Multi-threshold statistics (paper §4.1, the THRESHOLD running threshold
// θ), for Hopper: a batched kernel (one row per query) and a single-row one
// that also runs the whole θ-bisection in one launch.
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
// Batched design.  One thread block per query row, so no reduction crosses
// blocks: a second pass or atomics would make the sum order vary from run
// to run.  Each thread strides over λ (coalesced loads, bounds-checked, so
// no -1 pad is needed), keeps T ≤ 8 exact integer counts and f32 partial
// sums in registers, and the block then reduces them in a fixed order (warp
// shuffles, then one warp over the per-warp partials).  counts are exact;
// recsum adds the same terms as the reference in another order, so it
// agrees to f32 rounding (the tests hold it with rtol=1e-5).
//
// Bound on an H100 (3.35 TB/s): the [Q, λ] f32 row matrix read once plus
// 3·Q·T·4 bytes of thresholds and outputs; 2·T compare-and-adds per element
// (16·Q·λ operations) are far below the f32 rate, so it is bound by bytes.
// With Q = 64 blocks the card's 132 SMs are not all busy; at the path's
// λ ≈ 12k the whole call is a few microseconds either way.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#define NT_THETA_MAX_T 8
#define NT_THETA_THREADS 256
#define NT_BISECT_CLUSTER 8  // blocks a single row is spread over
#define NT_BISECT_G 16       // thresholds a pass over the slice keeps in registers
#define NT_BISECT_THREADS 128  // a block of the cluster
// a block's slice is kept in shared memory up to this many floats (40 KB,
// λ ≤ 81,920); a longer one is re-read from global memory at every pass
#define NT_BISECT_SMEM_FLOATS 10240

namespace {

namespace cg = cooperative_groups;

__global__ void theta_stats_batch_kernel(
    const float* __restrict__ x, int64_t lam,
    const float* __restrict__ thetas, int64_t T,
    float* __restrict__ counts, float* __restrict__ recsum) {
  const int64_t q = blockIdx.x;
  const float* xq = x + q * lam;
  float th[NT_THETA_MAX_T];
  unsigned int cnt[NT_THETA_MAX_T];
  float sum[NT_THETA_MAX_T];
#pragma unroll
  for (int t = 0; t < NT_THETA_MAX_T; ++t) {
    th[t] = t < T ? thetas[q * T + t] : 0.0f;
    cnt[t] = 0u;
    sum[t] = 0.0f;
  }
  for (int64_t b = threadIdx.x; b < lam; b += blockDim.x) {
    const float v = xq[b];
#pragma unroll
    for (int t = 0; t < NT_THETA_MAX_T; ++t) {
      if (v >= th[t]) {
        cnt[t] += 1u;
        sum[t] += v;
      }
    }
  }
  // fixed-order block reduction: shuffle within each warp, then warp 0 over
  // the per-warp partials
  __shared__ unsigned int s_cnt[NT_THETA_THREADS / 32][NT_THETA_MAX_T];
  __shared__ float s_sum[NT_THETA_THREADS / 32][NT_THETA_MAX_T];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < NT_THETA_MAX_T; ++t) {
    for (int off = 16; off > 0; off >>= 1) {
      cnt[t] += __shfl_down_sync(0xffffffffu, cnt[t], off);
      sum[t] += __shfl_down_sync(0xffffffffu, sum[t], off);
    }
    if (lane == 0) {
      s_cnt[warp][t] = cnt[t];
      s_sum[warp][t] = sum[t];
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
#pragma unroll
    for (int t = 0; t < NT_THETA_MAX_T; ++t) {
      unsigned int c = lane < nwarps ? s_cnt[lane][t] : 0u;
      float s = lane < nwarps ? s_sum[lane][t] : 0.0f;
      for (int off = 16; off > 0; off >>= 1) {
        c += __shfl_down_sync(0xffffffffu, c, off);
        s += __shfl_down_sync(0xffffffffu, s, off);
      }
      if (lane == 0 && t < T) {
        counts[q * T + t] = (float)c;
        recsum[q * T + t] = s;
      }
    }
  }
}

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

extern "C" int nt_theta_stats_batch(
    const float* x, int64_t nq, int64_t lam, const float* thetas, int64_t T,
    float* counts, float* recsum, void* stream) {
  if (nq == 0) return 0;
  if (T < 1 || T > NT_THETA_MAX_T) return (int)cudaErrorInvalidValue;
  theta_stats_batch_kernel<<<(unsigned)nq, NT_THETA_THREADS, 0,
                             (cudaStream_t)stream>>>(x, lam, thetas, T, counts,
                                                     recsum);
  return (int)cudaGetLastError();
}
