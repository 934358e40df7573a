// Batched multi-threshold statistics (paper §4.1, the THRESHOLD running
// threshold θ), for Hopper.
//
// Replaces the Pallas kernel theta_stats_batch
// (src/repro/kernels/theta_stats.py:132, grid (Q, λ-tiles) accumulating into
// the [1, T] output block across sequential λ steps).
//
//   counts[q, t] = #{b : x[q, b] >= θ[q, t]}
//   recsum[q, t] = Σ_{b : x[q, b] >= θ[q, t]} x[q, b]
//
// Design.  One thread block per query row, so no reduction crosses blocks:
// a second pass or atomics would make the sum order vary from run to run.
// Each thread strides over λ (coalesced loads, bounds-checked, so no -1 pad
// is needed), keeps T ≤ 8 exact integer counts and f32 partial sums in
// registers, and the block then reduces them in a fixed order (warp shuffles,
// then one warp over the per-warp partials).  counts are exact; recsum adds
// the same terms as the reference in another order, so it agrees to f32
// rounding (the tests hold it with rtol=1e-5).
//
// Bound on an H100 (3.35 TB/s): the [Q, λ] f32 row matrix read once plus
// 3·Q·T·4 bytes of thresholds and outputs; 2·T compare-and-adds per element
// (16·Q·λ operations) are far below the f32 rate, so it is bound by bytes.
// With Q = 64 blocks the card's 132 SMs are not all busy; at the path's
// λ ≈ 12k the whole call is a few microseconds either way.
#include <cuda_runtime.h>
#include <stdint.h>

#define NT_THETA_MAX_T 8
#define NT_THETA_THREADS 256

namespace {

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

}  // namespace

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
