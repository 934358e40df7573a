// ⊕-combine of predicate density rows (paper §3.2), for Hopper.
//
// Replaces three Pallas kernels: density_combine_batch
// (src/repro/kernels/density_combine.py:142, grid (Q, λ-tiles, γ) with the
// γ axis carried in the output tile across sequential grid steps), the
// single-query density_combine (density_combine.py:75, grid (λ-tiles, γ)),
// which nt_density_combine_excl runs with the single-query planner's
// exclusion fused in (below), and density_combine_batch_sharded (density_combine.py:181-232, the batch
// kernel per shard under shard_map), which each rank runs as a launch of
// nt_density_combine_batch on its own [rows, λ_local] slab.
//
// out[q, b] = ⊕_{j < γ, rows[q, j] >= 0} dens[rows[q, j], b]
//   AND: product, starting from 1.0
//   OR:  sum, starting from 0.0, then min(sum, 1) after the last row
//
// Design.  Blocks run in parallel with no carried grid state, so the γ axis
// is a loop inside each thread: one thread per (q, b) element folds its γ
// rows in ascending order with one f32 operation per step, exactly the left
// fold of the reference's _combine_local (density_combine.py:164-178), so
// the result is bit-identical to it and to the plain PyTorch version.
// Padded rows (-1) are skipped: acc*1 == acc and acc+0 == acc for the
// non-negative densities here, so skipping equals folding in the identity.
// The build passes -fmad=false and no fast-math flag; there is no a*b+c
// here anyway (AND only multiplies, OR only adds).
//
// Bound on an H100 (3.35 TB/s): the distinct predicate rows the wave names,
// read once (≤ rows·λ·4 bytes), plus the [Q, λ] f32 output written once;
// γ·Q·λ flops are far below the f32 rate, so the kernel is bound by bytes.
// Threads of a warp read neighbouring b of one row, so every load and store
// is coalesced; rows shared by several queries are re-read from L2, not HBM
// (91 rows × λ=12,208 × 4 B = 4.4 MB fits the 50 MB L2).  For one query
// (γ rows, no padding) the bound is (γ+1)·λ·4 bytes, the TPU kernel's own;
// the fold is np.prod / np.clip(np.sum) along axis 0, left to right, so it
// is bit-identical to the reference's combine_densities_np as well.
#include <cuda_runtime.h>
#include <stdint.h>

#define NT_COMBINE_THREADS 256
#define NT_COMBINE_BY_VALUE 64  // row ids a single-query launch carries in its parameters

namespace {

// A single query's row ids, passed by value in the launch parameters: no
// host→device copy before the launch.
struct RowIds {
  int32_t id[NT_COMBINE_BY_VALUE];
};

__global__ void density_combine_batch_kernel(
    const float* __restrict__ dens, int64_t lam,
    const int32_t* __restrict__ rows, int64_t gamma, int op_or,
    float* __restrict__ out) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t q = blockIdx.y;
  if (b >= lam) return;
  const int32_t* rq = rows + q * gamma;
  float acc = op_or ? 0.0f : 1.0f;
  for (int64_t j = 0; j < gamma; ++j) {
    const int32_t r = rq[j];
    if (r < 0) continue;  // padded slot: the ⊕-identity
    const float d = dens[(int64_t)r * lam + b];
    acc = op_or ? acc + d : acc * d;
  }
  if (op_or) acc = fminf(acc, 1.0f);
  out[q * lam + b] = acc;
}

// The single-query combine with the planner's exclusion fused in: out[b] is
// +0.0 for every b in excl (sorted ascending, no duplicates), else the fold
// above, so the result is bit-identical to the reference's
// combine_densities_np followed by combined[exclude] = 0.0
// (src/repro/core/engine.py:257-259), in one launch instead of a combine,
// a copy and a scatter.  The γ row ids come by value (rows == null, γ <=
// NT_COMBINE_BY_VALUE; a __grid_constant__ parameter, read where the launch
// put it, with no copy into each thread's local memory) or from a device
// array (rows != null, any γ): the same loop reads either.
// Each block owns a tile of NT_COMBINE_THREADS elements: it finds the
// tile's range of excl by binary search, marks those elements in shared
// memory, and then folds and stores every element of the tile once, so no
// two blocks touch one element and an excluded element reads no density.
// Bound: (γ + 1)·λ·4 bytes less γ·4 bytes per excluded block, plus the
// exclusion list read once.
__device__ __forceinline__ int64_t lower_bound(const int32_t* a, int64_t n, int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void density_combine_excl_kernel(
    const float* __restrict__ dens, int64_t lam, const __grid_constant__ RowIds ids,
    const int32_t* __restrict__ rows, int64_t gamma, const int32_t* __restrict__ excl,
    int64_t n_excl, int op_or, float* __restrict__ out) {
  __shared__ int64_t s_range[2];
  __shared__ unsigned char s_zero[NT_COMBINE_THREADS];
  const int64_t t0 = (int64_t)blockIdx.x * NT_COMBINE_THREADS;
  const int tid = threadIdx.x;
  const int64_t b = t0 + tid;
  s_zero[tid] = 0;
  if (n_excl > 0) {  // the same branch in every thread of the grid
    if (tid < 2) s_range[tid] = lower_bound(excl, n_excl, t0 + tid * NT_COMBINE_THREADS);
    __syncthreads();
    for (int64_t i = s_range[0] + tid; i < s_range[1]; i += NT_COMBINE_THREADS)
      s_zero[excl[i] - t0] = 1;
    __syncthreads();
  }
  if (b >= lam) return;
  float acc = op_or ? 0.0f : 1.0f;
  if (s_zero[tid]) {
    acc = 0.0f;
  } else {
    const int32_t* rp = rows != nullptr ? rows : ids.id;
    for (int64_t j = 0; j < gamma; ++j) {
      const int32_t r = rp[j];
      if (r < 0) continue;
      const float d = dens[(int64_t)r * lam + b];
      acc = op_or ? acc + d : acc * d;
    }
    if (op_or) acc = fminf(acc, 1.0f);
  }
  out[b] = acc;
}

}  // namespace

extern "C" int nt_density_combine_batch(
    const float* dens, int64_t lam, const int32_t* rows, int64_t nq,
    int64_t gamma, int op_or, float* out, void* stream) {
  if (nq == 0 || lam == 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((lam + threads - 1) / threads), (unsigned)nq);
  density_combine_batch_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      dens, lam, rows, gamma, op_or, out);
  return (int)cudaGetLastError();
}

// one query: γ row ids, each in [0, rows), from host_rows by value (γ <=
// NT_COMBINE_BY_VALUE) or from the device array dev_rows (any γ); excl:
// n_excl block ids in [0, λ), sorted ascending without duplicates, set to
// +0.0 (null when n_excl is 0) -> out [λ].  One launch.
extern "C" int nt_density_combine_excl(const float* dens, int64_t lam, const int32_t* host_rows,
                                       const int32_t* dev_rows, int64_t gamma,
                                       const int32_t* excl, int64_t n_excl, int op_or,
                                       float* out, void* stream) {
  if (lam == 0) return 0;
  RowIds ids = {};
  if (dev_rows == nullptr) {
    if (gamma > NT_COMBINE_BY_VALUE || (gamma > 0 && host_rows == nullptr))
      return (int)cudaErrorInvalidValue;
    for (int64_t j = 0; j < gamma; ++j) ids.id[j] = host_rows[j];
  }
  if (n_excl > 0 && excl == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (lam + NT_COMBINE_THREADS - 1) / NT_COMBINE_THREADS;
  density_combine_excl_kernel<<<(unsigned)blocks, NT_COMBINE_THREADS, 0,
                                (cudaStream_t)stream>>>(dens, lam, ids, dev_rows, gamma, excl,
                                                        n_excl, op_or, out);
  return (int)cudaGetLastError();
}
