// ⊕-combine of predicate density rows (paper §3.2), for Hopper.
//
// Replaces three Pallas kernels: density_combine_batch
// (src/repro/kernels/density_combine.py:142, grid (Q, λ-tiles, γ) with the
// γ axis carried in the output tile across sequential grid steps), the
// single-query density_combine (density_combine.py:75, grid (λ-tiles, γ)),
// which nt_density_combine_excl runs with the single-query planner's
// exclusion fused in (below), and density_combine_batch_sharded
// (density_combine.py:181-232, the batch kernel per shard under shard_map),
// which each rank runs as a launch of the wave kernel on its own
// [rows, λ_local] slab.
//
// out[q, b] = ⊕_{j < γ, rows[q, j] >= 0} dens[rows[q, j], b]
//   AND: product, starting from 1.0
//   OR:  sum, starting from 0.0, then min(sum, 1) after the last row
//
// Blocks run in parallel with no carried grid state, so the γ axis is a
// loop inside each thread: each element folds its γ rows in ascending order
// with one f32 operation per step, exactly the left fold of the reference's
// _combine_local (density_combine.py:164-178), so the result is
// bit-identical to it and to the plain PyTorch version.  Padded rows (-1)
// are skipped: acc*1 == acc and acc+0 == acc for the non-negative densities
// here, so skipping equals folding in the identity.  The build passes
// -fmad=false and no fast-math flag; there is no a*b+c here anyway (AND only
// multiplies, OR only adds).  The wave kernel's design is described above
// density_combine_wave_kernel, the single-query one's above
// density_combine_excl_kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT_COMBINE_THREADS 256
#define NT_COMBINE_BY_VALUE 64  // row ids a single-query launch carries in its parameters
#define NT_WAVE_BY_VALUE 896    // int32s of the ops-and-ids table a wave launch carries (3.5 KB)
#define NT_WAVE_TILE (4 * NT_COMBINE_THREADS)  // elements of a row a block takes at a time
#define NT_WAVE_BLOCKS_PER_SM 8

namespace {

// A single query's row ids, passed by value in the launch parameters: no
// host→device copy before the launch.
struct RowIds {
  int32_t id[NT_COMBINE_BY_VALUE];
};

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


// The wave: Q queries, each with its own ⊕ op, in one launch.
//
// The launch carries the wave's table, ops [Q] (0 AND, 1 OR) then row ids
// [Q, γ] (-1 padded), by value in a __grid_constant__ parameter up to
// NT_WAVE_BY_VALUE int32s (the path's 64 queries of γ <= 3 take 256), so no
// copy to the card precedes it; a larger table comes as a device array that
// the same loop reads.  The host mirror's exclusion comes in the same launch
// as one CSR list: excl[0..Q] are row offsets into the ids excl[Q+1..],
// ascending within each row; those elements are +0.0, bit-identical to
// where(excluded, 0.0, combined).
//
// The grid is sized to the card (at most NT_WAVE_BLOCKS_PER_SM blocks an
// SM) and walks the wave's tiles of NT_WAVE_TILE elements of one row.  For a
// tile each block reads its row's op and ids once (uniform loads, from the
// parameter bank when by value), marks the tile's excluded elements in
// shared memory (two binary searches, then the list's run inside the tile;
// nothing for a row without exclusions), and each thread folds 4
// consecutive elements: one 16-byte load a row and one 16-byte store where
// λ and both pointers allow it (vec), else 4 scalar ones, neighbouring
// threads on neighbouring elements.  Each element is written once, straight
// into its row of the output.
//
// Bound on an H100 (3.35 TB/s): the distinct predicate rows the wave names,
// read once (≤ rows·λ·4 bytes), plus the [Q, λ] f32 output written once and
// the exclusion list read once; γ·Q·λ flops are far below the f32 rate, so
// the kernel is bound by bytes.  Rows shared by several queries are re-read
// from L2, not HBM (91 rows × λ=12,208 × 4 B = 4.4 MB fits the 50 MB L2).
struct WaveTable {
  int32_t v[NT_WAVE_BY_VALUE];
};

__global__ void __launch_bounds__(NT_COMBINE_THREADS) density_combine_wave_kernel(
    const float* __restrict__ dens, int64_t lam, const __grid_constant__ WaveTable tab,
    const int32_t* __restrict__ dev_tab, int64_t nq, int64_t gamma,
    const int32_t* __restrict__ excl, int vec, float* __restrict__ out) {
  __shared__ int64_t s_range[2];
  __shared__ unsigned char s_zero[NT_WAVE_TILE];
  const int tid = threadIdx.x;
  const int32_t* tb = dev_tab != nullptr ? dev_tab : tab.v;
  const int64_t per_row = (lam + NT_WAVE_TILE - 1) / NT_WAVE_TILE;
  const int64_t n_tiles = nq * per_row;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t q = tile / per_row;
    const int64_t t0 = (tile - q * per_row) * NT_WAVE_TILE;
    const int op_or = tb[q];
    const int32_t* ids = tb + nq + q * gamma;
    bool zeroes = false;  // the same in every thread of the block
    if (excl != nullptr && excl[q] < excl[q + 1]) {
      zeroes = true;
      const int32_t* ex = excl + nq + 1;
      for (int i = tid; i < NT_WAVE_TILE; i += NT_COMBINE_THREADS) s_zero[i] = 0;
      if (tid < 2)
        s_range[tid] = excl[q] + lower_bound(ex + excl[q], excl[q + 1] - excl[q],
                                             t0 + tid * NT_WAVE_TILE);
      __syncthreads();
      for (int64_t i = s_range[0] + tid; i < s_range[1]; i += NT_COMBINE_THREADS)
        s_zero[ex[i] - t0] = 1;
      __syncthreads();
    }
    float* oq = out + q * lam;
    if (vec) {
      const int64_t b = t0 + 4 * tid;
      if (b < lam) {  // λ % 4 == 0: all four are in the row
        const float e = op_or ? 0.0f : 1.0f;
        float4 acc = make_float4(e, e, e, e);
        for (int64_t j = 0; j < gamma; ++j) {
          const int32_t r = ids[j];
          if (r < 0) continue;
          const float4 d = *reinterpret_cast<const float4*>(dens + (int64_t)r * lam + b);
          if (op_or) {
            acc.x = acc.x + d.x; acc.y = acc.y + d.y; acc.z = acc.z + d.z; acc.w = acc.w + d.w;
          } else {
            acc.x = acc.x * d.x; acc.y = acc.y * d.y; acc.z = acc.z * d.z; acc.w = acc.w * d.w;
          }
        }
        if (op_or) {
          acc.x = fminf(acc.x, 1.0f); acc.y = fminf(acc.y, 1.0f);
          acc.z = fminf(acc.z, 1.0f); acc.w = fminf(acc.w, 1.0f);
        }
        if (zeroes) {
          const unsigned char* z = s_zero + 4 * tid;
          if (z[0]) acc.x = 0.0f;
          if (z[1]) acc.y = 0.0f;
          if (z[2]) acc.z = 0.0f;
          if (z[3]) acc.w = 0.0f;
        }
        *reinterpret_cast<float4*>(oq + b) = acc;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = u * NT_COMBINE_THREADS + tid;
        const int64_t b = t0 + i;
        if (b >= lam) break;
        float acc = op_or ? 0.0f : 1.0f;
        for (int64_t j = 0; j < gamma; ++j) {
          const int32_t r = ids[j];
          if (r < 0) continue;
          const float d = dens[(int64_t)r * lam + b];
          acc = op_or ? acc + d : acc * d;
        }
        if (op_or) acc = fminf(acc, 1.0f);
        if (zeroes && s_zero[i]) acc = 0.0f;
        oq[b] = acc;
      }
    }
    if (zeroes) __syncthreads();  // s_zero is the next tile's
  }
}

}  // namespace

// The wave: Q queries, γ ids each, ops and ids in one table (ops [Q], then
// ids [Q, γ], each id in [-1, rows)), from host_tab by value (Q + Q·γ <=
// NT_WAVE_BY_VALUE) or from the device array dev_tab (any size); excl: the
// CSR exclusion (Q + 1 offsets, then the ids, each row's ascending in [0,
// λ)) on the card, or null -> out [Q, λ].  One launch.
extern "C" int nt_density_combine_wave(const float* dens, int64_t lam, const int32_t* host_tab,
                                       const int32_t* dev_tab, int64_t nq, int64_t gamma,
                                       const int32_t* excl, float* out, void* stream) {
  if (nq == 0 || lam == 0) return 0;
  WaveTable tab;
  const int64_t n_tab = nq + nq * gamma;
  if (dev_tab == nullptr) {
    if (n_tab > NT_WAVE_BY_VALUE || host_tab == nullptr) return (int)cudaErrorInvalidValue;
    for (int64_t i = 0; i < n_tab; ++i) tab.v[i] = host_tab[i];
  }
  const int vec = lam % 4 == 0 && reinterpret_cast<uintptr_t>(dens) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const int64_t tiles = nq * ((lam + NT_WAVE_TILE - 1) / NT_WAVE_TILE);
  const int64_t blocks = tiles < (int64_t)sms * NT_WAVE_BLOCKS_PER_SM
                             ? tiles : (int64_t)sms * NT_WAVE_BLOCKS_PER_SM;
  density_combine_wave_kernel<<<(unsigned)blocks, NT_COMBINE_THREADS, 0,
                                (cudaStream_t)stream>>>(dens, lam, tab, dev_tab, nq, gamma, excl,
                                                        vec, out);
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
