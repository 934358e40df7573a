// Inclusive f32 prefix sum of each row, for Hopper (paper §4.1-4.2: the
// THRESHOLD cut and the TWO-PRONG window both read these sums).
//
// Replaces the Pallas kernel prefix_sum (src/repro/kernels/window_scan.py:53,
// a sequential grid over 1024-element tiles, each scanned as a triangular
// matmul on the MXU with the running carry in SMEM).
//
// Contract: the result is bit-identical to repro_torch.core.scan.cumsum, the
// order of jnp.cumsum on JAX's CPU backend (XLA's reduce-window rewritten as
// a blocked scan of base 16), which the planners' plans are held to:
//   n <= 16: acc = 0; acc += x[j] left to right;
//   n  > 16: pad to a multiple of 16 with zeros, scan each 16-element chunk
//            that way, scan the chunk totals (the last value of each padded
//            chunk) recursively by the same rule, then add each chunk's
//            exclusive offset once (+0.0 for the first chunk).
// The triangular matmul of the TPU kernel adds in another order, so it is
// not carried over: being close is not enough, the plans compare these sums
// with k.
//
// Design.  A row is a chain of short dependent steps (λ = 12,208 on the
// path: levels of 12,208, 763, 48 and 3 values), and one block moving a
// whole row in and out through one SM is slow, so the row is spread over a
// thread block cluster of 8 (Hopper): it is cut into segments of 256 values
// (one level-1 chunk: 16 chunks of 16), and each block takes an eighth of
// the segments.  A block loads its part once, coalesced (float4 where the
// row is 16-byte aligned), into its shared memory, scans its level-0 chunks
// (one thread a chunk, 16 sequential adds) and its level-1 chunks there,
// and writes each segment's total into the shared memory of every block of
// the cluster (distributed shared memory).  After the one cluster barrier,
// each block's first warp scans the segment totals (levels 2 and up: at
// most 256 values, one chunk a lane, the top of at most 16 by shuffles) in
// registers, the same adds in every block; the block adds the offsets to
// its level-1 values and then its level-0 values, and writes its part of
// the result once, coalesced.  Every add is the plain version's f32 add in the
// plain version's order (-fmad=false), so the bits are the same at any n.
// Shared memory keeps one spare word per 16 (element i at i + i/16): the
// threads of a warp scan neighbouring chunks, and without the spare word
// their reads would fall on 2 banks.  It holds 17·(16 + 1) floats a segment
// and 2 a segment total: 6.5 KB a block at λ = 12,208, 39 KB at the
// branch's longest row, 65,536 = 16^4 (past it the levels from the third
// on no longer fit one warp).  A longer row (the tests' 65,537) takes the
// other branch of the same launch: one block of 256 threads per row with
// the levels in a global scratch (the chunk totals, Σ ceil(n/16^l) floats
// a row, given by the wrapper) and level 0 written straight into the output.
//
// Bound on an H100 (3.35 TB/s): Q·n·4 bytes read and Q·n·4 written; n adds
// per row are far below the f32 rate, so it is bound by bytes.  At one row
// (8.7 ns of bytes at λ = 12,208) what is left is the launch and the
// latency of the level chain.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#define NT_SCAN_BASE 16
#define NT_SCAN_MAX_LEVELS 16
#define NT_SCAN_THREADS 256   // a block of either branch
#define NT_SCAN_CLUSTER 8     // blocks a row of the cluster branch is split over
#define NT_SCAN_SMEM_MAX_N 65536  // 16^4: its levels from the third on fit one warp

namespace {

namespace cg = cooperative_groups;

// shared floats of one block of the cluster branch for a row of n: its
// segments' elements and chunk totals padded (a spare word per 16), then
// the row's segment totals and their scan
int64_t cluster_smem_floats(int64_t n) {
  const int64_t nseg = (n + 255) / 256, spb = (nseg + NT_SCAN_CLUSTER - 1) / NT_SCAN_CLUSTER;
  return spb * 16 * 17 + spb * 17 + 2 * nseg;
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }  // a spare word per 16

// One 16-value chunk scanned in place in registers, left to right from +0.0;
// returns its total (the last value)
__device__ __forceinline__ float scan16(float (&r)[NT_SCAN_BASE]) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < NT_SCAN_BASE; ++j) {
    acc = acc + r[j];
    r[j] = acc;
  }
  return acc;
}

// A row of n <= NT_SCAN_SMEM_MAX_N on a cluster of 8 blocks.  The row is cut
// into segments of 256 (one level-1 chunk: 16 chunks of 16); rank r takes
// segments [r·spb, (r + 1)·spb).  Each block loads its part coalesced into
// its shared memory, scans its level-0 chunks and level-1 chunks there and
// writes each segment's total into every block's shared memory; after one
// cluster barrier each block's first warp scans those totals (levels 2 and
// up, at most 256 values) in registers, the same adds in every block, and
// the block adds the offsets and writes its part of the result once.
// vec: float4 loads and stores (x and out 16-byte aligned, n a multiple of
// 4).
__global__ void __cluster_dims__(NT_SCAN_CLUSTER, 1, 1) __launch_bounds__(NT_SCAN_THREADS)
prefix_sum_cluster_kernel(const float* __restrict__ x, int n, float* __restrict__ out,
                          int vec) {
  extern __shared__ float sm[];
  constexpr int B = NT_SCAN_BASE, B1 = NT_SCAN_BASE + 1, SEG = B * B;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int nseg = (n + SEG - 1) / SEG, spb = (nseg + NT_SCAN_CLUSTER - 1) / NT_SCAN_CLUSTER;
  const int s0 = min(rank * spb, nseg), ns = min(s0 + spb, nseg) - s0;  // this block's segments
  const int e0 = s0 * SEG, ne = max(0, min((s0 + ns) * SEG, n) - e0);  // and elements
  const int nc = (ne + B - 1) / B;                                      // and level-0 chunks
  float* a0 = sm;                // level 0: the block's elements
  float* a1 = a0 + spb * B * B1; // level 1: its chunk totals
  float* t2 = a1 + spb * B1;     // level 2: the row's segment totals
  float* s2 = t2 + nseg;         // and their scan
  const int64_t base = (int64_t)(blockIdx.x / NT_SCAN_CLUSTER) * n + e0;
  const float* xr = x + base;
  float* orow = out + base;

  // the block's elements, zero-padded to whole chunks
  const int ne4 = vec ? ne / 4 : 0;
  for (int i4 = tid; i4 < ne4; i4 += nt) {
    const float4 v4 = reinterpret_cast<const float4*>(xr)[i4];
    float* p = a0 + pad(4 * i4);  // four words of one chunk
    p[0] = v4.x;
    p[1] = v4.y;
    p[2] = v4.z;
    p[3] = v4.w;
  }
  for (int i = 4 * ne4 + tid; i < nc * B; i += nt) a0[pad(i)] = i < ne ? xr[i] : 0.0f;
  __syncthreads();

  // level 0: its chunks scanned in place; the totals, zero-padded to whole
  // segments, are level 1
  for (int k = tid; k < ns * B; k += nt) {
    float tot = 0.0f;
    if (k < nc) {
      float r[B];
#pragma unroll
      for (int j = 0; j < B; ++j) r[j] = a0[k * B1 + j];
      tot = scan16(r);
#pragma unroll
      for (int j = 0; j < B; ++j) a0[k * B1 + j] = r[j];
    }
    a1[pad(k)] = tot;
  }
  __syncthreads();

  // level 1: one thread a segment; the segment's total into every block's t2
  for (int s = tid; s < ns; s += nt) {
    float r[B];
#pragma unroll
    for (int j = 0; j < B; ++j) r[j] = a1[s * B1 + j];
    const float tot = scan16(r);
#pragma unroll
    for (int j = 0; j < B; ++j) a1[s * B1 + j] = r[j];
#pragma unroll
    for (int q = 0; q < NT_SCAN_CLUSTER; ++q) cluster.map_shared_rank(t2, q)[s0 + s] = tot;
  }
  cluster.sync();  // every block holds every segment total; nothing crosses blocks after this

  // levels 2 and up (nseg <= 256 values) by each block's first warp, the
  // same adds in every block: lane j scans chunk j; with more than one chunk
  // the totals are the top, scanned in order from +0.0 by every lane alike
  // (lane j keeps the value before its own) and added to chunk j (+0.0 to
  // chunk 0)
  if (tid < 32) {
    const int mw = (nseg + B - 1) / B;
    float r[B];
#pragma unroll
    for (int j = 0; j < B; ++j) r[j] = lane < mw && lane * B + j < nseg ? t2[lane * B + j] : 0.0f;
    const float tot = scan16(r);
    if (mw > 1) {
      float acc = 0.0f, off = 0.0f;
      for (int j = 0; j < mw; ++j) {
        acc = acc + __shfl_sync(0xffffffffu, tot, j);
        if (j == lane - 1) off = acc;
      }
#pragma unroll
      for (int j = 0; j < B; ++j) r[j] = r[j] + off;
    }
#pragma unroll
    for (int j = 0; j < B; ++j)
      if (lane < mw && lane * B + j < nseg) s2[lane * B + j] = r[j];
  }
  __syncthreads();

  // level 1 + the scan of the segment totals before it (+0.0 for segment
  // 0); the level-1 value before the block's first chunk, which lies in
  // the previous block: segment s0 − 1's total plus its own offset
  for (int k = tid; k < nc; k += nt) {
    const int seg = s0 + k / B;
    a1[pad(k)] = a1[pad(k)] + (seg == 0 ? 0.0f : s2[seg - 1]);
  }
  const float prev = s0 == 0 ? 0.0f : t2[s0 - 1] + (s0 == 1 ? 0.0f : s2[s0 - 2]);
  __syncthreads();

  // level 0 + the level-1 value before each chunk (+0.0 for chunk 0), written once
  for (int i4 = tid; i4 < ne4; i4 += nt) {
    const int i = 4 * i4, k = i / B;
    const float* p = a0 + pad(i);
    const float off = k == 0 ? (s0 == 0 ? 0.0f : prev) : a1[pad(k - 1)];
    reinterpret_cast<float4*>(orow)[i4] = make_float4(p[0] + off, p[1] + off, p[2] + off,
                                                      p[3] + off);
  }
  for (int i = 4 * ne4 + tid; i < ne; i += nt) {
    const int k = i / B;
    orow[i] = a0[pad(i)] + (k == 0 ? (s0 == 0 ? 0.0f : prev) : a1[pad(k - 1)]);
  }
}

// The other branch, for rows past NT_SCAN_SMEM_MAX_N: one block per row, the
// levels in global scratch.
__global__ void prefix_sum_rows_kernel(const float* __restrict__ x, int64_t n,
                                       float* __restrict__ out,
                                       float* __restrict__ scratch,
                                       int64_t scratch_stride) {
  const int64_t row = blockIdx.x;
  float* lvl_out[NT_SCAN_MAX_LEVELS];
  float* lvl_tot[NT_SCAN_MAX_LEVELS];
  int64_t lvl_len[NT_SCAN_MAX_LEVELS];
  int levels = 0;

  const float* lin = x + row * n;
  float* lout = out + row * n;
  float* free_ = scratch + row * scratch_stride;
  int64_t len = n;
  // down pass: chunk scans, chunk totals become the next level
  while (len > NT_SCAN_BASE) {
    const int64_t m = (len + NT_SCAN_BASE - 1) / NT_SCAN_BASE;
    float* tot = free_;
    free_ += m;
    for (int64_t c = threadIdx.x; c < m; c += blockDim.x) {
      float acc = 0.0f;
      const int64_t base = c * NT_SCAN_BASE;
      for (int j = 0; j < NT_SCAN_BASE; ++j) {
        const int64_t i = base + j;
        const bool in_row = i < len;
        const float v = in_row ? lin[i] : 0.0f;  // the plain version's zero pad
        acc = acc + v;
        if (in_row) lout[i] = acc;
      }
      tot[c] = acc;
    }
    lvl_out[levels] = lout;
    lvl_tot[levels] = tot;
    lvl_len[levels] = len;
    ++levels;
    __syncthreads();
    lin = tot;  // the next level scans the totals in place
    lout = tot;
    len = m;
  }
  // top level: at most 16 values, sequential
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int64_t i = 0; i < len; ++i) {
      acc = acc + lin[i];
      lout[i] = acc;
    }
  }
  __syncthreads();
  // up pass: level l adds the finished scan of its chunk totals
  for (int l = levels - 1; l >= 0; --l) {
    float* o = lvl_out[l];
    const float* s = lvl_tot[l];
    const int64_t len_l = lvl_len[l];
    for (int64_t i = threadIdx.x; i < len_l; i += blockDim.x) {
      const int64_t c = i / NT_SCAN_BASE;
      const float off = c == 0 ? 0.0f : s[c - 1];
      o[i] = o[i] + off;
    }
    __syncthreads();
  }
}

}  // namespace

// The cluster branch's longest row: 65,536 floats.
extern "C" int64_t nt_prefix_sum_smem_max_n() { return NT_SCAN_SMEM_MAX_N; }

// Per-row global scratch that nt_prefix_sum needs for rows of n: 0 where a
// row takes the cluster branch, else Σ_l ceil(n / 16^l) over the levels
// whose length exceeds 16.
extern "C" int64_t nt_prefix_sum_scratch_floats(int64_t n) {
  if (n <= NT_SCAN_SMEM_MAX_N) return 0;
  int64_t total = 0;
  while (n > NT_SCAN_BASE) {
    n = (n + NT_SCAN_BASE - 1) / NT_SCAN_BASE;
    total += n;
  }
  return total;
}

// x, out: [rows, n] f32 contiguous; scratch: rows × scratch_stride f32 with
// scratch_stride = nt_prefix_sum_scratch_floats(n) (null where that is 0).
// One launch either way.
extern "C" int nt_prefix_sum(const float* x, int64_t rows, int64_t n, float* out,
                             float* scratch, int64_t scratch_stride, void* stream) {
  if (rows == 0 || n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= NT_SCAN_SMEM_MAX_N) {
    if (rows * NT_SCAN_CLUSTER > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    const size_t bytes = (size_t)cluster_smem_floats(n) * sizeof(float);  // <= 39 KB
    const int vec = n % 4 == 0 && (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
    prefix_sum_cluster_kernel<<<(unsigned)(rows * NT_SCAN_CLUSTER), NT_SCAN_THREADS, bytes,
                                st>>>(x, (int)n, out, vec);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr || scratch_stride < nt_prefix_sum_scratch_floats(n))
    return (int)cudaErrorInvalidValue;
  // 16 levels cover n < 16^16; an int64 n is smaller
  prefix_sum_rows_kernel<<<(unsigned)rows, NT_SCAN_THREADS, 0, st>>>(x, n, out, scratch,
                                                                     scratch_stride);
  return (int)cudaGetLastError();
}
