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
// Design.  One thread block per row walks the whole hierarchy, so no level
// waits on another block: a down pass in which one thread per chunk does the
// 16 sequential adds (level 0 writes its chunk scans straight into the
// output, higher levels scan the chunk totals in place in a per-row scratch
// of Σ ceil(n/16^l) floats, 814 at the path's λ = 12,208: levels 763, 48,
// 3), one thread for the top level of at most 16 values, then an up pass per
// level adding the offsets.  Every add is the plain version's f32 add in the
// plain version's order, and the build passes -fmad=false, so the bits are
// the same at any n.
//
// Bound on an H100 (3.35 TB/s): Q·n·4 bytes read and Q·n·4 written; n adds
// per row are far below the f32 rate, so it is bound by bytes.  One block per
// row leaves SMs idle below Q = 132 rows and each thread's 16 loads are
// strided by 64 bytes across a warp (L1 serves the reuse); speed is left for
// a later change, the order is what this kernel is for.
#include <cuda_runtime.h>
#include <stdint.h>

#define NT_SCAN_BASE 16
#define NT_SCAN_MAX_LEVELS 16
#define NT_SCAN_THREADS 256

namespace {

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

// x, out: [rows, n] f32 contiguous; scratch: rows × scratch_stride f32, with
// scratch_stride = Σ_l ceil(n / 16^l) over the levels whose length exceeds 16
// (the wrapper computes it)
extern "C" int nt_prefix_sum(const float* x, int64_t rows, int64_t n, float* out,
                             float* scratch, int64_t scratch_stride, void* stream) {
  if (rows == 0 || n == 0) return 0;
  // 16 levels cover n < 16^16; an int64 n is smaller
  prefix_sum_rows_kernel<<<(unsigned)rows, NT_SCAN_THREADS, 0,
                           (cudaStream_t)stream>>>(x, n, out, scratch,
                                                   scratch_stride);
  return (int)cudaGetLastError();
}
