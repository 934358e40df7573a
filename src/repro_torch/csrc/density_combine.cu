// Batched ⊕-combine of predicate density rows (paper §3.2), for Hopper.
//
// Replaces the Pallas kernel density_combine_batch
// (src/repro/kernels/density_combine.py:142, grid (Q, λ-tiles, γ) with the
// γ axis carried in the output tile across sequential grid steps).
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
// (91 rows × λ=12,208 × 4 B = 4.4 MB fits the 50 MB L2).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
