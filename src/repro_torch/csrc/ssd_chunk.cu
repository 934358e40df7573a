// Mamba2 SSD (state-space duality) chunked scan, for Hopper.
//
// Replaces the Pallas kernel ssd_scan (src/repro/kernels/ssd_chunk.py:66,
// pallas_call at :78: grid (B, H, chunks) with the chunk axis sequential and
// the running state H [ds, dh] in VMEM scratch across chunk steps).
//
// The recurrence h_t = a_t·h_{t-1} + B_t ⊗ u_t, y_t = C_t·h_t is evaluated a
// chunk of Q = 128 steps at a time (Mamba2 paper, Listing 1), as the TPU
// kernel does (ssd_chunk.py:28-63):
//   ca      = inclusive cumsum of the chunk's log-decays ld
//   y_intra = (C Bᵀ ⊙ L) U,        L[t, s] = exp(ca_t − ca_s)·1[s ≤ t]
//   y_inter = exp(ca) ⊙ (C H)
//   H      <- exp(ca_{Q-1})·H + (exp(ca_{Q-1} − ca) ⊙ B)ᵀ U
//
// Design.  Blocks run in parallel with nothing carried between them, so the
// TPU's sequential chunk axis becomes a loop inside one thread block per
// (b, h); the state H stays in shared memory, in f32, for the whole walk.
// Per chunk the block stages U [Q, dh], Bᵀ [ds, Q] and the log-decays in
// shared memory and computes ca with a one-warp scan (the TPU kernel sums
// by a triangular matmul: another order, so results agree to f32 rounding,
// held at the reference's atol 2e-3 / rtol 1e-2).  The 128×128 score tile
// would not fit beside the rest at ds = 128 (mamba2-130m), so the chunk's
// rows are walked in four tiles of 32: a tile's C rows and its 32×128 score
// slice are staged, its scores and its 32 output rows (intra + inter) are
// computed and written, and only then the next tile.  A score slice needs
// only the columns s < r0 + 32 (L is lower triangular), so the intra-chunk
// work is half a square.  Each product is a 4×4 register tile per thread
// over shared memory with odd row strides (no bank conflicts on the strided
// operand).  L is formed only where s <= t: the TPU kernel takes exp over
// the whole square and multiplies by the triangle, which gives inf·0 = NaN
// once a chunk's decays sum below −88 (128 identical pad tokens with
// dt > 0.69 do); here those entries are 0.  B and C are read through
// (batch, head) strides, so the [B, S, ds] projections that mamba_block
// broadcasts to every head are read with a head stride of 0 and never
// materialised.
//
// Shared memory: 3·Q + ds·(Q+1) + Q·dh + ds·dh + 32·(ds+1) + 32·(Q+1)
// floats: 108.5 KB at ds = dh = 64 (two blocks per SM), 166 KB at ds = 128.
//
// Bound on an H100: per (b, h) and chunk, Q(Q+1)·ds (scores, s <= t) +
// Q(Q+1)·dh (intra) + 2·Q·ds·dh (inter) + 2·Q·ds·dh (state) flops, against
// u, ld and the [B, S, ds] B and C read once and y written once.  At
// zamba2-7b's shapes (H = 112, ds = dh = 64) that is ~3·10⁴ flops per step
// per head against ~0.5 KB: bound by operations at the f32 rate outside the
// tensor cores (67 TFLOP/s).  Every product here is f32 FMA on the CUDA
// cores; tensor-core tiles (TF32 or bf16 wgmma) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define NT_SSD_Q 128
#define NT_SSD_RT 32  // rows of a score tile
#define NT_SSD_THREADS 256

namespace {

// acc[i][j] = Σ_k A[(m0+i)·lda + k] · Bm[k·ldb + n0 + nx·j], i, j < 4
__device__ __forceinline__ void tile4x4(const float* __restrict__ A, int lda,
                                        const float* __restrict__ Bm, int ldb,
                                        int K, int m0, int n0, int nx,
                                        float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(m0 + i) * lda + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[k * ldb + n0 + nx * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(NT_SSD_THREADS)
ssd_scan_kernel(const float* __restrict__ u, const float* __restrict__ ld,
                const float* __restrict__ bm, const float* __restrict__ cm,
                float* __restrict__ y, int64_t H, int64_t S, int dh, int ds,
                int64_t b_bstride, int64_t b_hstride, int64_t c_bstride,
                int64_t c_hstride) {
  constexpr int Q = NT_SSD_Q;
  constexpr int RT = NT_SSD_RT;
  const int64_t bi = blockIdx.x / H;
  const int64_t hi = blockIdx.x % H;
  const int tid = threadIdx.x;
  const float* ub = u + blockIdx.x * S * dh;
  const float* lb = ld + blockIdx.x * S;
  const float* bb = bm + bi * b_bstride + hi * b_hstride;
  const float* cb = cm + bi * c_bstride + hi * c_hstride;
  float* yb = y + blockIdx.x * S * dh;

  extern __shared__ float smem[];
  const int ldbt = Q + 1, ldc = ds + 1, lds = Q + 1;
  float* ca = smem;             // [Q]
  float* eca = ca + Q;          // [Q]  exp(ca)
  float* w = eca + Q;           // [Q]  exp(ca_{Q-1} - ca)
  float* Bt = w + Q;            // [ds][Q+1]
  float* U = Bt + ds * ldbt;    // [Q][dh]
  float* Hs = U + Q * dh;       // [ds][dh]
  float* Ct = Hs + ds * dh;     // [RT][ds+1]
  float* Sc = Ct + RT * ldc;    // [RT][Q+1]

  for (int i = tid; i < ds * dh; i += blockDim.x) Hs[i] = 0.0f;

  const int64_t chunks = S / Q;
  for (int64_t c = 0; c < chunks; ++c) {
    const int64_t t0 = c * Q;
    __syncthreads();  // the previous chunk's state update is done
    if (tid < 32) {   // one warp: ca = inclusive scan of the chunk's ld
      float v[4];
      float run = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        run += lb[t0 + tid * 4 + k];
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) ca[tid * 4 + k] = excl + v[k];
    }
    for (int i = tid; i < Q * dh; i += blockDim.x) U[i] = ub[t0 * dh + i];
    for (int i = tid; i < Q * ds; i += blockDim.x) {
      const int s = i / ds, n = i % ds;
      Bt[n * ldbt + s] = bb[(t0 + s) * ds + n];
    }
    __syncthreads();
    if (tid < Q) {
      eca[tid] = expf(ca[tid]);
      w[tid] = expf(ca[Q - 1] - ca[tid]);
    }

    for (int r0 = 0; r0 < Q; r0 += RT) {
      for (int i = tid; i < RT * ds; i += blockDim.x) {
        const int r = i / ds, n = i % ds;
        Ct[r * ldc + n] = cb[(t0 + r0 + r) * ds + n];
      }
      __syncthreads();
      // scores[r][s] = (C_r · B_s) · exp(ca_t − ca_s) for s <= t = r0 + r
      const int ncols = r0 + RT;
      {
        const int nx = ncols / 4;
        for (int tile = tid; tile < (RT / 4) * nx; tile += blockDim.x) {
          const int m0 = (tile / nx) * 4, n0 = tile % nx;
          float acc[4][4];
          tile4x4(Ct, ldc, Bt, ldbt, ds, m0, n0, nx, acc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = r0 + m0 + i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int s = n0 + nx * j;
              Sc[(m0 + i) * lds + s] = s <= t ? acc[i][j] * expf(ca[t] - ca[s]) : 0.0f;
            }
          }
        }
      }
      __syncthreads();
      // y[t] = scores[r] · U + exp(ca_t) · (C_r · H)
      {
        const int nx = dh / 4;
        for (int tile = tid; tile < (RT / 4) * nx; tile += blockDim.x) {
          const int m0 = (tile / nx) * 4, n0 = tile % nx;
          float intra[4][4], inter[4][4];
          tile4x4(Sc, lds, U, dh, ncols, m0, n0, nx, intra);
          tile4x4(Ct, ldc, Hs, dh, ds, m0, n0, nx, inter);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = r0 + m0 + i;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              yb[(t0 + t) * dh + n0 + nx * j] = intra[i][j] + eca[t] * inter[i][j];
          }
        }
      }
      __syncthreads();  // Ct and Sc are rewritten by the next row tile
    }

    // H <- exp(ca_{Q-1})·H + (w ⊙ B)ᵀ U, each thread updating its own cells
    for (int i = tid; i < ds * Q; i += blockDim.x) {
      const int n = i / Q, s = i % Q;
      Bt[n * ldbt + s] *= w[s];
    }
    __syncthreads();
    {
      const float decay = expf(ca[Q - 1]);
      const int nx = dh / 4;
      for (int tile = tid; tile < (ds / 4) * nx; tile += blockDim.x) {
        const int m0 = (tile / nx) * 4, n0 = tile % nx;
        float acc[4][4];
        tile4x4(Bt, ldbt, U, dh, Q, m0, n0, nx, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* h = &Hs[(m0 + i) * dh + n0 + nx * j];
            *h = decay * *h + acc[i][j];
          }
      }
    }
  }
}

int64_t ssd_scan_smem_bytes(int64_t dh, int64_t ds) {
  const int64_t Q = NT_SSD_Q, RT = NT_SSD_RT;
  return (3 * Q + ds * (Q + 1) + Q * dh + ds * dh + RT * (ds + 1) + RT * (Q + 1)) *
         (int64_t)sizeof(float);
}

}  // namespace

// u [B, H, S, dh], ld [B, H, S], y [B, H, S, dh] contiguous f32; B and C
// [B, H, S, ds] f32 with contiguous (S, ds) and the given batch and head
// strides (0 for a head-broadcast view).  S % 128 == 0, dh % 4 == 0 and
// dh <= 64, ds % 4 == 0 and ds <= 128 (checked by the wrapper).
extern "C" int nt_ssd_scan(const float* u, const float* ld, const float* bm,
                           const float* cm, float* y, int64_t B, int64_t H,
                           int64_t S, int64_t dh, int64_t ds, int64_t b_bstride,
                           int64_t b_hstride, int64_t c_bstride,
                           int64_t c_hstride, void* stream) {
  if (B * H == 0 || S == 0) return 0;
  const int64_t smem = ssd_scan_smem_bytes(dh, ds);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<(unsigned)(B * H), NT_SSD_THREADS, (size_t)smem,
                    (cudaStream_t)stream>>>(u, ld, bm, cm, y, H, S, (int)dh,
                                            (int)ds, b_bstride, b_hstride,
                                            c_bstride, c_hstride);
  return (int)cudaGetLastError();
}
