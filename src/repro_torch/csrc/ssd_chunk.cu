// Mamba2 SSD (state-space duality) chunked scan on Hopper's tensor cores, f32
// at f32-class accuracy through 3xTF32.
//
// Replaces the Pallas kernel ssd_scan (src/repro/kernels/ssd_chunk.py:66,
// pallas_call at :78: grid (B, H, chunks) with the chunk axis sequential and
// the running state H [ds, dh] in VMEM scratch across chunk steps).
//
// The recurrence h_t = a_t·h_{t-1} + B_t ⊗ u_t, y_t = C_t·h_t is evaluated a
// chunk of Q = 128 steps at a time (Mamba2 paper, Listing 1), the four terms
// of the TPU kernel (ssd_chunk.py:28-63):
//   ca      = inclusive cumsum of the chunk's log-decays ld
//   y_intra = (C Bᵀ ⊙ L) U,        L[t, s] = exp(ca_t − ca_s)·1[s ≤ t]
//   y_inter = exp(ca) ⊙ (C H)
//   H      <- exp(ca_{Q-1})·H + (exp(ca_{Q-1} − ca) ⊙ B)ᵀ U
//
// Design.  The TPU walks the chunks in order with H in scratch.  Here the
// chunk axis is parallel work: one call of the wrapper runs three kernels.
//   1. chunk state (ssd_state_kernel), one block per (b, h, chunk):
//      S_c = (w ⊙ B)ᵀ U with w = exp(ca_{Q-1} − ca), into a scratch
//      [B, H, nc, ds, dh], and exp(ca_{Q-1}) into a scratch [B, H, nc]; the
//      wrapper allocates both.
//   2. state pass (ssd_pass_kernel), many threads per (b, h), each owning
//      four of the ds·dh cells: H_0 = 0, H_{c+1} = exp(ca_{Q-1},c)·H_c + S_c,
//      in series over the chunks.  Each chunk's S_c is overwritten with its
//      incoming state H_c, and H_nc goes to the state output when the caller
//      asks for it.
//   3. chunk output (ssd_output_kernel), one block of 4 warps per (b, h,
//      chunk, 64-row tile), each warp 16 rows: acc = C·H_c, each row scaled
//      by exp(ca_t), then acc += (C Bᵀ ⊙ L)·U.  The score tile stays in
//      registers as the A operand of the product with U, as flash
//      attention's P does: a thread's columns 2t and 2t + 1 of an 8-column
//      step stand for k = t and t + 4, and the B fragment reads U's rows 2t
//      and 2t + 1.  A warp computes the score columns up to its tile's last
//      row, in 8-column steps.  L is formed only where s <= t; the rest is
//      set to 0 without an exp.  The TPU kernel takes exp over the whole
//      square and multiplies by the triangle, which gives inf·0 = NaN once a
//      chunk's decays sum below −88 (128 identical pad tokens with dt > 0.69
//      do).
// Phases 1 and 3 compute ca with the same one-warp scan (chunk_cumsum), so
// they see the same values.  It sums in another order than the TPU kernel's
// triangular matmul, so results agree to f32 rounding (held at the
// reference's atol 2e-3 / rtol 1e-2).
//
// Products.  Every product is mma.sync.m16n8k8 TF32 in 3xTF32 (tf32x3.cuh):
// each f32 operand split into hi and lo, three TF32 products a step.
// Operands come into shared memory by cp.async (16 bytes a copy).  Phase 1
// takes the chunk's 128 steps in quarters through a ring of two stages, the
// next quarter's copies in flight during this one's products.  Phase 3
// stages C, H_c and B, computes the scores, then stages U over them: fewer
// bytes a block, so three blocks an SM overlap one another's copies.  The
// kernels are compiled for dh = 64 and ds = DS = 64 or 128 (every
// configured model's): a smaller dh or ds is zero-padded to them as the
// operands are staged, so the products run without guards and only the
// writes of results check dh and ds.  (A guard inside the unrolled products
// cuts them into blocks the scheduler cannot interleave, and each 3xTF32
// step then waits out three dependent mma latencies.)
// Row strides make every fragment read of a warp hit 32 distinct banks:
// ≡ 8 (mod 32) floats where a fragment reads 4 rows × 8 columns (B and U in
// phase 1, H_c in phase 3), ≡ 4 (mod 32) where it reads 8 rows × 4 columns
// (C and B in phase 3) or rows 2t (U in phase 3).  B and C are read
// through their (batch, head) strides, so the [B, S, ds] projections that
// mamba_block broadcasts to every head (head stride 0) are never
// materialised.  Where a base is not 16-byte aligned, the same stages are
// filled by plain loads.
//
// Bound on an H100, per (b, h) and chunk: Q(Q+1)·ds (scores, s <= t) +
// Q(Q+1)·dh (intra) + 2·Q·ds·dh (inter) + 2·Q·ds·dh (state) flops, against
// u, ld and the [B, S, ds] B and C read once and y written once.  At
// zamba2-7b's long wave ([4, 112, 1920] steps, ds = dh = 64) that is
// 2.83·10¹⁰ flops against 0.45 GB: bound by operations, 0.172 ms on the
// tensor cores in 3xTF32 (three TF32 operations a flop at 494.7 TFLOP/s),
// 0.422 ms at the f32 FMA rate (67 TFLOP/s); the bytes alone take 0.134 ms.
// The design this replaces, one block per (b, h) walking its chunks with
// f32 FMA tiles out of shared memory, ran at 16% of the f32 FMA bound: 448
// blocks in 1.7 waves, shared-memory-load bound, no copy overlap.  The
// scratch adds 4·B·H·nc·ds·dh floats of traffic (S_c written, read and
// overwritten, read again: 0.44 GB at the long wave).
//
// Shared memory, with DS = 64 or 128 the padded ds and DH = 64: phase 1
// 2·Q + 64·(ld8(DS) + ld8(DH)) floats, 37 KB at DS = 64 (five blocks an SM),
// 53 KB at DS = 128; phase 3 Q + max(64·ld4(DS) + DS·ld8(DH) + Q·ld4(DS),
// Q·ld4(DH)) floats, 69.5 KB at DS = 64 (three blocks an SM), 135.5 KB at
// DS = 128 (mamba2-130m).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

#define NT_SSD_Q 128              // chunk length
#define NT_SSD_THREADS 128        // phases 1 and 3: 4 warps
#define NT_SSD_QS 32              // steps of a phase-1 stage: a quarter of the chunk
#define NT_SSD_RT 64              // rows of a phase-3 block: 4 warps of 16
#define NT_SSD_DH 64              // dh as compiled: smaller ones are zero-padded
#define NT_SSD_ND 8               // its 8-column blocks
#define NT_SSD_PASS_THREADS 256   // phase 2

namespace {

constexpr int Q = NT_SSD_Q;

constexpr int DH = NT_SSD_DH;

// shared-memory row strides, in floats: n rounded up to 32, then + 8 or + 4
__host__ __device__ constexpr int ld8(int n) { return ((n + 31) & ~31) + 8; }
__host__ __device__ constexpr int ld4(int n) { return ((n + 31) & ~31) + 4; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, R) and columns [0, n) of a row-major global matrix (row stride
// gs floats) into dst[Rp][ldd], zero from row R to Rp and from column n to
// np.  n, np and gs are multiples of 4 (ds and dh are multiples of 8), so
// every row starts 16-byte aligned when src does: by cp.async then, else by
// plain loads.
__device__ __forceinline__ void stage(float* dst, int ldd, const float* src, int gs, int R,
                                      int Rp, int n, int np) {
  const bool vec = ((uintptr_t)src & 15) == 0;
  const int cu = np >> 2;
  for (int i = threadIdx.x; i < Rp * cu; i += blockDim.x) {
    const int r = i / cu, c = (i - r * cu) * 4;
    float* d = dst + r * ldd + c;
    const float* s = src + (int64_t)r * gs + c;
    if (r >= R || c >= n) {
      d[0] = d[1] = d[2] = d[3] = 0.0f;
    } else if (vec) {
      cp_async16(d, s);
    } else {
      d[0] = s[0];
      d[1] = s[1];
      d[2] = s[2];
      d[3] = s[3];
    }
  }
}

// ca[i] = ld[0] + ... + ld[i] over a chunk's Q = 128 log-decays, by warp 0
// of the block: lane l sums its steps 4l..4l+3 in order, the lanes' totals
// are scanned by shuffles (Hillis-Steele: offsets 1, 2, 4, 8, 16), and the
// total of lanes < l is added to each of lane l's running sums.  Phases 1
// and 3 both call it, so both see the same ca.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ ld, float* ca) {
  const int lane = threadIdx.x & 31;
  float v[4], run = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    run += ld[lane * 4 + k];
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) ca[lane * 4 + k] = excl + v[k];
}

// Phase 1: S_c = (w ⊙ B)ᵀ U for one (b, h, chunk), a [DS, Q] × [Q, DH]
// product.  The A operand's rows are B's columns (state index m), its depth
// the chunk's steps; warp i takes the 16-row tiles i, i + 4, ..., MT of
// them (DS = 64·MT), each with DH / 8 column blocks.  The depth comes in
// quarters of 32 steps through a ring of two stages, the next quarter's
// copies in flight during this one's products.
template <int MT>
__global__ void __launch_bounds__(NT_SSD_THREADS)
ssd_state_kernel(const float* __restrict__ u, const float* __restrict__ ld,
                 const float* __restrict__ bm, float* __restrict__ st,
                 float* __restrict__ dec, int64_t H, int64_t nc, int64_t S, int dh, int ds,
                 int64_t b_bstride, int64_t b_hstride) {
  constexpr int QS = NT_SSD_QS, DS = 64 * MT, ldb = ld8(DS), ldu = ld8(DH);
  const int64_t bh = blockIdx.x / nc, c = blockIdx.x % nc;
  const int64_t bi = bh / H, hi = bh % H, t0 = c * Q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  extern __shared__ float smem[];
  float* ca = smem;              // [Q]
  float* w = ca + Q;             // [Q]  exp(ca_{Q-1} − ca)
  float* Bs = w + Q;             // [2][QS][ldb]  B's rows, zero from ds to DS
  float* Us = Bs + 2 * QS * ldb; // [2][QS][ldu]  U's rows, zero from dh to DH

  const float* bb = bm + bi * b_bstride + hi * b_hstride + t0 * ds;
  const float* ub = u + (bh * S + t0) * dh;
  // quarter q of the depth into stage q & 1
#define NT_SSD_STAGE_QUARTER(q)                                                        \
  do {                                                                                 \
    stage(Bs + ((q) & 1) * QS * ldb, ldb, bb + (int64_t)(q) * QS * ds, ds, QS, QS, ds, DS); \
    stage(Us + ((q) & 1) * QS * ldu, ldu, ub + (int64_t)(q) * QS * dh, dh, QS, QS, dh, DH); \
    cp_async_commit();                                                                 \
  } while (0)
  NT_SSD_STAGE_QUARTER(0);
  if (warp == 0) chunk_cumsum(ld + bh * S + t0, ca);
  __syncthreads();
  if (tid < Q) w[tid] = expf(ca[Q - 1] - ca[tid]);
  if (tid == 0) dec[bh * nc + c] = expf(ca[Q - 1]);

  float acc[MT][NT_SSD_ND][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT_SSD_ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;

  for (int q = 0; q < Q / QS; ++q) {
    cp_async_wait<0>();
    __syncthreads();  // quarter q is in (and w); every warp is done with quarter q − 1
    if (q + 1 < Q / QS) NT_SSD_STAGE_QUARTER(q + 1);
    const float* Bq = Bs + (q & 1) * QS * ldb;
    const float* Uq = Us + (q & 1) * QS * ldu;
#pragma unroll
    for (int kk = 0; kk < QS / 8; ++kk) {
      const int k0 = q * QS + kk * 8;
      const float w0 = w[k0 + t], w1 = w[k0 + t + 4];
      const float* b0 = Bq + (kk * 8 + t) * ldb + g;  // A[m][k] = w[k]·B[k][m]
      const float* b1 = b0 + 4 * ldb;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int m0 = (warp + 4 * i) * 16;
        split<false>(w0 * b0[m0], ah[i][0], al[i][0]);
        split<false>(w0 * b0[m0 + 8], ah[i][1], al[i][1]);
        split<false>(w1 * b1[m0], ah[i][2], al[i][2]);
        split<false>(w1 * b1[m0 + 8], ah[i][3], al[i][3]);
      }
      const float* u0 = Uq + (kk * 8 + t) * ldu + g;
#pragma unroll
      for (int n = 0; n < NT_SSD_ND; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split<false>(u0[n * 8], bh0, bl0);
        split<false>(u0[4 * ldu + n * 8], bh1, bl1);
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mma3<false, false>(acc[i][n], ah[i], al[i], bh0, bh1, bl0, bl1);
      }
    }
  }
#undef NT_SSD_STAGE_QUARTER

  // the [ds, dh] corner of the padded product
  float* sb = st + (bh * nc + c) * (int64_t)ds * dh;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = (warp + 4 * i) * 16 + g;
#pragma unroll
    for (int n = 0; n < NT_SSD_ND; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < dh && r < ds)
        *reinterpret_cast<float2*>(sb + r * dh + col) = make_float2(acc[i][n][0], acc[i][n][1]);
      if (col < dh && r + 8 < ds)
        *reinterpret_cast<float2*>(sb + (r + 8) * dh + col) =
            make_float2(acc[i][n][2], acc[i][n][3]);
    }
  }
}

// Phase 2: the state carried across chunks.  Thread e of (b, h) owns cells
// 4e..4e+3 of the [ds, dh] state; it reads eight chunks' S_c ahead of the
// dependent multiply-adds (a·H then + S_c, separately rounded).
__global__ void __launch_bounds__(NT_SSD_PASS_THREADS)
ssd_pass_kernel(float* __restrict__ st, const float* __restrict__ dec, float* __restrict__ hout,
                int64_t nc, int64_t n4, int64_t parts) {
  const int64_t bh = blockIdx.x / parts;
  const int64_t e = (blockIdx.x % parts) * NT_SSD_PASS_THREADS + threadIdx.x;
  if (e >= n4) return;
  float4* p = reinterpret_cast<float4*>(st) + bh * nc * n4 + e;
  const float* d = dec + bh * nc;
  float4 h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int64_t c0 = 0; c0 < nc; c0 += 8) {
    float4 s[8];
    float a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j < nc) {
        s[j] = p[(c0 + j) * n4];
        a[j] = d[c0 + j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j < nc) {
        p[(c0 + j) * n4] = h;  // chunk c0 + j's incoming state
        h.x = a[j] * h.x + s[j].x;
        h.y = a[j] * h.y + s[j].y;
        h.z = a[j] * h.z + s[j].z;
        h.w = a[j] * h.w + s[j].w;
      }
    }
  }
  if (hout != nullptr) reinterpret_cast<float4*>(hout)[bh * n4 + e] = h;
}

// Phase 3, before U is needed, for one warp's 16 rows (thread rows ta and
// ta + 8 of the chunk): acc = C·H_c, each row then scaled by exp(ca_t), and
// sc = C Bᵀ ⊙ L over NSC score column blocks of 8, C's split fragments
// shared by both products; the depth is DS (ds zero-padded).
template <int DS, int NSC>
__device__ __forceinline__ void output_scores(float (&acc)[NT_SSD_ND][4], float (&sc)[Q / 8][4],
                                              const float* Cs, const float* Hs,
                                              const float* Bs, const float* ca, int w0, int ta) {
  constexpr int ldc = ld4(DS), ldb = ld4(DS), ldh = ld8(DH);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, tb = ta + 8;
  const float* crow = Cs + (w0 + g) * ldc + t;
  for (int k0 = 0; k0 < DS; k0 += 8) {
    uint32_t ah[4], al[4];
    split<false>(crow[k0], ah[0], al[0]);
    split<false>(crow[8 * ldc + k0], ah[1], al[1]);
    split<false>(crow[k0 + 4], ah[2], al[2]);
    split<false>(crow[8 * ldc + k0 + 4], ah[3], al[3]);
    const float* h0 = Hs + (k0 + t) * ldh + g;
#pragma unroll
    for (int n = 0; n < NT_SSD_ND; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split<false>(h0[n * 8], bh0, bl0);
      split<false>(h0[4 * ldh + n * 8], bh1, bl1);
      mma3<false, false>(acc[n], ah, al, bh0, bh1, bl0, bl1);
    }
    const float* bk = Bs + g * ldb + k0 + t;  // B fragment of Bᵀ: B's row s, column k
#pragma unroll
    for (int nb = 0; nb < NSC; ++nb) {
      uint32_t bh0, bl0, bh1, bl1;
      split<false>(bk[nb * 8 * ldb], bh0, bl0);
      split<false>(bk[nb * 8 * ldb + 4], bh1, bl1);
      mma3<false, false>(sc[nb], ah, al, bh0, bh1, bl0, bl1);
    }
  }
  // y_inter = exp(ca_t)·(C H_c); scores ⊙ L, L formed only where s <= t
  const float cat = ca[ta], cbt = ca[tb], ea = expf(cat), eb = expf(cbt);
#pragma unroll
  for (int n = 0; n < NT_SSD_ND; ++n) {
    acc[n][0] *= ea;
    acc[n][1] *= ea;
    acc[n][2] *= eb;
    acc[n][3] *= eb;
  }
#pragma unroll
  for (int nb = 0; nb < NSC; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = nb * 8 + 2 * t + e;
      const float cs = ca[s];
      sc[nb][e] = s <= ta ? sc[nb][e] * expf(cat - cs) : 0.0f;
      sc[nb][2 + e] = s <= tb ? sc[nb][2 + e] * expf(cbt - cs) : 0.0f;
    }
  }
}

// Phase 3, once U is in: acc += sc·U, the scores from registers (k = t and
// t + 4 of a step are its columns 2t and 2t + 1), over NSC steps.
template <int NSC>
__device__ __forceinline__ void output_intra(float (&acc)[NT_SSD_ND][4],
                                             const float (&sc)[Q / 8][4], const float* Us) {
  constexpr int ldu = ld4(DH);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NSC; ++kk) {
    uint32_t ph[4], pl[4];
    split<false>(sc[kk][0], ph[0], pl[0]);  // (g, 2t)
    split<false>(sc[kk][2], ph[1], pl[1]);  // (g + 8, 2t)
    split<false>(sc[kk][1], ph[2], pl[2]);  // (g, 2t + 1)
    split<false>(sc[kk][3], ph[3], pl[3]);  // (g + 8, 2t + 1)
    const float* u0 = Us + (kk * 8 + 2 * t) * ldu + g;
#pragma unroll
    for (int n = 0; n < NT_SSD_ND; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split<false>(u0[n * 8], bh0, bl0);
      split<false>(u0[ldu + n * 8], bh1, bl1);
      mma3<false, false>(acc[n], ph, pl, bh0, bh1, bl0, bl1);
    }
  }
}

// Phase 3 after the first copies: one warp's 16 rows of y, over the tile's
// NSC score column blocks.  Between the scores and the product with U, the
// block stages U's rows s < 8·NSC over C, H_c and B (barriers: NSC is the
// same for every warp of the block).
template <int DS, int NSC>
__device__ __forceinline__ void output_rows(const float* Cs, const float* Hs, const float* Bs,
                                            float* Us, const float* ub, const float* ca,
                                            float* yb, int dh, int w0, int ta) {
  const int t = threadIdx.x & 3;
  float acc[NT_SSD_ND][4], sc[Q / 8][4];
#pragma unroll
  for (int n = 0; n < NT_SSD_ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < Q / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
  output_scores<DS, NSC>(acc, sc, Cs, Hs, Bs, ca, w0, ta);
  __syncthreads();  // every warp is done with C, H_c and B
  stage(Us, ld4(DH), ub, dh, 8 * NSC, 8 * NSC, dh, DH);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // U is in
  output_intra<NSC>(acc, sc, Us);
  // the dh columns of the padded product
#pragma unroll
  for (int n = 0; n < NT_SSD_ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (col < dh) {
      *reinterpret_cast<float2*>(yb + ta * dh + col) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(yb + (ta + 8) * dh + col) = make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// Phase 3: y for one (b, h, chunk) and 64-row tile.  Blocks come in pairs
// per chunk, the tile of rows 64..127 (twice the score columns) first.  Warp
// i of a tile starting at row r0 needs the score columns s < r0 + 16·i + 16;
// every warp computes the tile's columns, s < r0 + 64, by the same code for
// the block's four warps.  Columns past a warp's own rows are masked to 0
// and add nothing; they cost a quarter more score products, where code
// compiled for each warp's own count, eight copies, was slower still (the
// warps of one SM then run different code, and the instruction cache
// thrashes).  U is staged over C, H_c and B once the scores are done:
// 69.5 KB of shared memory at DS = 64, three blocks (12 warps) an SM, where
// staging U beside them during the scores (103.5 KB) left two.
template <int DS>
__global__ void __launch_bounds__(NT_SSD_THREADS, 3)
ssd_output_kernel(const float* __restrict__ u, const float* __restrict__ ld,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ st, float* __restrict__ y, int64_t H, int64_t nc,
                  int64_t S, int dh, int ds, int64_t b_bstride, int64_t b_hstride,
                  int64_t c_bstride, int64_t c_hstride) {
  constexpr int RT = NT_SSD_RT, ldc = ld4(DS), ldb = ld4(DS), ldh = ld8(DH);
  const int64_t tile = blockIdx.x >> 1;
  const int r0 = (1 - (int)(blockIdx.x & 1)) * RT;  // the tile's first row
  const int ncol = r0 + RT;                          // B and U rows s < ncol
  const int64_t bh = tile / nc, c = tile % nc, bi = bh / H, hi = bh % H, t0 = c * Q;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;

  extern __shared__ float smem[];
  float* ca = smem;          // [Q]
  float* Cs = ca + Q;        // [RT][ldc]  the tile's rows of C, zero from ds to DS
  float* Hs = Cs + RT * ldc; // [DS][ldh]  the chunk's incoming state, zero-padded
  float* Bs = Hs + DS * ldh; // [Q][ldb]   B's rows s < ncol, zero from ds to DS
  float* Us = Cs;            // [Q][ldu]   U's rows s < ncol, once C, H_c and B are done

  stage(Cs, ldc, cm + bi * c_bstride + hi * c_hstride + (t0 + r0) * ds, ds, RT, RT, ds, DS);
  stage(Hs, ldh, st + (bh * nc + c) * (int64_t)ds * dh, dh, ds, DS, dh, DH);
  stage(Bs, ldb, bm + bi * b_bstride + hi * b_hstride + t0 * ds, ds, ncol, ncol, ds, DS);
  cp_async_commit();
  if (warp == 0) chunk_cumsum(ld + bh * S + t0, ca);
  cp_async_wait<0>();
  __syncthreads();  // C, H_c, B and ca are in

  const int w0 = warp * 16;                // the warp's first row in the tile
  const int ta = r0 + w0 + g;              // the thread's first row in the chunk
  const float* ub = u + (bh * S + t0) * dh;
  float* yb = y + (bh * S + t0) * dh;
  if (r0 == 0)
    output_rows<DS, RT / 8>(Cs, Hs, Bs, Us, ub, ca, yb, dh, w0, ta);
  else
    output_rows<DS, Q / 8>(Cs, Hs, Bs, Us, ub, ca, yb, dh, w0, ta);
}

size_t state_smem_bytes(int DS) {
  return (size_t)(2 * Q + 2 * NT_SSD_QS * (ld8(DS) + ld8(DH))) * sizeof(float);
}

size_t output_smem_bytes(int DS) {
  const int cbh = NT_SSD_RT * ld4(DS) + DS * ld8(DH) + Q * ld4(DS);  // C, H_c and B
  const int u = Q * ld4(DH);                                          // U over them
  return (size_t)(Q + (cbh > u ? cbh : u)) * sizeof(float);
}

}  // namespace

// u [B, H, S, dh], ld [B, H, S], y [B, H, S, dh] contiguous f32; B and C
// [B, H, S, ds] f32 with contiguous (S, ds) rows and the given batch and head
// strides (0 for a head-broadcast view); st [B, H, S/128, ds, dh] and dec
// [B, H, S/128] f32 scratch; hfin [B, H, ds, dh] f32 or null (the final
// state is then not written).  S % 128 == 0, dh and ds multiples of 8 with
// dh <= 64, ds <= 128 (checked by the wrapper).  Launches the three phases
// on `stream` and returns the first CUDA error, or 0.
extern "C" int nt_ssd_scan(const float* u, const float* ld, const float* bm,
                           const float* cm, float* y, float* hfin, float* st, float* dec,
                           int64_t B, int64_t H, int64_t S, int64_t dh, int64_t ds,
                           int64_t b_bstride, int64_t b_hstride, int64_t c_bstride,
                           int64_t c_hstride, void* stream) {
  if (B * H == 0 || S == 0) return 0;
  cudaStream_t strm = (cudaStream_t)stream;
  const int64_t nc = S / Q;
  // ds zero-padded to DS = 64 or 128 (dh always to 64)
  const bool wide = ds > 64;
  const size_t smem1 = state_smem_bytes(wide ? 128 : 64);
  const size_t smem3 = output_smem_bytes(wide ? 128 : 64);
  auto state = wide ? ssd_state_kernel<2> : ssd_state_kernel<1>;
  auto output = wide ? ssd_output_kernel<128> : ssd_output_kernel<64>;
  cudaError_t err =
      cudaFuncSetAttribute(state, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(output, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return (int)err;

  state<<<(unsigned)(B * H * nc), NT_SSD_THREADS, smem1, strm>>>(
      u, ld, bm, st, dec, H, nc, S, (int)dh, (int)ds, b_bstride, b_hstride);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int64_t n4 = ds * dh / 4;
  const int64_t parts = (n4 + NT_SSD_PASS_THREADS - 1) / NT_SSD_PASS_THREADS;
  ssd_pass_kernel<<<(unsigned)(B * H * parts), NT_SSD_PASS_THREADS, 0, strm>>>(
      st, dec, hfin, nc, n4, parts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  output<<<(unsigned)(B * H * nc * 2), NT_SSD_THREADS, smem3, strm>>>(
      u, ld, bm, cm, st, y, H, nc, S, (int)dh, (int)ds, b_bstride, b_hstride, c_bstride,
      c_hstride);
  return (int)cudaGetLastError();
}
