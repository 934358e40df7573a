// Tiled online-softmax attention (flash attention) on Hopper's tensor cores,
// f32 at f32-class accuracy through 3xTF32.
//
// Replaces the Pallas kernel flash_attention
// (src/repro/kernels/flash_attention.py:85, pallas_call at :108: grid
// (B, Hq, q-tiles, kv-tiles) with the kv axis sequential and the softmax
// state m, l and the output accumulator in VMEM scratch across it).
//
// Semantics, the TPU kernel's own (flash_attention.py:30-82):
//   - queries are right-aligned to the end of the kv sequence:
//     q_pos = i + (T − S), k_pos = j;
//   - a logit is kept where k_pos < T, and (causal) q_pos >= k_pos, and
//     (window) q_pos − k_pos < window; the others are set to −1e30;
//   - a kv tile no query of the q tile can see is skipped whole, by the
//     tile_visible test (flash_attention.py:49-55) at this kernel's tiles;
//   - m starts at −1e30 (not −inf), so in a visible tile a row whose logits
//     are all masked takes p = exp(0) = 1 for them; a later tile with a
//     visible logit sets corr = exp(−1e30 − m) = 0 and cancels them, as on
//     the TPU.  This kernel does the same and zeroes the kv padding it
//     stages, so what is cancelled is finite;
//   - l is clamped at 1e-30 before the final division;
//   - GQA: q head h reads kv head h / (Hq / Hkv).
// Prompts that were left-padded are attended as they are: there is no
// padding mask beyond k_pos < T, as in the reference's serving path.
// f32 or bf16 inputs; the output takes q's type; every D >= 1 and S >= 1.
//
// What bounds it.  4·B·Hq·D flops per visible (query, key) pair (QKᵀ and
// PV), against q, k, v read once and o written once: at zamba2-7b's long
// wave (B 4, Hq 32, S = T = 1,895, D 112, causal) 1.0·10¹¹ flops against
// 0.46 GB, so bound by operations.  On the CUDA cores (f32 FMA, 67 TFLOP/s)
// that bound is 1.54 ms; on the tensor cores in 3xTF32 every product is
// three TF32 products (494.7 TFLOP/s dense), 0.62 ms.  The f32 FMA design
// this replaces ran at 20% of the first and was shared-memory-load bound.
//
// Products (3xTF32).  Each f32 operand x is split as hi = tf32(x) and
// lo = tf32(x − hi) (round to nearest, ties away, as cvt.rna.tf32.f32),
// and a·b is summed as a_lo·b_hi + a_hi·b_lo, then a_hi·b_hi, into f32
// accumulators by mma.sync.m16n8k8 TF32 (the lo·lo term, ~2^-22 relative,
// is dropped).  So the error stays near f32's, far inside the reference's
// 2e-3; one TF32 product alone would change the LM's results.  bf16 values
// are exact in TF32, so bf16 Q, K and V need no lo part (QKᵀ is one product
// a step, PV two).  The split is four integer and float ops (see split()),
// done in registers as fragments are loaded: Q's once per block where
// D <= 128 (its hi and lo fragments then stay in registers), else per
// k-step; K's and V's per warp and tile; P's per kv step.  -fmad=false
// keeps x − hi a plain subtraction.
//
// Work split (FlashAttention-2).  One block of 4 warps per (b, q head,
// 64-row q tile, column group); each warp owns 16 query rows and holds its
// 16 × Dp output accumulator (Dp = D rounded up to 8: 120 floats a thread at
// D = 240), its rows' m and l, and the [16, 32] logit tile in registers.
// The row max and sum go across the 4 threads of a quad by __shfl_xor_sync;
// the softmax runs in base 2 (logits scaled by scale·log2 e, then exp2),
// skips the mask on tiles every row sees whole, and skips rescaling the
// accumulator when no row's max moved (a multiply by 1).
// The logits stay in registers as PV's A operand: a thread holds columns
// 2t and 2t+1 of each 8-key step, so A's k = t and t + 4 stand for them and
// the B fragment reads V rows 2t and 2t + 1 (a permutation of the kv index
// inside the step, which the sum does not see).  q tiles are scheduled last
// first, so the causal tiles with the most kv tiles start early.
//
// Copies.  K and V tiles of 32 keys come in by cp.async (16 bytes a copy)
// into a ring of two stages: the loads of tile j + 1 are issued before the
// products of tile j.  Q is staged once per block.  Shared-memory rows are
// W = min(Dp, 256) + 4 floats: W ≡ 4 (mod 8), so the Q, K (row g, column t)
// and V (row 2t, column g) fragment reads of a warp hit 32 distinct banks.
// Where cp.async cannot be used (bf16 inputs, D not a multiple of 4, or a
// pointer not 16-byte aligned) the same stages are filled by plain loads
// converted to f32 (D = 1, 7, 17, ...), with no overlap.
//
// Shared memory: (64 + 2·2·32)·W floats: 89.1 KB at D = 112 (W 116: two
// blocks, 8 warps, an SM), 101.4 KB at D = 128, 187.4 KB at D = 240 (W 244:
// one block an SM), 199.7 KB at D = 256 and past it.
//
// D > 256 (only the tests' 300 and 512; no configured model): the output is
// split into column groups of 256 on the grid's z axis, each recomputing
// QKᵀ over D in chunks of 256 columns, with Q, K and V staged per chunk and
// tile (no ring).  At D <= 256 there is one group and QKᵀ is computed once.
//
// wgmma in TF32 takes only K-major B operands (V would have to be
// transposed in shared memory); mma.sync is the first step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

#define NT_FA_BQ 64      // query rows of a block: 4 warps of 16
#define NT_FA_BKV 32     // keys of a kv tile
#define NT_FA_THREADS 128
#define NT_FA_DMAX 256   // head dim held whole; wider heads are split in groups
#define NT_FA_NEG (-1e30f)

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One 8-deep step of S += Q Kᵀ over the tile's 32 keys: kr points at key g,
// column d + t of the step
template <bool BF>
__device__ __forceinline__ void qk_step(float (&s)[NT_FA_BKV / 8][4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], const float* kr, int W) {
#pragma unroll
  for (int nb = 0; nb < NT_FA_BKV / 8; ++nb) {
    uint32_t bh0, bl0, bh1, bl1;
    split<BF>(kr[nb * 8 * W], bh0, bl0);
    split<BF>(kr[nb * 8 * W + 4], bh1, bl1);
    mma3<BF, BF>(s[nb], ah, al, bh0, bh1, bl0, bl1);
  }
}

// Rows [r0, r0 + R) (rows at or past `limit` are zero) and columns
// [c0, c0 + cn) of a row-major [*, D] matrix into dst[R][W] as f32, zero
// from column cn to cp (cn <= cp <= W − 4, cp a multiple of 8).  vec: by
// 16-byte cp.async (f32, D and c0 multiples of 4, src 16-byte aligned);
// else by plain loads.  One division per thread and call.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int W, const T* src, int64_t D, int64_t r0,
                                      int64_t limit, int R, int c0, int cn, int cp, bool vec) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      const int cu = cp / 4, rpp = max(1, NT_FA_THREADS / cu), tr = tid / cu;
      const int tc = tid - tr * cu;
      if (tr >= rpp) return;
      for (int r = tr; r < R; r += rpp) {
        const bool row_in = r0 + r < limit;
        for (int c = 4 * tc; c < cp; c += 4 * NT_FA_THREADS) {
          const bool in = row_in && c < cn;
          cp_async16(dst + r * W + c, in ? (const void*)(src + (r0 + r) * D + c0 + c) : src,
                     in);
        }
      }
      return;
    }
  }
  {
    const int rpp = max(1, NT_FA_THREADS / cp), tr = tid / cp, tc = tid - tr * cp;
    if (tr >= rpp) return;
    for (int r = tr; r < R; r += rpp) {
      const bool row_in = r0 + r < limit;
      for (int c = tc; c < cp; c += NT_FA_THREADS)
        dst[r * W + c] = row_in && c < cn ? to_f32(src[(r0 + r) * D + c0 + c]) : 0.0f;
    }
  }
}

// T: input type.  ND: the output's 8-column blocks a thread row holds (the
// widest group's); EXACT_ND: every group has exactly ND (no guards).
template <typename T, int ND, bool EXACT_ND>
__global__ void __launch_bounds__(NT_FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int64_t Hq, int64_t Hkv,
                       int64_t S, int64_t T_len, int D, int groups, int causal,
                       int64_t window, float scale2, int vec) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;  // exact in TF32
  constexpr int BQ = NT_FA_BQ, BKV = NT_FA_BKV, NB = BKV / 8;
  constexpr bool QREG = ND <= 16;  // Q's split fragments live in registers
  const int64_t qi = (int64_t)gridDim.x - 1 - blockIdx.x;  // last tiles first
  const int64_t h = blockIdx.y, b = blockIdx.z / groups;
  const int c0 = (int)(blockIdx.z % groups) * NT_FA_DMAX;  // the group's first column
  const int gw = min(D - c0, NT_FA_DMAX), gp = (gw + 7) & ~7, nd = gp / 8;
  const int dch = min(D, NT_FA_DMAX), nch = (D + dch - 1) / dch;  // QKᵀ chunks
  const int W = min((D + 7) & ~7, NT_FA_DMAX) + 4;
  const bool ring = nch == 1;  // K and V through the two-stage ring
  const int64_t hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t q0 = qi * BQ;
  const int64_t off = T_len - S;  // right alignment of the queries
  const T* qb = q + ((b * Hq + h) * S) * D;
  const T* kb = k + ((b * Hkv + hk) * T_len) * D;
  const T* vb = v + ((b * Hkv + hk) * T_len) * D;
  T* ob = o + ((b * Hq + h) * S) * D;

  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][W]
  float* Ks = Qs + BQ * W;      // [2][BKV][W]
  float* Vs = Ks + 2 * BKV * W; // [2][BKV][W]
  const float* Qw = Qs + warp * 16 * W;

  // tile_visible, at this kernel's tiles; the visible tiles are one run
  // [j0, j1] (the causal test bounds j above, the window below)
  auto visible = [&](int64_t j) {
    const int64_t k0 = j * BKV;
    if (causal && !(q0 + BQ - 1 + off >= k0)) return false;
    if (window >= 0 && !((q0 + off) - (k0 + BKV - 1) < window)) return false;
    return true;
  };
  int64_t j0 = 0, j1 = (T_len + BKV - 1) / BKV - 1;
  while (j0 <= j1 && !visible(j0)) ++j0;
  while (j1 >= j0 && !visible(j1)) --j1;

  float acc[ND][4], m[2] = {NT_FA_NEG, NT_FA_NEG}, l[2] = {0.0f, 0.0f};
  uint32_t qh[QREG ? ND : 1][4], ql[QREG ? ND : 1][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  const int dp = (D + 7) & ~7;
  if (ring && j0 <= j1) {
    stage(Qs, W, qb, D, q0, S, BQ, 0, D, dp, vec);
    stage(Ks, W, kb, D, j0 * BKV, T_len, BKV, 0, D, dp, vec);
    stage(Vs, W, vb, D, j0 * BKV, T_len, BKV, 0, D, dp, vec);
  }

  for (int64_t j = j0; j <= j1; ++j) {
    const int64_t k0 = j * BKV;
    const int buf = ring ? (int)((j - j0) & 1) : 0;
    if (ring) {
      cp_async_wait_all();
      __syncthreads();  // tile j is in; every warp is done with tile j − 1's stage
      if (j < j1) {
        const int nb = buf ^ 1;
        stage(Ks + nb * BKV * W, W, kb, D, k0 + BKV, T_len, BKV, 0, D, dp, vec);
        stage(Vs + nb * BKV * W, W, vb, D, k0 + BKV, T_len, BKV, 0, D, dp, vec);
      }
    }
    const float* Kt = Ks + buf * BKV * W;
    const float* Vt = Vs + buf * BKV * W;
    if constexpr (QREG) {  // D <= 128: split the warp's Q fragments once
      if (j == j0) {
#pragma unroll
        for (int kk = 0; kk < ND; ++kk) {
          if (EXACT_ND || kk < nd) {
            const int d = kk * 8 + t;
            split<BF>(Qw[g * W + d], qh[kk][0], ql[kk][0]);
            split<BF>(Qw[(g + 8) * W + d], qh[kk][1], ql[kk][1]);
            split<BF>(Qw[g * W + d + 4], qh[kk][2], ql[kk][2]);
            split<BF>(Qw[(g + 8) * W + d + 4], qh[kk][3], ql[kk][3]);
          }
        }
      }
    }

    // S = Q Kᵀ for the warp's 16 rows and the tile's 32 keys
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
    for (int ch = 0; ch < nch; ++ch) {
      const int d0 = ch * dch, dn = min(dch, D - d0), dnp = (dn + 7) & ~7;
      if (!ring) {
        __syncthreads();  // the previous chunk's or tile's reads are done
        stage(Qs, W, qb, D, q0, S, BQ, d0, dn, dnp, vec);
        stage(Ks, W, kb, D, k0, T_len, BKV, d0, dn, dnp, vec);
        if (ch == 0) stage(Vs, W, vb, D, k0, T_len, BKV, c0, gw, gp, vec);
        cp_async_wait_all();
        __syncthreads();
      }
      if constexpr (QREG) {
#pragma unroll
        for (int kk = 0; kk < ND; ++kk)
          if (EXACT_ND || kk < nd) qk_step<BF>(s, qh[kk], ql[kk], Kt + g * W + kk * 8 + t, W);
      } else {
#pragma unroll 2
        for (int kk = 0; kk < dnp / 8; ++kk) {
          const int d = kk * 8 + t;
          uint32_t ah[4], al[4];
          split<BF>(Qw[g * W + d], ah[0], al[0]);
          split<BF>(Qw[(g + 8) * W + d], ah[1], al[1]);
          split<BF>(Qw[g * W + d + 4], ah[2], al[2]);
          split<BF>(Qw[(g + 8) * W + d + 4], ah[3], al[3]);
          qk_step<BF>(s, ah, al, Kt + g * W + d, W);
        }
      }
    }

    // online softmax; thread rows g (i = 0: s[.][0..1]) and g + 8 (i = 1:
    // s[.][2..3]), columns nb·8 + 2t + e.  A tile every row of the block
    // sees whole (most of them) skips the mask.
    const bool whole = k0 + BKV <= T_len && (!causal || q0 + off >= k0 + BKV - 1) &&
                       (window < 0 || q0 + BQ - 1 + off - k0 < window);
    const int kin = (int)min((int64_t)BKV, T_len - k0);  // keys of the tile below T
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int dq = (int)(q0 + warp * 16 + g + 8 * i + off - k0);  // q_pos − k0
      float mx = NT_FA_NEG;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kr = nb * 8 + 2 * t + e;  // k_pos − k0
          bool keep = true;
          if (!whole) {
            keep = kr < kin;
            if (causal) keep = keep && dq >= kr;
            if (window >= 0) keep = keep && dq - kr < window;
          }
          float& x = s[nb][2 * i + e];
          x = keep ? x * scale2 : NT_FA_NEG;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nb][2 * i + e];
          x = exp2f(x - m_new);
          sum += x;
        }
      l[i] = fmaf(l[i], corr, sum);  // this thread's columns; summed over the quad at the end
      m[i] = m_new;
      if (__any_sync(0xffffffffu, corr != 1.0f)) {  // a row's max moved
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][2 * i] *= corr;
          acc[n][2 * i + 1] *= corr;
        }
      }
    }

    // O += P V: P from registers (k = t, t + 4 are keys 2t, 2t + 1 of the step)
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      uint32_t ph[4], pl[4];
      split<false>(s[kk][0], ph[0], pl[0]);  // (g, 2t)
      split<false>(s[kk][2], ph[1], pl[1]);  // (g + 8, 2t)
      split<false>(s[kk][1], ph[2], pl[2]);  // (g, 2t + 1)
      split<false>(s[kk][3], ph[3], pl[3]);  // (g + 8, 2t + 1)
      const float* v0 = Vt + (kk * 8 + 2 * t) * W + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        if (EXACT_ND || n < nd) {
          uint32_t bh0, bl0, bh1, bl1;
          split<BF>(v0[n * 8], bh0, bl0);
          split<BF>(v0[W + n * 8], bh1, bl1);
          mma3<false, BF>(acc[n], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    }
  }
  if (ring) cp_async_wait_all();  // nothing left in flight at exit

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int64_t r = q0 + warp * 16 + g + 8 * i;
    if (r >= S) continue;
    const float li = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = c0 + n * 8 + 2 * t;
      if ((EXACT_ND || n < nd) && col < D) {
        store(&ob[r * D + col], acc[n][2 * i] / li);
        if (col + 1 < D) store(&ob[r * D + col + 1], acc[n][2 * i + 1] / li);
      }
    }
  }
}

template <typename T, int ND, bool EXACT_ND>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Hq,
           int64_t Hkv, int64_t S, int64_t T_len, int D, int causal, int64_t window,
           float scale2, int vec, cudaStream_t stream) {
  const int groups = (D + NT_FA_DMAX - 1) / NT_FA_DMAX;
  const int W = min((D + 7) & ~7, NT_FA_DMAX) + 4;
  const size_t smem = (size_t)(NT_FA_BQ + 4 * NT_FA_BKV) * W * sizeof(float);
  if (B * groups > 65535 || Hq > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, ND, EXACT_ND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + NT_FA_BQ - 1) / NT_FA_BQ), (unsigned)Hq,
                  (unsigned)(B * groups));
  flash_attention_kernel<T, ND, EXACT_ND><<<grid, NT_FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hkv, S, T_len, D, groups, causal,
      window, scale2, vec);
  return (int)cudaGetLastError();
}

// Instances: f32 exactly at the ported models' head dims (112: zamba2-7b,
// 120: h2o-danube-3-4b, 128: qwen / yi, 240: gemma3-12b), with no guards on
// the output blocks; every other D and bf16 by bound (guarded).
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Hq,
             int64_t Hkv, int64_t S, int64_t T_len, int D, int causal, int64_t window,
             float scale2, int vec, cudaStream_t st) {
#define NT_FA_GO(ND, EX) \
  return launch<T, ND, EX>(q, k, v, o, B, Hq, Hkv, S, T_len, D, causal, window, scale2, vec, st)
  const int nd = min((D + 7) & ~7, NT_FA_DMAX) / 8;  // the widest group's blocks
  if constexpr (std::is_same<T, float>::value) {
    if (D <= NT_FA_DMAX) switch (nd) {
      case 14: NT_FA_GO(14, true);
      case 15: NT_FA_GO(15, true);
      case 16: NT_FA_GO(16, true);
      case 30: NT_FA_GO(30, true);
      default: break;
    }
  }
  if (nd <= 4) NT_FA_GO(4, false);
  if (nd <= 16) NT_FA_GO(16, false);
  NT_FA_GO(32, false);
#undef NT_FA_GO
}

}  // namespace

// q [B, Hq, S, D], k and v [B, Hkv, T, D], o [B, Hq, S, D], all contiguous,
// f32 (bf16 = 0) or bf16 (bf16 = 1).  D >= 1, Hq % Hkv == 0; window < 0
// means no window (checked by the wrapper).
extern "C" int nt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int64_t B, int64_t Hq, int64_t Hkv,
                                  int64_t S, int64_t T_len, int64_t D, int causal,
                                  int64_t window, float scale, int bf16,
                                  void* stream) {
  if (B * Hq == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  // cp.async staging: f32 rows of a multiple of 4 floats from 16-byte-aligned bases
  const int vec = !bf16 && D % 4 == 0 &&
                  (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0;
  // the softmax runs in base 2: logits scaled by scale·log2(e), then exp2
  const float scale2 = (float)((double)scale * 1.4426950408889634);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, T_len, (int)D, causal,
                                   window, scale2, vec, st);
  return dispatch<float>(q, k, v, o, B, Hq, Hkv, S, T_len, (int)D, causal, window,
                         scale2, vec, st);
}
