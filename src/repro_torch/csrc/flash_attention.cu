// Tiled online-softmax attention (flash attention), for Hopper.
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
//
// Design.  Blocks run in parallel with nothing carried between them, so the
// TPU's sequential kv axis becomes a loop inside one thread block per
// (b, q-head, 64-row q tile, column group); the running max, sum and the
// block's [64, ≤128] output accumulator stay in registers (f32) across the
// loop.  256 threads as 16 × 16: thread (ty, tx) owns query rows
// 4·ty .. 4·ty+3; in QKᵀ it owns kv columns tx + 16·j (j < 4), in PV output
// columns tx + 16·c (c < NC ≤ 8) of its column group.  Q and each 64-row K
// tile are staged transposed ([d][65]: both the transposing store and the
// column reads are free of bank conflicts), V as it lies, P transposed.  The
// row max and sum go across the 16 threads of a row group by warp shuffles.
// f32 or bf16 inputs (converted to f32 as they are staged); the output
// takes q's type.  q tiles are scheduled last first, so the causal tiles
// with the most kv tiles start early.
//
// Every D >= 1, as the TPU kernel (whose tiles span the whole head dim):
//   - D <= 128 (zamba2-7b: 112, danube: 120, qwen/yi: 128): one column
//     group of ⌈D/16⌉·16 columns; Q is staged once, K whole per kv tile.
//   - D > 128 (gemma3-12b: 240): G = ⌈D/128⌉ column groups on the grid's
//     z axis, each owning 128 output columns (the last zero-padded past D)
//     and recomputing the whole QKᵀ and the row statistics, so no block
//     holds more than 8 accumulator columns per thread.  QKᵀ is summed
//     over D in chunks of 120 columns, Q's and K's chunks staged in turn
//     per kv tile (the [64, D] Q tile is read again per kv tile, from L2).
//   Either way each logit is summed over d = 0 .. D−1 in order, so a
//   D <= 128 result is the same to the bit as with one chunk.
//
// Shared memory: 2·Dc·65 + 64·16·NC + 64·65 floats with Dc = D (one chunk)
// or 120: 103.5 KB at D = 112 (two blocks per SM), 111.8 KB at any D > 128
// (two blocks per SM if the registers allow).
//
// Bound on an H100: 4·B·Hq·S·T·D flops without a mask (2 products), about
// half of that causal at S = T, against q, k, v read once and o written
// once.  At zamba2-7b's long wave (B 4, Hq 32, S = T = 2048, D 112) that is
// ~1.2·10¹¹ flops against ~0.5 GB: bound by operations; so is gemma3-12b's
// (B 4, Hq 16, Hkv 8, S = T = 1,895, D 240: 8.7·10¹⁰ flops over the pairs
// its window of 1024 keeps, against ~1.4 GB).  The column groups add QKᵀ
// work (at D = 240 each of 2 groups computes all of it).  Every product here
// is f32 FMA on the CUDA cores (67 TFLOP/s); tensor-core tiles (wgmma in
// TF32 or bf16, TMA-fed) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NT_FA_BQ 64
#define NT_FA_BKV 64
#define NT_FA_LD 65
#define NT_FA_THREADS 256
#define NT_FA_NEG (-1e30f)
#define NT_FA_COLS 128  // output columns of one column group
#define NT_FA_DCH 120   // QKᵀ chunk of the head dim when D > NT_FA_COLS

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int NC>
__global__ void __launch_bounds__(NT_FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int64_t Hq,
                       int64_t Hkv, int64_t S, int64_t T_len, int D, int groups,
                       int causal, int64_t window, float scale) {
  constexpr int BQ = NT_FA_BQ, BKV = NT_FA_BKV, LD = NT_FA_LD, DV = NC * 16;
  const int64_t qi = (int64_t)gridDim.x - 1 - blockIdx.x;  // last tiles first
  const int64_t h = blockIdx.y, b = blockIdx.z / groups;
  const int c0 = (int)(blockIdx.z % groups) * DV;  // the group's first output column
  // QKᵀ over D in nch chunks of dc columns (one chunk, staged once, if D <= 128)
  const int dc = D <= NT_FA_COLS ? D : NT_FA_DCH;
  const int nch = (D + dc - 1) / dc;
  const int64_t hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t q0 = qi * BQ;
  const int64_t off = T_len - S;  // right alignment of the queries
  const T* qb = q + ((b * Hq + h) * S) * D;
  const T* kb = k + ((b * Hkv + hk) * T_len) * D;
  const T* vb = v + ((b * Hkv + hk) * T_len) * D;
  T* ob = o + ((b * Hq + h) * S) * D;

  extern __shared__ float smem[];
  float* Qt = smem;            // [dc][LD]   Qt[d][r], columns d0 + d
  float* Kt = Qt + dc * LD;    // [dc][LD]   Kt[d][c]
  float* Vs = Kt + dc * LD;    // [BKV][DV]  columns c0 .., zero past D
  float* Pt = Vs + BKV * DV;   // [BKV][LD]  Pt[c][r]

  // Q's columns d0 .. d0 + dn − 1, transposed
  auto stage_q = [&](int d0, int dn) {
    for (int i = tid; i < BQ * dn; i += blockDim.x) {
      const int r = i / dn, d = i % dn;
      Qt[d * LD + r] = q0 + r < S ? to_f32(qb[(q0 + r) * D + d0 + d]) : 0.0f;
    }
  };
  if (nch == 1) stage_q(0, D);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NT_FA_NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const int64_t ntiles = (T_len + BKV - 1) / BKV;
  for (int64_t j = 0; j < ntiles; ++j) {
    const int64_t k0 = j * BKV;
    // tile_visible, at this kernel's tiles (uniform over the block)
    if (causal && !(q0 + BQ - 1 + off >= k0)) continue;
    if (window >= 0 && !((q0 + off) - (k0 + BKV - 1) < window)) continue;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.0f;
    for (int ch = 0; ch < nch; ++ch) {
      const int d0 = ch * dc, dn = min(dc, D - d0);
      __syncthreads();  // the previous chunk's or tile's reads of Qt, Kt, Vs, Pt are done
      if (nch > 1) stage_q(d0, dn);
      for (int i = tid; i < BKV * dn; i += blockDim.x) {
        const int c = i / dn, d = i % dn;
        const bool in = k0 + c < T_len;
        Kt[d * LD + c] = in ? to_f32(kb[(k0 + c) * D + d0 + d]) : 0.0f;
      }
      if (ch == 0) {
        for (int i = tid; i < BKV * DV; i += blockDim.x) {
          const int c = i / DV, d = i % DV;
          Vs[i] = (k0 + c < T_len && c0 + d < D) ? to_f32(vb[(k0 + c) * D + c0 + d]) : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < dn; ++d) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qt[d * LD + ty * 4 + i];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bk[jj] = Kt[d * LD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(a[i], bk[jj], s[i][jj]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q0 + ty * 4 + i + off;
      float mx = NT_FA_NEG;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int64_t kpos = k0 + tx + 16 * jj;
        bool keep = kpos < T_len;
        if (causal) keep = keep && qpos >= kpos;
        if (window >= 0) keep = keep && (qpos - kpos) < window;
        s[i][jj] = keep ? s[i][jj] * scale : NT_FA_NEG;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = expf(s[i][jj] - m_new);
        sum += s[i][jj];
      }
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) Pt[(tx + 16 * jj) * LD + ty * 4 + i] = s[i][jj];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Pt[c * LD + ty * 4 + i];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float vv = Vs[c * DV + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(p[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = c0 + tx + 16 * cc;
      if (d < D) store(&ob[r * D + d], acc[i][cc] / li);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t Hq, int64_t Hkv, int64_t S, int64_t T_len, int D, int causal,
           int64_t window, float scale, cudaStream_t stream) {
  const int dc = D <= NT_FA_COLS ? D : NT_FA_DCH;
  const int groups = (D + NT_FA_COLS - 1) / NT_FA_COLS;
  const size_t smem =
      (size_t)(2 * dc * NT_FA_LD + NT_FA_BKV * NC * 16 + NT_FA_BKV * NT_FA_LD) * sizeof(float);
  if (B * groups > 65535 || Hq > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + NT_FA_BQ - 1) / NT_FA_BQ), (unsigned)Hq,
                  (unsigned)(B * groups));
  flash_attention_kernel<T, NC><<<grid, NT_FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hkv, S, T_len, D, groups, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int64_t B,
             int64_t Hq, int64_t Hkv, int64_t S, int64_t T_len, int D, int causal,
             int64_t window, float scale, cudaStream_t st) {
  switch (D > NT_FA_COLS ? NT_FA_COLS / 16 : (D + 15) / 16) {
    case 1: return launch<T, 1>(q, k, v, o, B, Hq, Hkv, S, T_len, D, causal, window, scale, st);
    case 2: return launch<T, 2>(q, k, v, o, B, Hq, Hkv, S, T_len, D, causal, window, scale, st);
    case 3: return launch<T, 3>(q, k, v, o, B, Hq, Hkv, S, T_len, D, causal, window, scale, st);
    case 4: return launch<T, 4>(q, k, v, o, B, Hq, Hkv, S, T_len, D, causal, window, scale, st);
    case 5: return launch<T, 5>(q, k, v, o, B, Hq, Hkv, S, T_len, D, causal, window, scale, st);
    case 6: return launch<T, 6>(q, k, v, o, B, Hq, Hkv, S, T_len, D, causal, window, scale, st);
    case 7: return launch<T, 7>(q, k, v, o, B, Hq, Hkv, S, T_len, D, causal, window, scale, st);
    case 8: return launch<T, 8>(q, k, v, o, B, Hq, Hkv, S, T_len, D, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, T_len, (int)D, causal,
                                   window, scale, st);
  return dispatch<float>(q, k, v, o, B, Hq, Hkv, S, T_len, (int)D, causal, window,
                         scale, st);
}
