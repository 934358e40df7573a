// A round's record selection and packing over the union slabs, for Hopper.
//
// Replaces no Pallas kernel: the reference masks each query's blocks with
// the store's predicate_mask and finds and gathers the matching records
// with numpy on the host (src/repro/core/multi_query.py, _execute_wave).
// The port's device wave holds the round's union on the card.  Written as
// a PyTorch op chain (the plain version: advanced-index gathers of each
// predicate's column, bool folds over [pairs, R], nonzero, then gathers and
// copies to pack the records), the same fold reads each 32-byte dims row
// once per predicate through a gather and writes several [pairs, R]
// temporaries; these kernels do it in one read of the dims.
//
// Bound on an H100 (3.35 TB/s): bytes.  Each union block's dims rows
// (R·r·4 bytes) and valid bytes are read once, the [P, R/32] mask words are
// written once and read once, and each record's measures are read once and
// its 16 + 4·s packed bytes written once; a few integer compares per
// (pair, row) are far below the card's rate.
//
// Design.
//  * record_count_kernel: one thread block per (union block, tile of 1,024
//    rows), 256 threads of 4 rows each.  A thread loads its rows' dims into
//    registers as 16-byte vectors (r/4 of them a row where r is a multiple
//    of 4, up to 16; else 4-byte loads at each test) with its valid bytes,
//    then walks the pairs that read this union block (a CSR list), so a
//    block repeated by several queries is read once.  For each pair it
//    evaluates its query's γ (attr, value) tests, AND from true or OR from
//    false, padded slots (attr -1) the identity, or takes the pair's row of
//    a Predicate tree's mask, ANDs the valid byte, and turns each warp's 32
//    rows into one mask word with a ballot.  The tile's 32 words go out in
//    one coalesced store, its count into [P, tiles].
//  * record_scan_kernel: one block of 1,024 threads, a pair a thread, sums
//    each pair's tile counts and writes the exclusive prefix [P + 1] (the
//    last entry is the round's record count n, the one value the host
//    reads).
//  * record_pack_kernel: one thread block per pair, 256 mask words at a
//    time: a block scan of the words' popcounts places each word's rows in
//    shared memory, ascending; then the block writes the pair index and the
//    row (int64 each) and the measures' 4-byte words of its records,
//    neighbouring threads on neighbouring addresses, at the pair's offset.
//    Pairs keep their order and rows ascend within a pair, so the buffer is
//    the one nonzero's (pair, row) order gives, bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = kThreads * kRowsPerThread;  // 1,024 rows
constexpr int kTileWords = kTileRows / 32;            // 32 mask words
constexpr int kScanThreads = 1024;

struct Table {
  const int32_t* pos;       // [P] each pair's union block
  const int32_t* owner;     // [P] each pair's query
  const int32_t* tree;      // [P] each pair's row of the tree masks, or -1
  const int32_t* ub_off;    // [U + 1] CSR offsets of the pairs of each union block
  const int32_t* ub_pairs;  // [P] pairs grouped by union block, ascending
  const int32_t* attrs;     // [J, G] -1 marks a padded slot
  const int32_t* is_or;     // [J]
  const int64_t* vals;      // [J, G]
};

// attribute a of a row held as W int32 registers, by masks over
// compile-time indices: a select chain the compiler may fold into an
// indexed load, which would move the rows to local memory
template <int W>
__device__ __forceinline__ int32_t attr_of(const int32_t (&row)[W], int a) {
  int32_t x = 0;
#pragma unroll
  for (int c = 0; c < W; ++c) x |= row[c] & -(int32_t)(a == c);
  return x;
}

template <int NV>
__global__ void __launch_bounds__(kThreads)
record_count_kernel(const int32_t* __restrict__ dims, const uint8_t* __restrict__ valid,
                    const uint8_t* __restrict__ trees, Table t, int64_t R, int r, int G,
                    int tiles, int64_t words, uint32_t* __restrict__ bits,
                    int32_t* __restrict__ tile_counts) {
  constexpr int NVA = NV > 0 ? NV : 1;
  const int64_t u = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x % tiles);
  const int p0 = t.ub_off[u], p1 = t.ub_off[u + 1];
  if (p0 == p1) return;  // no pair reads this union block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t first = (int64_t)tile * kTileRows + warp * 32 + lane;
  const int64_t block0 = u * R;

  int32_t d[kRowsPerThread][4 * NVA];
  bool ok[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t row = first + i * kThreads;
    ok[i] = row < R && valid[block0 + row] != 0;
    if constexpr (NV > 0) {
      const uint4* src = reinterpret_cast<const uint4*>(dims + (block0 + (row < R ? row : 0)) * r);
#pragma unroll
      for (int k = 0; k < NVA; ++k) {
        const uint4 q = row < R ? src[k] : make_uint4(0, 0, 0, 0);
        d[i][4 * k] = (int32_t)q.x;
        d[i][4 * k + 1] = (int32_t)q.y;
        d[i][4 * k + 2] = (int32_t)q.z;
        d[i][4 * k + 3] = (int32_t)q.w;
      }
    }
  }

  __shared__ uint32_t words_s[kTileWords];
  __shared__ int counts_s[kWarps];
  for (int k = p0; k < p1; ++k) {
    const int p = t.ub_pairs[k];
    const int tr = t.tree[p];
    bool m[kRowsPerThread];
    if (tr >= 0) {  // a Predicate tree: its own mask, computed beside the kernel
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        m[i] = ok[i] && trees[(int64_t)tr * R + first + i * kThreads] != 0;
    } else {
      const int q = t.owner[p];
      const bool any = t.is_or[q] != 0;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) m[i] = !any;
      for (int g = 0; g < G; ++g) {
        const int a = t.attrs[q * G + g];
        if (a < 0) continue;  // a padded slot: the identity
        const int64_t v = t.vals[q * G + g];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          int32_t x;
          if constexpr (NV > 0) {
            x = attr_of<4 * NVA>(d[i], a);
          } else {
            const int64_t row = first + i * kThreads;
            x = row < R ? dims[(block0 + row) * r + a] : 0;
          }
          const bool eq = (int64_t)x == v;
          m[i] = any ? (m[i] || eq) : (m[i] && eq);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) m[i] = m[i] && ok[i];
    }
    int c = 0;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const uint32_t w = __ballot_sync(0xffffffffu, m[i]);
      if (lane == 0) words_s[i * kWarps + warp] = w;
      c += __popc(w);
    }
    if (lane == 0) counts_s[warp] = c;
    __syncthreads();
    const int64_t w = (int64_t)tile * kTileWords + threadIdx.x;
    if (threadIdx.x < kTileWords && w < words) bits[(int64_t)p * words + w] = words_s[threadIdx.x];
    if (threadIdx.x == 0) {
      int sum = 0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) sum += counts_s[i];
      tile_counts[(int64_t)p * tiles + tile] = sum;
    }
    __syncthreads();
  }
}

// inclusive scan of x over the block's threads; returns it and sets total
template <typename T, int NT>
__device__ __forceinline__ T block_scan(T x, T* warp_s, T* total) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_s[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < NT / 32 ? warp_s[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NT / 32) warp_s[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += warp_s[warp - 1];
  *total = warp_s[NT / 32 - 1];
  return x;
}

__global__ void __launch_bounds__(kScanThreads)
record_scan_kernel(const int32_t* __restrict__ tile_counts, int64_t P, int tiles,
                   int64_t* __restrict__ offsets) {
  __shared__ long long warp_s[kScanThreads / 32];
  long long carry = 0;
  // a pair a thread, 1,024 pairs at a time: each thread's tile counts are
  // contiguous, so a warp's loads are too
  for (int64_t p0 = 0; p0 < P; p0 += kScanThreads) {
    const int64_t p = p0 + threadIdx.x;
    long long c = 0;
    if (p < P) {
#pragma unroll 8
      for (int i = 0; i < tiles; ++i) c += tile_counts[p * tiles + i];
    }
    long long total;
    const long long incl = block_scan<long long, kScanThreads>(c, warp_s, &total);
    if (p < P) offsets[p] = carry + incl - c;
    carry += total;
    __syncthreads();  // every thread has read warp_s before the next chunk writes it
  }
  if (threadIdx.x == 0) offsets[P] = carry;
}

__global__ void __launch_bounds__(kThreads)
record_pack_kernel(const uint32_t* __restrict__ bits, const int64_t* __restrict__ offsets,
                   const int32_t* __restrict__ pos, const int32_t* __restrict__ meas,
                   int64_t R, int s, int64_t words, int64_t* __restrict__ out_pair,
                   int64_t* __restrict__ out_row, int32_t* __restrict__ out_meas) {
  const int64_t p = blockIdx.x;
  int64_t base = offsets[p];
  if (offsets[p + 1] == base) return;
  const int64_t src0 = (int64_t)pos[p] * R;
  __shared__ int32_t rows_s[kThreads * 32];
  __shared__ int warp_s[kWarps];
  for (int64_t w0 = 0; w0 < words; w0 += kThreads) {
    const int64_t w = w0 + threadIdx.x;
    uint32_t word = w < words ? bits[p * words + w] : 0u;
    const int c = __popc(word);
    int total;
    int o = block_scan<int, kThreads>(c, warp_s, &total) - c;
    while (word) {
      rows_s[o++] = (int32_t)(w * 32 + __ffs(word) - 1);
      word &= word - 1;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < total; e += kThreads) {
      out_pair[base + e] = p;
      out_row[base + e] = rows_s[e];
    }
    const int64_t n_words = (int64_t)total * s;
    for (int64_t e = threadIdx.x; e < n_words; e += kThreads) {
      const int64_t rec = e / s;
      const int64_t j = e - rec * s;
      out_meas[(base + rec) * s + j] = meas[(src0 + rows_s[rec]) * s + j];
    }
    base += total;
    __syncthreads();
  }
}

template <int NV>
void launch_count(const int32_t* dims, const uint8_t* valid, const uint8_t* trees, Table t,
                  int64_t U, int64_t R, int r, int G, int tiles, int64_t words, uint32_t* bits,
                  int32_t* tile_counts, cudaStream_t s) {
  record_count_kernel<NV><<<(unsigned)(U * tiles), kThreads, 0, s>>>(
      dims, valid, trees, t, R, r, G, tiles, words, bits, tile_counts);
}

}  // namespace

// The count pass and the scan, two kernels counted as one launch.
// bits [P, ceil(R/32)] uint32, tile_counts [P, ceil(R/1024)] int32 and
// offsets [P + 1] int64 are written; trees may be null when no pair takes
// a tree's mask.
extern "C" int nt_record_select(const void* dims, const void* valid, const void* trees,
                                const void* pos, const void* owner, const void* tree,
                                const void* ub_off, const void* ub_pairs, const void* attrs,
                                const void* is_or, const void* vals, int64_t P, int64_t U,
                                int64_t R, int64_t r, int64_t G, void* bits, void* tile_counts,
                                void* offsets, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Table t{(const int32_t*)pos,    (const int32_t*)owner,    (const int32_t*)tree,
                (const int32_t*)ub_off, (const int32_t*)ub_pairs, (const int32_t*)attrs,
                (const int32_t*)is_or,  (const int64_t*)vals};
  const int tiles = (int)((R + kTileRows - 1) / kTileRows);
  const int64_t words = (R + 31) / 32;
  if (P > 0 && U > 0 && R > 0) {
    const int32_t* d = (const int32_t*)dims;
    const uint8_t* v = (const uint8_t*)valid;
    const uint8_t* tr = (const uint8_t*)trees;
    uint32_t* b = (uint32_t*)bits;
    int32_t* tc = (int32_t*)tile_counts;
    const bool vec = r % 4 == 0 && r <= 16 && (uintptr_t)dims % 16 == 0;
    switch (vec ? r / 4 : 0) {
      case 1: launch_count<1>(d, v, tr, t, U, R, (int)r, (int)G, tiles, words, b, tc, s); break;
      case 2: launch_count<2>(d, v, tr, t, U, R, (int)r, (int)G, tiles, words, b, tc, s); break;
      case 3: launch_count<3>(d, v, tr, t, U, R, (int)r, (int)G, tiles, words, b, tc, s); break;
      case 4: launch_count<4>(d, v, tr, t, U, R, (int)r, (int)G, tiles, words, b, tc, s); break;
      default: launch_count<0>(d, v, tr, t, U, R, (int)r, (int)G, tiles, words, b, tc, s);
    }
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  record_scan_kernel<<<1, kScanThreads, 0, s>>>((const int32_t*)tile_counts, P, tiles,
                                                (int64_t*)offsets);
  return (int)cudaGetLastError();
}

// The write pass: out holds n·(4 + s) int32 words, the pair indices and the
// rows as int64 [n] each, then the measures' words [n, s].
extern "C" int nt_record_pack(const void* bits, const void* offsets, const void* pos,
                              const void* meas, int64_t P, int64_t R, int64_t s, int64_t n,
                              void* out, void* stream) {
  if (P == 0) return 0;
  int32_t* o = (int32_t*)out;
  record_pack_kernel<<<(unsigned)P, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bits, (const int64_t*)offsets, (const int32_t*)pos,
      (const int32_t*)meas, R, (int)s, (R + 31) / 32, (int64_t*)o, (int64_t*)(o + 2 * n),
      o + 4 * n);
  return (int)cudaGetLastError();
}
