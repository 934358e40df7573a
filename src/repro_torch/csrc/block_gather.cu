// Union gather of block slabs: out[u] = slab[ids[u]], for Hopper.
//
// Replaces the Pallas kernel block_gather (src/repro/kernels/plan_wave.py:325,
// grid (U,) whose scalar-prefetched ids drive the input index_map).
//
// Design.  One thread block per union id; the block reads its own id and
// copies the block's R·d elements as raw bytes, so one kernel serves i32,
// f32 and i8 slabs, 2-D and 3-D alike, and the copy is bit-identical by
// construction.  Where the per-block byte count and both base pointers allow
// it, threads move 16 bytes each (uint4), neighbouring threads on
// neighbouring addresses; otherwise 4 bytes, otherwise 1.  Repeated ids just
// copy the same block twice; U = 0 launches nothing (the wrapper returns
// early).  Ids are validated on the host before upload (BlockStore.fetch;
// the block cache gathers only slots of its own pool), so the kernel does no
// bounds check of its own.
//
// Bound on an H100 (3.35 TB/s): U·R·d·size bytes read plus the same written,
// plus 4·U bytes of ids — a pure copy, bound by bytes.  At the path's block
// (R = 8192 records × 5 i32 dims = 160 KiB) each thread block streams 10,240
// 16-byte vectors, 40 per thread, which keeps enough loads in flight.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void block_gather_kernel(const V* __restrict__ slab,
                                    const int32_t* __restrict__ ids,
                                    int64_t nvec, V* __restrict__ out) {
  const int64_t u = blockIdx.x;
  const V* src = slab + (int64_t)ids[u] * nvec;
  V* dst = out + u * nvec;
  for (int64_t v = threadIdx.x; v < nvec; v += blockDim.x) dst[v] = src[v];
}

template <typename V>
int launch(const void* slab, const int32_t* ids, int64_t u, int64_t nbytes,
           void* out, cudaStream_t stream) {
  const int64_t nvec = nbytes / (int64_t)sizeof(V);
  block_gather_kernel<V><<<(unsigned)u, 256, 0, stream>>>(
      (const V*)slab, ids, nvec, (V*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// nbytes: bytes of one block's slab (R·d·element size)
extern "C" int nt_block_gather(const void* slab, const int32_t* ids, int64_t u,
                               int64_t nbytes, void* out, void* stream) {
  if (u == 0 || nbytes == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t align = (uintptr_t)slab | (uintptr_t)out | (uintptr_t)nbytes;
  if (align % 16 == 0) return launch<uint4>(slab, ids, u, nbytes, out, s);
  if (align % 4 == 0) return launch<uint32_t>(slab, ids, u, nbytes, out, s);
  return launch<uint8_t>(slab, ids, u, nbytes, out, s);
}
