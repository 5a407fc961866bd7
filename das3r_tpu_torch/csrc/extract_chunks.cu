// extract_chunks: the entry stream's chunk gather fused with the rank decode.
//
// Replaces the TPU kernel das3r_tpu/ops/splat/binning.py::_extract_chunks_pallas
// and the decode after it (binning.py:686-695). Slot j of chunk c holds
//     rank = min(keys[src0[c] + j] & (2^nbits - 1), n - 1)   for j < nlive[c]
//     rank = n                                              otherwise.
//
// Bound on the H100: memory. Each slot reads one 8-byte key and writes one
// 4-byte rank (~12 B/slot, ~84 MB at ~7M slots, ~25 us at 3.35 TB/s); there is
// no arithmetic to speak of. The TPU version DMAs two 128-key rows per chunk
// and rotates lanes because Mosaic cannot DMA at an element offset; Hopper
// loads at any element offset, so this is one thread per slot with
// neighbouring threads on neighbouring addresses (coalesced reads and
// writes) and a masked load instead of the TPU's trailing sentinel pad.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;
constexpr int kThreads = 256;

__global__ void extract_chunks_kernel(const int64_t* __restrict__ keys,
                                      const int64_t* __restrict__ src0,
                                      const int32_t* __restrict__ nlive,
                                      int64_t n_slots, int64_t mask, int32_t n,
                                      int32_t* __restrict__ rank) {
  const int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (i >= n_slots) return;
  const int64_t c = i / kChunk;
  const int j = (int)(i % kChunk);
  int32_t r = n;
  if (j < nlive[c]) {
    const int64_t v = keys[src0[c] + j] & mask;
    r = (int32_t)(v < (int64_t)(n - 1) ? v : (int64_t)(n - 1));
  }
  rank[i] = r;
}

}  // namespace

extern "C" int extract_chunks_launch(const void* keys, const void* src0,
                                     const void* nlive, long long n_chunks,
                                     int nbits, int n, void* rank,
                                     void* stream) {
  const int64_t n_slots = (int64_t)n_chunks * kChunk;
  const int64_t blocks = (n_slots + kThreads - 1) / kThreads;
  extract_chunks_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int64_t*)keys, (const int64_t*)src0, (const int32_t*)nlive,
      n_slots, (int64_t)((1ULL << nbits) - 1), (int32_t)n, (int32_t*)rank);
  return (int)cudaGetLastError();
}
