// extract_windows: the [T, K] window gather of the window path, fused with
// the rank decode.
//
// Replaces the TPU kernel das3r_tpu/ops/splat/binning.py::
// _extract_windows_pallas and the decode after it (bin_gaussians,
// binning.py:472). Slot j of tile t's window holds
//     rank[t, j] = min(keys[min(start[t] + j, n_keys - 1)] & (2^nbits - 1), n - 1)
// for j < K. The caller pads the sorted keys with K + 128 sentinels, so the
// clamp never binds there; it keeps the read in bounds for any input.
//
// Bound on the H100: memory. Each slot reads one 8-byte key and writes one
// 4-byte rank; there is no arithmetic to speak of. The TPU version copies
// each window's K/128 + 1 rows of 128 keys and rotates and stitches lanes
// because Mosaic cannot DMA at an element offset; Hopper loads at any
// element offset. So the grid is (K / 256 blocks, T tiles), one thread per
// slot, consecutive slots of a window on consecutive threads: the key reads
// and rank writes coalesce, a window's start only shifts the first sector.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void extract_windows_kernel(const int64_t* __restrict__ keys,
                                       int64_t n_keys,
                                       const int64_t* __restrict__ start,
                                       int k_cap, int64_t mask, int32_t n,
                                       int32_t* __restrict__ rank) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= k_cap) return;
  const int64_t t = blockIdx.y;
  int64_t idx = start[t] + j;
  idx = idx < 0 ? 0 : (idx > n_keys - 1 ? n_keys - 1 : idx);
  const int64_t v = keys[idx] & mask;
  rank[t * k_cap + j] = (int32_t)(v < (int64_t)(n - 1) ? v : (int64_t)(n - 1));
}

}  // namespace

extern "C" int extract_windows_launch(const void* keys, long long n_keys,
                                      const void* start, int n_tiles,
                                      int k_cap, int nbits, int n, void* rank,
                                      void* stream) {
  if (n_tiles == 0) return 0;
  const dim3 grid((unsigned)((k_cap + kThreads - 1) / kThreads),
                  (unsigned)n_tiles);
  extract_windows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, (int64_t)n_keys, (const int64_t*)start, k_cap,
      (int64_t)((1ULL << nbits) - 1), (int32_t)n, (int32_t*)rank);
  return (int)cudaGetLastError();
}
