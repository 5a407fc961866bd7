// blend_forward: front-to-back alpha blend of each tile's depth-ordered
// entry list, fused with the gather of the attribute table by stream rank.
//
// Replaces the TPU kernel das3r_tpu/ops/splat/entry_blend.py::_forward_kernel
// and the E-scale gather table[rank] of _fwd_impl_full (entry_blend.py:440).
// No [E, 9] tensor is materialised.
//
// The TPU kernel walks one sequential grid over the stream and carries the
// current tile's pixel state across grid steps. Hopper blocks run in no
// order, so here each block owns one tile: 256 threads, one per pixel of a
// 16x16 tile, walk the tile's slot range [astart[t], astart[t] + count[t]).
// Batches of 256 entries are loaded cooperatively (rank, then the table row
// into shared memory) and every thread runs the CUDA rasterizer's serial
// loop over the batch:
//     skip if power > 0 or alpha < 1/255;
//     test_T = T * (1 - alpha); if test_T < eps the pixel is done;
//     else C += alpha * T * c, T = test_T.
// The block leaves when every pixel is done (__syncthreads_count), the
// exact saturation skip that the TPU kernel's sticky running product gives.
// An empty tile writes (cpre = 0, tfinal = 1) itself.
//
// For the backward (csrc/blend_backward.cu) the kernel can also write
// n_last[t, p]: the count of list positions up to and including the
// pixel's last contributing entry. The backward walks each pixel's list
// from there and restores T by division, so nothing per entry is saved.
// The serving path passes a null pointer and writes nothing more.
//
// Bound on the H100: operations, not bytes. Each pixel-entry evaluation is
// ~15 FP32 operations and one exp; the exp goes to the special-function
// units (16 per SM per clock, ~4.2e12/s on an H100 SXM at 1.98 GHz), about
// as tight as the FP32 pipes (~67 TFLOP/s). The design keeps the entry
// attributes in shared memory (each entry read once per block from device
// memory) and stops at saturation, so the work is only the evaluations
// the serial loop needs. Known weakness, left for a later change: one block
// per tile gives poor load balance when a few tiles hold most entries.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block, one per pixel
constexpr int kAttr = 9;  // mean_x mean_y conic_xx conic_xy conic_yy r g b op

__global__ void __launch_bounds__(kPix)
blend_forward_kernel(const float* __restrict__ table,
                     const int32_t* __restrict__ rank,
                     const int32_t* __restrict__ astart,
                     const int32_t* __restrict__ count, int tiles_x,
                     float alpha_clip, float alpha_floor, float eps,
                     float* __restrict__ cpre, float* __restrict__ tfinal,
                     int32_t* __restrict__ n_last) {
  __shared__ float s_attr[kAttr][kPix];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = (float)((t % tiles_x) * kTile + p % kTile);
  const float py = (float)((t / tiles_x) * kTile + p / kTile);
  const int64_t beg = astart[t];
  const int cnt = count[t];

  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  int last = 0;
  bool done = false;
  for (int b = 0; b < cnt; b += kPix) {
    // Also the barrier that keeps the previous batch's readers ahead of
    // the writes below.
    if (__syncthreads_count(done) == kPix) break;
    if (b + p < cnt) {
      const float* row = table + (int64_t)rank[beg + b + p] * kAttr;
#pragma unroll
      for (int a = 0; a < kAttr; ++a) s_attr[a][p] = row[a];
    }
    __syncthreads();
    const int nb = min(kPix, cnt - b);
    for (int j = 0; j < nb && !done; ++j) {
      const float dx = s_attr[0][j] - px;
      const float dy = s_attr[1][j] - py;
      const float power = -0.5f * (s_attr[2][j] * dx * dx +
                                   s_attr[4][j] * dy * dy) -
                          s_attr[3][j] * dx * dy;
      if (power > 0.0f) continue;
      const float alpha = fminf(alpha_clip, s_attr[8][j] * expf(power));
      if (alpha < alpha_floor) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < eps) {
        done = true;
        break;
      }
      const float w = alpha * T;
      c0 += w * s_attr[5][j];
      c1 += w * s_attr[6][j];
      c2 += w * s_attr[7][j];
      T = test_T;
      last = b + j + 1;
    }
  }
  float* out = cpre + (int64_t)t * 3 * kPix;
  out[p] = c0;
  out[kPix + p] = c1;
  out[2 * kPix + p] = c2;
  tfinal[(int64_t)t * kPix + p] = T;
  if (n_last != nullptr) n_last[(int64_t)t * kPix + p] = last;
}

}  // namespace

extern "C" int blend_forward_launch(const void* table, const void* rank,
                                    const void* astart, const void* count,
                                    int n_tiles, int tiles_x, float alpha_clip,
                                    float alpha_floor, float eps, void* cpre,
                                    void* tfinal, void* n_last,
                                    void* stream) {
  blend_forward_kernel<<<n_tiles, kPix, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int32_t*)rank, (const int32_t*)astart,
      (const int32_t*)count, tiles_x, alpha_clip, alpha_floor, eps,
      (float*)cpre, (float*)tfinal, (int32_t*)n_last);
  return (int)cudaGetLastError();
}
