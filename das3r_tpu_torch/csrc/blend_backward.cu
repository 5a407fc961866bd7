// blend_backward: the gradient of every attribute-table row from the
// cotangents of the entry-stream blend's outputs (cpre, tfinal).
//
// Replaces the TPU kernel das3r_tpu/ops/splat/entry_blend.py::_backward_kernel
// and the XLA reduction of its per-entry gradients to table rows (_bwd,
// entry_blend.py:510-523). No [E, 9] per-entry tensor is materialised.
//
// The TPU kernel walks the stream backwards on one sequential grid and
// replays each 128-entry chunk from the transmittance its forward saved at
// the chunk's start (tin). The forward kernel here (blend_forward.cu) has
// no chunk grid: it runs one serial loop per pixel. So this kernel follows
// the CUDA rasterizer instead. The forward saves, per pixel, n_last: the
// list positions up to and including its last contributing entry. Each
// block owns one tile, 256 threads, one per pixel, and walks the tile's
// list back to front in batches of 256 entries, from the block's largest
// n_last. A thread sees entry j only if j < n_last[p]; every valid entry it
// sees contributed in the forward (the entry that crossed eps and all
// later ones lie at or past n_last), because power, alpha and 1 - alpha are
// computed by the same expressions as in blend_forward.cu, both built with
// --fmad=false. Per seen, valid entry, from T = T_final backwards:
//     T_before = T / (1 - alpha);  w = alpha * T_before
//     dalpha = (gC . c) T_before - S / (1 - alpha);  S += (gC . c) w
//     (dalpha = 0 where alpha_raw > alpha_clip)
//     d_power = alpha_raw * dalpha
// with S = gT * T_final at the start; then the 9 per-entry terms
// (mean2d, conic, color, opacity) as in the TPU kernel. The terms of an
// entry are summed over the block's pixels: a warp shuffle reduction,
// skipped when no lane of the warp saw the entry, then one shared-memory
// add per warp. After each batch, each entry's 9 sums go into
// g_table[rank] with atomicAdd. A table row is in at most
// max_tiles_per_gaussian tiles' lists, so the atomics rarely collide; their
// order, and the warps' order in shared memory, vary from run to run, so
// the result varies in its last bits.
//
// Bound on the H100: operations. Each seen entry costs a pixel ~50 FP32
// operations, one exp and two divisions, and a warp that saw it 45
// shuffles; the bytes are the table rows, ranks and per-pixel vectors, read
// once per block. The design visits only the list prefix the forward's
// pixels reached (n_last), which for a dense scene is a small part of the
// list. Known weakness, left for a later change: as in the forward, one
// block per tile balances poorly when a few tiles hold most entries, and
// the reduction costs about as much as the arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block, one per pixel
constexpr int kAttr = 9;  // mean_x mean_y conic_xx conic_xy conic_yy r g b op
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kPix)
blend_backward_kernel(const float* __restrict__ table,
                      const int32_t* __restrict__ rank,
                      const int32_t* __restrict__ astart,
                      const int32_t* __restrict__ count, int tiles_x,
                      float alpha_clip, float alpha_floor,
                      const float* __restrict__ tfinal,
                      const int32_t* __restrict__ n_last,
                      const float* __restrict__ g_cpre,
                      const float* __restrict__ g_tfinal,
                      float* __restrict__ g_table) {
  __shared__ float s_attr[kAttr][kPix];
  __shared__ float s_grad[kAttr][kPix];
  __shared__ int32_t s_rank[kPix];
  __shared__ int s_end;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const float px = (float)((t % tiles_x) * kTile + p % kTile);
  const float py = (float)((t / tiles_x) * kTile + p / kTile);
  const int64_t beg = astart[t];
  const int64_t pix = (int64_t)t * kPix + p;
  const int my_last = n_last[pix];

  if (p == 0) s_end = 0;
  __syncthreads();
  atomicMax(&s_end, my_last);
  __syncthreads();
  const int end = min(s_end, count[t]);
  if (end == 0) return;  // uniform: no pixel saw a contributing entry

  const float* gc = g_cpre + (int64_t)t * 3 * kPix;
  const float g0 = gc[p], g1 = gc[kPix + p], g2 = gc[2 * kPix + p];
  float T = tfinal[pix];
  float S = g_tfinal[pix] * T;

  for (int b = ((end - 1) / kPix) * kPix; b >= 0; b -= kPix) {
    // Also the barrier that keeps the previous batch's readers and its
    // flush ahead of the writes below.
    __syncthreads();
    const int nb = min(kPix, end - b);
    if (p < nb) {
      const int32_t r = rank[beg + b + p];
      s_rank[p] = r;
      const float* row = table + (int64_t)r * kAttr;
#pragma unroll
      for (int a = 0; a < kAttr; ++a) s_attr[a][p] = row[a];
    }
#pragma unroll
    for (int a = 0; a < kAttr; ++a) s_grad[a][p] = 0.0f;
    __syncthreads();

    for (int j = nb - 1; j >= 0; --j) {  // uniform over the block
      float v[kAttr];
#pragma unroll
      for (int a = 0; a < kAttr; ++a) v[a] = 0.0f;
      bool seen = false;
      if (b + j < my_last) {
        // The same expressions as blend_forward.cu, in the same order.
        const float dx = s_attr[0][j] - px;
        const float dy = s_attr[1][j] - py;
        const float power = -0.5f * (s_attr[2][j] * dx * dx +
                                     s_attr[4][j] * dy * dy) -
                            s_attr[3][j] * dx * dy;
        const float alpha_raw = s_attr[8][j] * expf(power);
        const float alpha = fminf(alpha_clip, alpha_raw);
        if (power <= 0.0f && alpha >= alpha_floor) {
          seen = true;
          const float one_m = 1.0f - alpha;
          const float t_before = T / one_m;
          const float w = alpha * t_before;
          const float gdot = g0 * s_attr[5][j] + g1 * s_attr[6][j] +
                             g2 * s_attr[7][j];
          float d_alpha = gdot * t_before - S / one_m;
          S += gdot * w;
          T = t_before;
          if (alpha_raw > alpha_clip) d_alpha = 0.0f;
          const float d_power = alpha_raw * d_alpha;
          const float cxx = s_attr[2][j], cxy = s_attr[3][j],
                      cyy = s_attr[4][j];
          v[0] = -(cxx * dx + cxy * dy) * d_power;
          v[1] = -(cyy * dy + cxy * dx) * d_power;
          v[2] = -0.5f * dx * dx * d_power;
          v[3] = -dx * dy * d_power;
          v[4] = -0.5f * dy * dy * d_power;
          v[5] = w * g0;
          v[6] = w * g1;
          v[7] = w * g2;
          v[8] = (alpha_raw / fmaxf(s_attr[8][j], 1e-30f)) * d_alpha;
        }
      }
      if (__any_sync(kFull, seen)) {
#pragma unroll
        for (int a = 0; a < kAttr; ++a) {
          float x = v[a];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            x += __shfl_down_sync(kFull, x, off);
          if (lane == 0) atomicAdd(&s_grad[a][j], x);
        }
      }
    }
    __syncthreads();
    if (p < nb) {
      float* dst = g_table + (int64_t)s_rank[p] * kAttr;
#pragma unroll
      for (int a = 0; a < kAttr; ++a) {
        const float x = s_grad[a][p];
        if (x != 0.0f) atomicAdd(dst + a, x);
      }
    }
  }
}

}  // namespace

extern "C" int blend_backward_launch(const void* table, const void* rank,
                                     const void* astart, const void* count,
                                     int n_tiles, int tiles_x,
                                     float alpha_clip, float alpha_floor,
                                     const void* tfinal, const void* n_last,
                                     const void* g_cpre, const void* g_tfinal,
                                     void* g_table, void* stream) {
  blend_backward_kernel<<<n_tiles, kPix, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int32_t*)rank, (const int32_t*)astart,
      (const int32_t*)count, tiles_x, alpha_clip, alpha_floor,
      (const float*)tfinal, (const int32_t*)n_last, (const float*)g_cpre,
      (const float*)g_tfinal, (float*)g_table);
  return (int)cudaGetLastError();
}
