// window_blend_backward: per-slot gradients [T, 9, K] of the [T, K] window
// blend, from the cotangent of its colours.
//
// Replaces the TPU kernel das3r_tpu/ops/splat/pallas_blend.py::
// _backward_kernel (launched from _bwd, pallas_blend.py:375-411). The
// gradient of bg (sum of g * T_final) and the per-Gaussian sum of the slot
// gradients (the backward of the attr_rank[bins.rank] gather) stay outside,
// as in the JAX package. A slot belongs to one tile, so each block writes
// its tile's slots directly: no atomics, and the result is deterministic.
// Slots outside the visited chunks are left as the caller zeroed them.
//
// One block per tile, 256 threads, one per pixel. The visited chunks are
// the contiguous run from delta / chunk whose tin rows (the forward's
// running transmittance at each chunk's entry) reach eps at some pixel: the
// block counts them with __syncthreads_or, relying on the forward's
// invariant (window_blend_forward.cu) that unvisited rows are 0, as the TPU
// kernel does. It then walks them in reverse. Per chunk:
//   1. stage the chunk's 9 x chunk attributes in shared memory;
//   2. replay the forward from tin, each thread storing its pixel's T before
//      every slot in shared memory (T_before[chunk][256]: 128 KB at chunk
//      128, opted in with cudaFuncAttributeMaxDynamicSharedMemorySize);
//   3. walk the slots back to front with the suffix
//      S = (g . bg) T_final + sum over later contributing slots of (g . c) w:
//        dalpha = (g . c) T_before - S / max(1 - alpha, 1e-12), S += (g . c) w
//        (dalpha = 0 where alpha_raw > alpha_clip); d_power = alpha_raw dalpha
//      and the nine terms: mean2d -(cxx dx + cxy dy) d_power and
//      -(cyy dy + cxy dx) d_power, conic -dx^2/2, -dx dy, -dy^2/2 times
//      d_power, colour w g, opacity alpha_raw / max(op, 1e-30) dalpha;
//   4. sum each slot's nine terms over the warp with shuffles (skipped when
//      no lane contributed), store one partial per warp in shared memory,
//      and after the chunk add the eight warps' partials in a fixed order
//      and write g_attrs[t, :, slot].
// The replay stores T_before instead of restoring it by division (kernel C's
// choice): the division compounds one rounding per contributing entry, and a
// window chunk is short enough that the stored values fit in shared memory,
// so the backward sees exactly the forward's transmittances and its
// contribute decisions. The replay uses the forward's expressions in its
// order, both built with --fmad=false.
//
// Bound on the H100: operations. Each pixel-slot evaluation of a visited
// chunk costs the replay (~15 FP32 operations and one exp) and the
// backward (~40 FP32 operations, one exp and one division), and each slot a
// warp reduction of nine values (45 shuffles per warp). Known weaknesses,
// left for a later change: one block per tile, and 169 KB of shared memory
// per block at chunk 128, which allows one block per SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block, one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kAttr = 9;
constexpr int kMaxChunk = 128;
constexpr unsigned kFull = 0xffffffffu;

size_t shared_bytes(int chunk) {
  return sizeof(float) * ((size_t)chunk * kPix + (size_t)kAttr * chunk +
                          (size_t)kWarps * kAttr * chunk);
}

__global__ void __launch_bounds__(kPix)
window_backward_kernel(const float* __restrict__ attrs,
                       const int32_t* __restrict__ count,
                       const int32_t* __restrict__ delta,
                       const float* __restrict__ bg,
                       const float* __restrict__ g_colors,
                       const float* __restrict__ tfinal,
                       const float* __restrict__ tin, int k_width, int chunk,
                       int tiles_x, float alpha_clip, float alpha_floor,
                       float eps, float* __restrict__ g_attrs) {
  extern __shared__ float smem[];
  float* s_tb = smem;                            // [chunk][kPix]
  float* s_attr = s_tb + chunk * kPix;           // [kAttr][chunk]
  float* s_part = s_attr + kAttr * chunk;        // [kWarps][kAttr][chunk]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5;
  const float px = (float)((t % tiles_x) * kTile + p % kTile);
  const float py = (float)((t / tiles_x) * kTile + p / kTile);
  const int cnt = count[t];
  const int del = delta[t];
  const int n_chunks = k_width / chunk;
  const int c0 = del / chunk;
  const float* tin_t = tin + (int64_t)t * n_chunks * kPix;

  int n_vis = 0;
  while (c0 + n_vis < n_chunks &&
         __syncthreads_or(tin_t[(int64_t)(c0 + n_vis) * kPix + p] >= eps))
    ++n_vis;
  if (n_vis == 0) return;  // uniform over the block

  const float* a_t = attrs + (int64_t)t * kAttr * k_width;
  float* g_t = g_attrs + (int64_t)t * kAttr * k_width;
  const float* gp = g_colors + ((int64_t)t * kPix + p) * 3;
  const float g0 = gp[0], g1 = gp[1], g2 = gp[2];
  float S = (g0 * bg[0] + g1 * bg[1] + g2 * bg[2]) * tfinal[(int64_t)t * kPix + p];

  for (int c = c0 + n_vis - 1; c >= c0; --c) {
    // Also the barrier that keeps the previous chunk's readers of s_attr and
    // s_part ahead of the writes below.
    __syncthreads();
    for (int i = p; i < kAttr * chunk; i += kPix) {
      const int a = i / chunk, j = i - a * chunk;
      s_attr[i] = a_t[(int64_t)a * k_width + c * chunk + j];
    }
    __syncthreads();
    const int lo = max(del - c * chunk, 0);
    const int hi = min(del + cnt - c * chunk, chunk);

    // replay the chunk forward from its entry transmittance
    float T = tin_t[(int64_t)c * kPix + p];
    for (int j = 0; j < chunk; ++j) {
      s_tb[j * kPix + p] = T;
      if (j < lo || j >= hi) continue;
      const float dx = s_attr[0 * chunk + j] - px;
      const float dy = s_attr[1 * chunk + j] - py;
      const float power = -0.5f * (s_attr[2 * chunk + j] * dx * dx +
                                   s_attr[4 * chunk + j] * dy * dy) -
                          s_attr[3 * chunk + j] * dx * dy;
      if (power > 0.0f) continue;
      const float alpha =
          fminf(alpha_clip, s_attr[8 * chunk + j] * expf(power));
      if (alpha < alpha_floor) continue;
      T = T * (1.0f - alpha);
    }

    for (int j = chunk - 1; j >= 0; --j) {  // uniform over the block
      float v[kAttr];
#pragma unroll
      for (int a = 0; a < kAttr; ++a) v[a] = 0.0f;
      bool contrib = false;
      if (j >= lo && j < hi) {
        const float dx = s_attr[0 * chunk + j] - px;
        const float dy = s_attr[1 * chunk + j] - py;
        const float cxx = s_attr[2 * chunk + j], cxy = s_attr[3 * chunk + j],
                    cyy = s_attr[4 * chunk + j];
        const float power = -0.5f * (cxx * dx * dx + cyy * dy * dy) -
                            cxy * dx * dy;
        const float op = s_attr[8 * chunk + j];
        const float alpha_raw = op * expf(power);
        const float alpha = fminf(alpha_clip, alpha_raw);
        if (power <= 0.0f && alpha >= alpha_floor) {
          const float t_before = s_tb[j * kPix + p];
          const float one_m = 1.0f - alpha;
          if (t_before * one_m >= eps) {
            contrib = true;
            const float w = alpha * t_before;
            const float gdot = g0 * s_attr[5 * chunk + j] +
                               g1 * s_attr[6 * chunk + j] +
                               g2 * s_attr[7 * chunk + j];
            float d_alpha = gdot * t_before - S / fmaxf(one_m, 1e-12f);
            S += gdot * w;
            if (alpha_raw > alpha_clip) d_alpha = 0.0f;
            const float d_power = alpha_raw * d_alpha;
            v[0] = -(cxx * dx + cxy * dy) * d_power;
            v[1] = -(cyy * dy + cxy * dx) * d_power;
            v[2] = -0.5f * dx * dx * d_power;
            v[3] = -dx * dy * d_power;
            v[4] = -0.5f * dy * dy * d_power;
            v[5] = w * g0;
            v[6] = w * g1;
            v[7] = w * g2;
            v[8] = (alpha_raw / fmaxf(op, 1e-30f)) * d_alpha;
          }
        }
      }
      float* part = s_part + (warp * kAttr) * chunk + j;
      if (__any_sync(kFull, contrib)) {
#pragma unroll
        for (int a = 0; a < kAttr; ++a) {
          float x = v[a];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            x += __shfl_down_sync(kFull, x, off);
          if (lane == 0) part[a * chunk] = x;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int a = 0; a < kAttr; ++a) part[a * chunk] = 0.0f;
      }
    }
    __syncthreads();
    for (int i = p; i < kAttr * chunk; i += kPix) {
      const int a = i / chunk, j = i - a * chunk;
      float x = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) x += s_part[w * kAttr * chunk + i];
      g_t[(int64_t)a * k_width + c * chunk + j] = x;
    }
  }
}

}  // namespace

extern "C" int window_blend_backward_launch(
    const void* attrs, const void* count, const void* delta, const void* bg,
    const void* g_colors, const void* tfinal, const void* tin, int n_tiles,
    int k_width, int chunk, int tiles_x, float alpha_clip, float alpha_floor,
    float eps, void* g_attrs, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || k_width % chunk != 0) return -1;
  if (n_tiles == 0) return 0;
  const size_t smem = shared_bytes(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      window_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_backward_kernel<<<n_tiles, kPix, smem, (cudaStream_t)stream>>>(
      (const float*)attrs, (const int32_t*)count, (const int32_t*)delta,
      (const float*)bg, (const float*)g_colors, (const float*)tfinal,
      (const float*)tin, k_width, chunk, tiles_x, alpha_clip, alpha_floor,
      eps, (float*)g_attrs);
  return (int)cudaGetLastError();
}
