// window_blend_backward: per-slot gradients [T, 9, K] of the [T, K] window
// blend, from the cotangent of its colours.
//
// Replaces the TPU kernel das3r_tpu/ops/splat/pallas_blend.py::
// _backward_kernel (launched from _bwd, pallas_blend.py:375-411). The
// gradient of bg (sum of g * T_final) and the per-Gaussian sum of the slot
// gradients (the backward of the attr_rank[bins.rank] gather) stay outside,
// as in the JAX package. A slot belongs to one tile, so each block writes
// its tile's slots directly: no atomics, and the result is deterministic.
// Slots outside the visited chunks, and sub-batches no pixel contributed
// to, are left as the caller zeroed them.
//
// One block per tile, 256 threads. The visited chunks are the contiguous
// run from delta / chunk whose tin rows (the forward's running
// transmittance at each chunk's entry) reach eps at some pixel: the block
// counts them with __syncthreads_or, relying on the forward's invariant
// (window_blend_forward.cu) that unvisited rows are 0, as the TPU kernel
// does. It then walks them in reverse. Per chunk:
//   1. stage the chunk's attributes in shared memory, [chunk][kAttrPad];
//   2. replay the forward from tin, each thread keeping its pixel's T at
//      every kNB-slot boundary (s_tb, [chunk / kNB][256] in shared memory:
//      a register array indexed by the sub-batch would go to local memory);
//   3. walk the sub-batches back to front; for each, thread = pixel:
//      replay it again from its boundary T, storing T_before and alpha_raw
//      (or -1 where the slot is not valid) in the d_power and w planes;
//      then sweep it back to front with the suffix
//      S = (g . bg) T_final + sum over later contributing slots of (g . c) w:
//        dalpha = (g . c) T_before - S / max(1 - alpha, 1e-12), S += (g . c) w
//        (dalpha = 0 where alpha_raw > alpha_clip); d_power = alpha_raw dalpha
//      overwriting the planes with d_power and w = alpha T_before (0 where
//      the slot did not contribute). Pass B and the combine
//      (blend_backward_common.cuh) reduce each slot over the pixels in a
//      fixed order and write g_attrs[t, :, slot].
// The replays store T_before instead of restoring it by division (kernel
// C's choice): the division compounds one rounding per contributing entry.
// They run the forward kernel's own step (blend_step.cuh, one definition
// for both, built with --fmad=false), so the backward sees exactly the
// forward's transmittances and contribute decisions. The sweep's division
// is the fast one (__fdividef): it feeds dalpha only.
//
// Bound on the H100: operations. Each pixel-slot evaluation of a visited
// chunk costs two replays (~15 FP32 operations and one exp each), the
// sweep (~20 FP32 operations and one division) and pass B (~7 FMA-class
// operations). The design before this one stored T_before for the whole
// 128-slot chunk (169 KB of shared memory per block: one block per SM)
// and reduced every slot's nine terms with 45 warp shuffles per warp. Here
// the second replay buys the smaller store (52 KB per block at chunk 128:
// four blocks per SM) and no shuffles. The replays carry no branch (an
// invalid slot leaves T as it was), so the compiler interleaves four slots'
// exps: with branches, the boundary replay and the second replay took
// 0.76 and 0.53 ms of 3.19 on the trainer scene of chip_smoke.py (H100
// 80GB HBM3, 700 W), the price of not storing the chunk's transmittances.
//
// A launch blends n_tiles window rows whose first is global tile tile0 (the
// tile-sharded window render, rasterize.py::_windows_sharded, blends one
// range per launch; the whole image is tile0 = 0). Block t takes its pixel
// coordinates from tile tile0 + t and reads and writes row t alone.
#include "blend_backward_common.cuh"
#include "blend_step.cuh"

namespace {

using namespace blend_bwd;
using blend_step::advance;
using blend_step::Eval;
using blend_step::evaluate;

constexpr int kMaxChunk = 128;
constexpr int kMaxSub = kMaxChunk / kNB;  // boundaries per chunk, at most

// d_power and w planes (the partials go over them), colour cotangents, the
// boundary Ts [kMaxSub][kPix] and the chunk's attributes [chunk][kAttrPad]
size_t shared_bytes(int chunk) {
  return sizeof(float) * ((size_t)kBatchFloats + (size_t)kMaxSub * kPix +
                          (size_t)chunk * kAttrPad);
}

// four blocks per SM, as the shared memory allows: at most 64 registers
__global__ void __launch_bounds__(kPix, 4)
window_backward_kernel(const float* __restrict__ attrs,
                       const int32_t* __restrict__ count,
                       const int32_t* __restrict__ delta,
                       const float* __restrict__ bg,
                       const float* __restrict__ g_colors,
                       const float* __restrict__ tfinal,
                       const float* __restrict__ tin, int k_width, int chunk,
                       int tile0, int tiles_x, float alpha_clip,
                       float alpha_floor,
                       float eps, float* __restrict__ g_attrs) {
  extern __shared__ float smem[];
  float* s_dp = smem;                          // [kNB][kRow]; the partials
  float* s_w = s_dp + kNB * kRow;              // [kNB][kRow]
  float* s_g = s_w + kNB * kRow;               // [3][kPix]
  float* s_tb = s_g + 3 * kPix;                // [kMaxSub][kPix]
  float* s_attr = s_tb + kMaxSub * kPix;       // [chunk][kAttrPad]
  const int t = blockIdx.x;   // local tile: the rows it reads and writes
  const int tg = tile0 + t;   // global tile: its pixel coordinates
  const int p = threadIdx.x;
  const int tx0 = (tg % tiles_x) * kTile, ty0 = (tg / tiles_x) * kTile;
  const float px = (float)(tx0 + p % kTile);
  const float py = (float)(ty0 + p / kTile);
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
  s_g[p] = g0;
  s_g[kPix + p] = g1;
  s_g[2 * kPix + p] = g2;
  float S = (g0 * bg[0] + g1 * bg[1] + g2 * bg[2]) * tfinal[(int64_t)t * kPix + p];
  const int nb = min(kNB, chunk);  // chunk and kNB are powers of 2
  const int n_sub = chunk / nb;

  for (int c = c0 + n_vis - 1; c >= c0; --c) {
    // Also the barrier that keeps the previous chunk's readers of s_attr
    // ahead of the writes below.
    __syncthreads();
    for (int i = p; i < kAttr * chunk; i += kPix) {
      const int a = i / chunk, j = i - a * chunk;
      s_attr[j * kAttrPad + attr_slot(a)] =
          a_t[(int64_t)a * k_width + c * chunk + j];
    }
    __syncthreads();
    const int lo = max(del - c * chunk, 0);
    const int hi = min(del + cnt - c * chunk, chunk);

    // The forward's step at slot j (blend_step.cuh): T_before -> T after;
    // returns alpha_raw, or -1 where the slot is not valid.
    auto step = [&](int j, float& T) -> float {
      const float* row = s_attr + j * kAttrPad;
      const Eval e = evaluate(*(const float4*)row, *(const float2*)(row + 4),
                              px, py, j >= lo && j < hi, alpha_clip,
                              alpha_floor);
      T = advance(T, e);
      return e.valid ? e.alpha_raw : -1.0f;
    };

    // the boundary Ts; the last sub-batch's slots end no boundary
    {
      float T = tin_t[(int64_t)c * kPix + p];
      for (int sb = 0; sb < n_sub; ++sb) {
        s_tb[sb * kPix + p] = T;
        if (sb + 1 == n_sub) break;
        const int j_end = min((sb + 1) * nb, hi);
#pragma unroll 4
        for (int j = max(sb * nb, lo); j < j_end; ++j) step(j, T);
      }
    }

    for (int sb = n_sub - 1; sb >= 0; --sb) {
      const int j0 = sb * nb;
      if (j0 >= hi || j0 + nb <= lo) continue;  // uniform: no live slot
      // Also the barrier that keeps the previous sub-batch's combine, which
      // reads the partials over the d_power plane, ahead of the writes
      // below.
      __syncthreads();
      float T = s_tb[sb * kPix + p];
#pragma unroll 4
      for (int j = 0; j < nb; ++j) {
        s_w[j * kRow + p] = T;
        s_dp[j * kRow + p] = step(j0 + j, T);
      }
      // pass A: the pixel's reverse sweep over the sub-batch
      bool any = false;
      for (int j = nb - 1; j >= 0; --j) {
        const float alpha_raw = s_dp[j * kRow + p];
        const float t_before = s_w[j * kRow + p];
        float d_power = 0.0f, w = 0.0f;
        if (alpha_raw >= 0.0f) {
          const float alpha = fminf(alpha_clip, alpha_raw);
          const float one_m = 1.0f - alpha;
          if (t_before * one_m >= eps) {
            any = true;
            const float4 a2 =
                *(const float4*)(s_attr + (j0 + j) * kAttrPad + 8);
            w = alpha * t_before;
            const float gdot = g0 * a2.x + g1 * a2.y + g2 * a2.z;
            float d_alpha =
                gdot * t_before - __fdividef(S, fmaxf(one_m, 1e-12f));
            S += gdot * w;
            if (alpha_raw > alpha_clip) d_alpha = 0.0f;
            d_power = alpha_raw * d_alpha;
          }
        }
        s_dp[j * kRow + p] = d_power;
        s_w[j * kRow + p] = w;
      }
      if (!__syncthreads_or(any)) continue;  // no pixel contributed

      const float* batch_attr = s_attr + j0 * kAttrPad;
      reduce_batch(s_dp, s_w, s_g, batch_attr, nb, (float)tx0, (float)ty0);
      __syncthreads();
      for (int i = p; i < kAttr * nb; i += kPix) {
        const int a = i / nb, j = i - a * nb;
        g_t[(int64_t)a * k_width + c * chunk + j0 + j] =
            entry_grad(s_dp, batch_attr + j * kAttrPad, a, j);
      }
    }
  }
}

}  // namespace

extern "C" int window_blend_backward_launch(
    const void* attrs, const void* count, const void* delta, const void* bg,
    const void* g_colors, const void* tfinal, const void* tin, int n_tiles,
    int k_width, int chunk, int tile0, int tiles_x, float alpha_clip,
    float alpha_floor, float eps, void* g_attrs, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || k_width % chunk != 0 ||
      (chunk & (chunk - 1)) != 0)
    return -1;
  if (n_tiles == 0) return 0;
  const size_t smem = shared_bytes(chunk);
  const int err = allow_shared(window_backward_kernel, smem);
  if (err != 0) return err;
  window_backward_kernel<<<n_tiles, kPix, smem, (cudaStream_t)stream>>>(
      (const float*)attrs, (const int32_t*)count, (const int32_t*)delta,
      (const float*)bg, (const float*)g_colors, (const float*)tfinal,
      (const float*)tin, k_width, chunk, tile0, tiles_x, alpha_clip,
      alpha_floor,
      eps, (float*)g_attrs);
  return (int)cudaGetLastError();
}

// Blocks resident per SM at this chunk width.
extern "C" int window_blend_backward_blocks_per_sm(int chunk) {
  if (chunk < 1 || chunk > kMaxChunk) return -1;
  return blocks_per_sm(window_backward_kernel, shared_bytes(chunk));
}
