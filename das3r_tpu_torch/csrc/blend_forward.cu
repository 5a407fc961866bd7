// blend_forward: front-to-back alpha blend of each tile's depth-ordered
// entry list, fused with the gather of the attribute table by stream rank.
//
// Replaces the TPU kernel das3r_tpu/ops/splat/entry_blend.py::_forward_kernel
// and the E-scale gather table[rank] of _fwd_impl_full (entry_blend.py:440).
// No [E, 9] tensor is materialised.
//
// The TPU kernel walks one sequential grid over the stream and carries the
// current tile's pixel state across grid steps. Hopper blocks run in no
// order, so here each block owns one tile and walks its slot range
// [astart[t], astart[t] + count[t]) in batches of kNB entries. Per pixel,
// over the entries in list order, blend_step.cuh's step (the one that the
// window forward kernel D runs and the backward kernels C and E replay):
//     valid = power <= 0 and alpha >= alpha_floor;
//     t_after = valid ? T_run * (1 - alpha) : T_run;
//     if valid and t_after >= eps:
//         C += alpha * T_run * c, T_out = t_after, n_last = position + 1;
//     T_run = t_after   (sticky: committed even below eps).
// (C, T_out) is the CUDA rasterizer's (C, T), which skips invalid entries
// and stops a pixel once T (1 - alpha) < eps: blend_step.cuh gives the
// argument. The block leaves once no pixel's T_run is >= eps, which is the
// rasterizer's "every pixel is done" and the exact saturation skip that the
// TPU kernel's sticky running product gives. An empty tile writes (cpre =
// 0, tfinal = 1, n_last = 0) itself.
//
// For the backward (csrc/blend_backward.cu) the kernel can also write
// n_last[t, p]: the count of list positions up to and including the
// pixel's last contributing entry. The backward walks each pixel's list
// from there and restores T by division, so nothing per entry is saved.
// n_last is a template parameter: the serving path passes a null pointer
// and its instantiation has neither the select nor the store.
//
// Bound on the H100: operations, not bytes. Each pixel-entry evaluation is
// ~15 FP32 operations and one exp; a tile that never saturates evaluates
// every one of its entries at all 256 pixels. The design is kernel D's
// (window_blend_forward.cu) but for its staging: it cuts the instructions
// issued around each evaluation.
//   - 128 threads, two pixels each, one above the other (p and p + 128,
//     8 rows apart): each shared load and the x half of the power serve
//     two evaluations, and each thread carries two independent T chains;
//   - an entry's attributes are staged as blend_step.cuh's 48-byte padded
//     rows and read by three broadcast loads (float4, float2, float4);
//   - the step has no branch, and the entry loop is unrolled by 4, so that
//     consecutive entries' exps are in flight together; only the T
//     multiply is serial. The serving instantiation evaluates a group's
//     four entries before it blends them;
//   - a batch is 128 entries, one table row per thread, staged by rank
//     (rank, then the row's nine floats) before a barrier; the barrier
//     that starts the next batch is the exit test.
// On the trainer scene of chip_smoke.py (576 tiles that never saturate,
// 463.5M evaluations; H100 80GB HBM3, 700 W), timed in turns against a
// one-pixel, scalar-load, branching kernel of 1.02 ms: the layout, the
// branch-free step and two pixels per thread took off 9, 13 and 5
// points. Without n_last the compiler issued each entry's exps only after
// the previous entry's blend; evaluating the group first took 4.5% off
// serving (training's schedule already overlaps them). The random scene's
// tiles saturate after at most 294 entries, and 128-entry batches waste
// less of the last batch there than 256. Two designs were measured and
// left out: D's double buffer (cp.async, the ranks held one batch ahead)
// ran level on the trainer scene and 4% slower on the random one; a
// warp-uniform leave of the batch once a warp's pixels are all below eps
// (__any_sync after each group) took 20-23% off the random scene but
// cost 0.6-1.4% on the trainer scene in training and 3.3-3.6% in
// serving, and most launches run on the trainer scene.
// The table is [N + 1, 9] f32 in depth order. Pads in a tile's 128-aligned
// range hold rank N, the zero row; no rank past count[t] is read, and no
// entry past it blended.
//
// A launch blends n_tiles tiles from global tile tile0 on (the tile-sharded
// render blends one range per launch; the whole image is tile0 = 0). Block
// t takes its pixel coordinates from tile tile0 + t; count, astart, the
// outputs and n_last are indexed by t alone, local to the range. A tile
// past the image (the padded tail of the last range) has count 0, so it
// reads nothing and writes (0, 1).
#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_step.cuh"

namespace {

using blend_step::attr_slot;
using blend_step::blend_slot;
using blend_step::Eval;
using blend_step::evaluate;
using blend_step::kAttr;
using blend_step::kAttrPad;

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // pixels of a tile
constexpr int kThreads = kPix / 2;   // two pixels each: p and p + kThreads
constexpr int kNB = kThreads;        // entries per batch: one per thread

template <bool kLast>
__global__ void __launch_bounds__(kThreads)
blend_forward_kernel(const float* __restrict__ table,
                     const int32_t* __restrict__ rank,
                     const int32_t* __restrict__ astart,
                     const int32_t* __restrict__ count, int tile0,
                     int tiles_x, float alpha_clip, float alpha_floor,
                     float eps,
                     float* __restrict__ cpre, float* __restrict__ tfinal,
                     int32_t* __restrict__ n_last) {
  __shared__ __align__(16) float s_attr[kNB * kAttrPad];
  const int t = blockIdx.x;   // local tile: the rows it reads and writes
  const int tg = tile0 + t;   // global tile: its pixel coordinates
  const int q = threadIdx.x;  // pixels q and q + kThreads of the tile
  const float px = (float)((tg % tiles_x) * kTile + q % kTile);
  const float py0 = (float)((tg / tiles_x) * kTile + q / kTile);
  const float py1 = py0 + (float)(kThreads / kTile);
  const int32_t* rank_t = rank + astart[t];
  const int cnt = count[t];

  float cr0 = 0.0f, cg0 = 0.0f, cb0 = 0.0f, cr1 = 0.0f, cg1 = 0.0f,
        cb1 = 0.0f;
  float to0 = 1.0f, tr0 = 1.0f, to1 = 1.0f, tr1 = 1.0f;
  int last0 = 0, last1 = 0;
  for (int b = 0; b < cnt; b += kNB) {
    // Also the barrier that keeps the previous batch's readers ahead of
    // the writes below.
    if (!__syncthreads_or(tr0 >= eps || tr1 >= eps)) break;
    if (b + q < cnt) {
      const float* row = table + (int64_t)rank_t[b + q] * kAttr;
#pragma unroll
      for (int a = 0; a < kAttr; ++a)
        s_attr[q * kAttrPad + attr_slot(a)] = row[a];
    }
    __syncthreads();
    // entry j of the batch into both pixels
    auto step = [&](int j) {
      const float* row = s_attr + j * kAttrPad;
      const float4 a0 = *(const float4*)row;
      const float2 a1 = *(const float2*)(row + 4);
      const float4 col = *(const float4*)(row + 8);
      const bool c0 =
          blend_slot(evaluate(a0, a1, px, py0, true, alpha_clip, alpha_floor),
                     col, eps, tr0, to0, cr0, cg0, cb0);
      const bool c1 =
          blend_slot(evaluate(a0, a1, px, py1, true, alpha_clip, alpha_floor),
                     col, eps, tr1, to1, cr1, cg1, cb1);
      if (kLast) {
        last0 = c0 ? b + j + 1 : last0;
        last1 = c1 ? b + j + 1 : last1;
      }
    };
    // Entries j .. j + 3 in serving: every evaluation first, then the
    // blends in list order (the same operations on the same values).
    auto group = [&](int j) {
      Eval e0[4], e1[4];
      float4 col[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* row = s_attr + (j + k) * kAttrPad;
        const float4 a0 = *(const float4*)row;
        const float2 a1 = *(const float2*)(row + 4);
        col[k] = *(const float4*)(row + 8);
        e0[k] = evaluate(a0, a1, px, py0, true, alpha_clip, alpha_floor);
        e1[k] = evaluate(a0, a1, px, py1, true, alpha_clip, alpha_floor);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        blend_slot(e0[k], col[k], eps, tr0, to0, cr0, cg0, cb0);
        blend_slot(e1[k], col[k], eps, tr1, to1, cr1, cg1, cb1);
      }
    };
    const int nb = min(kNB, cnt - b);
    int j = 0;
    for (; j + 4 <= nb; j += 4) {
      if (kLast) {
#pragma unroll
        for (int k = 0; k < 4; ++k) step(j + k);
      } else {
        group(j);
      }
    }
    for (; j < nb; ++j) step(j);
  }
  const int64_t pix = (int64_t)t * kPix + q;
  float* out = cpre + (int64_t)t * 3 * kPix + q;
  out[0] = cr0;
  out[kPix] = cg0;
  out[2 * kPix] = cb0;
  out[kThreads] = cr1;
  out[kPix + kThreads] = cg1;
  out[2 * kPix + kThreads] = cb1;
  tfinal[pix] = to0;
  tfinal[pix + kThreads] = to1;
  if (kLast) {
    n_last[pix] = last0;
    n_last[pix + kThreads] = last1;
  }
}

}  // namespace

extern "C" int blend_forward_launch(const void* table, const void* rank,
                                    const void* astart, const void* count,
                                    int n_tiles, int tile0, int tiles_x,
                                    float alpha_clip, float alpha_floor,
                                    float eps, void* cpre, void* tfinal,
                                    void* n_last, void* stream) {
  auto kernel = n_last != nullptr ? blend_forward_kernel<true>
                                  : blend_forward_kernel<false>;
  kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int32_t*)rank, (const int32_t*)astart,
      (const int32_t*)count, tile0, tiles_x, alpha_clip, alpha_floor, eps,
      (float*)cpre, (float*)tfinal, (int32_t*)n_last);
  return (int)cudaGetLastError();
}

// Blocks resident per SM of the instantiation with n_last (with_n_last
// != 0, training) or without it (serving).
extern "C" int blend_forward_blocks_per_sm(int with_n_last) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, with_n_last ? blend_forward_kernel<true>
                          : blend_forward_kernel<false>,
          kThreads, 0) != cudaSuccess)
    return -1;
  return n;
}
