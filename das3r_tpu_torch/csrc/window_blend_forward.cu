// window_blend_forward: front-to-back alpha blend of each tile's [T, K]
// window of depth-ordered attributes, background composed in.
//
// Replaces the TPU kernel das3r_tpu/ops/splat/pallas_blend.py::_forward_kernel
// (launched by _forward_impl, pallas_blend.py:331-367), with its contract:
// attrs [T, 9, K] (rows mean_x mean_y conic_xx conic_xy conic_yy r g b op),
// count and delta [T]; the live slots of tile t are [delta, delta + count).
// Outputs colors [T, 256, 3] = C + T_final * bg, tfinal [T, 256] and
// tin [T, K / chunk, 256]: the running transmittance entering each visited
// chunk, 0 for every chunk the loop never visited.
//
// One block per tile walks chunks c = delta / chunk, ... while c <
// ceil((delta + count) / chunk) and some pixel's running product is still
// >= eps (the TPU kernel's while-loop condition). Per pixel, over the
// chunk's live slots in order (blend_step.cuh's step, which kernel E
// replays):
//     valid = power <= 0 and alpha >= alpha_floor;
//     t_after = valid ? T_run * (1 - alpha) : T_run;
//     if valid and t_after >= eps: C += alpha * T_run * c, T_out = t_after;
//     T_run = t_after   (sticky: committed even below eps).
// T_run is the TPU kernel's sticky running product and T_out its
// CUDA-visible transmittance. A visited chunk's tin row holds T_run >= eps
// at some pixel (the loop condition) and an unvisited row is all 0: the
// backward (window_blend_backward.cu) finds the visited chunks by that.
// An empty tile visits no chunk: colors = bg, tfinal = 1, tin = 0.
//
// Bound on the H100: operations. Each pixel-slot evaluation is ~15 FP32
// operations and one exp; a tile that never saturates evaluates every one
// of its live slots at all 256 pixels. The design cuts the instructions
// issued around each evaluation:
//   - 128 threads, two pixels each, one above the other (p and p + 128,
//     8 rows apart): each shared load and the x half of the power serve
//     two evaluations, and each thread carries two independent T chains;
//   - a slot's attributes are staged as blend_step.cuh's 48-byte padded
//     rows and read by three broadcast loads (float4, float2, float4);
//   - the step has no branch (an invalid slot leaves T as it was, a slot
//     that does not contribute leaves C by a select), and the slot loop is
//     unrolled by 4, so that consecutive slots' exps are in flight
//     together; only the T multiply is serial;
//   - two chunk buffers: chunk c + 1 is copied with cp.async while chunk c
//     is blended, and the one barrier per chunk is the exit test.
// On the trainer scene of chip_smoke.py (576 tiles that never saturate,
// 463.5M evaluations; H100 80GB HBM3, 700 W), the changes added one at a
// time and timed in turns against a one-pixel, scalar-load, branching,
// single-buffer kernel of 1.07 ms took off 15, 8, 0 and 9 points of it
// (layout, no branch, two pixels, double buffer): 0.71 ms. Two pixels per
// thread and 256 threads of one pixel ran level. Half-tile blocks, which
// even out the 4.4 tiles per SM, gained nothing: the warps per scheduler
// stay as many, and the kernel is bound by their instruction issue.
#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_step.cuh"

namespace {

using blend_step::attr_slot;
using blend_step::blend_slot;
using blend_step::evaluate;
using blend_step::kAttr;
using blend_step::kAttrPad;

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // pixels of a tile
constexpr int kThreads = kPix / 2;   // two pixels each: p and p + kThreads
constexpr int kMaxChunk = 128;
constexpr int kBuf = kMaxChunk * kAttrPad;  // floats of one chunk buffer
// two chunk buffers, within the 48 KB a launch may take without opting in
static_assert(2 * kBuf * sizeof(float) <= 48 * 1024,
              "D's launch needs no opt-in");

// Copy chunk c's 9 x chunk attributes into buf's padded rows: 4-byte
// cp.async copies, one commit group. Each attribute row of [T, 9, K] is
// contiguous, so neighbouring threads read neighbouring addresses.
__device__ __forceinline__ void stage_chunk(float* buf, const float* a_t,
                                            int k_width, int c, int chunk) {
  for (int j = threadIdx.x; j < chunk; j += kThreads) {
    const float* src = a_t + (int64_t)c * chunk + j;
    const unsigned dst =
        (unsigned)__cvta_generic_to_shared(buf + j * kAttrPad);
#pragma unroll
    for (int a = 0; a < kAttr; ++a)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       dst + 4 * attr_slot(a)),
                   "l"(src + (int64_t)a * k_width)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
window_forward_kernel(const float* __restrict__ attrs,
                      const int32_t* __restrict__ count,
                      const int32_t* __restrict__ delta,
                      const float* __restrict__ bg, int k_width, int chunk,
                      int tiles_x, float alpha_clip, float alpha_floor,
                      float eps, float* __restrict__ colors,
                      float* __restrict__ tfinal, float* __restrict__ tin) {
  __shared__ __align__(16) float s_attr[2][kBuf];
  const int t = blockIdx.x;
  const int q = threadIdx.x;  // pixels q and q + kThreads of the tile
  const float px = (float)((t % tiles_x) * kTile + q % kTile);
  const float py0 = (float)((t / tiles_x) * kTile + q / kTile);
  const float py1 = py0 + (float)(kThreads / kTile);
  const int cnt = count[t];
  const int del = delta[t];
  const int n_chunks = k_width / chunk;
  const int c0 = del / chunk;
  const int c_end = min((del + cnt + chunk - 1) / chunk, n_chunks);
  const float* a_t = attrs + (int64_t)t * kAttr * k_width;
  float* tin_t = tin + (int64_t)t * n_chunks * kPix + q;

  float cr0 = 0.0f, cg0 = 0.0f, cb0 = 0.0f, cr1 = 0.0f, cg1 = 0.0f,
        cb1 = 0.0f;
  float to0 = 1.0f, tr0 = 1.0f, to1 = 1.0f, tr1 = 1.0f;
  if (c0 < c_end) stage_chunk(s_attr[0], a_t, k_width, c0, chunk);
  int c = c0;
  for (; c < c_end; ++c) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // Chunk c is in place for every thread, and every thread is done with
    // chunk c - 1, whose buffer the copies below overwrite.
    if (!__syncthreads_or(tr0 >= eps || tr1 >= eps)) break;
    tin_t[(int64_t)c * kPix] = tr0;
    tin_t[(int64_t)c * kPix + kThreads] = tr1;
    const int b = (c - c0) & 1;
    if (c + 1 < c_end)
      stage_chunk(s_attr[b ^ 1], a_t, k_width, c + 1, chunk);
    const float* buf = s_attr[b];
    const int lo = max(del - c * chunk, 0);
    const int hi = min(del + cnt - c * chunk, chunk);
#pragma unroll 4
    for (int j = lo; j < hi; ++j) {
      const float* row = buf + j * kAttrPad;
      const float4 a0 = *(const float4*)row;
      const float2 a1 = *(const float2*)(row + 4);
      const float4 col = *(const float4*)(row + 8);
      blend_slot(evaluate(a0, a1, px, py0, true, alpha_clip, alpha_floor),
                 col, eps, tr0, to0, cr0, cg0, cb0);
      blend_slot(evaluate(a0, a1, px, py1, true, alpha_clip, alpha_floor),
                 col, eps, tr1, to1, cr1, cg1, cb1);
    }
  }
  // rows of the chunks never visited: before delta / chunk and after the
  // loop's exit
  for (int z = 0; z < c0; ++z) {
    tin_t[(int64_t)z * kPix] = 0.0f;
    tin_t[(int64_t)z * kPix + kThreads] = 0.0f;
  }
  for (int z = c; z < n_chunks; ++z) {
    tin_t[(int64_t)z * kPix] = 0.0f;
    tin_t[(int64_t)z * kPix + kThreads] = 0.0f;
  }
  const int64_t pix = (int64_t)t * kPix + q;
  float* out = colors + pix * 3;
  out[0] = cr0 + to0 * bg[0];
  out[1] = cg0 + to0 * bg[1];
  out[2] = cb0 + to0 * bg[2];
  out += kThreads * 3;
  out[0] = cr1 + to1 * bg[0];
  out[1] = cg1 + to1 * bg[1];
  out[2] = cb1 + to1 * bg[2];
  tfinal[pix] = to0;
  tfinal[pix + kThreads] = to1;
}

}  // namespace

extern "C" int window_blend_forward_launch(
    const void* attrs, const void* count, const void* delta, const void* bg,
    int n_tiles, int k_width, int chunk, int tiles_x, float alpha_clip,
    float alpha_floor, float eps, void* colors, void* tfinal, void* tin,
    void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || k_width % chunk != 0) return -1;
  if (n_tiles == 0) return 0;
  window_forward_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)attrs, (const int32_t*)count, (const int32_t*)delta,
      (const float*)bg, k_width, chunk, tiles_x, alpha_clip, alpha_floor, eps,
      (float*)colors, (float*)tfinal, (float*)tin);
  return (int)cudaGetLastError();
}

// Blocks resident per SM (the chunk width does not change it: the shared
// memory is static).
extern "C" int window_blend_forward_blocks_per_sm(int chunk) {
  if (chunk < 1 || chunk > kMaxChunk) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, window_forward_kernel, kThreads, 0) != cudaSuccess)
    return -1;
  return n;
}
