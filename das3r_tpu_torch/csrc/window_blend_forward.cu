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
// One block per tile, 256 threads, one per pixel of the 16x16 tile. The
// block walks chunks c = delta / chunk, ... while c < ceil((delta + count) /
// chunk) and some pixel's running product is still >= eps (the TPU kernel's
// while-loop condition, tested with __syncthreads_or, which is also the
// barrier before the chunk's attributes are overwritten). Each chunk's
// 9 x chunk attributes are staged in shared memory (each row is contiguous
// in [T, 9, K], so the loads coalesce); each thread then runs the serial
// loop over the chunk's live slots:
//     skip unless power <= 0 and alpha >= alpha_floor;
//     t_after = T_run * (1 - alpha);
//     if t_after >= eps: C += alpha * T_run * c, T_out = t_after;
//     T_run = t_after   (sticky: committed even below eps).
// T_run is the TPU kernel's sticky running product and T_out its
// CUDA-visible transmittance. A visited chunk's tin row holds T_run >= eps
// at some pixel (the loop condition) and an unvisited row is all 0: the
// backward (window_blend_backward.cu) finds the visited chunks by that.
// An empty tile visits no chunk: colors = bg, tfinal = 1, tin = 0.
//
// Bound on the H100: operations. Each pixel-slot evaluation is ~15 FP32
// operations and one exp (special-function units); the bytes are the
// visited chunks' attributes, read once per block, and the outputs. The
// design stops at saturation, so the work is what the serial loop needs.
// Known weakness, left for a later change: one block per tile balances
// poorly when a few tiles hold most entries.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block, one per pixel
constexpr int kAttr = 9;
constexpr int kMaxChunk = 128;

__global__ void __launch_bounds__(kPix)
window_forward_kernel(const float* __restrict__ attrs,
                      const int32_t* __restrict__ count,
                      const int32_t* __restrict__ delta,
                      const float* __restrict__ bg, int k_width, int chunk,
                      int tiles_x, float alpha_clip, float alpha_floor,
                      float eps, float* __restrict__ colors,
                      float* __restrict__ tfinal, float* __restrict__ tin) {
  __shared__ float s_attr[kAttr][kMaxChunk];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = (float)((t % tiles_x) * kTile + p % kTile);
  const float py = (float)((t / tiles_x) * kTile + p / kTile);
  const int cnt = count[t];
  const int del = delta[t];
  const int n_chunks = k_width / chunk;
  const int c0 = del / chunk;
  const int c_end = min((del + cnt + chunk - 1) / chunk, n_chunks);
  const float* a_t = attrs + (int64_t)t * kAttr * k_width;
  float* tin_t = tin + (int64_t)t * n_chunks * kPix;

  float c_r = 0.0f, c_g = 0.0f, c_b = 0.0f;
  float t_out = 1.0f, t_run = 1.0f;
  int c = c0;
  for (; c < c_end; ++c) {
    if (!__syncthreads_or(t_run >= eps)) break;
    tin_t[(int64_t)c * kPix + p] = t_run;
    for (int i = p; i < kAttr * chunk; i += kPix) {
      const int a = i / chunk, j = i - a * chunk;
      s_attr[a][j] = a_t[(int64_t)a * k_width + c * chunk + j];
    }
    __syncthreads();
    const int lo = max(del - c * chunk, 0);
    const int hi = min(del + cnt - c * chunk, chunk);
    for (int j = lo; j < hi; ++j) {
      const float dx = s_attr[0][j] - px;
      const float dy = s_attr[1][j] - py;
      const float power = -0.5f * (s_attr[2][j] * dx * dx +
                                   s_attr[4][j] * dy * dy) -
                          s_attr[3][j] * dx * dy;
      if (power > 0.0f) continue;
      const float alpha = fminf(alpha_clip, s_attr[8][j] * expf(power));
      if (alpha < alpha_floor) continue;
      const float t_after = t_run * (1.0f - alpha);
      if (t_after >= eps) {
        const float w = alpha * t_run;
        c_r += w * s_attr[5][j];
        c_g += w * s_attr[6][j];
        c_b += w * s_attr[7][j];
        t_out = t_after;
      }
      t_run = t_after;
    }
  }
  // rows of the chunks never visited: before delta / chunk and after the
  // loop's exit
  for (int z = 0; z < c0; ++z) tin_t[(int64_t)z * kPix + p] = 0.0f;
  for (int z = c; z < n_chunks; ++z) tin_t[(int64_t)z * kPix + p] = 0.0f;
  float* out = colors + ((int64_t)t * kPix + p) * 3;
  out[0] = c_r + t_out * bg[0];
  out[1] = c_g + t_out * bg[1];
  out[2] = c_b + t_out * bg[2];
  tfinal[(int64_t)t * kPix + p] = t_out;
}

}  // namespace

extern "C" int window_blend_forward_launch(
    const void* attrs, const void* count, const void* delta, const void* bg,
    int n_tiles, int k_width, int chunk, int tiles_x, float alpha_clip,
    float alpha_floor, float eps, void* colors, void* tfinal, void* tin,
    void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || k_width % chunk != 0) return -1;
  if (n_tiles == 0) return 0;
  window_forward_kernel<<<n_tiles, kPix, 0, (cudaStream_t)stream>>>(
      (const float*)attrs, (const int32_t*)count, (const int32_t*)delta,
      (const float*)bg, k_width, chunk, tiles_x, alpha_clip, alpha_floor, eps,
      (float*)colors, (float*)tfinal, (float*)tin);
  return (int)cudaGetLastError();
}
