// blend_step.cuh: the window blend's step at one slot, in the one
// definition that the window forward kernel (window_blend_forward.cu,
// kernel D) runs and the window backward kernel (window_blend_backward.cu,
// kernel E) replays, so that their contribute decisions agree by
// construction; and the shared-memory layout of a slot's attributes that
// the blend kernels read it from.
//
// The expressions are the TPU kernel's (das3r_tpu/ops/splat/pallas_blend.py
// ::_forward_kernel), in its order and unfused: every kernel is built with
// --fmad=false, and the exp is the IEEE expf (no __expf, no fast-math), so
// that E's replay sees exactly D's transmittances.
#pragma once
#include <cuda_runtime.h>

namespace blend_step {

constexpr int kAttr = 9;  // mean_x mean_y conic_xx conic_xy conic_yy r g b op
// A slot's attributes in shared memory: kAttrPad floats, 16-byte aligned,
// [mx my cxx cxy | cyy op - - | r g b -], so that the step reads one
// broadcast float4 and one float2, and the colours a second float4.
constexpr int kAttrPad = 12;
// the slot of attribute a (table column order) in that layout
__host__ __device__ constexpr int attr_slot(int a) {
  return a < 5 ? a : (a == 8 ? 5 : a + 3);
}

// One slot evaluated at one pixel.
struct Eval {
  float alpha_raw;  // op * exp(power)
  float alpha;      // min(alpha_clip, alpha_raw)
  bool valid;       // live, power <= 0 and alpha >= alpha_floor
};

// Slot (a0 = [mx my cxx cxy], a1 = [cyy op]) at pixel (px, py); ``live``:
// the slot lies in the tile's [delta, delta + count).
__device__ __forceinline__ Eval evaluate(float4 a0, float2 a1, float px,
                                         float py, bool live,
                                         float alpha_clip,
                                         float alpha_floor) {
  const float dx = a0.x - px;
  const float dy = a0.y - py;
  const float power =
      -0.5f * (a0.z * dx * dx + a1.x * dy * dy) - a0.w * dx * dy;
  const float alpha_raw = a1.y * expf(power);
  const float alpha = fminf(alpha_clip, alpha_raw);
  return {alpha_raw, alpha, live && power <= 0.0f && alpha >= alpha_floor};
}

// T after the slot: T (1 - alpha) where the slot is valid, T where not.
// Without a branch, so that consecutive slots' exps overlap.
__device__ __forceinline__ float advance(float T, const Eval& e) {
  const float t_next = T * (1.0f - e.alpha);
  return e.valid ? t_next : T;
}

}  // namespace blend_step
