// blend_step.cuh: the blend's step at one entry, in the one definition that
// all four blend kernels run: the forward kernels blend_forward.cu (kernel
// B, the entry stream) and window_blend_forward.cu (kernel D, the [T, K]
// windows), and the backward kernels blend_backward.cu (kernel C) and
// window_blend_backward.cu (kernel E), which replay it, so that their
// contribute decisions agree by construction; and the shared-memory layout
// of an entry's attributes that the blend kernels read it from.
//
// The expressions are the TPU kernels' (das3r_tpu/ops/splat/entry_blend.py
// and pallas_blend.py, ::_forward_kernel), in their order and unfused:
// every kernel is built with --fmad=false, and the exp is the IEEE expf (no
// __expf, no fast-math), so that a backward's replay sees exactly its
// forward's transmittances.
//
// blend_slot is the forward's step without a branch. It carries two
// transmittances per pixel: t_run, the TPU kernels' sticky running product
// (committed at every valid entry, even below eps), and t_out, the
// CUDA-visible one (committed only where the entry contributes). It gives
// the CUDA rasterizer's (c, T): that loop skips an invalid entry, stops the
// pixel once T (1 - alpha) < eps and otherwise adds alpha T c and sets T to
// T (1 - alpha). Until the pixel first crosses eps, t_run == t_out == the
// rasterizer's T, because both are committed at the same entries. At the
// crossing t_run drops below eps and t_out stays. After it, every step has
// t_after <= t_run < eps (1 - alpha lies in (0, 1], and a rounded product
// by a factor <= 1 is never larger), so no later entry contributes: c and
// t_out are final, as the rasterizer's are once it stops. So "no pixel of
// the tile has t_run >= eps" is the rasterizer's "every pixel is done", and
// a kernel may leave the tile there.
#pragma once
#include <cuda_runtime.h>

namespace blend_step {

constexpr int kAttr = 9;  // mean_x mean_y conic_xx conic_xy conic_yy r g b op
// An entry's attributes in shared memory: kAttrPad floats, 16-byte aligned,
// [mx my cxx cxy | cyy op - - | r g b -], so that the step reads one
// broadcast float4 and one float2, and the colours a second float4.
constexpr int kAttrPad = 12;
// the slot of attribute a (table column order) in that layout
__host__ __device__ constexpr int attr_slot(int a) {
  return a < 5 ? a : (a == 8 ? 5 : a + 3);
}

// One entry evaluated at one pixel.
struct Eval {
  float alpha_raw;  // op * exp(power)
  float alpha;      // min(alpha_clip, alpha_raw)
  bool valid;       // live, power <= 0 and alpha >= alpha_floor
};

// Entry (a0 = [mx my cxx cxy], a1 = [cyy op]) at pixel (px, py); ``live``:
// the entry lies in the tile's list (a window's [delta, delta + count), or
// before the pixel's n_last).
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

// T after the entry: T (1 - alpha) where the entry is valid, T where not.
// Without a branch, so that consecutive entries' exps overlap.
__device__ __forceinline__ float advance(float T, const Eval& e) {
  const float t_next = T * (1.0f - e.alpha);
  return e.valid ? t_next : T;
}

// One entry (colour col) into one pixel's state, by selects; returns
// whether it contributed. c += w col with w = alpha * t_run, before t_run
// moves, in list order.
__device__ __forceinline__ bool blend_slot(const Eval& e, float4 col,
                                           float eps, float& t_run,
                                           float& t_out, float& cr,
                                           float& cg, float& cb) {
  const float t_after = advance(t_run, e);
  const bool contrib = e.valid && t_after >= eps;
  const float w = e.alpha * t_run;
  cr = contrib ? cr + w * col.x : cr;
  cg = contrib ? cg + w * col.y : cg;
  cb = contrib ? cb + w * col.z : cb;
  t_out = contrib ? t_after : t_out;
  t_run = t_after;
  return contrib;
}

}  // namespace blend_step
