// entry_table.cuh: the two forms of the entry stream's attribute table that
// kernels B (blend_forward.cu) and C (blend_backward.cu) read, each as a
// reader of one attribute of one row, in f32. A kernel body is a template on
// the reader, so both forms run the same f32 step after the read.
//
// TableF32: [M, 9] f32, the columns of blend_step.cuh (mean_x mean_y conic_xx
// conic_xy conic_yy r g b op).
//
// TableBf16: [M, 11] bf16, the JAX package's table_bf16 layout
// (das3r_tpu/ops/splat/entry_blend.py::encode_bf16_table):
//     0 mean_x_hi  1 mean_x_lo  2 mean_y_hi  3 mean_y_lo
//     4-6 conic    7-9 colour   10 opacity
// with hi = bf16(m) and lo = bf16(m - f32(hi)). The decode is the JAX
// kernels' _load_attrs: a bf16 value widens to f32 exactly (its 16 bits are
// the top half of the f32), and mean = f32(hi) + f32(lo), one f32 add (no
// contraction: the kernels are built with --fmad=false). So the decoded row
// is bitwise JAX's.
//
// Alignment: an 11-column row is 22 bytes, so odd rows start at 2 bytes
// past a 4-byte boundary. The reader loads 2-byte values. It keeps JAX's
// layout as it is (the encode is bitwise JAX's and nothing is padded), and
// the cost is in the staging of a batch, once per entry and block: B and C
// are bound by the operations of the step, repeated at every pixel, not by
// these loads. A 12-column padded row would allow three 8-byte loads instead
// of eleven 2-byte ones, for 2 more bytes per row.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_step.cuh"

namespace entry_table {

constexpr int kAttrBf16 = 11;  // columns of the bf16 table

struct TableF32 {
  const float* t;
  __device__ __forceinline__ float operator()(int64_t r, int a) const {
    return t[r * blend_step::kAttr + a];
  }
};

// bf16 bits -> f32, exactly
__device__ __forceinline__ float widen(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}

struct TableBf16 {
  const uint16_t* t;
  // attribute a (f32 column order) of row r: a mean is hi + lo, the rest
  // one column each (column a + 2)
  __device__ __forceinline__ float operator()(int64_t r, int a) const {
    const uint16_t* row = t + r * kAttrBf16;
    if (a < 2) return widen(row[2 * a]) + widen(row[2 * a + 1]);
    return widen(row[a + 2]);
  }
};

}  // namespace entry_table
