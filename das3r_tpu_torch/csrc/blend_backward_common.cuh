// blend_backward_common.cuh: the batch machinery shared by the two
// blend-backward kernels, blend_backward.cu (kernel C, the entry stream)
// and window_blend_backward.cu (kernel E, the [T, K] windows).
//
// Both kernels run one block of 256 threads per 16x16 tile and walk the
// tile's entries back to front in batches of kNB. For each batch:
//   pass A (thread = pixel, in the kernel): the serial reverse sweep with
//     the pixel's carried T and suffix S; per (entry, pixel) it stores two
//     scalars in shared memory, d_power = alpha_raw * dalpha and
//     w = alpha * T_before, both 0 where the pixel did not contribute;
//   pass B (reduce_batch, thread = entry x pixel group): each of the
//     kNB x kGroups threads sums its entry's nine moments over its group's
//     pixels in registers (sum dp, dp dx, dp dy, dp dx^2, dp dx dy, dp dy^2,
//     w g_r, w g_g, w g_b) and, after a barrier, stores them as partials
//     over the d_power plane, which saves the ~10 KB a separate buffer would
//     take: one more block per SM;
//   combine (entry_grad): the groups' partials of an entry are added in
//     group order and turned into the nine gradients with the entry's conic
//     and opacity: mean -(cxx Mx + cxy My), -(cyy My + cxy Mx); conic
//     -Mxx/2, -Mxy, -Myy/2; colour the three w g sums; opacity sum dp / op,
//     which is sum (alpha_raw / op) dalpha in exact arithmetic.
// No warp shuffle and no shared atomic: the sums of a block are in a fixed
// order. Pass B decides nothing, so it uses explicit fmaf although the
// kernels are built with --fmad=false (which keeps pass A's contribute
// decisions those of the forward kernels).
//
// kNB = 16: pass B then has 16 groups of one pixel column each. 32 also
// works; there the [kNB][256] planes double, and on an H100
// 80GB HBM3 at 700 W the blocks per SM fell from 5 to 3 (C) and 4 to 2
// (E); C ran 1.84 ms against 1.69 at 16 and E 2.49 against 2.47 on the
// trainer scene of chip_smoke.py, timed in turns.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace blend_bwd {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;     // threads per block, one per pixel
constexpr int kAttr = 9;  // mean_x mean_y conic_xx conic_xy conic_yy r g b op
// An entry's attributes in shared memory: kAttrPad floats, 16-byte aligned,
// [mx my cxx cxy | cyy op - - | r g b -], so that the forward's
// expressions read two broadcast float4 loads and the colours a third.
constexpr int kAttrPad = 12;
// the slot of attribute a (table column order) in that layout
__host__ __device__ constexpr int attr_slot(int a) {
  return a < 5 ? a : (a == 8 ? 5 : a + 3);
}
constexpr int kNB = 16;                 // entries per batch
static_assert(kNB == 16 || kNB == 32, "a batch holds 16 or 32 entries");
constexpr int kGroups = kPix / kNB;     // pass B: pixel groups per entry
constexpr int kCols = kTile / kGroups;  // pixel columns per group
// Padded rows: pass B's warp reads 32 / kGroups entries' rows at once, and
// a row offset of kGroups floats puts them on distinct banks.
constexpr int kRow = kPix + kGroups;    // of the [kNB][kPix] planes
constexpr int kPart = kGroups + 1;      // of the [kAttr][kNB] partials
static_assert(kAttr * kNB * kPart <= kNB * kRow,
              "the partials fit over the d_power plane");

// floats of shared memory: d_power and w planes, colour cotangents
constexpr int kBatchFloats = 2 * kNB * kRow + 3 * kPix;

// Pass B for thread (j, grp): entry j's nine moments over its pixels, q.
__device__ __forceinline__ void sum_entry(
    const float* __restrict__ s_dp, const float* __restrict__ s_w,
    const float* __restrict__ s_g, const float* __restrict__ batch_attr,
    int j, int grp, float px0, float py0, float* q) {
  const float mx = batch_attr[j * kAttrPad + 0];
  const float my = batch_attr[j * kAttrPad + 1];
  const float* dp_row = s_dp + j * kRow + grp;
  const float* w_row = s_w + j * kRow + grp;
  const float* g_col = s_g + grp;
  float sa[kCols], sy[kCols], syy[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) sa[k] = sy[k] = syy[k] = 0.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    const float dy = my - (py0 + (float)r);
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int p = r * kTile + k * kGroups;
      const float dp = dp_row[p], w = w_row[p];
      const float t = dp * dy;
      sa[k] += dp;
      sy[k] += t;
      syy[k] = fmaf(t, dy, syy[k]);
      cr = fmaf(w, g_col[p], cr);
      cg = fmaf(w, g_col[kPix + p], cg);
      cb = fmaf(w, g_col[2 * kPix + p], cb);
    }
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const float dx = mx - (px0 + (float)(grp + k * kGroups));
    q[0] = fmaf(dx, sa[k], q[0]);
    q[1] += sy[k];
    q[2] = fmaf(dx * dx, sa[k], q[2]);
    q[3] = fmaf(dx, sy[k], q[3]);
    q[4] += syy[k];
    q[8] += sa[k];
  }
  q[5] = cr;
  q[6] = cg;
  q[7] = cb;
}

// Pass B. Thread (j, grp) = (tid / kGroups, tid % kGroups) sums entry j of
// the batch over pixel columns grp + kGroups * k of every row; writes its
// nine partials (Mx, My, Mxx, Mxy, Myy, sum w g_r, g_g, g_b, sum dp) to
// s_dp[(q * kNB + j) * kPart + grp], over the d_power plane: s_dp / s_w
// [kNB][kRow]; s_g: [3][kPix]; entry j's attributes
// at batch_attr[j * kAttrPad]; (px0, py0): the tile's first pixel. Rows
// j >= nb are not read. Every thread of the block calls it: it holds a
// barrier.
__device__ __forceinline__ void reduce_batch(
    float* __restrict__ s_dp, const float* __restrict__ s_w,
    const float* __restrict__ s_g, const float* __restrict__ batch_attr,
    int nb, float px0, float py0) {
  const int j = threadIdx.x / kGroups;
  const int grp = threadIdx.x - j * kGroups;
  float q[kAttr] = {};
  if (j < nb) sum_entry(s_dp, s_w, s_g, batch_attr, j, grp, px0, py0, q);
  __syncthreads();  // the planes are read: the partials go over them
  if (j < nb) {
    float* part = s_dp + j * kPart + grp;
#pragma unroll
    for (int a = 0; a < kAttr; ++a) part[a * kNB * kPart] = q[a];
  }
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory; 0 or the CUDA
// error.
template <typename Kernel>
inline int allow_shared(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Blocks of `kernel` resident on one SM at `smem` bytes of dynamic shared
// memory, or -1 on a CUDA error.
template <typename Kernel>
inline int blocks_per_sm(Kernel kernel, size_t smem) {
  int n = 0;
  if (allow_shared(kernel, smem) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kPix, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

// Sum of partial q of entry j over the groups, in group order.
__device__ __forceinline__ float group_sum(const float* __restrict__ s_part,
                                           int q, int j) {
  const float* part = s_part + (q * kNB + j) * kPart;
  float x = 0.0f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) x += part[g];
  return x;
}

// Gradient column a of entry j, from reduce_batch's partials and the
// entry's attributes attr[0..kAttrPad).
__device__ __forceinline__ float entry_grad(const float* __restrict__ s_part,
                                            const float* __restrict__ attr,
                                            int a, int j) {
  if (a < 2) {
    const float mx = group_sum(s_part, 0, j), my = group_sum(s_part, 1, j);
    return a == 0 ? -(attr[2] * mx + attr[3] * my)
                  : -(attr[4] * my + attr[3] * mx);
  }
  const float x = group_sum(s_part, a, j);
  switch (a) {
    case 2: return -0.5f * x;
    case 3: return -x;
    case 4: return -0.5f * x;
    case 8: return x / fmaxf(attr[attr_slot(8)], 1e-30f);
    default: return x;  // colour
  }
}

}  // namespace blend_bwd
