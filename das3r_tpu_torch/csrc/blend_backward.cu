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
// block owns one tile, 256 threads, and walks the tile's list back to front
// from the block's largest n_last, in batches of kNB entries
// (blend_backward_common.cuh). Pass A, thread = pixel: the pixel sees entry
// j only if j < n_last[p]; every valid entry it sees contributed in the
// forward (the entry that crossed eps and all later ones lie at or past
// n_last), because both kernels evaluate an entry by blend_step.cuh's
// evaluate, built with --fmad=false. Per seen, valid entry, from T =
// T_final backwards:
//     r = 1 / (1 - alpha);  T_before = T r;  w = alpha * T_before
//     dalpha = (gC . c) T_before - S r;  S += (gC . c) w
//     (dalpha = 0 where alpha_raw > alpha_clip);  d_power = alpha_raw dalpha
// with S = gT * T_final at the start; d_power and w go to shared memory.
// r is the fast reciprocal (__fdividef): no decision depends on it, and
// 1 - alpha >= 1 - alpha_clip keeps it within 2 ulp. Pass B and the combine
// (the header) reduce each entry over the tile's pixels in a fixed order;
// then one atomicAdd per entry and column adds its nine sums into
// g_table[rank]. A table row is in at most max_tiles_per_gaussian tiles'
// lists, so the atomics rarely collide; their order varies from run to run,
// so the result varies in its last bits.
//
// As in blend_forward.cu, a launch covers n_tiles tiles from global tile
// tile0 on: block t takes its pixel coordinates from tile tile0 + t and
// reads and writes every per-tile and per-pixel array at t alone. A tile
// past the image has count 0 and n_last 0, so it returns at once.
//
// The table_bf16 form (blend_backward_bf16_launch) reads the [N + 1, 11]
// bf16 table of entry_table.cuh, decoded to f32 at both of its reads (the
// first batch and each next batch); the rest is the f32 form. It replaces
// the TPU kernel's table_bf16 form, which decodes in _load_attrs
// (entry_blend.py:71-81, called at :248). The gradient it writes is that of
// the f32 table [N + 1, 9], from the decoded values: straight through the
// encode, as JAX's custom_vjp gives it (_bwd, entry_blend.py:510-523).
//
// Bound on the H100: operations, ~55 FP32 and an exp and a reciprocal per
// seen pixel-entry; the bytes are the table rows, ranks and per-pixel
// vectors, read once per block. The design before this one reduced the
// nine terms of every entry with 45 warp shuffles per warp and 72 shared
// atomics per block, which cost more than the arithmetic. Here a batch
// costs two shared stores and five shared loads per pixel-entry; each
// entry's attributes are three broadcast float4 loads; the next batch's
// ranks and table rows are loaded into registers while pass A runs; and
// at 38 KB of shared memory and 48 registers five blocks fit on an SM.
// What is left is instruction issue: ~75 instructions per warp and entry in
// pass A (the exp is the forward's expf, the power the forward's unfused
// products), and the barriers of each batch. Known weakness: one block per
// tile balances poorly when a few tiles hold most entries.
#include "blend_backward_common.cuh"
#include "blend_step.cuh"
#include "entry_table.cuh"

namespace {

using namespace blend_bwd;
using blend_step::Eval;
using blend_step::evaluate;

// d_power and w planes (the partials go over them), colour cotangents,
// then the batch's attributes [kNB][kAttrPad] and ranks [kNB]
constexpr size_t kSharedBytes =
    sizeof(float) * (kBatchFloats + kNB * kAttrPad) + sizeof(int32_t) * kNB;
// within the 48 KB a launch may take without opting in
static_assert(kSharedBytes <= 48 * 1024, "C's launch needs no opt-in");
// table values each thread stages per batch
constexpr int kStage = (kNB * kAttr + kPix - 1) / kPix;

// five blocks per SM, as the shared memory allows: at most 48 registers
template <typename Table>
__global__ void __launch_bounds__(kPix, 5)
blend_backward_kernel(const Table table,
                      const int32_t* __restrict__ rank,
                      const int32_t* __restrict__ astart,
                      const int32_t* __restrict__ count, int tile0,
                      int tiles_x, float alpha_clip, float alpha_floor,
                      const float* __restrict__ tfinal,
                      const int32_t* __restrict__ n_last,
                      const float* __restrict__ g_cpre,
                      const float* __restrict__ g_tfinal,
                      float* __restrict__ g_table) {
  extern __shared__ float smem[];
  float* s_dp = smem;                          // [kNB][kRow]; the partials
  float* s_w = s_dp + kNB * kRow;              // [kNB][kRow]
  float* s_g = s_w + kNB * kRow;               // [3][kPix]
  float* s_attr = s_g + 3 * kPix;              // [kNB][kAttrPad]
  int32_t* s_rank = (int32_t*)(s_attr + kNB * kAttrPad);  // [kNB]
  __shared__ int s_end;
  const int t = blockIdx.x;   // local tile: the rows it reads and writes
  const int tg = tile0 + t;   // global tile: its pixel coordinates
  const int p = threadIdx.x;
  const int tx0 = (tg % tiles_x) * kTile, ty0 = (tg / tiles_x) * kTile;
  const float px = (float)(tx0 + p % kTile);
  const float py = (float)(ty0 + p / kTile);
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
  s_g[p] = g0;
  s_g[kPix + p] = g1;
  s_g[2 * kPix + p] = g2;
  float T = tfinal[pix];
  float S = g_tfinal[pix] * T;

  // Element i = p + u * kPix of a batch is attribute i % kAttr of its entry
  // i / kAttr. The next batch's ranks are loaded before pass A and its
  // table values after it, so that pass A and pass B hide their latency.
  int32_t nr[kStage];
  float nv[kStage];
  const int b_first = ((end - 1) / kNB) * kNB;
#pragma unroll
  for (int u = 0; u < kStage; ++u) {
    const int i = p + u * kPix;
    if (i < min(kNB, end - b_first) * kAttr) {
      nr[u] = rank[beg + b_first + i / kAttr];
      nv[u] = table(nr[u], i % kAttr);
    }
  }

  for (int b = b_first; b >= 0; b -= kNB) {
    // Also the barrier that keeps the previous batch's combine ahead of the
    // writes below.
    __syncthreads();
    const int nb = min(kNB, end - b);
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = p + u * kPix;
      if (i < nb * kAttr) {
        const int j = i / kAttr, a = i % kAttr;
        if (a == 0) s_rank[j] = nr[u];
        s_attr[j * kAttrPad + attr_slot(a)] = nv[u];
      }
    }
    __syncthreads();
    const bool next = b > 0;  // the next batch holds kNB entries
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = p + u * kPix;
      if (next && i < kNB * kAttr) nr[u] = rank[beg + b - kNB + i / kAttr];
    }

    // pass A: the pixel's reverse sweep
    bool any = false;
#pragma unroll 4
    for (int j = nb - 1; j >= 0; --j) {  // uniform over the block
      float d_power = 0.0f, w = 0.0f;
      const float4 a0 = *(const float4*)(s_attr + j * kAttrPad);
      const float4 a1 = *(const float4*)(s_attr + j * kAttrPad + 4);
      const float4 a2 = *(const float4*)(s_attr + j * kAttrPad + 8);
      if (b + j < my_last) {
        // The forward's step (blend_step.cuh), the one kernel B ran.
        const Eval e = evaluate(a0, make_float2(a1.x, a1.y), px, py, true,
                                alpha_clip, alpha_floor);
        if (e.valid) {
          any = true;
          // one_m >= 1 - alpha_clip: the fast reciprocal is within 2 ulp
          const float inv = __fdividef(1.0f, 1.0f - e.alpha);
          const float t_before = T * inv;
          w = e.alpha * t_before;
          const float gdot = g0 * a2.x + g1 * a2.y + g2 * a2.z;
          float d_alpha = gdot * t_before - S * inv;
          S += gdot * w;
          T = t_before;
          if (e.alpha_raw > alpha_clip) d_alpha = 0.0f;
          d_power = e.alpha_raw * d_alpha;
        }
      }
      s_dp[j * kRow + p] = d_power;
      s_w[j * kRow + p] = w;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = p + u * kPix;
      if (next && i < kNB * kAttr)
        nv[u] = table(nr[u], i % kAttr);
    }
    if (!__syncthreads_or(any)) continue;  // no pixel saw the batch

    reduce_batch(s_dp, s_w, s_g, s_attr, nb, (float)tx0, (float)ty0);
    __syncthreads();
    for (int i = p; i < kAttr * nb; i += kPix) {
      const int a = i / nb, j = i - a * nb;
      const float x = entry_grad(s_dp, s_attr + j * kAttrPad, a, j);
      if (x != 0.0f) atomicAdd(g_table + (int64_t)s_rank[j] * kAttr + a, x);
    }
  }
}

template <typename Table>
int launch(Table table, const void* rank, const void* astart,
           const void* count, int n_tiles, int tile0, int tiles_x,
           float alpha_clip, float alpha_floor, const void* tfinal,
           const void* n_last, const void* g_cpre, const void* g_tfinal,
           void* g_table, void* stream) {
  if (n_tiles == 0) return 0;
  blend_backward_kernel<Table>
      <<<n_tiles, kPix, kSharedBytes, (cudaStream_t)stream>>>(
          table, (const int32_t*)rank, (const int32_t*)astart,
          (const int32_t*)count, tile0, tiles_x, alpha_clip, alpha_floor,
          (const float*)tfinal, (const int32_t*)n_last, (const float*)g_cpre,
          (const float*)g_tfinal, (float*)g_table);
  return (int)cudaGetLastError();
}

}  // namespace

// table: [N + 1, 9] f32; g_table: [N + 1, 9] f32
extern "C" int blend_backward_launch(const void* table, const void* rank,
                                     const void* astart, const void* count,
                                     int n_tiles, int tile0, int tiles_x,
                                     float alpha_clip, float alpha_floor,
                                     const void* tfinal, const void* n_last,
                                     const void* g_cpre, const void* g_tfinal,
                                     void* g_table, void* stream) {
  return launch(entry_table::TableF32{(const float*)table}, rank, astart,
                count, n_tiles, tile0, tiles_x, alpha_clip, alpha_floor,
                tfinal, n_last, g_cpre, g_tfinal, g_table, stream);
}

// table: [N + 1, 11] bf16 (entry_table.cuh); g_table: [N + 1, 9] f32
extern "C" int blend_backward_bf16_launch(
    const void* table, const void* rank, const void* astart,
    const void* count, int n_tiles, int tile0, int tiles_x, float alpha_clip,
    float alpha_floor, const void* tfinal, const void* n_last,
    const void* g_cpre, const void* g_tfinal, void* g_table, void* stream) {
  return launch(entry_table::TableBf16{(const uint16_t*)table}, rank, astart,
                count, n_tiles, tile0, tiles_x, alpha_clip, alpha_floor,
                tfinal, n_last, g_cpre, g_tfinal, g_table, stream);
}

// Blocks resident per SM of the f32 form (chunk is not used: the batch has
// a fixed size).
extern "C" int blend_backward_blocks_per_sm(int chunk) {
  return blocks_per_sm(blend_backward_kernel<entry_table::TableF32>,
                       kSharedBytes);
}
