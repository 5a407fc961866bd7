// dup_count, dup_emit: the duplication table's live keys, counted per row and
// then written at each row's offset.
//
// Replaces the port's dense [N, D] tensor program (binning.py::_emit_keys and
// _tile_pair_keep on CUDA tensors), which builds every (Gaussian, rect cell)
// pair of the table, culls it and compacts the survivors with a boolean
// index: ~100 elementwise passes over N * D slots of which a few percent
// live. The JAX package's table is plain jnp that XLA fuses; there is no
// Pallas kernel behind it.
//
// Row r is depth rank r, Gaussian g = order[r], read from the un-gathered
// per-Gaussian arrays. Its allowed cells are a = min(ntt[g], D) when
// binnable[g] (0 otherwise); with the split table (h_pos given) a row with
// more than L cells whose heavy position h_pos[r] is at or past
// heavy_rows_cap keeps only its first L. Cell d < a lies at row
// (d + 0.5) / w and column d - row * w of the rect (w its width), and lives
// when the tile-pair cull keeps it (or always, without tight binning). Its
// key is (ty * tiles_x + tx) << nbits | r.
//
// dup_count writes each row's live count; the caller scans the counts and
// sizes the output from the total; dup_emit repeats the loop and writes the
// row's keys from offset incl[r] - counts[r], in cell order. So the keys come
// out row-major in depth order: the order of the dense table's keys[valid].
//
// The cull is binning.py::_tile_pair_keep's f32 arithmetic in its order of
// operations. The build passes --fmad=false and keeps IEEE division, and
// tmin / tmax propagate NaN as torch.minimum / torch.maximum do, so the kept
// set is bitwise the plain version's.
//
// Bound on the H100: memory. Each pass reads ~48 B per row (the index and
// seven per-Gaussian fields); dup_emit also writes 8 B per live key. One
// thread per row: a row's cells are few (at most D) and its keys are
// contiguous in the output.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Rows {
  const int64_t* order;
  const int32_t* rect_min;   // [N, 2] (x, y)
  const int32_t* rect_max;   // [N, 2]
  const int32_t* ntt;        // [N]
  const bool* binnable;      // [N]
  const float* mean2d;       // [N, 2]
  const float* conic;        // [N, 3]
  const float* q_cap;        // [N]
  const int64_t* h_pos;      // [N] by depth rank, or NULL: no split table
  int32_t n, d_cap, light, heavy_cap, tiles_x, tile, tight;
};

__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

// One row's rect and conic, and the cells it may emit.
struct Row {
  int32_t a, w, x0, y0;
  float mx, my, A, B, C, A_safe, C_safe, q_lim;
};

__device__ __forceinline__ Row load_row(const Rows& p, int32_t r) {
  Row o;
  const int64_t g = p.order[r];
  int32_t a = 0;
  if (p.binnable[g]) {
    a = p.ntt[g] < p.d_cap ? p.ntt[g] : p.d_cap;
    if (p.h_pos != nullptr && a > p.light && p.h_pos[r] >= p.heavy_cap)
      a = p.light;
  }
  o.a = a;
  o.x0 = p.rect_min[2 * g];
  o.y0 = p.rect_min[2 * g + 1];
  const int32_t w = p.rect_max[2 * g] - o.x0;
  o.w = w > 1 ? w : 1;
  o.mx = p.mean2d[2 * g];
  o.my = p.mean2d[2 * g + 1];
  o.A = p.conic[3 * g];
  o.B = p.conic[3 * g + 1];
  o.C = p.conic[3 * g + 2];
  o.A_safe = o.A > 0.0f ? o.A : 1.0f;
  o.C_safe = o.C > 0.0f ? o.C : 1.0f;
  o.q_lim = p.q_cap[g] + 1e-3f;
  return o;
}

// binning.py::_tile_pair_keep at tile (tx, ty).
__device__ __forceinline__ bool keep(const Row& o, int32_t tx, int32_t ty,
                                     float tile) {
  const float lx = (float)tx * tile - o.mx;
  const float hx = lx + (tile - 1.0f);
  const float ly = (float)ty * tile - o.my;
  const float hy = ly + (tile - 1.0f);
  const bool inside = (lx <= 0.0f) & (hx >= 0.0f) & (ly <= 0.0f) &
                      (hy >= 0.0f);
  const float nB = -o.B;
  const float B2 = 2.0f * o.B;
  float q[4];
  const float xs[2] = {lx, hx};
  const float ys[2] = {ly, hy};
#pragma unroll
  for (int i = 0; i < 2; ++i) {       // q_edge_x(lx), q_edge_x(hx)
    const float xh = xs[i];
    const float yst = tmin(tmax(nB * xh / o.C_safe, ly), hy);
    q[i] = o.A * xh * xh + B2 * xh * yst + o.C * yst * yst;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {       // q_edge_y(ly), q_edge_y(hy)
    const float yh = ys[i];
    const float xst = tmin(tmax(nB * yh / o.A_safe, lx), hx);
    q[2 + i] = o.A * xst * xst + B2 * xst * yh + o.C * yh * yh;
  }
  float q_min = tmin(tmin(q[0], q[1]), tmin(q[2], q[3]));
  if (inside) q_min = 0.0f;
  return q_min <= o.q_lim;
}

// Calls f(d, tx, ty) for each live cell of row r, in cell order.
template <typename F>
__device__ __forceinline__ void for_live_cells(const Rows& p, const Row& o,
                                               F f) {
  const float tile = (float)p.tile;
  const float wf = (float)o.w;
  for (int32_t d = 0; d < o.a; ++d) {
    const int32_t row = (int32_t)(((float)d + 0.5f) / wf);
    const int32_t tx = o.x0 + (d - row * o.w);
    const int32_t ty = o.y0 + row;
    if (!p.tight || keep(o, tx, ty, tile)) f(tx, ty);
  }
}

__global__ void dup_count_kernel(Rows p, int32_t* __restrict__ counts) {
  const int64_t r = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (r >= p.n) return;
  const Row o = load_row(p, (int32_t)r);
  int32_t c = 0;
  for_live_cells(p, o, [&](int32_t, int32_t) { ++c; });
  counts[r] = c;
}

__global__ void dup_emit_kernel(Rows p, const int32_t* __restrict__ counts,
                                const int64_t* __restrict__ incl, int nbits,
                                int64_t* __restrict__ keys) {
  const int64_t r = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (r >= p.n) return;
  const Row o = load_row(p, (int32_t)r);
  int64_t* out = keys + (incl[r] - counts[r]);
  for_live_cells(p, o, [&](int32_t tx, int32_t ty) {
    *out++ = ((int64_t)(ty * p.tiles_x + tx) << nbits) | r;
  });
}

Rows rows(const void* order, const void* rect_min, const void* rect_max,
          const void* ntt, const void* binnable, const void* mean2d,
          const void* conic, const void* q_cap, const void* h_pos, int n,
          int d_cap, int light, int heavy_cap, int tiles_x, int tile,
          int tight) {
  return Rows{(const int64_t*)order, (const int32_t*)rect_min,
              (const int32_t*)rect_max, (const int32_t*)ntt,
              (const bool*)binnable, (const float*)mean2d,
              (const float*)conic, (const float*)q_cap,
              (const int64_t*)h_pos, n, d_cap, light, heavy_cap, tiles_x,
              tile, tight};
}

}  // namespace

extern "C" int dup_count_launch(const void* order, const void* rect_min,
                                const void* rect_max, const void* ntt,
                                const void* binnable, const void* mean2d,
                                const void* conic, const void* q_cap,
                                const void* h_pos, int n, int d_cap,
                                int light, int heavy_cap, int tiles_x,
                                int tile, int tight, void* counts,
                                void* stream) {
  if (n == 0) return 0;
  dup_count_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>(
      rows(order, rect_min, rect_max, ntt, binnable, mean2d, conic, q_cap,
           h_pos, n, d_cap, light, heavy_cap, tiles_x, tile, tight),
      (int32_t*)counts);
  return (int)cudaGetLastError();
}

extern "C" int dup_emit_launch(const void* order, const void* rect_min,
                               const void* rect_max, const void* ntt,
                               const void* binnable, const void* mean2d,
                               const void* conic, const void* q_cap,
                               const void* h_pos, int n, int d_cap, int light,
                               int heavy_cap, int tiles_x, int tile,
                               int tight, const void* counts,
                               const void* incl, int nbits, void* keys,
                               void* stream) {
  if (n == 0) return 0;
  dup_emit_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>(
      rows(order, rect_min, rect_max, ntt, binnable, mean2d, conic, q_cap,
           h_pos, n, d_cap, light, heavy_cap, tiles_x, tile, tight),
      (const int32_t*)counts, (const int64_t*)incl, nbits, (int64_t*)keys);
  return (int)cudaGetLastError();
}
