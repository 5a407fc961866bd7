"""Static rasterization settings.

The same fields and the same ``tiles_x`` / ``tiles_y`` / ``n_tiles``
properties as ``das3r_tpu/ops/splat/settings.py``, so that one config can be
handed to both packages. Fields the JAX package needs only because XLA
shapes are static keep their names and defaults here; the port reads them
as follows:

* ``max_total_entries``: ``None`` (the default) sizes the entry stream from
  the real per-tile counts, which eager PyTorch knows, so nothing is ever
  dropped. A set value keeps the JAX package's farthest-first drop policy
  and its ``entry_overflow`` report.
* ``full_sort_below``: with ``max_total_entries`` set, duplication tables
  larger than this are compacted to the cap before the sort (dropping the
  farthest entries), as in the JAX package.
* ``tile`` must be 16 on the GPU: every blend kernel maps a 16x16 tile
  onto one block.
* ``entry_stream`` alone picks the raster branch: True the exact entry
  stream, False the [T, K] window path, whose windows hold
  ``max_per_tile`` slots (a multiple of 128 or a divisor of 128) and are
  cut by the ``extract_windows`` kernel or, with ``use_dma_windows=False``,
  by the aligned row gather. The JAX package also falls back to the window
  path off the TPU and without ``max_total_entries``; the port does not.
* ``heavy_rows_cap`` and ``light_dup_width``: the split-width duplication
  table, as in the JAX package (binning.py), on both raster branches.
* ``entries_per_shard``: the stream capacity of one tile range of the
  tile-sharded render (``rasterize.render_range``); unset, a range takes
  the global cap, or, with ``max_total_entries`` None, is sized from its
  counts.
* Not ported (ROADMAP.md): the quantized-depth
  binning (``depth_sort_bits > 0`` raises), the backward reduction
  options (``segsum_*``) and ``table_bf16`` (rasterize raises).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    image_height: int
    image_width: int
    sh_degree: int = 3
    near: float = 0.001         # patched near-plane cull threshold
    scale_modifier: float = 1.0
    tile: int = 16              # tile side in pixels
    max_per_tile: int = 1024
    max_tiles_per_gaussian: int = 64  # duplication cap D during binning
    alpha_floor: float = 1.0 / 255.0  # CUDA skip threshold
    transmittance_eps: float = 1e-4   # CUDA early-termination threshold
    alpha_clip: float = 0.99
    max_total_entries: int | None = None
    full_sort_below: int = 64_000_000
    depth_sort_bits: int = 0
    # Exact opacity-aware binning: shrink the rect to the alpha-floor
    # isoline and keep a (Gaussian, tile) pair only if the conic quadratic
    # can reach alpha >= floor inside the tile (image-preserving).
    tight_binning: bool = True
    use_dma_windows: bool = True
    entry_stream: bool = True
    entries_per_shard: int | None = None
    light_dup_width: int = 4
    heavy_rows_cap: int | None = None
    segsum_grad_reduce: bool = True
    segsum_min_rows: int = 500_000
    table_bf16: bool = False

    @property
    def tiles_x(self) -> int:
        return -(-self.image_width // self.tile)

    @property
    def tiles_y(self) -> int:
        return -(-self.image_height // self.tile)

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y
