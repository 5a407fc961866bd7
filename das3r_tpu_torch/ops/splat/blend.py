"""Tile-to-image assembly (``das3r_tpu/ops/splat/blend.py::assemble_image``).

The port has two raster paths, the entry stream (``entry_blend``) and the
[T, K] window path (``window_blend``), and both end here. The JAX
package's XLA window blends have their counterparts there:
``blend_tiles`` computes the function of ``window_blend.
window_forward_plain`` (tests/test_torch_window_options.py holds the two
within 2e-4 on the same bins), and the tile-sharded ``blend_tiles_sharded``
is ``rasterize.window_range`` on each rank of the tile group, through
kernels D and E in their tile-range form.
"""
from __future__ import annotations

import torch

from das3r_tpu_torch.ops.splat.settings import RasterSettings


def assemble_image(tiles: torch.Tensor,
                   settings: RasterSettings) -> torch.Tensor:
    """[T, P, 3] per-tile pixels -> [3, H, W] (tiles x-fastest, pixels
    x-fastest within a tile)."""
    s = settings
    t = s.tile
    img = tiles.reshape(s.tiles_y, s.tiles_x, t, t, 3)
    img = img.permute(0, 2, 1, 3, 4).reshape(s.tiles_y * t, s.tiles_x * t, 3)
    img = img[: s.image_height, : s.image_width]
    return img.permute(2, 0, 1)
