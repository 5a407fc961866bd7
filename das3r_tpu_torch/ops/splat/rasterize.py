"""Public rasterization API: the entry-stream branch of
``das3r_tpu/ops/splat/rasterize.py``.

    image, radii, aux = rasterize(
        means3d, opacities, settings,
        viewmatrix=..., projmatrix=..., campos=..., bg=...,
        tan_fovx=..., tan_fovy=...,
        shs=... | colors_precomp=...,
        scales=... / rotations=... | cov3d_precomp=...,
        mean2d_offset=..., device=None)

The [T, K] window branch and the tile-sharded branch of the JAX package
are not ported yet (ROADMAP.md). Binning runs on detached tensors;
gradients flow through the depth-ordered attribute table: the blend
backward gives each table row its gradient, ``permute_rows`` takes it
back to Gaussian order, and autograd carries it through preprocess.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from das3r_tpu_torch.ops.splat import binning, blend, entry_blend
from das3r_tpu_torch.ops.splat import preprocess as prep_mod
from das3r_tpu_torch.ops.splat.settings import RasterSettings
from das3r_tpu_torch.utils.device import on_device, resolve_device

# Candidate light widths of the split duplication table; ``dup_hist``
# counts binnable Gaussians whose capped footprint exceeds each.
DUP_HIST_WIDTHS = (2, 4, 6, 8, 10, 12, 16, 20, 24, 28)


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, order):
        ctx.save_for_backward(order)
        return x[order]

    @staticmethod
    def backward(ctx, g):
        (order,) = ctx.saved_tensors
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], dtype=order.dtype,
                                  device=order.device)
        return g[inv], None


def permute_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``x[order]`` for a PERMUTATION ``order``, whose backward is a row
    gather by the inverse permutation (as in the JAX package) instead of
    the scatter-add autograd would emit for an arbitrary index. The
    inverse is built in the backward, so a forward-only render pays
    nothing for it."""
    return _PermuteRows.apply(x, order.detach())


class RasterAux(NamedTuple):
    n_contrib_tiles: torch.Tensor   # [T] live Gaussians per tile
    tile_overflow: torch.Tensor     # [] always 0: the stream has no capacity
    dup_overflow: torch.Tensor      # [] Gaussians whose rect was cut by D
    entry_overflow: torch.Tensor    # [] entries dropped by max_total_entries
    max_tiles_touched: torch.Tensor  # [] largest pre-cap rect tile count
    heavy_overflow: torch.Tensor    # [] always 0: no split table
    heavy_rows: torch.Tensor        # [] Gaussians beyond light_dup_width
    dup_hist: torch.Tensor          # [len(DUP_HIST_WIDTHS)] footprint counts


def _dup_telemetry(p: prep_mod.Preprocessed, settings: RasterSettings):
    """(max_tiles_touched, heavy_rows, dup_hist) from preprocess outputs."""
    ntt = torch.clamp_max(p.n_tiles_touched, settings.max_tiles_per_gaussian)
    live = p.binnable
    heavy_rows = torch.sum((ntt > settings.light_dup_width) & live)
    hist = torch.stack([torch.sum((ntt > w) & live) for w in DUP_HIST_WIDTHS])
    return torch.max(p.n_tiles_touched), heavy_rows, hist


def rasterize(
    means3d,
    opacities,
    settings: RasterSettings,
    *,
    viewmatrix,
    projmatrix,
    campos,
    bg,
    tan_fovx,
    tan_fovy,
    shs=None,
    colors_precomp=None,
    scales=None,
    rotations=None,
    cov3d_precomp=None,
    mean2d_offset=None,
    device=None,
):
    """Render N Gaussians -> ([3, H, W] image, [N] int32 radii, RasterAux).

    Array arguments may be tensors or numpy arrays; they are moved to
    ``device`` (default: CUDA, and a RuntimeError without it)."""
    s = settings
    if not s.entry_stream or s.table_bf16:
        raise NotImplementedError(
            "only the exact f32 entry-stream path is ported (ROADMAP.md)")
    dev = resolve_device(device)

    def on(x):
        return on_device(x, dev)

    if isinstance(tan_fovx, torch.Tensor):
        tan_fovx, tan_fovy = on(tan_fovx), on(tan_fovy)
    means3d = on(means3d)
    # The named ranges are the layers of a torch.profiler breakdown.
    with record_function("das3r::preprocess"):
        p = prep_mod.preprocess(
            means3d, on(opacities), s,
            viewmatrix=on(viewmatrix), projmatrix=on(projmatrix),
            campos=on(campos), shs=on(shs),
            colors_precomp=on(colors_precomp), scales=on(scales),
            rotations=on(rotations), cov3d_precomp=on(cov3d_precomp),
            mean2d_offset=on(mean2d_offset), tan_fovx=tan_fovx,
            tan_fovy=tan_fovy)
    with record_function("das3r::bin_entry_stream"):
        es = binning.bin_entry_stream(
            prep_mod.Preprocessed(*(x.detach() for x in p)), s)
    with record_function("das3r::blend"):
        attr_mat = torch.cat([p.mean2d, p.conic, p.color,
                              p.opacity[:, None]], 1)
        # depth-rank-ordered table + zero sentinel row for stream pad slots
        table = torch.cat([permute_rows(attr_mat, es.order),
                           torch.zeros_like(attr_mat[:1])])
        cpre, tfinal = entry_blend.render_tiles(table.contiguous(), es, s)
    with record_function("das3r::assemble"):
        tiles = cpre + tfinal * on(bg).reshape(1, 3, 1)       # [T, 3, P]
        img = blend.assemble_image(tiles.transpose(1, 2), s)
        mtt, hrows, hist = _dup_telemetry(p, s)
    aux = RasterAux(
        n_contrib_tiles=es.count,
        tile_overflow=torch.zeros((), dtype=torch.int64, device=dev),
        dup_overflow=es.dup_overflow,
        entry_overflow=es.entry_overflow,
        max_tiles_touched=mtt,
        heavy_overflow=es.heavy_overflow,
        heavy_rows=hrows, dup_hist=hist,
    )
    return img, p.radius, aux
