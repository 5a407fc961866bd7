"""Public rasterization API: the entry-stream and [T, K] window branches
of ``das3r_tpu/ops/splat/rasterize.py``.

    image, radii, aux = rasterize(
        means3d, opacities, settings,
        viewmatrix=..., projmatrix=..., campos=..., bg=...,
        tan_fovx=..., tan_fovy=...,
        shs=... | colors_precomp=...,
        scales=... / rotations=... | cov3d_precomp=...,
        mean2d_offset=..., device=None)

The branch follows ``settings.entry_stream`` alone: True takes the exact
entry stream, False the [T, K] window path (``bin_gaussians``, then
``window_blend``), which truncates a tile at ``max_per_tile`` entries and
reports it in ``tile_overflow``. The JAX package also takes the window
path off the TPU, without ``max_total_entries``, and when the keys do not
fit 32 bits; the port's entry stream needs none of these (its stream is
sized from the counts when ``max_total_entries`` is None, and its keys are
int64). The tile-sharded branch is not ported (ROADMAP.md).

Binning runs on detached tensors; gradients flow through the
depth-ordered attribute table: the blend backward gives each table row
(entry stream) or window slot (window path) its gradient, the gather
from rank to slot and ``permute_rows`` take it back to Gaussian order,
and autograd carries it through preprocess.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from das3r_tpu_torch.ops.splat import binning, blend, entry_blend, window_blend
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
    tile_overflow: torch.Tensor     # [] tiles over max_per_tile (window path;
                                    #    0 on the entry stream: no capacity)
    dup_overflow: torch.Tensor      # [] Gaussians whose rect was cut by D
    entry_overflow: torch.Tensor    # [] entries dropped by max_total_entries
    max_tiles_touched: torch.Tensor  # [] largest pre-cap rect tile count
    heavy_overflow: torch.Tensor    # [] heavy-row cells past heavy_rows_cap
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
    if s.table_bf16:
        raise NotImplementedError(
            "the bf16 attribute table is not ported (ROADMAP.md)")
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
    if not s.entry_stream:
        return _rasterize_windows(p, s, on(bg))
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


def _rasterize_windows(p: prep_mod.Preprocessed, s: RasterSettings, bg):
    """The [T, K] window branch (rasterize.py:204-246 of the JAX package,
    its ``backend="pallas"`` form)."""
    with record_function("das3r::bin_gaussians"):
        bins = binning.bin_gaussians(
            prep_mod.Preprocessed(*(x.detach() for x in p)), s)
    with record_function("das3r::blend"):
        attr_mat = torch.cat([p.mean2d, p.conic, p.color,
                              p.opacity[:, None]], 1)
        # depth-rank order at N scale, then the one [T, K]-scale gather by
        # rank; its backward is the per-Gaussian sum of the slot gradients
        attr_rank = permute_rows(attr_mat, bins.order)
        attrs = attr_rank[bins.rank].transpose(1, 2).contiguous()
        tiles = window_blend.blend_tiles_window(
            attrs, bins.count, bins.delta,
            bg.to(torch.float32).reshape(3).contiguous(), s)
    with record_function("das3r::assemble"):
        img = blend.assemble_image(tiles, s)
        mtt, hrows, hist = _dup_telemetry(p, s)
    aux = RasterAux(
        n_contrib_tiles=bins.full_count,
        tile_overflow=torch.sum(bins.full_count > s.max_per_tile),
        dup_overflow=bins.dup_overflow,
        entry_overflow=bins.entry_overflow,
        max_tiles_touched=mtt,
        heavy_overflow=bins.heavy_overflow,
        heavy_rows=hrows, dup_hist=hist,
    )
    return img, p.radius, aux
