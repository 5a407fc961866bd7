"""Public rasterization API: the entry-stream and [T, K] window branches
of ``das3r_tpu/ops/splat/rasterize.py``.

    image, radii, aux = rasterize(
        means3d, opacities, settings,
        viewmatrix=..., projmatrix=..., campos=..., bg=...,
        tan_fovx=..., tan_fovy=...,
        shs=... | colors_precomp=...,
        scales=... / rotations=... | cov3d_precomp=...,
        mean2d_offset=..., device=None,
        tile_group=None, gauss_group=None)

The branch follows ``settings.entry_stream`` alone: True takes the exact
entry stream, False the [T, K] window path (``bin_gaussians``, then
``window_blend``), which truncates a tile at ``max_per_tile`` entries and
reports it in ``tile_overflow``. The JAX package also takes the window
path off the TPU, without ``max_total_entries``, and when the keys do not
fit 32 bits; the port's entry stream needs none of these (its stream is
sized from the counts when ``max_total_entries`` is None, and its keys are
int64).

Multi-device (``parallel/``): with ``gauss_group`` the per-Gaussian inputs
are this rank's slice of the Gaussians; preprocess runs on the slice and
its outputs are gathered over the group before binning, whose sort is
global. With ``tile_group`` (entry stream only, as in the JAX package's
Pallas path; its tile-sharded window path is an XLA blend, not ported)
each rank of the group blends one tile range (``render_range``) and the
ranges' rows are gathered, so the image is whole on every rank
(``_entry_stream_sharded``).

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
from das3r_tpu_torch.parallel import collectives
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
    tile_group=None,
    gauss_group=None,
):
    """Render N Gaussians -> ([3, H, W] image, [N] int32 radii, RasterAux).

    Array arguments may be tensors or numpy arrays; they are moved to
    ``device`` (default: CUDA, and a RuntimeError without it).
    ``tile_group`` and ``gauss_group``: process groups of the mesh's tile
    and Gaussian axes (module docstring); with ``gauss_group`` the
    per-Gaussian inputs are this rank's slice and ``radii`` covers every
    rank's Gaussians."""
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
    if collectives.size(gauss_group) > 1:
        with record_function("das3r::gather_gaussians"):
            p = gather_preprocessed(p, gauss_group)
    if collectives.size(tile_group) > 1:
        if not s.entry_stream:
            raise NotImplementedError(
                "tile sharding runs on the entry stream; the JAX package's "
                "tile-sharded window path is an XLA blend, not ported")
        return _entry_stream_sharded(p, s, on(bg), tile_group)
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


# Preprocessed fields gathered over the Gaussian axis, by dtype: the float
# block carries the gradients; the int block is the binning's integers.
_FLOAT_FIELDS = {"mean2d": 2, "depth": 1, "conic": 3, "color": 3,
                 "opacity": 1, "q_cap": 1}
_INT_FIELDS = {"radius": 1, "rect_min": 2, "rect_max": 2,
               "n_tiles_touched": 1, "binnable": 1}


def gather_preprocessed(p: prep_mod.Preprocessed,
                        group) -> prep_mod.Preprocessed:
    """Every rank's preprocess outputs, concatenated in rank order: two
    gathers (the float fields, differentiable, and the integer ones). The
    gather's backward gives this rank the gradient of its own Gaussians
    (``collectives.gather_rows``); the JAX package's counterpart is the
    replicating sharding constraint (rasterize.py:150-156), whose
    transpose reshards the per-Gaussian gradients."""
    def block(fields, dtype):
        return torch.cat([getattr(p, k).reshape(-1, w).to(dtype)
                          for k, w in fields.items()], 1)

    floats = collectives.gather_rows(block(_FLOAT_FIELDS, torch.float32),
                                     group, "gaussians_float")
    ints = collectives.gather_blocks(block(_INT_FIELDS, torch.int32),
                                     group, "gaussians_int")
    out = {}
    for fields, gathered in ((_FLOAT_FIELDS, floats), (_INT_FIELDS, ints)):
        i = 0
        for k, w in fields.items():
            x = gathered[:, i:i + w]
            out[k] = (x if getattr(p, k).dim() == 2 else x[:, 0]).to(
                getattr(p, k).dtype)
            i += w
    return prep_mod.Preprocessed(**out)


def range_tiles(settings: RasterSettings, n_ranges: int) -> int:
    """Tiles per range when the image is cut into ``n_ranges`` ranges:
    ceil(T / n_ranges); the last range's tail past the image is padding."""
    return -(-settings.n_tiles // n_ranges)


def range_capacity(settings: RasterSettings, n: int) -> int | None:
    """A range's stream capacity: ``entries_per_shard``, else the global
    cap, rounded up to 1024 as in the JAX package; None (the port's
    default) sizes each range's stream from its counts."""
    cap = settings.entries_per_shard or binning.entry_stream_cap(settings, n)
    return None if cap is None else -(-cap // 1024) * 1024


def render_range(table: torch.Tensor, ks: binning.SortedKeyStream,
                 settings: RasterSettings, n: int, n_ranges: int,
                 index: int):
    """Tile range ``index`` of ``n_ranges``: tiles [index * t_loc, (index +
    1) * t_loc), t_loc = ``range_tiles``, laid out from the sorted keys
    ``ks`` of all N = ``n`` Gaussians (at ``range_capacity``) and blended
    with the depth-rank ``table`` [N + 1, 9] by kernels A, B and C in their
    tile-range form. Returns (cpre [t_loc, 3, P], tfinal [t_loc, 1, P], the
    range's ``EntryStream``), rows local to the range; its
    ``entry_overflow`` counts ``ks``'s drops and the range's own."""
    t_loc = range_tiles(settings, n_ranges)
    tile0 = index * t_loc
    es = binning.entry_stream_from_keys(ks, settings, n,
                                        range_capacity(settings, n), tile0,
                                        t_loc)
    cpre, tfinal = entry_blend.render_tiles(table, es, settings, tile0, t_loc)
    return cpre, tfinal, es


def _entry_stream_sharded(p: prep_mod.Preprocessed, s: RasterSettings, bg,
                          tile_group):
    """Tile-sharded entry-stream render (``_entry_stream_sharded`` of the
    JAX package, rasterize.py:249-322). Every rank of ``tile_group`` sorts
    the keys (the same sort on every rank) and builds the table; rank i
    renders range i (``render_range``); the ranges' tile rows, counts and
    drops are gathered, so every rank holds the whole image. The table's
    gradient is summed over the group, where each rank gives the gradient
    of its own range: JAX's psum at the replicated table's transpose."""
    n = p.depth.shape[0]
    n_ranges, index = collectives.size(tile_group), collectives.index(
        tile_group)
    with record_function("das3r::bin_entry_stream"):
        ks = binning._sorted_key_stream(
            prep_mod.Preprocessed(*(x.detach() for x in p)), s)
    with record_function("das3r::blend"):
        attr_mat = torch.cat([p.mean2d, p.conic, p.color,
                              p.opacity[:, None]], 1)
        table = torch.cat([permute_rows(attr_mat, ks.order),
                           torch.zeros_like(attr_mat[:1])])
        (table,) = collectives.sum_grads(tile_group, "table_grad", table)
        cpre, tfinal, es = render_range(table, ks, s, n, n_ranges, index)
    with record_function("das3r::gather_tiles"):
        rows = collectives.gather_rows(torch.cat([cpre, tfinal], 1),
                                       tile_group, "tiles")[:s.n_tiles]
        drop = es.entry_overflow - ks.entry_overflow
        counts = collectives.gather_blocks(
            torch.cat([es.count.to(torch.int64), drop.reshape(1)]),
            tile_group, "counts").reshape(n_ranges, -1)
    with record_function("das3r::assemble"):
        tiles = rows[:, :3] + rows[:, 3:] * bg.reshape(1, 3, 1)
        img = blend.assemble_image(tiles.transpose(1, 2), s)
        mtt, hrows, hist = _dup_telemetry(p, s)
    aux = RasterAux(
        n_contrib_tiles=counts[:, :-1].reshape(-1)[:s.n_tiles].to(
            torch.int32),
        tile_overflow=torch.zeros((), dtype=torch.int64, device=bg.device),
        dup_overflow=ks.dup_overflow,
        entry_overflow=ks.entry_overflow + counts[:, -1].sum(),
        max_tiles_touched=mtt,
        heavy_overflow=ks.heavy_overflow,
        heavy_rows=hrows, dup_hist=hist,
    )
    return img, p.radius, aux
