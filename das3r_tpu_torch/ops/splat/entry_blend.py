"""Entry-stream blend: variable-length per-tile lists, forward and backward.

Port of ``das3r_tpu/ops/splat/entry_blend.py``. Each tile's depth-ordered
entries live at slots [astart[t], astart[t] + count[t]) of the stream built
by ``binning.bin_entry_stream``; the attribute table is indexed by depth
rank, with a zero sentinel row for pad slots. Outputs are background-free:
``cpre`` (premultiplied color) and ``tfinal`` (final transmittance); the
caller composes ``cpre + tfinal * bg``, so the bg gradient rides ordinary
autograd.

The backward is the CUDA rasterizer's suffix form: walking each tile's
list back to front with S = gT * T_final + sum over later entries of
(gC . c) w, it gives every table row the gradient of its mean2d, conic,
color and opacity. Two versions, as for the forward:

* the plain PyTorch version (``blend_backward_plain``) is the JAX kernel's
  algorithm batched over tiles: reverse chunk walk, replay of each chunk
  from the per-chunk transmittance ``tin`` of the plain forward;
* the CUDA kernel (csrc/blend_backward.cu) walks each pixel's list from its
  last contributing entry (``n_last``, saved by the forward kernel) and
  restores T before each entry from T_final by division.

A call may blend one range of tiles instead of the whole image (the
tile-sharded render, ``rasterize.render_range``): ``tile0`` is the global
index of its first tile and ``n_tiles_out`` its tile count. The stream's
per-tile arrays (``astart``, ``count``) and every output row are local to
the range; only the pixel coordinates come from the global tile grid, as
in the JAX kernels (``_pixel_coords(s, tile0 + tid)``). A tile past the
image, in the padded tail of the last range, has count 0 and gives
(cpre, tfinal) = (0, 1).

Attribute columns of the table:
    0: mean2d_x  1: mean2d_y  2: conic_xx  3: conic_xy  4: conic_yy
    5: color_r   6: color_g   7: color_b   8: opacity
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from das3r_tpu_torch.ops.splat import kernels
from das3r_tpu_torch.ops.splat.binning import CHUNK, EntryStream
from das3r_tpu_torch.ops.splat.settings import RasterSettings

N_ATTR = 9


class PlainBlend(NamedTuple):
    cpre: torch.Tensor        # [T, 3, P] premultiplied color
    tfinal: torch.Tensor      # [T, 1, P] final (CUDA-visible) transmittance
    n_eval: torch.Tensor      # [T, P] entries each pixel's serial loop
                              # tests: a prefix of the tile's list
    chunks_skipped: int       # live tile chunks skipped as saturated
    tin: torch.Tensor         # [E_al/128, P] running T entering each chunk
    n_last: torch.Tensor      # [T, P] int32 list positions up to and
                              # including the last contributing entry


class PlainBlendGrad(NamedTuple):
    g_table: torch.Tensor     # [M, 9] gradient of each table row
    chunks_skipped: int       # live tile chunks skipped as saturated


def _tile_pixels(settings: RasterSettings, n_tiles: int, dev,
                 tile0: int = 0):
    """(px, py) [T, P] float pixel coordinates of the pixels of tiles
    [tile0, tile0 + n_tiles) of the image's tile grid."""
    s = settings
    P = s.tile * s.tile
    pix = torch.arange(P, device=dev)
    tiles = tile0 + torch.arange(n_tiles, device=dev)
    px = ((tiles % s.tiles_x) * s.tile)[:, None] + pix % s.tile
    py = ((tiles // s.tiles_x) * s.tile)[:, None] + pix // s.tile
    return px.to(torch.float32), py.to(torch.float32)


def _chunk_math(attr, px, py, t_in, settings: RasterSettings, live=None):
    """Per-(pixel, entry) quantities of one chunk for a batch of tiles:
    attr [Ta, C, 9], px/py/t_in [Ta, P] -> tensors [Ta, P, C]
    (``_chunk_math`` of the JAX kernel, with a cumulative product in place
    of its exp-of-log-sum). ``live`` [Ta, C], when given, marks the slots
    that may be valid at all."""
    s = settings
    a_mx, a_my, a_cxx, a_cxy, a_cyy = (attr[:, None, :, i] for i in range(5))
    a_op = attr[:, None, :, 8]
    dx = a_mx - px[:, :, None]
    dy = a_my - py[:, :, None]
    power = -0.5 * (a_cxx * dx * dx + a_cyy * dy * dy) - a_cxy * dx * dy
    alpha_raw = a_op * torch.exp(power)
    alpha = torch.clamp_max(alpha_raw, s.alpha_clip)
    valid = (power <= 0.0) & (alpha >= s.alpha_floor)
    if live is not None:
        valid = valid & live[:, None, :]
    a = torch.where(valid, alpha, torch.zeros_like(alpha))
    one_m = 1.0 - a
    prod = torch.cumprod(torch.cat([t_in[:, :, None], one_m], 2), 2)
    cum_before, t_after = prod[:, :, :-1], prod[:, :, 1:]
    contribute = valid & (t_after >= s.transmittance_eps)
    w = torch.where(contribute, a * cum_before, torch.zeros_like(a))
    return dict(dx=dx, dy=dy, alpha_raw=alpha_raw, one_m=one_m,
                cum_before=cum_before, t_after=t_after,
                contribute=contribute, w=w)


def _chunk_grads(attr, m, g_col, svec, settings: RasterSettings):
    """The JAX backward kernel's per-entry gradients of one chunk, from
    ``_chunk_math``'s quantities ``m``, the colour cotangents g_col
    [Ta, P, 3] and the suffix carried in from later entries svec [Ta, P].
    Per entry and pixel: dalpha = (g . c) T_before - S_i / (1 - alpha)
    where the entry contributes (S_i: svec plus the later entries of the
    chunk), zeroed where alpha_raw > alpha_clip; the mean2d, conic and
    opacity terms follow through the power. Returns (g_rows [Ta, C, 9],
    the chunk's suffix sum to add to svec [Ta, P])."""
    s = settings
    dx, dy, w, alpha_raw = m["dx"], m["dy"], m["w"], m["alpha_raw"]
    gc_dot = torch.bmm(g_col, attr[:, :, 5:8].transpose(1, 2))
    e = gc_dot * w
    # S_i = S + sum_{j > i} e_j: an exclusive suffix sum over the chunk
    incl = torch.cumsum(e.flip(2), 2).flip(2)
    s_i = (torch.cat([incl[:, :, 1:], torch.zeros_like(incl[:, :, :1])], 2)
           + svec[:, :, None])
    d_alpha = torch.where(
        m["contribute"],
        gc_dot * m["cum_before"] - s_i / torch.clamp_min(m["one_m"], 1e-12),
        torch.zeros_like(w))
    d_alpha_raw = torch.where(alpha_raw > s.alpha_clip,
                              torch.zeros_like(d_alpha), d_alpha)
    d_power = alpha_raw * d_alpha_raw
    a_cxx, a_cxy, a_cyy = (attr[:, None, :, i] for i in (2, 3, 4))
    a_op = attr[:, None, :, 8]
    g_rows = torch.stack([
        (-(a_cxx * dx + a_cxy * dy) * d_power).sum(1),
        (-(a_cyy * dy + a_cxy * dx) * d_power).sum(1),
        (-0.5 * dx * dx * d_power).sum(1),
        (-dx * dy * d_power).sum(1),
        (-0.5 * dy * dy * d_power).sum(1),
        *torch.bmm(w.transpose(1, 2), g_col).unbind(2),
        ((alpha_raw / torch.clamp_min(a_op, 1e-30)) * d_alpha_raw).sum(1),
    ], 2)
    return g_rows, e.sum(2)


def _check_range(count: torch.Tensor, settings: RasterSettings,
                 tile0: int, n_tiles_out: int | None) -> int:
    """The tile count of a range; raise unless ``count`` holds it."""
    n_tiles_out = settings.n_tiles if n_tiles_out is None else n_tiles_out
    if count.dim() != 1 or count.shape[0] != n_tiles_out:
        raise ValueError(f"astart/count must hold {n_tiles_out} tiles, "
                         f"got {tuple(count.shape)}")
    if not 0 <= tile0 < 2**31 - n_tiles_out:
        raise ValueError(f"tile0={tile0} out of range")
    return n_tiles_out


def blend_forward_plain(table: torch.Tensor, rank: torch.Tensor,
                        astart: torch.Tensor, count: torch.Tensor,
                        settings: RasterSettings, tile0: int = 0,
                        n_tiles_out: int | None = None) -> PlainBlend:
    """The JAX kernel's algorithm written out in torch, batched over tiles.

    Walks chunks of 128 entries; each chunk's transmittance comes from one
    cumulative product seeded with the carried running T. Two
    transmittances are carried per pixel, as in the TPU kernel: ``trun``,
    the running product committed even past eps (the sticky ``done`` bit in
    product form), and ``tacc``, the T after the last contributing entry. A
    tile's chunk is skipped, exactly, once every pixel has trun < eps.
    ``tin`` records trun entering every chunk of a tile, skipped or not,
    as the TPU kernel saves it for its backward. ``tile0`` and
    ``n_tiles_out`` name the tile range (module docstring).
    """
    s = settings
    dev = table.device
    P = s.tile * s.tile
    n_tiles = _check_range(count, s, tile0, n_tiles_out)
    px, py = _tile_pixels(s, n_tiles, dev, tile0)

    cacc = torch.zeros(n_tiles, P, 3, device=dev)
    tacc = torch.ones(n_tiles, P, device=dev)
    trun = torch.ones(n_tiles, P, device=dev)
    n_eval = torch.zeros(n_tiles, P, dtype=torch.int64, device=dev)
    n_last = torch.zeros(n_tiles, P, dtype=torch.int32, device=dev)
    tin = torch.ones(rank.shape[0] // CHUNK, P, device=dev)
    n_chunks = (count.to(torch.int64) + CHUNK - 1) // CHUNK
    chunk0 = astart.to(torch.int64) // CHUNK
    lane = torch.arange(CHUNK, device=dev)
    skipped = 0
    for k in range(int(n_chunks.max()) if n_tiles else 0):
        has = n_chunks > k
        hi = has.nonzero().squeeze(1)
        tin[chunk0[hi] + k] = trun[hi]
        go = has & (trun.amax(1) >= s.transmittance_eps)
        skipped += int((has & ~go).sum())
        ti = go.nonzero().squeeze(1)
        if ti.numel() == 0:
            continue
        attr = table[rank[(chunk0[ti] + k)[:, None] * CHUNK + lane]]
        m = _chunk_math(attr, px[ti], py[ti], trun[ti], s)
        contribute = m["contribute"]
        cacc[ti] += torch.bmm(m["w"], attr[:, :, 5:8])
        tacc[ti] = torch.amin(torch.where(
            contribute, m["t_after"], tacc[ti][:, :, None]), 2)
        trun[ti] = m["t_after"][:, :, -1]
        live = (k * CHUNK + lane) < count[ti][:, None]       # not a pad
        n_eval[ti] += ((m["cum_before"] >= s.transmittance_eps)
                       & live[:, None, :]).sum(2)
        # position after the chunk's last contributing entry
        last = CHUNK - torch.argmax(contribute.flip(2).to(torch.int8), 2)
        n_last[ti] = torch.where(contribute.any(2),
                                 (k * CHUNK + last).to(torch.int32),
                                 n_last[ti])
    return PlainBlend(cpre=cacc.transpose(1, 2).contiguous(),
                      tfinal=tacc[:, None, :], n_eval=n_eval,
                      chunks_skipped=skipped, tin=tin, n_last=n_last)


def blend_backward_plain(table: torch.Tensor, rank: torch.Tensor,
                         astart: torch.Tensor, count: torch.Tensor,
                         settings: RasterSettings, tfinal: torch.Tensor,
                         tin: torch.Tensor, g_cpre: torch.Tensor,
                         g_tfinal: torch.Tensor, tile0: int = 0,
                         n_tiles_out: int | None = None) -> PlainBlendGrad:
    """The JAX ``_backward_kernel``'s algorithm batched over tiles, with
    its reduction of per-entry gradients to table rows (``_bwd``).

    Walks each tile's chunks in reverse, replays each chunk's forward from
    ``tin`` (``blend_forward_plain``), and carries the suffix
    S = gT * T_final + sum over later entries of (gC . c) w per pixel
    (``_chunk_grads`` gives each entry's terms). A chunk whose entering T
    is below eps at every pixel holds no contributing entry and is
    skipped, exactly, as in the forward. ``tile0`` and ``n_tiles_out``
    name the tile range (module docstring)."""
    s = settings
    dev = table.device
    n_tiles = _check_range(count, s, tile0, n_tiles_out)
    px, py = _tile_pixels(s, n_tiles, dev, tile0)
    g_col = g_cpre.transpose(1, 2)                         # [T, P, 3]
    svec = (g_tfinal[:, 0, :] * tfinal[:, 0, :]).clone()   # [T, P]
    g_table = torch.zeros_like(table)
    n_chunks = (count.to(torch.int64) + CHUNK - 1) // CHUNK
    chunk0 = astart.to(torch.int64) // CHUNK
    lane = torch.arange(CHUNK, device=dev)
    skipped = 0
    for k in reversed(range(int(n_chunks.max()) if n_tiles else 0)):
        has = n_chunks > k
        cidx = torch.where(has, chunk0 + k, torch.zeros_like(chunk0))
        go = has & (tin[cidx].amax(1) >= s.transmittance_eps)
        skipped += int((has & ~go).sum())
        ti = go.nonzero().squeeze(1)
        if ti.numel() == 0:
            continue
        r = rank[(chunk0[ti] + k)[:, None] * CHUNK + lane]  # [Ta, CHUNK]
        attr = table[r]
        m = _chunk_math(attr, px[ti], py[ti], tin[cidx[ti]], s)
        g_rows, e_sum = _chunk_grads(attr, m, g_col[ti], svec[ti], s)
        g_table.index_add_(0, r.reshape(-1), g_rows.reshape(-1, N_ATTR))
        svec[ti] += e_sum
    return PlainBlendGrad(g_table=g_table, chunks_skipped=skipped)


def _check_stream(table, rank, astart, count, settings: RasterSettings,
                  tile0: int, n_tiles_out: int | None) -> int:
    """Raise unless the CUDA kernels can take this table and stream;
    return the range's tile count."""
    s = settings
    if s.tile != 16:
        raise ValueError(f"the blend kernels need 16x16 tiles, got {s.tile}")
    kernels.check(table, "table", torch.float32, 2)
    kernels.check(rank, "rank", torch.int32, 1, table.device)
    kernels.check(astart, "astart", torch.int32, 1, table.device)
    kernels.check(count, "count", torch.int32, 1, table.device)
    if table.shape[1] != N_ATTR:
        raise ValueError(f"table must be [M, {N_ATTR}], got "
                         f"{tuple(table.shape)}")
    if astart.shape != count.shape:
        raise ValueError(f"astart {tuple(astart.shape)} != count "
                         f"{tuple(count.shape)}")
    return _check_range(count, s, tile0, n_tiles_out)


def blend_forward(table: torch.Tensor, rank: torch.Tensor,
                  astart: torch.Tensor, count: torch.Tensor,
                  settings: RasterSettings, for_backward: bool = False,
                  tile0: int = 0, n_tiles_out: int | None = None):
    """(cpre [T, 3, P], tfinal [T, 1, P]) of each tile's front-to-back blend;
    with ``for_backward`` also ``n_last`` [T, P] int32, one past each
    pixel's last contributing entry, which ``blend_backward`` starts from.
    T is ``n_tiles_out`` (default: the image's), the tiles from ``tile0``
    on (module docstring).

    Replaces the TPU kernel ``das3r_tpu/ops/splat/entry_blend.py::
    _forward_kernel`` together with the ``table[rank]`` gather before it.
    On the H100 it is bound by operations (~15 FP32 operations and one exp
    per pixel-entry evaluation), so the kernel (csrc/blend_forward.cu) cuts
    the instructions around each evaluation as kernel D does: two pixels
    per thread, each batch's table rows copied by rank into padded
    shared-memory rows, and the branch-free step that kernels C, D and E
    share (csrc/blend_step.cuh); the block leaves the tile once its pixels
    are saturated. Without ``for_backward`` it launches the instantiation
    that neither tracks nor writes ``n_last`` and evaluates four entries
    before it blends them.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel.
    """
    if table.device.type == "cpu":
        out = blend_forward_plain(table, rank, astart, count, settings,
                                  tile0, n_tiles_out)
        if for_backward:
            return out.cpre, out.tfinal, out.n_last
        return out.cpre, out.tfinal
    s = settings
    n_tiles = _check_stream(table, rank, astart, count, s, tile0,
                            n_tiles_out)
    P = s.tile * s.tile
    cpre = torch.empty(n_tiles, 3, P, device=table.device)
    tfinal = torch.empty(n_tiles, 1, P, device=table.device)
    n_last = (torch.empty(n_tiles, P, dtype=torch.int32, device=table.device)
              if for_backward else None)
    kernels.launch("blend_forward", table.data_ptr(), rank.data_ptr(),
                   astart.data_ptr(), count.data_ptr(), n_tiles, tile0,
                   s.tiles_x, s.alpha_clip, s.alpha_floor, s.transmittance_eps,
                   cpre.data_ptr(), tfinal.data_ptr(),
                   None if n_last is None else n_last.data_ptr())
    blend_forward.launches += 1
    if for_backward:
        return cpre, tfinal, n_last
    return cpre, tfinal


blend_forward.launches = 0


def blend_backward(table: torch.Tensor, rank: torch.Tensor,
                   astart: torch.Tensor, count: torch.Tensor,
                   settings: RasterSettings, tfinal: torch.Tensor,
                   n_last: torch.Tensor, g_cpre: torch.Tensor,
                   g_tfinal: torch.Tensor, tile0: int = 0,
                   n_tiles_out: int | None = None) -> torch.Tensor:
    """g_table [M, 9]: the gradient of every table row, given the
    cotangents of ``cpre`` and ``tfinal`` and the forward's ``tfinal`` and
    ``n_last`` (``blend_forward(..., for_backward=True)``), for the range
    of ``n_tiles_out`` tiles from ``tile0`` (module docstring).

    Replaces the TPU kernel ``das3r_tpu/ops/splat/entry_blend.py::
    _backward_kernel`` and the XLA reduction of its per-entry gradients to
    table rows (``_bwd``). On the H100 it is bound by operations (~55 FP32
    operations, one exp and one reciprocal per pixel-entry evaluation), so
    the kernel (csrc/blend_backward.cu) visits only the list prefix that
    the forward's pixels reached, in batches of 16 entries: each pixel
    sweeps a batch back to front and leaves two scalars per entry in
    shared memory, then each entry's nine sums are reduced over the tile's
    pixels in registers, combined in a fixed order and added into the table
    rows with one atomic per entry and column. A CPU tensor
    takes the plain version, which replays each chunk from the per-chunk
    transmittance of the plain forward, run again here (it does not need
    ``n_last``); a CUDA tensor launches the kernel.
    """
    if table.device.type == "cpu":
        fwd = blend_forward_plain(table, rank, astart, count, settings,
                                  tile0, n_tiles_out)
        return blend_backward_plain(table, rank, astart, count, settings,
                                    fwd.tfinal, fwd.tin, g_cpre, g_tfinal,
                                    tile0, n_tiles_out).g_table
    s = settings
    n_tiles = _check_stream(table, rank, astart, count, s, tile0,
                            n_tiles_out)
    P = s.tile * s.tile
    for t, name, dtype, shape in (
            (tfinal, "tfinal", torch.float32, (n_tiles, 1, P)),
            (n_last, "n_last", torch.int32, (n_tiles, P)),
            (g_cpre, "g_cpre", torch.float32, (n_tiles, 3, P)),
            (g_tfinal, "g_tfinal", torch.float32, (n_tiles, 1, P))):
        kernels.check(t, name, dtype, len(shape), table.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    g_table = torch.zeros_like(table)
    kernels.launch("blend_backward", table.data_ptr(), rank.data_ptr(),
                   astart.data_ptr(), count.data_ptr(), n_tiles, tile0,
                   s.tiles_x, s.alpha_clip, s.alpha_floor, tfinal.data_ptr(),
                   n_last.data_ptr(), g_cpre.data_ptr(), g_tfinal.data_ptr(),
                   g_table.data_ptr())
    blend_backward.launches += 1
    return g_table


blend_backward.launches = 0


class _BlendEntryStream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, rank, astart, count, settings, tile0,
                n_tiles_out):
        rng = dict(tile0=tile0, n_tiles_out=n_tiles_out)
        if not ctx.needs_input_grad[0]:
            return blend_forward(table, rank, astart, count, settings, **rng)
        cpre, tfinal, n_last = blend_forward(table, rank, astart, count,
                                             settings, True, **rng)
        ctx.save_for_backward(table, rank, astart, count, tfinal, n_last)
        ctx.settings, ctx.rng = settings, rng
        return cpre, tfinal

    @staticmethod
    def backward(ctx, g_cpre, g_tfinal):
        table, rank, astart, count, tfinal, n_last = ctx.saved_tensors
        with record_function("das3r::blend_backward"):
            g_table = blend_backward(table, rank, astart, count,
                                     ctx.settings, tfinal, n_last,
                                     g_cpre.contiguous(),
                                     g_tfinal.contiguous(), **ctx.rng)
        return g_table, None, None, None, None, None, None


def blend_entry_stream(table, rank, astart, count,
                       settings: RasterSettings, tile0: int = 0,
                       n_tiles_out: int | None = None):
    """table [N+1, 9] (row N = zero sentinel), rank [E_al] int32, astart
    and count [T] int32 -> (cpre [T, 3, P], tfinal [T, 1, P]); an empty
    tile is (0, 1). T is ``n_tiles_out`` (default: the image's), the tiles
    from ``tile0`` on. Differentiable in ``table``."""
    return _BlendEntryStream.apply(table, rank, astart, count, settings,
                                   tile0, n_tiles_out)


def render_tiles(table: torch.Tensor, stream: EntryStream,
                 settings: RasterSettings, tile0: int = 0,
                 n_tiles_out: int | None = None):
    """Blend every tile of ``stream`` (a range's stream from
    ``binning.entry_stream_from_keys(tile0, t_loc)`` with ``n_tiles_out =
    t_loc``); see ``blend_entry_stream``."""
    return blend_entry_stream(table, stream.rank, stream.astart,
                              stream.count, settings, tile0, n_tiles_out)
