"""Entry-stream blend: variable-length per-tile lists, forward only.

Port of the forward of ``das3r_tpu/ops/splat/entry_blend.py``. Each tile's
depth-ordered entries live at slots [astart[t], astart[t] + count[t]) of
the stream built by ``binning.bin_entry_stream``; the attribute table is
indexed by depth rank, with a zero sentinel row for pad slots. Outputs are
background-free: ``cpre`` (premultiplied color) and ``tfinal`` (final
transmittance); the caller composes ``cpre + tfinal * bg``.

Attribute columns of the table:
    0: mean2d_x  1: mean2d_y  2: conic_xx  3: conic_xy  4: conic_yy
    5: color_r   6: color_g   7: color_b   8: opacity

The gradients of the render (``entry_blend._backward_kernel`` on the TPU)
are the next slice of the port (ROADMAP.md queue 1, "gradients of the
render"); until then the backward raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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


def blend_forward_plain(table: torch.Tensor, rank: torch.Tensor,
                        astart: torch.Tensor, count: torch.Tensor,
                        settings: RasterSettings) -> PlainBlend:
    """The JAX kernel's algorithm written out in torch, batched over tiles.

    Walks chunks of 128 entries; each chunk's transmittance comes from one
    cumulative product seeded with the carried running T. Two
    transmittances are carried per pixel, as in the TPU kernel: ``trun``,
    the running product committed even past eps (the sticky ``done`` bit in
    product form), and ``tacc``, the T after the last contributing entry. A
    tile's chunk is skipped, exactly, once every pixel has trun < eps.
    """
    s = settings
    dev = table.device
    P = s.tile * s.tile
    n_tiles = count.shape[0]
    pix = torch.arange(P, device=dev)
    tiles = torch.arange(n_tiles, device=dev)
    px = ((tiles % s.tiles_x) * s.tile)[:, None] + pix % s.tile
    py = ((tiles // s.tiles_x) * s.tile)[:, None] + pix // s.tile
    px, py = px.to(torch.float32), py.to(torch.float32)

    cacc = torch.zeros(n_tiles, P, 3, device=dev)
    tacc = torch.ones(n_tiles, P, device=dev)
    trun = torch.ones(n_tiles, P, device=dev)
    n_eval = torch.zeros(n_tiles, P, dtype=torch.int64, device=dev)
    n_chunks = (count.to(torch.int64) + CHUNK - 1) // CHUNK
    chunk0 = astart.to(torch.int64) // CHUNK
    lane = torch.arange(CHUNK, device=dev)
    skipped = 0
    for k in range(int(n_chunks.max()) if n_tiles else 0):
        has = n_chunks > k
        go = has & (trun.amax(1) >= s.transmittance_eps)
        skipped += int((has & ~go).sum())
        ti = go.nonzero().squeeze(1)
        if ti.numel() == 0:
            continue
        attr = table[rank[(chunk0[ti] + k)[:, None] * CHUNK + lane]]
        a_mx, a_my, a_cxx, a_cxy, a_cyy = (attr[:, None, :, i]
                                           for i in range(5))
        a_op = attr[:, None, :, 8]
        dx = a_mx - px[ti][:, :, None]                     # [Ta, P, CHUNK]
        dy = a_my - py[ti][:, :, None]
        power = -0.5 * (a_cxx * dx * dx + a_cyy * dy * dy) - a_cxy * dx * dy
        alpha = torch.clamp_max(a_op * torch.exp(power), s.alpha_clip)
        valid = (power <= 0.0) & (alpha >= s.alpha_floor)
        a = torch.where(valid, alpha, torch.zeros_like(alpha))
        t_in = trun[ti]
        prod = torch.cumprod(torch.cat([t_in[:, :, None], 1.0 - a], 2), 2)
        cum_before, t_after = prod[:, :, :-1], prod[:, :, 1:]
        contribute = valid & (t_after >= s.transmittance_eps)
        w = torch.where(contribute, a * cum_before, torch.zeros_like(a))
        cacc[ti] += torch.bmm(w, attr[:, :, 5:8])
        tacc[ti] = torch.amin(torch.where(
            contribute, t_after, tacc[ti][:, :, None]), 2)
        trun[ti] = t_after[:, :, -1]
        live = (k * CHUNK + lane) < count[ti][:, None]       # not a pad
        n_eval[ti] += ((cum_before >= s.transmittance_eps)
                       & live[:, None, :]).sum(2)
    return PlainBlend(cpre=cacc.transpose(1, 2).contiguous(),
                      tfinal=tacc[:, None, :], n_eval=n_eval,
                      chunks_skipped=skipped)


def blend_forward(table: torch.Tensor, rank: torch.Tensor,
                  astart: torch.Tensor, count: torch.Tensor,
                  settings: RasterSettings):
    """(cpre [T, 3, P], tfinal [T, 1, P]) of each tile's front-to-back blend.

    Replaces the TPU kernel ``das3r_tpu/ops/splat/entry_blend.py::
    _forward_kernel`` together with the ``table[rank]`` gather before it.
    On the H100 it is bound by operations (~15 FP32 operations and one exp
    per pixel-entry evaluation), so the kernel (csrc/blend_forward.cu) keeps
    each batch of entries in shared memory, runs the serial per-pixel loop
    and leaves a tile as soon as every pixel is saturated. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel.
    """
    if table.device.type == "cpu":
        out = blend_forward_plain(table, rank, astart, count, settings)
        return out.cpre, out.tfinal
    s = settings
    if s.tile != 16:
        raise ValueError(f"the blend kernel needs 16x16 tiles, got {s.tile}")
    kernels.check(table, "table", torch.float32, 2)
    kernels.check(rank, "rank", torch.int32, 1, table.device)
    kernels.check(astart, "astart", torch.int32, 1, table.device)
    kernels.check(count, "count", torch.int32, 1, table.device)
    if table.shape[1] != N_ATTR:
        raise ValueError(f"table must be [M, {N_ATTR}], got "
                         f"{tuple(table.shape)}")
    n_tiles = count.shape[0]
    if astart.shape[0] != n_tiles or n_tiles != s.n_tiles:
        raise ValueError(f"astart/count must hold {s.n_tiles} tiles")
    P = s.tile * s.tile
    cpre = torch.empty(n_tiles, 3, P, device=table.device)
    tfinal = torch.empty(n_tiles, 1, P, device=table.device)
    kernels.launch("blend_forward", table.data_ptr(), rank.data_ptr(),
                   astart.data_ptr(), count.data_ptr(), n_tiles, s.tiles_x,
                   s.alpha_clip, s.alpha_floor, s.transmittance_eps,
                   cpre.data_ptr(), tfinal.data_ptr())
    blend_forward.launches += 1
    return cpre, tfinal


blend_forward.launches = 0


class _BlendEntryStream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, rank, astart, count, settings):
        return blend_forward(table, rank, astart, count, settings)

    @staticmethod
    def backward(ctx, g_cpre, g_tfinal):
        raise NotImplementedError(
            "the entry-stream blend has no backward in the PyTorch port yet: "
            "see ROADMAP.md queue 1, 'gradients of the render'")


def blend_entry_stream(table, rank, astart, count,
                       settings: RasterSettings):
    """table [N+1, 9] (row N = zero sentinel), rank [E_al] int32, astart
    and count [T] int32 -> (cpre [T, 3, P], tfinal [T, 1, P]); an empty
    tile is (0, 1). Differentiable in ``table`` once the backward lands."""
    return _BlendEntryStream.apply(table, rank, astart, count, settings)


def render_tiles(table: torch.Tensor, stream: EntryStream,
                 settings: RasterSettings):
    """Blend every tile of ``stream``; see ``blend_entry_stream``."""
    return blend_entry_stream(table, stream.rank, stream.astart,
                              stream.count, settings)
