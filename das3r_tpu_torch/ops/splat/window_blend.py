"""[T, K] window blend: per-tile front-to-back blending over fixed-width
windows of depth-ordered attributes, forward and backward.

Port of ``das3r_tpu/ops/splat/pallas_blend.py`` (the JAX package's Pallas
window blend; the name says what it blends, since "Pallas" means nothing
here). Tile t's window holds attributes ``attrs[t]`` [9, K]; its live
slots are [delta, delta + count). The blend walks chunks of ``_pick_chunk(K)``
slots from ``delta // chunk``, stops a tile once every pixel's running
transmittance is below eps, and composes the background inside: colours
= C + T_final * bg.

Two versions of each direction:

* the plain PyTorch versions (``window_forward_plain``,
  ``window_backward_plain``) keep the JAX algorithm, batched over tiles:
  the chunk loop, the early exit, zero ``tin`` rows for chunks never
  visited, and a reverse sweep that replays each visited chunk from
  ``tin`` with the suffix sum. A cumulative product stands in for the
  kernel's exp-of-log matmul, as in ``entry_blend``;
* the CUDA kernels ``csrc/window_blend_forward.cu`` (kernel D) and
  ``csrc/window_blend_backward.cu`` (kernel E).

A call may blend a range of window rows instead of the whole image (the
tile-sharded window render, ``rasterize._windows_sharded``): ``tile0`` is
the global index of the first row's tile, the row count is ``attrs``'s;
only the pixel coordinates come from the global tile grid. The whole
image is ``tile0 = 0``.

Attribute rows (axis 1 of ``attrs``):
    0: mean2d_x  1: mean2d_y  2: conic_xx  3: conic_xy  4: conic_yy
    5: color_r   6: color_g   7: color_b   8: opacity
"""
from __future__ import annotations

import torch

from das3r_tpu_torch.ops.splat import kernels
from das3r_tpu_torch.ops.splat.entry_blend import (
    N_ATTR, _chunk_grads, _chunk_math, _tile_pixels)
from das3r_tpu_torch.ops.splat.settings import RasterSettings


def _pick_chunk(K: int) -> int:
    if K % 128 == 0:
        return 128
    if not (K <= 128 and 128 % K == 0):
        raise ValueError(f"max_per_tile={K} must be a multiple of 128 or a "
                         "divisor of 128")
    return K


def _chunk_slots(attrs, deltas, counts, ti, c, chunk):
    """Attributes [Ta, chunk, 9], slot indices [Ta, chunk] and live mask of
    chunk ``c[i]`` of tile ``ti[i]``."""
    lane = torch.arange(chunk, device=attrs.device)
    slot = c[:, None] * chunk + lane
    attr = attrs[ti[:, None], :, slot]
    d = deltas[ti, None]
    live = (slot >= d) & (slot < d + counts[ti, None])
    return attr, slot, live


def window_forward_plain(attrs: torch.Tensor, counts: torch.Tensor,
                         deltas: torch.Tensor, bg: torch.Tensor,
                         settings: RasterSettings, tile0: int = 0):
    """(colors [T, P, 3], tfinal [T, P], tin [T, K/chunk, P]): the JAX
    forward kernel's algorithm batched over tiles. Two transmittances per
    pixel: ``T_run``, the running product committed even past eps (which
    decides the early exit), and ``T_out``, the T after the last
    contributing entry. The JAX package's XLA window blend
    (``blend.py::blend_tiles``) computes the same function."""
    s = settings
    dev = attrs.device
    n_tiles, _, K = attrs.shape
    chunk = _pick_chunk(K)
    P = s.tile * s.tile
    px, py = _tile_pixels(s, n_tiles, dev, tile0)
    counts, deltas = counts.to(torch.int64), deltas.to(torch.int64)
    c0 = deltas // chunk
    n_run = torch.clamp_min(
        (deltas + counts + chunk - 1) // chunk - c0, 0)
    cacc = torch.zeros(n_tiles, P, 3, device=dev)
    t_out = torch.ones(n_tiles, P, device=dev)
    t_run = torch.ones(n_tiles, P, device=dev)
    tin = torch.zeros(n_tiles, K // chunk, P, device=dev)
    for k in range(int(n_run.max()) if n_tiles else 0):
        go = (n_run > k) & (t_run.amax(1) >= s.transmittance_eps)
        ti = go.nonzero().squeeze(1)
        if ti.numel() == 0:
            break
        c = c0[ti] + k
        tin[ti, c] = t_run[ti]
        attr, _, live = _chunk_slots(attrs, deltas, counts, ti, c, chunk)
        m = _chunk_math(attr, px[ti], py[ti], t_run[ti], s, live)
        cacc[ti] += torch.bmm(m["w"], attr[:, :, 5:8])
        t_out[ti] = torch.amin(torch.where(
            m["contribute"], m["t_after"], t_out[ti][:, :, None]), 2)
        t_run[ti] = m["t_after"][:, :, -1]
    colors = cacc + t_out[:, :, None] * bg.reshape(1, 1, 3)
    return colors, t_out, tin


def window_backward_plain(attrs: torch.Tensor, counts: torch.Tensor,
                          deltas: torch.Tensor, bg: torch.Tensor,
                          g_colors: torch.Tensor, tfinal: torch.Tensor,
                          tin: torch.Tensor, settings: RasterSettings,
                          tile0: int = 0) -> torch.Tensor:
    """g_attrs [T, 9, K]: the JAX backward kernel's algorithm batched over
    tiles. A tile's visited chunks are its ``tin`` rows that reach eps; they
    are swept in reverse from S = (g . bg) T_final, each replayed from its
    ``tin`` row (``entry_blend._chunk_grads`` gives the per-slot terms).
    Slots outside the visited chunks get zero."""
    s = settings
    dev = attrs.device
    n_tiles, _, K = attrs.shape
    chunk = _pick_chunk(K)
    px, py = _tile_pixels(s, n_tiles, dev, tile0)
    counts, deltas = counts.to(torch.int64), deltas.to(torch.int64)
    c0 = deltas // chunk
    n_vis = (tin.amax(2) >= s.transmittance_eps).sum(1)
    svec = (g_colors * bg.reshape(1, 1, 3)).sum(2) * tfinal       # [T, P]
    g_attrs = torch.zeros_like(attrs)
    for k in reversed(range(int(n_vis.max()) if n_tiles else 0)):
        ti = (n_vis > k).nonzero().squeeze(1)
        c = c0[ti] + k
        attr, slot, live = _chunk_slots(attrs, deltas, counts, ti, c, chunk)
        m = _chunk_math(attr, px[ti], py[ti], tin[ti, c], s, live)
        g_rows, e_sum = _chunk_grads(attr, m, g_colors[ti], svec[ti], s)
        g_attrs[ti[:, None], :, slot] = g_rows
        svec[ti] += e_sum
    return g_attrs


def _check_window(attrs, counts, deltas, bg, settings: RasterSettings,
                  tile0: int):
    """Raise unless the CUDA kernels can take these windows."""
    s = settings
    if s.tile != 16:
        raise ValueError(f"the blend kernels need 16x16 tiles, got {s.tile}")
    kernels.check(attrs, "attrs", torch.float32, 3)
    kernels.check(counts, "counts", torch.int32, 1, attrs.device)
    kernels.check(deltas, "deltas", torch.int32, 1, attrs.device)
    kernels.check(bg, "bg", torch.float32, 1, attrs.device)
    n_tiles = attrs.shape[0]
    if attrs.shape[1] != N_ATTR:
        raise ValueError(f"attrs must be [T, {N_ATTR}, K], got "
                         f"{tuple(attrs.shape)}")
    if counts.shape[0] != n_tiles or deltas.shape[0] != n_tiles:
        raise ValueError(f"counts/deltas must hold {n_tiles} tiles")
    if not 0 <= tile0 < 2**31 - n_tiles:
        raise ValueError(f"tile0={tile0} out of range")
    if bg.shape[0] != 3:
        raise ValueError(f"bg must be [3], got {tuple(bg.shape)}")


def window_forward(attrs: torch.Tensor, counts: torch.Tensor,
                   deltas: torch.Tensor, bg: torch.Tensor,
                   settings: RasterSettings, tile0: int = 0):
    """(colors [T, P, 3], tfinal [T, P], tin [T, K/chunk, P]); see
    ``window_forward_plain``.

    Replaces the TPU kernel ``das3r_tpu/ops/splat/pallas_blend.py::
    _forward_kernel``. On the H100 it is bound by operations (~15 FP32
    operations and one exp per pixel-slot evaluation), so the kernel
    (csrc/window_blend_forward.cu) cuts the instructions around each
    evaluation: two pixels per thread, each chunk's attributes copied into
    padded shared-memory rows while the previous chunk is blended, and a
    branch-free step (csrc/blend_step.cuh, the one kernel E replays); it
    leaves a tile once every pixel is saturated. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel."""
    if attrs.device.type == "cpu":
        return window_forward_plain(attrs, counts, deltas, bg, settings,
                                    tile0)
    _check_window(attrs, counts, deltas, bg, settings, tile0)
    s = settings
    n_tiles, _, K = attrs.shape
    chunk = _pick_chunk(K)
    P = s.tile * s.tile
    dev = attrs.device
    colors = torch.empty(n_tiles, P, 3, device=dev)
    tfinal = torch.empty(n_tiles, P, device=dev)
    tin = torch.empty(n_tiles, K // chunk, P, device=dev)
    kernels.launch("window_blend_forward", attrs.data_ptr(),
                   counts.data_ptr(), deltas.data_ptr(), bg.data_ptr(),
                   n_tiles, K, chunk, tile0, s.tiles_x, s.alpha_clip,
                   s.alpha_floor, s.transmittance_eps, colors.data_ptr(),
                   tfinal.data_ptr(), tin.data_ptr())
    return colors, tfinal, tin


def window_backward(attrs: torch.Tensor, counts: torch.Tensor,
                    deltas: torch.Tensor, bg: torch.Tensor,
                    g_colors: torch.Tensor, tfinal: torch.Tensor,
                    tin: torch.Tensor, settings: RasterSettings,
                    tile0: int = 0) -> torch.Tensor:
    """g_attrs [T, 9, K] from the colour cotangents and the forward's
    ``tfinal`` and ``tin``; see ``window_backward_plain``.

    Replaces the TPU kernel ``das3r_tpu/ops/splat/pallas_blend.py::
    _backward_kernel``. On the H100 it is bound by operations (two replays
    and ~30 FP32 operations, two exps and a division per pixel-slot
    evaluation), so the kernel (csrc/window_blend_backward.cu) replays each
    chunk's transmittances in sub-batches of 16 slots, leaves two scalars
    per pixel-slot in shared memory, reduces each slot over the tile's
    pixels in registers in a fixed order and writes its sums directly (a
    slot belongs to one tile: no atomics, deterministic). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    if attrs.device.type == "cpu":
        return window_backward_plain(attrs, counts, deltas, bg, g_colors,
                                     tfinal, tin, settings, tile0)
    _check_window(attrs, counts, deltas, bg, settings, tile0)
    s = settings
    n_tiles, _, K = attrs.shape
    chunk = _pick_chunk(K)
    P = s.tile * s.tile
    for t, name, shape in ((g_colors, "g_colors", (n_tiles, P, 3)),
                           (tfinal, "tfinal", (n_tiles, P)),
                           (tin, "tin", (n_tiles, K // chunk, P))):
        kernels.check(t, name, torch.float32, len(shape), attrs.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    g_attrs = torch.zeros_like(attrs)
    kernels.launch("window_blend_backward", attrs.data_ptr(),
                   counts.data_ptr(), deltas.data_ptr(), bg.data_ptr(),
                   g_colors.data_ptr(), tfinal.data_ptr(), tin.data_ptr(),
                   n_tiles, K, chunk, tile0, s.tiles_x, s.alpha_clip,
                   s.alpha_floor, s.transmittance_eps, g_attrs.data_ptr())
    return g_attrs


class _BlendTilesWindow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs, counts, deltas, bg, settings, tile0):
        colors, tfinal, tin = window_forward(attrs, counts, deltas, bg,
                                             settings, tile0)
        ctx.save_for_backward(attrs, counts, deltas, bg, tfinal, tin)
        ctx.settings, ctx.tile0 = settings, tile0
        return colors

    @staticmethod
    def backward(ctx, g_colors):
        attrs, counts, deltas, bg, tfinal, tin = ctx.saved_tensors
        g_colors = g_colors.contiguous()
        g_attrs = g_bg = None
        if ctx.needs_input_grad[0]:
            g_attrs = window_backward(attrs, counts, deltas, bg, g_colors,
                                      tfinal, tin, ctx.settings, ctx.tile0)
        if ctx.needs_input_grad[3]:
            # dL/dbg = sum over pixels of g * T_final
            g_bg = (g_colors * tfinal[:, :, None]).sum((0, 1))
        return g_attrs, None, None, g_bg, None, None


def blend_tiles_window(attrs, counts, deltas, bg, settings: RasterSettings,
                       tile0: int = 0) -> torch.Tensor:
    """attrs [T, 9, K], counts/deltas [T] int32, bg [3] -> tile colours
    [T, P, 3] (``blend_tiles_pallas`` of the JAX package). Live slots are
    [delta, delta + count) per tile; the rows are the tiles from ``tile0``
    on (module docstring). Differentiable in ``attrs`` and ``bg``."""
    return _BlendTilesWindow.apply(attrs, counts, deltas, bg, settings,
                                   tile0)
