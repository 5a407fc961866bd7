"""Per-scene capacity probing (port of ``das3r_tpu/models/autosize.py``).

The JAX package needs every rasterizer capacity at trace time, so it
renders a few views once per scene before training and picks the
capacities from the measured occupancy plus a margin. The port keeps the
same probe and the same rules, so that one scene gets the same settings
in both packages: the trainer's regrow logic and its tests read them. The
probe renders on the [T, K] window path (``entry_stream=False``,
``max_per_tile=128``) under ``torch.no_grad()``; its counts come from the
pre-truncation binning telemetry, so the small K costs nothing.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from das3r_tpu_torch.ops.splat import RasterSettings
from das3r_tpu_torch.ops.splat.rasterize import DUP_HIST_WIDTHS


class ProbeStats(NamedTuple):
    """Per-scene capacity probe results (max over sampled views)."""
    max_total: int      # peak 128-aligned kept entry total
    max_tile: int       # peak per-tile occupancy
    max_dup: int        # peak per-Gaussian rect tile count (pre-cap)
    heavy_rows: int     # Gaussians touching > settings.light_dup_width
    dup_hist: tuple     # counts > each rasterize.DUP_HIST_WIDTHS entry


def probe_views(f: int, max_views: int = 8) -> np.ndarray:
    """Indices of the probed views: all ``f`` when there are at most
    ``max_views``, else ``max_views`` evenly spaced, as the JAX package's
    ``jnp.linspace(0, f - 1, max_views).astype(int32)`` (float32)."""
    if f <= max_views:
        return np.arange(f)
    return np.linspace(0, f - 1, max_views, dtype=np.float32).astype(
        np.int32)


@torch.no_grad()
def probe_capacities(params, meta, settings: RasterSettings, poses7,
                     fovx, fovy, mode: str = "train",
                     max_views: int = 8) -> ProbeStats:
    """One probe pass over up to ``max_views`` evenly spaced views of the
    [F, 7] pose stack ``poses7``, on the parameters' device. "Heavy rows"
    are Gaussians touching more than ``settings.light_dup_width`` tiles;
    ``dup_hist`` gives that count at every candidate light width so that
    ``auto_split_table`` can pick the cheapest split."""
    from das3r_tpu_torch.models import render as render_mod

    probe_settings = dataclasses.replace(
        settings, max_per_tile=128, entry_stream=False, heavy_rows_cap=None)
    dev = params.xyz.device
    poses7 = torch.as_tensor(poses7, device=dev)
    mx_total = mx_tile = mx_dup = mx_heavy = 0
    mx_hist = torch.zeros(len(DUP_HIST_WIDTHS), dtype=torch.int64,
                          device=dev)
    for v in probe_views(poses7.shape[0], max_views):
        out = render_mod.render(params, meta, probe_settings, poses7[int(v)],
                                torch.zeros(3, device=dev), fovx, fovy,
                                mode=mode, device=dev)
        fc = out.aux.n_contrib_tiles.to(torch.int64)
        mx_total = max(mx_total, int(((fc + 127) // 128 * 128).sum()))
        mx_tile = max(mx_tile, int(fc.max()))
        mx_dup = max(mx_dup, int(out.aux.max_tiles_touched))
        mx_heavy = max(mx_heavy, int(out.aux.heavy_rows))
        mx_hist = torch.maximum(mx_hist, out.aux.dup_hist.to(torch.int64))
    return ProbeStats(mx_total, mx_tile, mx_dup, mx_heavy,
                      tuple(int(c) for c in mx_hist.cpu()))


def probe_entry_stats(params, meta, settings: RasterSettings, poses7,
                      fovx, fovy, mode: str = "train",
                      max_views: int = 8):
    """The 4-tuple view of :func:`probe_capacities`."""
    st = probe_capacities(params, meta, settings, poses7, fovx, fovy,
                          mode=mode, max_views=max_views)
    return st.max_total, st.max_tile, st.max_dup, st.heavy_rows


def auto_entry_cap(params, meta, settings: RasterSettings, poses7,
                   fovx, fovy, margin: float = 1.2,
                   mode: str = "train") -> int:
    """``max_total_entries`` for this scene: the peak aligned entry total
    x margin, rounded up to the stream block (1024), at least 8 blocks."""
    mx_total, _, _, _ = probe_entry_stats(params, meta, settings, poses7,
                                          fovx, fovy, mode=mode)
    cap = max(int(mx_total * margin), 8 * 1024)
    return -(-cap // 1024) * 1024


def auto_dup_cap(params, meta, settings: RasterSettings, poses7,
                 fovx, fovy, margin: float = 1.3,
                 mode: str = "train") -> int:
    """``max_tiles_per_gaussian`` for this scene: the peak rect tile count
    x margin, rounded up to a multiple of 4, at least 8, at most the
    settings' own. The duplication table is N x this cap, so it sizes the
    binning sort."""
    _, _, mx_dup, _ = probe_entry_stats(params, meta, settings, poses7,
                                        fovx, fovy, mode=mode)
    cap = max(int(mx_dup * margin), 8)
    return min(-(-cap // 4) * 4, settings.max_tiles_per_gaussian)


# Below this many duplication-table slots (N x dup cap) the split table's
# heavy-row compaction costs more than it saves: the JAX package's value,
# kept so that both packages pick the same table. The card's own binning
# times of the split against the full-width table are in PERF.md.
SPLIT_TABLE_MIN_SLOTS = 8 * 1024 * 1024


def auto_heavy_cap(mx_heavy: int, n_gaussians: int | None = None,
                   dup_cap: int | None = None,
                   margin: float = 1.5) -> int | None:
    """``heavy_rows_cap`` from a probed peak heavy-row count: x margin,
    rounded up to 1024, at least 4096 rows; None (one full-width table)
    below ``SPLIT_TABLE_MIN_SLOTS`` when ``n_gaussians`` and ``dup_cap``
    are given."""
    if (n_gaussians is not None and dup_cap is not None
            and n_gaussians * dup_cap < SPLIT_TABLE_MIN_SLOTS):
        return None
    return -(-max(int(mx_heavy * margin), 4096) // 1024) * 1024


def auto_split_table(stats: ProbeStats, n_gaussians: int, dup_cap: int,
                     margin: float = 1.5):
    """The split-table shape with the smallest sort domain
    ``n*L + heavy_cap(L) * (dup_cap - L)``: ``{"light_dup_width": L,
    "heavy_rows_cap": cap}``, or ``{"heavy_rows_cap": None}`` when no split
    beats the full-width table or the domain is below
    ``SPLIT_TABLE_MIN_SLOTS``."""
    no_split = {"heavy_rows_cap": None}
    if n_gaussians * dup_cap < SPLIT_TABLE_MIN_SLOTS:
        return no_split
    best_cost, best = n_gaussians * dup_cap, no_split
    for w, cnt in zip(DUP_HIST_WIDTHS, stats.dup_hist):
        if not 0 < w < dup_cap:
            continue
        h_cap = -(-max(int(cnt * margin), 4096) // 1024) * 1024
        cost = n_gaussians * w + h_cap * (dup_cap - w)
        if cost < best_cost:
            best_cost = cost
            best = {"light_dup_width": w, "heavy_rows_cap": h_cap}
    return best
