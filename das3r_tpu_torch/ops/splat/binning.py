"""Depth-ordered tile binning into a 128-aligned entry stream.

Port of the entry-stream part of ``das3r_tpu/ops/splat/binning.py``: a
duplication table of (Gaussian, tile) pairs, one sort of self-describing
``tile << nbits | depth_rank`` keys, then a layout in which each tile's
depth-ordered segment starts at a multiple of 128 slots.

Differences from the JAX package, by design:

* Keys are int64, so ``(n_tiles + 1) << nbits`` only has to stay below
  2^63 instead of 2^32.
* The sort sees only the live pairs (``packed[valid]``, then ``torch.sort``)
  instead of the whole padded table; since keys are unique this equals the
  live prefix of the JAX full sort.
* With ``max_total_entries=None`` the stream is sized from the real counts
  and drops nothing; a set cap keeps the JAX farthest-first drop policy.
* The chunk gather plus rank decode is one CUDA kernel
  (``extract_chunks``, replacing ``_extract_chunks_pallas``).

Every function here runs on detached inputs: gradients flow through the
gathered attribute values, never through the indices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from das3r_tpu_torch.ops.splat import kernels
from das3r_tpu_torch.ops.splat.preprocess import Preprocessed
from das3r_tpu_torch.ops.splat.settings import RasterSettings

CHUNK = 128   # entries per stream chunk; each chunk belongs to one tile


def _tile_pair_keep(m2d, conic, q_cap, tx, ty, settings: RasterSettings):
    """Exact per-(Gaussian, tile) cull: keep iff the minimum of the conic
    quadratic q(d) = A dx^2 + 2B dx dy + C dy^2 over the tile's pixel box
    satisfies alpha = op * exp(-q/2) >= alpha_floor, i.e. q_min <= q_cap.
    The continuous-box minimum lower-bounds the integer-pixel minimum, so
    the cull never drops a contributing pair."""
    s = settings
    mx, my = m2d[:, 0:1], m2d[:, 1:2]
    A, B, C = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    A_safe = torch.where(A > 0, A, torch.ones_like(A))
    C_safe = torch.where(C > 0, C, torch.ones_like(C))

    lx = tx.to(torch.float32) * s.tile - mx              # [N, D]
    hx = lx + (s.tile - 1)
    ly = ty.to(torch.float32) * s.tile - my
    hy = ly + (s.tile - 1)
    inside = (lx <= 0) & (hx >= 0) & (ly <= 0) & (hy >= 0)

    def q_edge_x(xh):
        yst = torch.minimum(torch.maximum(-B * xh / C_safe, ly), hy)
        return A * xh * xh + 2.0 * B * xh * yst + C * yst * yst

    def q_edge_y(yh):
        xst = torch.minimum(torch.maximum(-B * yh / A_safe, lx), hx)
        return A * xst * xst + 2.0 * B * xst * yh + C * yh * yh

    q_min = torch.minimum(
        torch.minimum(q_edge_x(lx), q_edge_x(hx)),
        torch.minimum(q_edge_y(ly), q_edge_y(hy)))
    q_min = torch.where(inside, torch.zeros_like(q_min), q_min)
    return q_min <= q_cap[:, None] + 1e-3


class SortedKeyStream(NamedTuple):
    sorted_packed: torch.Tensor   # [E] int64 (tile << nbits | rank), live only
    order: torch.Tensor           # [N] int64 depth rank -> gaussian index
    nbits: int                    # rank = key & (2^nbits - 1)
    dup_overflow: torch.Tensor    # [] Gaussians whose rect was cut by D
    entry_overflow: torch.Tensor  # [] live entries beyond max_total_entries


def rank_bits(n: int) -> int:
    return max(int(n - 1).bit_length(), 1)


def _sorted_key_stream(prep: Preprocessed,
                       settings: RasterSettings) -> SortedKeyStream:
    """Duplication table -> packed self-describing keys -> one sort."""
    s = settings
    n = prep.depth.shape[0]
    d_cap = s.max_tiles_per_gaussian
    nbits = rank_bits(n)
    dev = prep.depth.device

    alive = prep.binnable
    # Global front-to-back order; stable so equal depths keep input order
    # (the CUDA radix sort over float bits is stable too).
    sort_depth = torch.where(alive, prep.depth,
                             torch.full_like(prep.depth, float("inf")))
    order = torch.argsort(sort_depth, stable=True)

    width = torch.clamp_min(prep.rect_max[:, 0] - prep.rect_min[:, 0], 1)[order]
    ntt = torch.where(alive, torch.clamp_max(prep.n_tiles_touched, d_cap),
                      torch.zeros_like(prep.n_tiles_touched))[order]
    rect_min = prep.rect_min[order]
    dup_overflow = torch.sum(prep.n_tiles_touched > d_cap)

    # Entry (i, d) is the d-th rect cell of depth-ranked Gaussian i.
    # d // width via float: (d + 0.5) / w lies strictly inside
    # (d/w, (d+1)/w), far from the f32 rounding error at these magnitudes.
    d_idx = torch.arange(d_cap, dtype=torch.int32, device=dev)[None, :]
    row = ((d_idx.to(torch.float32) + 0.5)
           / width[:, None].to(torch.float32)).to(torch.int32)
    col = d_idx - row * width[:, None]
    ty = rect_min[:, 1:2] + row
    tx = rect_min[:, 0:1] + col
    valid = d_idx < ntt[:, None]
    if s.tight_binning:
        valid = valid & _tile_pair_keep(prep.mean2d[order], prep.conic[order],
                                        prep.q_cap[order], tx, ty, s)
    tile = (ty * s.tiles_x + tx).to(torch.int64)
    rank_iota = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    # A Gaussian touches a tile at most once, so the key is unique and its
    # order is tile-major, depth-minor. Boolean indexing keeps row-major
    # (depth-major) order, which the capped compaction below relies on.
    live = ((tile << nbits) | rank_iota)[valid]

    entry_overflow = torch.zeros((), dtype=torch.int64, device=dev)
    if s.max_total_entries is not None:
        entry_overflow = torch.clamp_min(
            torch.tensor(live.numel() - s.max_total_entries, device=dev), 0)
        if n * d_cap > s.full_sort_below:
            # the JAX compaction buffer: the farthest Gaussians' entries
            # beyond the cap are dropped
            live = live[: s.max_total_entries]
    return SortedKeyStream(sorted_packed=torch.sort(live).values, order=order,
                           nbits=nbits, dup_overflow=dup_overflow,
                           entry_overflow=entry_overflow)


class EntryStream(NamedTuple):
    """128-aligned variable-length per-tile entry stream (no K cap)."""
    rank: torch.Tensor        # [E_al] int32 depth rank per slot; n on pads
    chunk_tile: torch.Tensor  # [E_al/128] int32 owning tile (n_tiles: void)
    order: torch.Tensor       # [N] int64 depth rank -> gaussian index
    count: torch.Tensor       # [T] int32 live entries per tile
    astart: torch.Tensor      # [T] int32 first slot of each tile's segment
    dup_overflow: torch.Tensor
    entry_overflow: torch.Tensor
    heavy_overflow: torch.Tensor


def entry_stream_supported(n: int, settings: RasterSettings) -> bool:
    """The int64 key must hold (n_tiles + 1) << ceil(log2 N)."""
    return (settings.n_tiles + 1) << rank_bits(n) <= 2**63 - 1


def entry_stream_cap(settings: RasterSettings, n: int) -> int | None:
    """The JAX package's static aligned-stream capacity when
    ``max_total_entries`` is set; ``None`` sizes the stream from the real
    counts."""
    s = settings
    if s.max_total_entries is None:
        return None
    e = min(n * s.max_tiles_per_gaussian + CHUNK * s.n_tiles,
            s.max_total_entries)
    return -(-e // 1024) * 1024


def extract_chunks_plain(keys: torch.Tensor, src0: torch.Tensor,
                         nlive: torch.Tensor, nbits: int,
                         n: int) -> torch.Tensor:
    """Plain version of the ``extract_chunks`` kernel: slot j of chunk c
    holds ``min(keys[src0[c] + j] & mask, n - 1)`` for j < nlive[c] and n
    on dead lanes. Returns [n_chunks * 128] int32."""
    lane = torch.arange(CHUNK, device=keys.device)
    live = lane[None, :] < nlive[:, None]
    idx = src0[:, None] + lane[None, :]
    mask = (1 << nbits) - 1
    rank = torch.full(live.shape, n, dtype=torch.int32, device=keys.device)
    rank[live] = torch.clamp_max(keys[idx[live]] & mask, n - 1).to(torch.int32)
    return rank.reshape(-1)


def extract_chunks(keys: torch.Tensor, src0: torch.Tensor,
                   nlive: torch.Tensor, nbits: int, n: int) -> torch.Tensor:
    """Stream chunk gather fused with the rank decode.

    Replaces the TPU kernel ``das3r_tpu/ops/splat/binning.py::
    _extract_chunks_pallas`` (whose row-DMA-and-roll exists only because
    Mosaic cannot DMA at an element offset). On the H100 it is bound by
    memory: per slot one 8-byte key read and one 4-byte rank write, so the
    kernel (csrc/extract_chunks.cu) is one thread per slot, neighbouring
    threads on neighbouring addresses, with masked loads for dead lanes.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if keys.device.type == "cpu":
        return extract_chunks_plain(keys, src0, nlive, nbits, n)
    kernels.check(keys, "keys", torch.int64, 1)
    kernels.check(src0, "src0", torch.int64, 1, keys.device)
    kernels.check(nlive, "nlive", torch.int32, 1, keys.device)
    if src0.shape != nlive.shape:
        raise ValueError(f"src0 {tuple(src0.shape)} != nlive "
                         f"{tuple(nlive.shape)}")
    if not 1 <= nbits <= 62 or not 1 <= n < 2**31:
        raise ValueError(f"nbits={nbits}, n={n} out of range")
    rank = torch.empty(src0.shape[0] * CHUNK, dtype=torch.int32,
                       device=keys.device)
    kernels.launch("extract_chunks", keys.data_ptr(), src0.data_ptr(),
                   nlive.data_ptr(), src0.shape[0], nbits, n,
                   rank.data_ptr())
    extract_chunks.launches += 1
    return rank


extract_chunks.launches = 0


class ChunkLayout(NamedTuple):
    """Where each 128-slot chunk of the stream reads its keys."""
    chunk_tile: torch.Tensor   # [n_chunks] int32 owning tile (n_tiles: void)
    src0: torch.Tensor         # [n_chunks] int64 sorted-key index of slot 0
    nlive: torch.Tensor        # [n_chunks] int32 live slots of the chunk
    count: torch.Tensor        # [T] int64 live entries per tile
    astart: torch.Tensor       # [T] int64 first slot of each tile's segment
    stream_drop: torch.Tensor  # [] entries cut by the stream capacity


def chunk_layout(keys: torch.Tensor, nbits: int, settings: RasterSettings,
                 e_al: int | None = None) -> ChunkLayout:
    """Per-tile segments and per-chunk key sources of the 128-aligned
    stream over sorted ``keys``. ``e_al=None`` sizes the stream from the
    counts (at least one chunk)."""
    s = settings
    t_loc = s.n_tiles
    dev = keys.device

    boundaries = torch.arange(t_loc + 1, dtype=torch.int64,
                              device=dev) << nbits
    bounds = torch.searchsorted(keys, boundaries)
    start = bounds[:-1]
    count_raw = bounds[1:] - start                           # uncapped
    ccount = (count_raw + CHUNK - 1) // CHUNK * CHUNK
    astart = torch.cumsum(ccount, 0) - ccount
    total = int(ccount.sum())
    if e_al is None:
        e_al = max(total, CHUNK)
    # Tiles whose aligned segment crosses the stream capacity lose their
    # tail (entry_overflow): the same farthest-first policy as the cap.
    count = torch.minimum(count_raw, torch.clamp_min(e_al - astart, 0))
    stream_drop = torch.sum(count_raw - count)

    # Per-chunk owning tile: scatter each non-empty tile's id at its first
    # chunk, then forward-fill with a running max. Tiles sharing a start
    # chunk form an empty-then-nonempty run, so the max picks the owner.
    n_chunks = e_al // CHUNK
    first_chunk = torch.clamp_max(astart // CHUNK, n_chunks - 1)
    tile_iota = torch.arange(t_loc, dtype=torch.int64, device=dev)
    marks = torch.zeros(n_chunks, dtype=torch.int64, device=dev)
    marks.scatter_reduce_(0, first_chunk, torch.where(
        count > 0, tile_iota, torch.zeros_like(tile_iota)), "amax")
    owner = torch.cummax(marks, 0).values
    chunk_ids = torch.arange(n_chunks, dtype=torch.int64, device=dev)
    chunk_live = chunk_ids * CHUNK < total
    chunk_tile = torch.where(chunk_live, owner,
                             torch.full_like(owner, t_loc)).to(torch.int32)

    # Chunk c holds slots [coff, coff + 128) of its owner's segment, read
    # from the sorted keys at start[owner] + coff.
    coff = chunk_ids * CHUNK - astart[owner]
    nlive = torch.where(chunk_live,
                        torch.clamp(count[owner] - coff, 0, CHUNK),
                        torch.zeros_like(coff)).to(torch.int32)
    return ChunkLayout(chunk_tile=chunk_tile, src0=start[owner] + coff,
                       nlive=nlive, count=count, astart=astart,
                       stream_drop=stream_drop)


def entry_stream_from_keys(ks: SortedKeyStream, settings: RasterSettings,
                           n: int, e_al: int | None = None) -> EntryStream:
    """Lay out the 128-aligned entry stream from a sorted key stream.
    ``e_al=None`` sizes it from the counts (at least one chunk)."""
    lay = chunk_layout(ks.sorted_packed, ks.nbits, settings, e_al)
    rank = extract_chunks(ks.sorted_packed, lay.src0, lay.nlive, ks.nbits, n)
    return EntryStream(rank=rank, chunk_tile=lay.chunk_tile, order=ks.order,
                       count=lay.count.to(torch.int32),
                       astart=lay.astart.to(torch.int32),
                       dup_overflow=ks.dup_overflow,
                       entry_overflow=ks.entry_overflow + lay.stream_drop,
                       heavy_overflow=torch.zeros_like(lay.stream_drop))


def bin_entry_stream(prep: Preprocessed,
                     settings: RasterSettings) -> EntryStream:
    n = prep.depth.shape[0]
    if not entry_stream_supported(n, settings):
        raise ValueError("(n_tiles + 1) << ceil(log2 N) exceeds the int64 key")
    with record_function("das3r::sorted_key_stream"):
        ks = _sorted_key_stream(prep, settings)
    with record_function("das3r::entry_stream_from_keys"):
        return entry_stream_from_keys(ks, settings, n,
                                      entry_stream_cap(settings, n))
