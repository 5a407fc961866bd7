"""Depth-ordered tile binning: the 128-aligned entry stream and the
[T, K] per-tile windows.

Port of ``das3r_tpu/ops/splat/binning.py``: a duplication table of
(Gaussian, tile) pairs, one sort of self-describing
``tile << nbits | depth_rank`` keys, then either a layout in which each
tile's depth-ordered segment starts at a multiple of 128 slots
(``bin_entry_stream``) or a window of K slots cut at each tile's start
(``bin_gaussians``, the [T, K] window path).

Differences from the JAX package, by design:

* Keys are int64, so ``(n_tiles + 1) << nbits`` only has to stay below
  2^63 instead of 2^32. The JAX pair-sort fallback for wider key spaces
  is never needed.
* The sort sees only the live pairs (``packed[valid]``, then ``torch.sort``)
  instead of the whole padded table; since keys are unique this equals the
  live prefix of the JAX full sort. ``_windows`` pads the live keys with
  K + 128 sentinels itself, so a window read never leaves the array.
* With ``max_total_entries=None`` the stream is sized from the real counts
  and drops nothing; a set cap keeps the JAX farthest-first drop policy.
* On the card the duplication table is never built: a pair of CUDA
  kernels (``dup_count``, ``dup_emit``) counts each depth-ranked row's
  live cells and writes its keys at the row's offset (``dup_keys``), the
  split table's two tables as one emission. The dense [N, D] table stays
  as the plain version on CPU tensors (``dup_keys_plain``).
* The chunk gather plus rank decode is one CUDA kernel
  (``extract_chunks``, replacing ``_extract_chunks_pallas``), and so is
  the window gather plus rank decode (``extract_windows``, replacing
  ``_extract_windows_pallas``).
* The split-width duplication table (``heavy_rows_cap`` set, ``0 <
  light_dup_width < max_tiles_per_gaussian``) emits the same keys as the
  JAX one, and reports ``entry_overflow`` without truncating, as JAX does
  on that branch.
* The quantized-depth window binning (``depth_sort_bits > 0``,
  ``_bin_quantized_depth``) sorts its keys with a stable sort, so equal
  keys keep the Gaussian order; JAX's sort leaves their order unspecified.

Every function here runs on detached inputs: gradients flow through the
gathered attribute values, never through the indices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from das3r_tpu_torch.ops.splat import kernels
from das3r_tpu_torch.ops.splat.preprocess import Preprocessed
from das3r_tpu_torch.ops.splat.settings import RasterSettings
from das3r_tpu_torch.utils import trace

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
    heavy_overflow: torch.Tensor  # [] rect cells of the heavy rows past
    #                               heavy_rows_cap (0 without the split
    #                               table): the JAX count, which with
    #                               tight_binning upper-bounds the live
    #                               entries dropped


def rank_bits(n: int) -> int:
    return max(int(n - 1).bit_length(), 1)


def _emit_keys(width, rect_min, ntt, m2d, conic, q_cap, rank, d0: int,
               d_width: int, nbits: int, settings: RasterSettings):
    """Live ``tile << nbits | rank`` keys of rect cells [d0, d0 + d_width)
    of the rows described by the per-row arrays (``rank`` [R] int64 is each
    row's depth rank), row-major: depth-major when the rows are in depth
    order."""
    s = settings
    dev = width.device
    # Cell d of a row: d // width via float: (d + 0.5) / w lies strictly
    # inside (d/w, (d+1)/w), far from the f32 rounding error at these
    # magnitudes.
    d_idx = d0 + torch.arange(d_width, dtype=torch.int32, device=dev)[None, :]
    row = ((d_idx.to(torch.float32) + 0.5)
           / width[:, None].to(torch.float32)).to(torch.int32)
    col = d_idx - row * width[:, None]
    ty = rect_min[:, 1:2] + row
    tx = rect_min[:, 0:1] + col
    valid = d_idx < ntt[:, None]
    if s.tight_binning:
        valid = valid & _tile_pair_keep(m2d, conic, q_cap, tx, ty, s)
    tile = (ty * s.tiles_x + tx).to(torch.int64)
    # A Gaussian touches a tile at most once, so the key is unique and its
    # order is tile-major, depth-minor. Boolean indexing keeps row-major
    # order; it waits for the device to count the live keys.
    keys = (tile << nbits) | rank[:, None]
    with trace.sync("emit_keys"):
        return keys[valid]


def uses_split_table(settings: RasterSettings) -> bool:
    """Whether the duplication table is split (``heavy_rows_cap`` set and
    ``0 < light_dup_width < max_tiles_per_gaussian``)."""
    s = settings
    return (s.heavy_rows_cap is not None
            and 0 < s.light_dup_width < s.max_tiles_per_gaussian)


def allowed_cells(prep: Preprocessed, d_cap: int) -> torch.Tensor:
    """[N] int32 rect cells a Gaussian may emit: its tile count capped at
    D, 0 when it is not binnable."""
    return torch.where(prep.binnable,
                       torch.clamp_max(prep.n_tiles_touched, d_cap),
                       torch.zeros_like(prep.n_tiles_touched))


def heavy_rows(ntt: torch.Tensor, settings: RasterSettings):
    """The split table's heavy rows, from ``ntt`` [N] (``allowed_cells`` in
    depth order): (h_pos [N] int64, each row's position among the heavy
    rows before it, and ``heavy_overflow``, the cells past L of the heavy
    rows at or past ``heavy_rows_cap``)."""
    L, h_cap = settings.light_dup_width, settings.heavy_rows_cap
    heavy = ntt > L                                   # [N] (0 if dead)
    h_pos = torch.cumsum(heavy, 0) - heavy.to(torch.int64)
    heavy_overflow = torch.sum(torch.where(
        heavy & (h_pos >= h_cap), ntt - L, torch.zeros_like(ntt))).to(
            torch.int64)
    return h_pos, heavy_overflow


def row_allowance(ntt: torch.Tensor, h_pos: torch.Tensor | None,
                  settings: RasterSettings) -> torch.Tensor:
    """[N] cells that ``dup_count`` and ``dup_emit`` let row r emit: all of
    ``ntt[r]``, or the first L of a heavy row at or past ``heavy_rows_cap``
    (``h_pos`` given: the split table). Through the plain cull
    (``_emit_keys`` with it as the count) it emits the split table's two
    tables' keys in one buffer, row-major."""
    if h_pos is None:
        return ntt
    L, h_cap = settings.light_dup_width, settings.heavy_rows_cap
    return torch.where((ntt > L) & (h_pos >= h_cap), torch.full_like(ntt, L),
                       ntt)


def dup_keys_plain(prep: Preprocessed, order: torch.Tensor, nbits: int,
                   settings: RasterSettings):
    """Plain version of the ``dup_count`` / ``dup_emit`` pair: the dense
    duplication table. Returns (live keys, ``heavy_overflow``).

    The full-width table is [N, D], its keys depth-major. With the split
    table (``uses_split_table``) it is split as in the JAX package: every
    row emits its first L cells into [N, L], and the rows with more cells,
    in depth order, take the first ``heavy_rows_cap`` rows of a [H_cap, D -
    L] table for the rest; the keys are the first table's, then the
    second's. A heavy row past the cap (the farthest go first) keeps its
    first L cells; the cells it loses are ``heavy_overflow``. Without such
    a row both tables together hold the full-width table's keys."""
    s = settings
    n = order.shape[0]
    d_cap = s.max_tiles_per_gaussian
    dev = order.device
    width = torch.clamp_min(prep.rect_max[:, 0] - prep.rect_min[:, 0], 1)[order]
    ntt = allowed_cells(prep, d_cap)[order]
    rect_min = prep.rect_min[order]
    m2d, conic, q_cap = prep.mean2d[order], prep.conic[order], prep.q_cap[order]
    rank = torch.arange(n, dtype=torch.int64, device=dev)
    if not uses_split_table(s):
        return (_emit_keys(width, rect_min, ntt, m2d, conic, q_cap, rank, 0,
                           d_cap, nbits, s),
                torch.zeros((), dtype=torch.int64, device=dev))
    L, h_cap = s.light_dup_width, s.heavy_rows_cap
    h_pos, heavy_overflow = heavy_rows(ntt, s)
    in_h = (ntt > L) & (h_pos < h_cap)
    # hid[j]: the depth rank of heavy row j, n on unused rows
    hid = torch.full((h_cap + 1,), n, dtype=torch.int64, device=dev)
    hid.scatter_(0, torch.where(in_h, h_pos, h_cap),
                 torch.where(in_h, rank, n))
    hid = hid[:-1]
    hc = torch.clamp_max(hid, n - 1)
    live = torch.cat([
        _emit_keys(width, rect_min, ntt, m2d, conic, q_cap, rank, 0, L,
                   nbits, s),
        _emit_keys(width[hc], rect_min[hc],
                   torch.where(hid < n, ntt[hc], torch.zeros_like(hc)),
                   m2d[hc], conic[hc], q_cap[hc], hc, L, d_cap - L,
                   nbits, s)])
    return live, heavy_overflow


def dup_keys(prep: Preprocessed, order: torch.Tensor, nbits: int,
             settings: RasterSettings):
    """The live ``tile << nbits | depth_rank`` keys of the duplication
    table: (keys, ``heavy_overflow``, the key count as a [] int64 on the
    device, or None where only the host knows it).

    Row r is depth rank r, Gaussian ``order[r]``. The kernels
    (csrc/dup_keys.cu) give each row its allowance (``row_allowance``): with
    the split table the two tables become one emission into one buffer.
    ``dup_count`` counts each row's cells that the cull keeps; an inclusive
    scan of the counts gives each row's end, and one read of the total
    sizes the output; ``dup_emit`` writes each row's keys there. So the
    keys are row-major in depth order, as the full-width table's
    ``keys[valid]``, and the split table's are the same set as its two
    tables'. A CPU tensor takes the plain version (``dup_keys_plain``); a
    CUDA tensor launches the kernels.
    """
    if order.device.type == "cpu":
        return (*dup_keys_plain(prep, order, nbits, settings), None)
    s = settings
    n = order.shape[0]
    dev = order.device
    d_cap = s.max_tiles_per_gaussian
    kernels.check(order, "order", torch.int64, 1)
    # the fields may be column views (the Gaussian-sharded render's
    # gathered blocks): the kernels read rows of packed arrays
    f = {}
    for name, dtype, shape in (("rect_min", torch.int32, (n, 2)),
                               ("rect_max", torch.int32, (n, 2)),
                               ("n_tiles_touched", torch.int32, (n,)),
                               ("binnable", torch.bool, (n,)),
                               ("mean2d", torch.float32, (n, 2)),
                               ("conic", torch.float32, (n, 3)),
                               ("q_cap", torch.float32, (n,))):
        f[name] = getattr(prep, name).contiguous()
        kernels.check(f[name], name, dtype, len(shape), dev)
        if tuple(f[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(f[name].shape)}")
    if not 1 <= nbits <= 62 or not 0 <= n < 2**31 or not 0 < d_cap < 2**31:
        raise ValueError(f"nbits={nbits}, n={n}, D={d_cap} out of range")
    h_pos, heavy_overflow = None, torch.zeros((), dtype=torch.int64,
                                              device=dev)
    if uses_split_table(s):
        h_pos, heavy_overflow = heavy_rows(allowed_cells(prep, d_cap)[order],
                                           s)
    args = (order.data_ptr(), f["rect_min"].data_ptr(),
            f["rect_max"].data_ptr(), f["n_tiles_touched"].data_ptr(),
            f["binnable"].data_ptr(), f["mean2d"].data_ptr(),
            f["conic"].data_ptr(), f["q_cap"].data_ptr(),
            None if h_pos is None else h_pos.data_ptr(), n, d_cap,
            s.light_dup_width, s.heavy_rows_cap or 0, s.tiles_x, s.tile,
            int(s.tight_binning))
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    kernels.launch("dup_count", *args, counts.data_ptr())
    incl = torch.cumsum(counts, 0)                    # int64
    total = incl[-1] if n else torch.zeros((), dtype=torch.int64,
                                           device=dev)
    with trace.sync("emit_keys"):
        keys = torch.empty(int(total), dtype=torch.int64, device=dev)
    kernels.launch("dup_emit", *args, counts.data_ptr(), incl.data_ptr(),
                   nbits, keys.data_ptr())
    return keys, heavy_overflow, total


def _sorted_key_stream(prep: Preprocessed,
                       settings: RasterSettings) -> SortedKeyStream:
    """Duplication table (``dup_keys``) -> packed self-describing keys ->
    one sort."""
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
    dup_overflow = torch.sum(prep.n_tiles_touched > d_cap)
    live, heavy_overflow, n_live = dup_keys(prep, order, nbits, s)

    entry_overflow = torch.zeros((), dtype=torch.int64, device=dev)
    if s.max_total_entries is not None:
        if n_live is None:
            with trace.sync("entry_cap_to_device"):
                over = torch.tensor(live.numel() - s.max_total_entries,
                                    device=dev)
        else:
            over = n_live - s.max_total_entries
        entry_overflow = torch.clamp_min(over, 0)
        # the JAX compaction buffer of the full-width table: the farthest
        # Gaussians' entries beyond the cap are dropped (its keys are in
        # depth-major order; the split table's are not, and JAX's split
        # branch drops nothing either)
        if not uses_split_table(s) and n * d_cap > s.full_sort_below:
            live = live[: s.max_total_entries]
    return SortedKeyStream(sorted_packed=torch.sort(live).values, order=order,
                           nbits=nbits, dup_overflow=dup_overflow,
                           entry_overflow=entry_overflow,
                           heavy_overflow=heavy_overflow)


class EntryStream(NamedTuple):
    """128-aligned variable-length per-tile entry stream (no K cap)."""
    rank: torch.Tensor        # [E_al] int32 depth rank per slot; n on pads
    chunk_tile: torch.Tensor  # [E_al/128] int32 owning (local) tile; void:
                              # the range's tile count
    order: torch.Tensor       # [N] int64 depth rank -> gaussian index
    count: torch.Tensor       # [T] int32 live entries per (local) tile
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

    It reads only ``src0`` and ``nlive``, which ``chunk_layout`` computes
    for the range it lays out, so a tile range's stream needs no other
    form of the kernel.

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
    return rank


class ChunkLayout(NamedTuple):
    """Where each 128-slot chunk of the stream reads its keys. Tile ids
    are local to the laid-out range: local tile t is global tile
    tile0 + t."""
    chunk_tile: torch.Tensor   # [n_chunks] int32 owning tile (t_loc: void)
    src0: torch.Tensor         # [n_chunks] int64 sorted-key index of slot 0
    nlive: torch.Tensor        # [n_chunks] int32 live slots of the chunk
    count: torch.Tensor        # [t_loc] int64 live entries per tile
    astart: torch.Tensor       # [t_loc] int64 first slot of each segment
    stream_drop: torch.Tensor  # [] entries cut by the stream capacity


def chunk_layout(keys: torch.Tensor, nbits: int, settings: RasterSettings,
                 e_al: int | None = None, tile0: int = 0,
                 t_loc: int | None = None) -> ChunkLayout:
    """Per-tile segments and per-chunk key sources of the 128-aligned
    stream over sorted ``keys``, for tiles [tile0, tile0 + t_loc) (default:
    the whole image). ``e_al=None`` sizes the stream from the counts (at
    least one chunk). Tile ids past the image (the padded tail of the last
    range) clamp to the image's end, so their segments are empty."""
    s = settings
    if t_loc is None:
        t_loc = s.n_tiles
    dev = keys.device

    boundaries = torch.clamp_max(
        tile0 + torch.arange(t_loc + 1, dtype=torch.int64, device=dev),
        s.n_tiles) << nbits
    bounds = torch.searchsorted(keys, boundaries)
    start = bounds[:-1]
    count_raw = bounds[1:] - start                           # uncapped
    ccount = (count_raw + CHUNK - 1) // CHUNK * CHUNK
    astart = torch.cumsum(ccount, 0) - ccount
    with trace.sync("stream_total"):
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
                           n: int, e_al: int | None = None, tile0: int = 0,
                           t_loc: int | None = None) -> EntryStream:
    """Lay out the 128-aligned entry stream of tiles [tile0, tile0 + t_loc)
    (default: the whole image) from a sorted key stream, with local tile
    ids (``chunk_tile``, ``count``, ``astart``; void chunks hold t_loc).
    ``e_al=None`` sizes it from the counts (at least one chunk)."""
    lay = chunk_layout(ks.sorted_packed, ks.nbits, settings, e_al, tile0,
                       t_loc)
    rank = extract_chunks(ks.sorted_packed, lay.src0, lay.nlive, ks.nbits, n)
    return EntryStream(rank=rank, chunk_tile=lay.chunk_tile, order=ks.order,
                       count=lay.count.to(torch.int32),
                       astart=lay.astart.to(torch.int32),
                       dup_overflow=ks.dup_overflow,
                       entry_overflow=ks.entry_overflow + lay.stream_drop,
                       heavy_overflow=ks.heavy_overflow)


def bin_entry_stream(prep: Preprocessed,
                     settings: RasterSettings) -> EntryStream:
    n = prep.depth.shape[0]
    if not entry_stream_supported(n, settings):
        raise ValueError("(n_tiles + 1) << ceil(log2 N) exceeds the int64 key")
    ks = _sorted_key_stream(prep, settings)
    return entry_stream_from_keys(ks, settings, n,
                                  entry_stream_cap(settings, n))


# ---------------------------------------------------------------------------
# The [T, K] window path


class TileBins(NamedTuple):
    rank: torch.Tensor        # [T, K] int32 depth rank per window slot (junk
                              # outside [delta, delta + count); at most N-1);
                              # [T, K + 128] on the aligned row-gather path
    delta: torch.Tensor       # [T] int32 leading foreign entries per window
    order: torch.Tensor       # [N] int64 depth rank -> gaussian index
    count: torch.Tensor       # [T] int32 live slots (at [delta, delta+count))
    full_count: torch.Tensor  # [T] int32 pre-truncation count
    dup_overflow: torch.Tensor
    entry_overflow: torch.Tensor
    heavy_overflow: torch.Tensor  # [] see SortedKeyStream


def gids(bins: TileBins) -> torch.Tensor:
    """[T, K] Gaussian index per slot (junk outside the live range)."""
    return bins.order[bins.rank]


def _pad128(keys: torch.Tensor, sentinel: int, extra: int = 0) -> torch.Tensor:
    """Append ``extra`` sentinels, then more up to a multiple of 128."""
    e = keys.shape[0]
    pad = extra + (-(e + extra)) % 128
    if pad:
        keys = torch.cat([keys, torch.full((pad,), sentinel, dtype=keys.dtype,
                                           device=keys.device)])
    return keys


def extract_windows_plain(keys: torch.Tensor, start: torch.Tensor,
                          k_cap: int, nbits: int, n: int) -> torch.Tensor:
    """Plain version of the ``extract_windows`` kernel, the per-element
    gather of ``_windows``: ``rank[t, j] = min(keys[start[t] + j] & mask,
    n - 1)`` for j < ``k_cap``, the index clipped to the array as in the
    JAX package. Returns [T, k_cap] int32."""
    slot = torch.arange(k_cap, dtype=torch.int64, device=keys.device)
    idx = torch.clamp(start[:, None] + slot, 0, keys.shape[0] - 1)
    return torch.clamp_max(keys[idx] & ((1 << nbits) - 1), n - 1).to(
        torch.int32)


def extract_windows(keys: torch.Tensor, start: torch.Tensor, k_cap: int,
                    nbits: int, n: int) -> torch.Tensor:
    """The [T, K] window gather fused with the rank decode; see
    ``extract_windows_plain`` for what it computes.

    Replaces the TPU kernel ``das3r_tpu/ops/splat/binning.py::
    _extract_windows_pallas``, whose row DMA, lane roll and stitch exist
    only because Mosaic cannot DMA at an element offset. On the H100 it is
    bound by memory: per slot one 8-byte key read and one 4-byte rank
    write, so the kernel (csrc/extract_windows.cu) is one thread per slot,
    consecutive slots of a window on consecutive threads. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel.
    """
    if keys.device.type == "cpu":
        return extract_windows_plain(keys, start, k_cap, nbits, n)
    kernels.check(keys, "keys", torch.int64, 1)
    kernels.check(start, "start", torch.int64, 1, keys.device)
    if not 1 <= nbits <= 62 or not 1 <= n < 2**31 or keys.numel() == 0:
        raise ValueError(f"nbits={nbits}, n={n}, {keys.numel()} keys: "
                         "out of range")
    if not 1 <= k_cap < 2**31 or start.shape[0] > 65535:
        raise ValueError(f"k_cap={k_cap}, {start.shape[0]} tiles: out of "
                         "range")
    rank = torch.empty(start.shape[0], k_cap, dtype=torch.int32,
                       device=keys.device)
    kernels.launch("extract_windows", keys.data_ptr(), keys.numel(),
                   start.data_ptr(), start.shape[0], k_cap, nbits, n,
                   rank.data_ptr())
    return rank


def _windows(sorted_keys: torch.Tensor, nbits: int, n: int, n_tiles: int,
             k_cap: int, use_dma: bool = True):
    """Cut per-tile [start, start + K) windows from the sorted live keys
    and decode their depth ranks.

    The keys are padded here with K + 128 sentinels (and up to a multiple
    of 128), so a window read at any tile start stays in the array. Three
    implementations with the JAX package's semantics (count =
    min(full_count, K) nearest entries):

      * K a multiple of 128 and ``use_dma``: the ``extract_windows`` kernel
        on CUDA at the exact element offset; ``delta`` is 0.
      * K a multiple of 128 and not ``use_dma``: windows start at the
        previous multiple of 128 and are a whole-row gather of K + 128
        entries; the up-to-127 foreign leading entries are reported in
        ``delta`` and masked by the blend.
      * otherwise the per-element gather (``extract_windows_plain``).

    Returns (rank [T, K or K+128] int32, delta, count, full_count)."""
    dev = sorted_keys.device
    sentinel = ((n_tiles + 1) << nbits) - 1
    keys = _pad128(sorted_keys, sentinel, extra=k_cap + 128)
    e = keys.shape[0]
    boundaries = torch.arange(n_tiles + 1, dtype=torch.int64,
                              device=dev) << nbits
    bounds = torch.searchsorted(keys, boundaries)
    start = bounds[:-1]
    full_count = (bounds[1:] - start).to(torch.int32)
    k_pad = k_cap + 128
    zeros = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    if k_cap % 128 == 0 and use_dma:
        delta = zeros
        rank = extract_windows(keys, start, k_cap, nbits, n)
    elif k_cap % 128 == 0:
        start_al = torch.clamp_max(start // 128 * 128, e - k_pad)
        delta = torch.where(full_count > 0, (start - start_al).to(torch.int32),
                            zeros)
        widx = (start_al // 128)[:, None] + torch.arange(
            k_pad // 128, dtype=torch.int64, device=dev)
        win = keys.reshape(e // 128, 128)[widx].reshape(n_tiles, k_pad)
        rank = torch.clamp_max(win & ((1 << nbits) - 1), n - 1).to(
            torch.int32)
    else:
        delta = zeros
        rank = extract_windows_plain(keys, start, k_cap, nbits, n)
    count = torch.clamp_max(full_count, k_cap)
    return rank, delta, count, full_count


def quantized_depth(depth: torch.Tensor, alive: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """[N] int64 depth quantized to ``bits`` over the live depth range, in
    f32 in the JAX package's order of operations (binning.py:728-732):
    (depth - dmin) * ((2^bits - 1) / max(dmax - dmin, 1e-12)), clipped to
    [0, 2^bits - 1] and truncated."""
    inf = torch.tensor(float("inf"), device=depth.device)
    dmin = torch.where(alive, depth, inf).min()
    dmax = torch.where(alive, depth, -inf).max()
    scale = (2.0**bits - 1.0) / torch.clamp_min(dmax - dmin, 1e-12)
    return torch.clamp((depth - dmin) * scale, 0.0,
                       2.0**bits - 1.0).to(torch.int64)


def _bin_quantized_depth(prep: Preprocessed,
                         settings: RasterSettings) -> TileBins:
    """The [T, K] windows from ``tile << bits | quantized depth`` keys
    (``_bin_quantized_depth`` of the JAX package, binning.py:714-778): no
    depth argsort; the sorted payload is the Gaussian id, so ``rank`` is
    the Gaussian index and ``order`` the identity. The cells are the rect
    cells (no tight-binning cull), in a buffer of ``max_total_entries``
    (default N * D) filled in Gaussian order: the entries past it are
    dropped and counted in ``entry_overflow``. The sort is stable (module
    docstring)."""
    s = settings
    n = prep.depth.shape[0]
    dev = prep.depth.device
    d_cap = s.max_tiles_per_gaussian
    bits = s.depth_sort_bits
    e_cap = s.max_total_entries or n * d_cap
    alive = prep.binnable.to(torch.bool)
    depth_q = quantized_depth(prep.depth, alive, bits)

    width = torch.clamp_min(prep.rect_max[:, 0] - prep.rect_min[:, 0], 1)
    ntt = torch.where(alive, torch.clamp_max(prep.n_tiles_touched, d_cap),
                      torch.zeros_like(prep.n_tiles_touched)).to(torch.int64)
    dup_overflow = torch.sum(prep.n_tiles_touched > d_cap)
    d_idx = torch.arange(d_cap, dtype=torch.int64, device=dev)[None, :]
    w = width.to(torch.int64)[:, None]
    ty = prep.rect_min[:, 1:2].to(torch.int64) + d_idx // w
    tx = prep.rect_min[:, 0:1].to(torch.int64) + d_idx % w
    key = ((ty * s.tiles_x + tx) << bits) | depth_q[:, None]
    base = torch.cumsum(ntt, 0) - ntt
    in_buf = (alive[:, None] & (d_idx < ntt[:, None])
              & (base[:, None] + d_idx < e_cap))
    entry_overflow = torch.clamp_min(ntt.sum() - e_cap, 0)
    gid = torch.arange(n, dtype=torch.int64, device=dev)[:, None].expand(
        n, d_cap)
    # The buffer's live prefix in Gaussian order; JAX's sentinels sort
    # after every live key and are never read as live.
    sorted_key, perm = torch.sort(key[in_buf], stable=True)
    sorted_gid = gid[in_buf][perm]

    tile_ids = torch.arange(s.n_tiles + 1, dtype=torch.int64, device=dev)
    bounds = torch.searchsorted(sorted_key >> bits, tile_ids, side="left")
    start = bounds[:-1]
    full_count = (bounds[1:] - start).to(torch.int32)
    K = s.max_per_tile
    slot = torch.arange(K, dtype=torch.int64, device=dev)[None, :]
    padded = torch.cat([sorted_gid, sorted_gid.new_zeros(K)])
    rank = torch.clamp_max(padded[start[:, None] + slot], n - 1).to(
        torch.int32)
    zeros = torch.zeros((), dtype=torch.int64, device=dev)
    return TileBins(rank=rank,
                    delta=torch.zeros(s.n_tiles, dtype=torch.int32,
                                      device=dev),
                    order=torch.arange(n, dtype=torch.int64, device=dev),
                    count=torch.clamp_max(full_count, K),
                    full_count=full_count, dup_overflow=dup_overflow,
                    entry_overflow=entry_overflow, heavy_overflow=zeros)


def uses_quantized_depth(settings: RasterSettings) -> bool:
    """Whether ``bin_gaussians`` takes the quantized-depth binning: as in
    the JAX package, when ``depth_sort_bits > 0`` and its keys fit 32
    bits; else the exact path."""
    s = settings
    return (s.depth_sort_bits > 0
            and (s.n_tiles + 1) << s.depth_sort_bits <= 2**32)


def bin_gaussians(prep: Preprocessed, settings: RasterSettings) -> TileBins:
    """Bin into [T, K] windows of ``settings.max_per_tile`` slots; a tile
    with more entries keeps its K nearest (``tile_overflow``). With
    ``depth_sort_bits`` (``uses_quantized_depth``) the keys carry the
    quantized depth (``_bin_quantized_depth``)."""
    s = settings
    if uses_quantized_depth(s):
        return _bin_quantized_depth(prep, s)
    n = prep.depth.shape[0]
    if not entry_stream_supported(n, s):
        raise ValueError("(n_tiles + 1) << ceil(log2 N) exceeds the int64 key")
    ks = _sorted_key_stream(prep, s)
    rank, delta, count, full_count = _windows(
        ks.sorted_packed, ks.nbits, n, s.n_tiles, s.max_per_tile,
        s.use_dma_windows)
    return TileBins(rank=rank, delta=delta, order=ks.order, count=count,
                    full_count=full_count, dup_overflow=ks.dup_overflow,
                    entry_overflow=ks.entry_overflow,
                    heavy_overflow=ks.heavy_overflow)
