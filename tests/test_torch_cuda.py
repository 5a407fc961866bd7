"""PyTorch port: each CUDA kernel against its plain version, on the card.

Marked ``cuda``; every test skips without a GPU. The file imports neither
JAX nor the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` because ``tests/conftest.py`` configures JAX). Inputs
are made with numpy from a seed; the plain versions run on the CPU.
"""
import numpy as np
import pytest
import torch

from das3r_tpu_torch.ops.splat import RasterSettings
from das3r_tpu_torch.ops.splat import binning, entry_blend, window_blend
from das3r_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda
BLEND_TOL = 2e-4   # serial product vs chunked cumprod near T = 1e-4
# x max|g| per column group: the JAX gradient bar. Kernel C restores T by a
# fast reciprocal where the plain version replays a chunked product, and
# its atomics add in an order that changes from run to run.
GRAD_TOL = 2e-5
GROUPS = {"mean2d": [0, 1], "conic": [2, 3, 4], "color": [5, 6, 7],
          "opacity": [8]}


def launched(kernel: str) -> int:
    """Launches of ``kernel`` so far (``launch/<kernel>``)."""
    return trace.counters().get("launch/" + kernel, 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels run only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("nbits", [1, 12, 23])
def test_extract_chunks_kernel_matches_plain(cuda, nbits):
    rng = np.random.default_rng(nbits)
    n = 2 ** (nbits - 1) + 1
    assert binning.rank_bits(n) == nbits
    n_tiles = 8160                                   # 1080p
    # rank fields up to the mask, so the min(., n - 1) clamp is exercised
    keys = np.unique((rng.integers(0, n_tiles, 6000) << nbits)
                     | rng.integers(0, 2 ** nbits, 6000))
    m = keys.size
    src0 = rng.integers(0, m - 1, 64)
    nlive = np.minimum(rng.integers(0, 129, 64), m - src0)
    src0[:3], nlive[:3] = [0, m - 5, 17], [128, 5, 0]  # full, at the end, empty
    args = [torch.as_tensor(keys), torch.as_tensor(src0),
            torch.as_tensor(nlive.astype(np.int32))]
    want = binning.extract_chunks(*args, nbits, n)         # CPU: plain
    before = launched("extract_chunks")
    got = binning.extract_chunks(*(a.to(cuda) for a in args), nbits, n)
    torch.cuda.synchronize()
    assert launched("extract_chunks") == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


def random_stream(rng, settings, counts, n_rows, saturate):
    """A 128-aligned stream over a random attribute table: tile t holds
    ``counts[t]`` random ranks; pads and the sentinel row are rank n_rows."""
    s = settings
    aligned = -(-counts // 128) * 128
    astart = np.cumsum(aligned) - aligned
    rank = np.full(max(int(aligned.sum()), 128), n_rows, np.int32)
    for a, c in zip(astart, counts):
        rank[a:a + c] = rng.integers(0, n_rows, c)
    sx, sy = (rng.uniform(20, 60, (2, n_rows)) if saturate
              else rng.uniform(0.7, 12, (2, n_rows)))
    rho = rng.uniform(-0.6, 0.6, n_rows)
    cxx, cyy, cxy = sx * sx, sy * sy, rho * sx * sy
    det = cxx * cyy - cxy * cxy
    table = np.zeros((n_rows + 1, entry_blend.N_ATTR), np.float32)
    table[:-1, 0] = rng.uniform(-8, s.tiles_x * s.tile + 8, n_rows)
    table[:-1, 1] = rng.uniform(-8, s.tiles_y * s.tile + 8, n_rows)
    table[:-1, 2:5] = np.stack([cyy / det, -cxy / det, cxx / det], -1)
    table[:-1, 5:8] = rng.uniform(0, 1, (n_rows, 3))
    table[:-1, 8] = (rng.uniform(0.7, 0.99, n_rows) if saturate
                     else rng.uniform(0.0, 0.99, n_rows))
    return [torch.as_tensor(table), torch.as_tensor(rank),
            torch.as_tensor(astart.astype(np.int32)),
            torch.as_tensor(counts.astype(np.int32))]


# "sparse": random splats; "saturate": broad near-opaque splats that end
# tiles early; "gap": tile 5 holds a run of 100 entries of a row far off
# the image, so whole backward batches are seen by no pixel; "shared_row":
# the first 64 entries of every tile are one broad faint splat's row, so the
# backward's table-row atomics collide within and across blocks;
# "boundaries": random splats on lists of a batch's length and one either
# side of it, for batches of 64, 128 and 256 entries, and of two to six
# 128-entry batches (kernel B stages each 128-entry batch in place);
# "cancelling": "shared_row" re-drawn on the "boundaries" lengths, where
# row 0's opacity gradient sums tile terms that cancel 45-fold, so it has a
# bar of its own (``cancelling_bar``).
BLEND_CASES = ["sparse", "saturate", "gap", "shared_row", "boundaries"]
FORWARD_CASES = ["sparse", "saturate", "boundaries"]


@pytest.mark.parametrize("variant", FORWARD_CASES)
def test_blend_forward_kernel_matches_plain(cuda, variant):
    """See ``blend_case``; with ``saturate`` tiles end early."""
    s, args = blend_case(variant)
    plain = entry_blend.blend_forward_plain(*args, s)
    if variant == "saturate":
        assert plain.chunks_skipped > 0, "fixture no longer saturates"
    before = launched("blend_forward")
    cpre, tfinal = entry_blend.blend_forward(*(a.to(cuda) for a in args), s)
    torch.cuda.synchronize()
    assert launched("blend_forward") == before + 1
    assert cpre.shape == plain.cpre.shape and tfinal.shape == plain.tfinal.shape
    torch.testing.assert_close(cpre.cpu(), plain.cpre, atol=BLEND_TOL, rtol=0)
    torch.testing.assert_close(tfinal.cpu(), plain.tfinal, atol=BLEND_TOL,
                               rtol=0)
    assert (cpre[0] == 0).all() and (tfinal[0] == 1).all()   # empty tile


def blend_case(variant):
    """The blend kernels' fixture: tile lists of 0, 1, 255, 256, 257 and
    1500 entries (batch boundaries of the forward's 128-entry and the
    backward's 16- or 32-entry batches, and lengths that are multiples of
    neither), partial edge tiles, and the ``BLEND_CASES`` variant."""
    saturate = variant == "saturate"
    rng = np.random.default_rng(7 + saturate + 2 * (variant == "boundaries"))
    s = RasterSettings(image_height=72, image_width=88)
    counts = rng.integers(0, 700, s.n_tiles)
    counts[:6] = [0, 1, 255, 256, 257, 1500]
    if variant in ("boundaries", "cancelling"):
        counts[:20] = [0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 257, 383,
                       384, 385, 511, 512, 513, 767, 768, 1500]
    args = random_stream(rng, s, counts, 3000, saturate)
    table, rank, astart, count = args
    if variant == "gap":
        table[0, :2] = -1000.0
        rank[int(astart[5]) + 600:int(astart[5]) + 700] = 0
    elif variant in ("shared_row", "cancelling"):
        table[0] = torch.tensor([44.0, 36.0, 1 / 1600, 0.0, 1 / 1600,
                                 0.3, 0.6, 0.9, 0.05])
        for a, c in zip(astart.tolist(), count.tolist()):
            rank[a:a + min(c, 64)] = 0
    return s, args


@pytest.mark.parametrize("variant", FORWARD_CASES)
def test_blend_forward_n_last_matches_plain(cuda, variant):
    """The kernel's n_last (one past each pixel's last contributing entry)
    against the plain forward's. A pixel may differ where the serial and
    the chunked products of T round to opposite sides of eps, as for the
    forward's 2e-4 bar; such pixels are rare."""
    s, args = blend_case(variant)
    plain = entry_blend.blend_forward_plain(*args, s)
    cpre, tfinal, n_last = entry_blend.blend_forward(
        *(a.to(cuda) for a in args), s, for_backward=True)
    torch.cuda.synchronize()
    assert n_last.dtype == torch.int32 and n_last.shape == plain.n_last.shape
    same = (n_last.cpu() == plain.n_last).float().mean()
    assert same >= 0.999, float(same)
    assert (n_last.cpu() <= args[3][:, None]).all()
    assert (n_last[0] == 0).all() and int(n_last.max()) > 0
    torch.testing.assert_close(cpre.cpu(), plain.cpre, atol=BLEND_TOL, rtol=0)


@pytest.mark.parametrize("variant", FORWARD_CASES)
def test_blend_forward_kernel_is_deterministic(cuda, variant):
    """Kernel B: two launches on the same inputs agree bit for bit, with
    and without n_last."""
    s, args = blend_case(variant)
    dev = [a.to(cuda) for a in args]
    for for_backward in (False, True):
        first = entry_blend.blend_forward(*dev, s, for_backward=for_backward)
        second = entry_blend.blend_forward(*dev, s, for_backward=for_backward)
        torch.cuda.synchronize()
        for a, b, name in zip(first, second, ("cpre", "tfinal", "n_last")):
            assert torch.equal(a, b), (name, for_backward)


@pytest.mark.parametrize("variant", FORWARD_CASES)
def test_blend_forward_n_last_leaves_outputs_bitwise(cuda, variant):
    """Kernel B's instantiation that writes n_last blends as the serving
    one does: cpre and tfinal equal bit for bit."""
    s, args = blend_case(variant)
    dev = [a.to(cuda) for a in args]
    cpre, tfinal = entry_blend.blend_forward(*dev, s)
    cpre_n, tfinal_n, _ = entry_blend.blend_forward(*dev, s,
                                                    for_backward=True)
    torch.cuda.synchronize()
    assert torch.equal(cpre, cpre_n) and torch.equal(tfinal, tfinal_n)


@pytest.mark.parametrize("variant", FORWARD_CASES)
def test_blend_forward_kernel_equals_window_kernel(cuda, variant):
    """Kernels B and D run blend_step.cuh's step on the same lists in the
    same order: B on the case's entry stream and D on the same lists laid
    out as [T, 9, K] windows (delta 0, K = 1536, no background) give
    bitwise the same colour and final transmittance."""
    s, args = blend_case(variant)
    table, rank, astart, count = args
    k_width = 1536
    assert int(count.max()) <= k_width
    attrs = torch.zeros(s.n_tiles, entry_blend.N_ATTR, k_width)
    for t, (a, c) in enumerate(zip(astart.tolist(), count.tolist())):
        attrs[t, :, :c] = table[rank[a:a + c].long()].T
    dev = [a.to(cuda) for a in args]
    cpre, tfinal = entry_blend.blend_forward(*dev, s)
    colors, tfinal_d, _ = window_blend.window_forward(
        attrs.to(cuda), count.to(cuda),
        torch.zeros_like(count).to(cuda), torch.zeros(3, device=cuda), s)
    torch.cuda.synchronize()
    assert torch.equal(cpre, colors.transpose(1, 2))
    assert torch.equal(tfinal[:, 0], tfinal_d)


@pytest.mark.parametrize("variant", BLEND_CASES)
def test_blend_backward_kernel_matches_plain(cuda, variant):
    s, args = blend_case(variant)
    rng = np.random.default_rng(11 + BLEND_CASES.index(variant))
    P = s.tile * s.tile
    g_cpre = torch.as_tensor(rng.normal(size=(s.n_tiles, 3, P)).astype(
        np.float32))
    g_tfinal = torch.as_tensor(rng.normal(size=(s.n_tiles, 1, P)).astype(
        np.float32))
    fwd = entry_blend.blend_forward_plain(*args, s)
    want = entry_blend.blend_backward_plain(
        *args, s, fwd.tfinal, fwd.tin, g_cpre, g_tfinal).g_table
    dev = [a.to(cuda) for a in args]
    _, tfinal, n_last = entry_blend.blend_forward(*dev, s, for_backward=True)
    before = launched("blend_backward")
    got = entry_blend.blend_backward(*dev, s, tfinal, n_last,
                                     g_cpre.to(cuda), g_tfinal.to(cuda))
    torch.cuda.synchronize()
    assert launched("blend_backward") == before + 1
    assert got.shape == want.shape and got.device.type == "cuda"
    got = got.cpu()
    assert torch.isfinite(got).all() and (got[-1] == 0).all()  # sentinel
    for name, cols in GROUPS.items():
        ref = float(want[:, cols].abs().max())
        assert ref > 0, name
        torch.testing.assert_close(got[:, cols], want[:, cols],
                                   atol=GRAD_TOL * ref, rtol=0, msg=name)


# The "cancelling" instance's bar. Its tile terms cancel, so the float32
# sums of both versions are off the float64 value by a share of the terms'
# magnitudes, not of the result: per element, |g - g64| <= CANCEL_TOL x
# sum_t |term_t|, the float64 sum of the magnitudes of the tile terms (each
# the plain backward of one tile's list), or the JAX bar GRAD_TOL x max|g64|
# of the column group, whichever is larger (a tile's term is itself a sum
# over its pixels, whose cancellation the tile terms do not show; it is
# small against the group's largest value). A float32 sum of 30 tile terms
# is within 30 x 6e-8 of their magnitudes; CANCEL_TOL leaves ~5x for the
# terms' own rounding.
CANCEL_TOL = 1e-5
CANCEL_SEED = 14        # the cotangents (shared_row's)


def cancelling_case():
    """(settings, stream args, g_cpre, g_tfinal) of the "cancelling"
    instance."""
    s, args = blend_case("cancelling")
    rng = np.random.default_rng(CANCEL_SEED)
    P = s.tile * s.tile
    g_cpre = torch.as_tensor(rng.normal(size=(s.n_tiles, 3, P)).astype(
        np.float32))
    g_tfinal = torch.as_tensor(rng.normal(size=(s.n_tiles, 1, P)).astype(
        np.float32))
    return s, args, g_cpre, g_tfinal


def f64_grad_and_terms(s, args, g_cpre, g_tfinal):
    """(g64, sum_t |term_t|) [M, 9] float64: the plain forward and
    backward run in float64, once per tile's list (the other tiles' counts
    0), the terms summed and their magnitudes summed."""
    table, rank, astart, count = args
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)     # the plain versions' buffers
    try:
        t64 = table.double()
        fwd = entry_blend.blend_forward_plain(t64, rank, astart, count, s)
        g64 = torch.zeros_like(t64)
        mag = torch.zeros_like(t64)
        for t in count.nonzero().squeeze(1).tolist():
            one = torch.zeros_like(count)
            one[t] = count[t]
            term = entry_blend.blend_backward_plain(
                t64, rank, astart, one, s, fwd.tfinal, fwd.tin,
                g_cpre.double(), g_tfinal.double()).g_table
            g64 += term
            mag += term.abs()
    finally:
        torch.set_default_dtype(prev)
    return g64, mag


def cancelling_bar(got, g64, mag) -> dict:
    """Hold ``got`` to the "cancelling" bar (above); per column group, the
    worst |got - g64| against the bar, and how many elements are beyond
    the JAX bar alone."""
    err = (got.double() - g64).abs()
    out = {}
    for name, cols in GROUPS.items():
        jax_bar = GRAD_TOL * float(g64[:, cols].abs().max())
        bar = torch.clamp_min(CANCEL_TOL * mag[:, cols], jax_bar)
        e = err[:, cols]
        assert (e <= bar).all(), (name, float((e / bar).max()))
        out[name] = dict(worst_over_bar=float((e / bar).max()),
                         beyond_jax_bar=int((e > jax_bar).sum()))
    return out


def test_blend_backward_kernel_meets_the_cancelling_bar(cuda):
    """Kernel C on the "cancelling" instance, against the float64 value
    at the bar scaled by the terms' magnitudes (``cancelling_bar``)."""
    s, args, g_cpre, g_tfinal = cancelling_case()
    g64, mag = f64_grad_and_terms(s, args, g_cpre, g_tfinal)
    dev = [a.to(cuda) for a in args]
    _, tfinal, n_last = entry_blend.blend_forward(*dev, s, for_backward=True)
    got = entry_blend.blend_backward(*dev, s, tfinal, n_last,
                                     g_cpre.to(cuda), g_tfinal.to(cuda))
    torch.cuda.synchronize()
    print(cancelling_bar(got.cpu(), g64, mag))


def range_args(args, tile0, t_loc):
    """One tile range of a ``blend_case`` stream: its tiles' counts and
    segment starts (count 0 past the image), over the same ranks."""
    _, rank, astart, count = args
    k = max(min(t_loc, count.shape[0] - tile0), 0)
    loc_count = torch.zeros(t_loc, dtype=torch.int32)
    loc_astart = torch.zeros(t_loc, dtype=torch.int32)
    loc_count[:k] = count[tile0:tile0 + k]
    loc_astart[:k] = astart[tile0:tile0 + k]
    return [args[0], rank, loc_astart, loc_count]


# The tile-range form of B and C on the existing instances (no new draw):
# the image's 30 tiles as 4 ranges of 8, the last with 2 padded tiles.
RANGE_TILE0 = {"first": 0, "second": 8, "last": 24}


@pytest.mark.parametrize("where", list(RANGE_TILE0))
@pytest.mark.parametrize("variant", FORWARD_CASES)
def test_blend_kernels_on_a_tile_range_match_plain(cuda, variant, where):
    """Kernels B and C on one tile range (``tile0``, ``n_tiles_out``)
    against their plain versions at the bars of the whole-image tests; B's
    rows bitwise the whole-image launch's rows of those tiles; a padded
    tile (0, 1) and no gradient."""
    s, args = blend_case(variant)
    tile0, t_loc = RANGE_TILE0[where], 8
    assert -(-s.n_tiles // 4) == t_loc
    loc = range_args(args, tile0, t_loc)
    rng = dict(tile0=tile0, n_tiles_out=t_loc)
    plain = entry_blend.blend_forward_plain(*loc, s, **rng)
    dev = [a.to(cuda) for a in loc]
    cpre, tfinal, n_last = entry_blend.blend_forward(*dev, s, True, **rng)
    whole, whole_t = entry_blend.blend_forward(*(a.to(cuda) for a in args),
                                               s)
    torch.cuda.synchronize()
    torch.testing.assert_close(cpre.cpu(), plain.cpre, atol=BLEND_TOL,
                               rtol=0)
    torch.testing.assert_close(tfinal.cpu(), plain.tfinal, atol=BLEND_TOL,
                               rtol=0)
    k = min(t_loc, s.n_tiles - tile0)
    assert torch.equal(cpre[:k], whole[tile0:tile0 + k])
    assert torch.equal(tfinal[:k], whole_t[tile0:tile0 + k])
    assert (cpre[k:] == 0).all() and (tfinal[k:] == 1).all()
    assert (n_last[k:] == 0).all()

    gen = np.random.default_rng(31 + tile0)
    P = s.tile * s.tile
    g_cpre = torch.as_tensor(gen.normal(size=(t_loc, 3, P)).astype(
        np.float32))
    g_tfinal = torch.as_tensor(gen.normal(size=(t_loc, 1, P)).astype(
        np.float32))
    want = entry_blend.blend_backward_plain(
        *loc, s, plain.tfinal, plain.tin, g_cpre, g_tfinal, **rng).g_table
    got = entry_blend.blend_backward(*dev, s, tfinal, n_last,
                                     g_cpre.to(cuda), g_tfinal.to(cuda),
                                     **rng)
    torch.cuda.synchronize()
    got = got.cpu()
    assert torch.isfinite(got).all() and (got[-1] == 0).all()
    for name, cols in GROUPS.items():
        ref = float(want[:, cols].abs().max())
        assert ref > 0, name
        torch.testing.assert_close(got[:, cols], want[:, cols],
                                   atol=GRAD_TOL * ref, rtol=0, msg=name)


@pytest.mark.parametrize("variant", FORWARD_CASES)
def test_blend_forward_range_from_zero_is_the_whole_launch(cuda, variant):
    """B with tile0 = 0 and n_tiles_out = n_tiles is bitwise the launch
    that names neither."""
    s, args = blend_case(variant)
    dev = [a.to(cuda) for a in args]
    for for_backward in (False, True):
        a = entry_blend.blend_forward(*dev, s, for_backward)
        b = entry_blend.blend_forward(*dev, s, for_backward, tile0=0,
                                      n_tiles_out=s.n_tiles)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_blend_backward_autograd_launches_both_kernels(cuda):
    s, args = blend_case("sparse")
    table = args[0].to(cuda).requires_grad_(True)
    f0 = launched("blend_forward")
    b0 = launched("blend_backward")
    cpre, tfinal = entry_blend.blend_entry_stream(
        table, *(a.to(cuda) for a in args[1:]), s)
    (cpre.sum() + tfinal.sum()).backward()
    torch.cuda.synchronize()
    assert launched("blend_forward") == f0 + 1
    assert launched("blend_backward") == b0 + 1
    assert torch.isfinite(table.grad).all() and table.grad.abs().sum() > 0


def test_kernel_wrappers_raise_on_bad_cuda_input(cuda):
    s = RasterSettings(image_height=32, image_width=32)
    keys = torch.arange(512, device=cuda)
    src0 = torch.arange(0, 512, 128, device=cuda)
    nlive = torch.full((4,), 128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int64"):
        binning.extract_chunks(keys.int(), src0, nlive, 9, 512)
    with pytest.raises(ValueError, match="contiguous"):
        binning.extract_chunks(keys, torch.arange(0, 1024, 128,
                                                  device=cuda)[::2],
                               nlive, 9, 512)
    with pytest.raises(ValueError, match="must be on"):
        binning.extract_chunks(keys, src0.cpu(), nlive, 9, 512)

    table = torch.zeros(5, entry_blend.N_ATTR, device=cuda)
    rank = torch.full((128,), 4, dtype=torch.int32, device=cuda)
    per_tile = torch.zeros(s.n_tiles, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        entry_blend.blend_forward(table.double(), rank, per_tile, per_tile, s)
    with pytest.raises(ValueError, match=r"\[M, 9\]"):
        entry_blend.blend_forward(table[:, :8].contiguous(), rank, per_tile,
                                  per_tile, s)
    with pytest.raises(ValueError, match="must be on"):
        entry_blend.blend_forward(table, rank.cpu(), per_tile, per_tile, s)
    with pytest.raises(ValueError, match="tiles"):
        entry_blend.blend_forward(table, rank, per_tile[:2], per_tile[:2], s)

    P = s.tile * s.tile
    tfinal = torch.ones(s.n_tiles, 1, P, device=cuda)
    n_last = torch.zeros(s.n_tiles, P, dtype=torch.int32, device=cuda)
    g_cpre = torch.zeros(s.n_tiles, 3, P, device=cuda)
    good = (table, rank, per_tile, per_tile, s, tfinal, n_last, g_cpre,
            tfinal)
    entry_blend.blend_backward(*good)
    for i, bad, match in (
            (6, n_last.long(), "int32"),
            (6, n_last[:, :128].contiguous(), r"must be \("),
            (7, g_cpre.transpose(1, 2), "3-D|contiguous"),
            (8, tfinal.cpu(), "must be on"),
            (0, table.double(), "float32")):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError, match=match):
            entry_blend.blend_backward(*args)


@pytest.mark.parametrize("nbits,k_cap", [(9, 128), (23, 1024)])
def test_extract_windows_kernel_matches_plain(cuda, nbits, k_cap):
    """Kernel F against the per-element gather, bitwise, on keys padded as
    ``_windows`` pads them, plus window starts near the end (clamped)."""
    rng = np.random.default_rng(nbits)
    n = 2 ** (nbits - 1) + 3
    n_tiles = 300
    keys = np.unique((rng.integers(0, n_tiles, 20000) << nbits)
                     | rng.integers(0, 2 ** nbits, 20000))
    keys = binning._pad128(torch.as_tensor(keys),
                           ((n_tiles + 1) << nbits) - 1, extra=k_cap + 128)
    bounds = torch.searchsorted(keys, torch.arange(
        n_tiles + 1, dtype=torch.int64) << nbits)
    start = bounds[:-1].clone()
    start[:2] = torch.tensor([keys.numel() - 5, 0])
    want = binning.extract_windows(keys, start, k_cap, nbits, n)  # plain
    before = launched("extract_windows")
    got = binning.extract_windows(keys.to(cuda), start.to(cuda), k_cap,
                                  nbits, n)
    torch.cuda.synchronize()
    assert launched("extract_windows") == before + 1
    assert got.dtype == torch.int32 and got.shape == (n_tiles, k_cap)
    assert torch.equal(got.cpu(), want)


def window_case(k_width, mode, seed=3):
    """Random [T, 9, K] windows: tile 0 empty, tile 1 full, the rest with
    random counts and (for K + 128 aligned windows) deltas below 128; tile 2
    holds min(120, K) live slots, the first min(64, K / 2) of them far off
    the image: 16-slot backward sub-batches that no pixel contributes to
    (two at K = 64, three or more above). ``mode``: "sparse" random splats,
    "saturate" broad near-opaque splats that end tiles early, "faint"
    opacities below 0.01, so that a long window is walked to its end."""
    saturate = mode == "saturate"
    rng = np.random.default_rng(seed + saturate)
    s = RasterSettings(image_height=72, image_width=88)
    t = s.n_tiles
    aligned = k_width > 128 and k_width % 256 == 0
    deltas = (rng.integers(0, 128, t) if aligned else np.zeros(t, int))
    counts = rng.integers(0, k_width - deltas + 1)
    deltas[:2] = 0
    counts[:3] = [0, k_width, min(120, k_width - deltas[2])]
    sx, sy = (rng.uniform(20, 60, (2, t, k_width)) if saturate
              else rng.uniform(0.7, 12, (2, t, k_width)))
    rho = rng.uniform(-0.6, 0.6, (t, k_width))
    cxx, cyy, cxy = sx * sx, sy * sy, rho * sx * sy
    det = cxx * cyy - cxy * cxy
    attrs = np.zeros((t, 9, k_width), np.float32)
    tx = (np.arange(t) % s.tiles_x) * 16
    ty = (np.arange(t) // s.tiles_x) * 16
    attrs[:, 0] = tx[:, None] + rng.uniform(-8, 24, (t, k_width))
    attrs[:, 1] = ty[:, None] + rng.uniform(-8, 24, (t, k_width))
    attrs[:, 2:5] = np.stack([cyy / det, -cxy / det, cxx / det], 1)
    attrs[:, 5:8] = rng.uniform(0, 1, (t, 3, k_width))
    attrs[:, 8] = rng.uniform(*{"sparse": (0.0, 0.99), "saturate": (0.7, 0.99),
                                "faint": (0.0, 0.01)}[mode], (t, k_width))
    attrs[2, :2, deltas[2]:deltas[2] + min(64, k_width // 2)] = -1000.0
    return s, [torch.as_tensor(attrs), torch.as_tensor(counts.astype(np.int32)),
               torch.as_tensor(deltas.astype(np.int32)),
               torch.tensor([0.2, 0.5, 0.9])]


# K = 16384 is the trainer's regrow ceiling (max_per_tile); at K = 2, 8 and
# 32 the chunk is K, shorter than kernel D's unroll by 4 or a few of it
WINDOW_CASES = [(2, "sparse"), (8, "sparse"), (32, "sparse"), (64, "sparse"),
                (256, "sparse"), (256, "saturate"), (384, "saturate"),
                (16384, "faint")]


@pytest.mark.parametrize("k_width,mode", WINDOW_CASES)
def test_window_forward_kernel_matches_plain(cuda, k_width, mode):
    """Kernel D: colours and tfinal within the forward bar; tin's visited
    rows within it too, its unvisited rows exactly 0 where the plain
    version's are; an empty tile gives bg, tfinal 1 and an all-zero tin."""
    s, args = window_case(k_width, mode)
    want = window_blend.window_forward_plain(*args, s)
    before = launched("window_blend_forward")
    got = window_blend.window_forward(*(a.to(cuda) for a in args), s)
    torch.cuda.synchronize()
    assert launched("window_blend_forward") == before + 1
    for g, w, name in zip(got, want, ("colors", "tfinal", "tin")):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g.cpu(), w, atol=BLEND_TOL, rtol=0,
                                   msg=name)
    colors, tfinal, tin = (x.cpu() for x in got)
    rows = tin.amax(2)            # a visited row reaches eps, others are 0
    assert ((rows == 0) | (rows >= s.transmittance_eps)).all()
    if mode != "saturate":
        assert torch.equal(rows == 0, want[2].amax(2) == 0)
    assert torch.equal(colors[0], args[3].expand(256, 3))
    assert (tfinal[0] == 1).all() and (tin[0] == 0).all()
    if mode == "saturate":
        chunk = window_blend._pick_chunk(k_width)
        n_vis = (tin.amax(2) >= s.transmittance_eps).sum(1)
        n_run = -(-(args[1] + args[2]) // chunk)
        assert (n_vis < n_run).any(), "fixture no longer saturates"


def window_backward_inputs(k_width, mode):
    """(settings, the window_backward arguments on the CPU): the case's
    windows, colour cotangents from a seed, the plain forward's tfinal and
    tin."""
    s, args = window_case(k_width, mode)
    _, tfinal, tin = window_blend.window_forward_plain(*args, s)
    g = torch.as_tensor(np.random.default_rng(k_width).normal(
        size=(s.n_tiles, 256, 3)).astype(np.float32))
    return s, [*args, g, tfinal, tin]


@pytest.mark.parametrize("k_width,mode", WINDOW_CASES)
def test_window_backward_kernel_matches_plain(cuda, k_width, mode):
    """Kernel E against the plain backward on the plain forward's tfinal
    and tin, per attribute group within 2e-5 x max|g|; zero outside the
    live slots."""
    s, bargs = window_backward_inputs(k_width, mode)
    args = bargs[:4]
    want = window_blend.window_backward_plain(*bargs, s)
    before = launched("window_blend_backward")
    got = window_blend.window_backward(*(a.to(cuda) for a in bargs), s)
    torch.cuda.synchronize()
    assert launched("window_blend_backward") == before + 1
    got = got.cpu()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got[0] == 0).all()                       # the empty tile
    slot = torch.arange(k_width)
    live = ((slot >= args[2][:, None])
            & (slot < (args[2] + args[1])[:, None]))
    assert (got.transpose(1, 2)[~live] == 0).all()
    for name, rows in GROUPS.items():
        ref = float(want[:, rows].abs().max())
        assert ref > 0, name
        torch.testing.assert_close(got[:, rows], want[:, rows],
                                   atol=GRAD_TOL * ref, rtol=0, msg=name)


@pytest.mark.parametrize("k_width,mode", [(256, "sparse"),
                                          (16384, "faint")])
def test_window_backward_kernel_is_deterministic(cuda, k_width, mode):
    """Kernel E writes each slot once, summed in a fixed order: two
    launches on the same inputs agree bit for bit."""
    s, bargs = window_backward_inputs(k_width, mode)
    dev = [a.to(cuda) for a in bargs]
    first = window_blend.window_backward(*dev, s)
    second = window_blend.window_backward(*dev, s)
    torch.cuda.synchronize()
    assert first.abs().max() > 0
    assert torch.equal(first, second)


@pytest.mark.parametrize("k_width,mode", [(8, "sparse"), (256, "saturate"),
                                          (16384, "faint")])
def test_window_forward_kernel_is_deterministic(cuda, k_width, mode):
    """Kernel D: two launches on the same inputs agree bit for bit."""
    s, args = window_case(k_width, mode)
    dev = [a.to(cuda) for a in args]
    first = window_blend.window_forward(*dev, s)
    second = window_blend.window_forward(*dev, s)
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("colors", "tfinal", "tin")):
        assert torch.equal(a, b), name


def assert_window_grads_close(got, want):
    for name, rows in GROUPS.items():
        ref = float(want[:, rows].abs().max())
        assert ref > 0, name
        torch.testing.assert_close(got[:, rows], want[:, rows],
                                   atol=GRAD_TOL * ref, rtol=0, msg=name)


@pytest.mark.parametrize("k_width,mode", WINDOW_CASES)
def test_window_kernel_pair_matches_plain_pair(cuda, k_width, mode):
    """Kernel E on kernel D's tfinal and tin against the plain backward on
    the plain forward's: the window path's two kernels as training runs
    them, per attribute group within 2e-5 x max|g|."""
    s, bargs = window_backward_inputs(k_width, mode)
    want = window_blend.window_backward_plain(*bargs, s)
    dev = [a.to(cuda) for a in bargs[:5]]
    _, tfinal, tin = window_blend.window_forward(*dev[:4], s)
    got = window_blend.window_backward(*dev, tfinal, tin, s)
    torch.cuda.synchronize()
    got = got.cpu()
    assert torch.isfinite(got).all()
    assert_window_grads_close(got, want)


def saturating_window_case():
    """K = 384 windows (three chunks of 128) where tile 3 saturates on the
    last slot of its first chunk and tile 4 on slot 65 of its second (mid
    group of kernel D's 4-slot unroll), every pixel on that slot: slots
    before it are one broad splat over the tile, of an opacity that leaves
    T near 2e-4, and the slot itself is opaque. Both tiles hold 384 live
    slots, so chunks follow the exit. Returns (settings, window_forward
    arguments, {tile: index of its saturating slot})."""
    s, args = window_case(384, "sparse", seed=5)
    attrs, counts, deltas, _ = args
    saturate_at = {3: 127, 4: 128 + 65}
    for t, m in saturate_at.items():
        counts[t], deltas[t] = 384, 0
        cx = (t % s.tiles_x) * 16 + 7.5
        cy = (t // s.tiles_x) * 16 + 7.5
        a = 1.0 - 2e-4 ** (1.0 / m)
        attrs[t, :, :m + 1] = torch.tensor(
            [cx, cy, 1e-6, 0.0, 1e-6, 0.3, 0.6, 0.9, a])[:, None]
        attrs[t, 8, m] = 0.99
    return s, args, saturate_at


def test_window_kernels_at_a_saturating_slot(cuda):
    """Kernel D where every pixel of a tile saturates on the last slot of a
    chunk, and on a slot in the middle of an unrolled group: its outputs
    within the forward bar of the plain version's, tin's zero pattern the
    plain version's (the chunk after the exit unvisited), then kernel E on
    D's outputs against the plain pair."""
    s, args, saturate_at = saturating_window_case()
    want = window_blend.window_forward_plain(*args, s)
    dev = [a.to(cuda) for a in args]
    got = window_blend.window_forward(*dev, s)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("colors", "tfinal", "tin")):
        torch.testing.assert_close(g.cpu(), w, atol=BLEND_TOL, rtol=0,
                                   msg=name)
    tin = got[2].cpu()
    assert torch.equal(tin == 0, want[2] == 0)
    for t, m in saturate_at.items():
        c_exit = m // 128 + 1       # the first chunk the tile never visits
        assert (tin[t, c_exit:] == 0).all() and (tin[t, :c_exit] > 0).all()
        # every pixel's last contribution is slot m - 1, which leaves T
        # near 2e-4: slot m takes it below eps
        tf = want[1][t]
        assert ((tf >= s.transmittance_eps) & (tf < 1e-3)).all()
    g = torch.as_tensor(np.random.default_rng(9).normal(
        size=(s.n_tiles, 256, 3)).astype(np.float32))
    want_g = window_blend.window_backward_plain(*args, g, want[1], want[2],
                                                s)
    got_g = window_blend.window_backward(*dev, g.to(cuda), got[1], got[2], s)
    torch.cuda.synchronize()
    assert_window_grads_close(got_g.cpu(), want_g)


def test_window_blend_autograd_launches_both_kernels(cuda):
    s, args = window_case(256, "sparse")
    attrs = args[0].to(cuda).requires_grad_(True)
    bg = args[3].to(cuda).requires_grad_(True)
    f0 = launched("window_blend_forward")
    b0 = launched("window_blend_backward")
    colors = window_blend.blend_tiles_window(
        attrs, args[1].to(cuda), args[2].to(cuda), bg, s)
    colors.sum().backward()
    torch.cuda.synchronize()
    assert launched("window_blend_forward") == f0 + 1
    assert launched("window_blend_backward") == b0 + 1
    assert torch.isfinite(attrs.grad).all() and attrs.grad.abs().sum() > 0
    _, tfinal, _ = window_blend.window_forward_plain(*args, s)
    torch.testing.assert_close(bg.grad.cpu(), tfinal.sum().expand(3),
                               rtol=1e-4, atol=0)


def test_window_wrappers_raise_on_bad_cuda_input(cuda):
    s, args = window_case(128, "sparse")
    good = [a.to(cuda) for a in args]
    with pytest.raises(ValueError, match="float32"):
        window_blend.window_forward(good[0].double(), *good[1:], s)
    with pytest.raises(ValueError, match="int32"):
        window_blend.window_forward(good[0], good[1].long(), *good[2:], s)
    with pytest.raises(ValueError, match="must be on"):
        window_blend.window_forward(good[0], good[1].cpu(), *good[2:], s)
    with pytest.raises(ValueError, match="multiple of 128"):
        window_blend.window_forward(good[0][:, :, :96].contiguous(),
                                    *good[1:], s)
    # the rows are attrs's (a range of window rows): counts must match
    with pytest.raises(ValueError, match="counts/deltas must hold 4 tiles"):
        window_blend.window_forward(good[0][:4].contiguous(), *good[1:], s)
    with pytest.raises(ValueError, match=r"attrs must be \[T, 9, K\]"):
        window_blend.window_forward(good[0][:, :8].contiguous(), *good[1:],
                                    s)
    with pytest.raises(ValueError, match="tile0"):
        window_blend.window_forward(*good, s, -1)
    with pytest.raises(ValueError, match="tiles"):
        window_blend.window_forward(good[0], good[1][:4].contiguous(),
                                    *good[2:], s)
    colors, tfinal, tin = window_blend.window_forward(*good, s)
    window_blend.window_backward(*good, colors, tfinal, tin, s)
    with pytest.raises(ValueError, match=r"tin must be"):
        window_blend.window_backward(*good, colors, tfinal, tin[:, :0]
                                     .contiguous(), s)
    with pytest.raises(ValueError, match="contiguous"):
        window_blend.window_backward(*good, colors.transpose(1, 2), tfinal,
                                     tin, s)
    keys = torch.arange(512, device=cuda)
    with pytest.raises(ValueError, match="int64"):
        binning.extract_windows(keys, keys[:4].int(), 128, 9, 512)
    with pytest.raises(ValueError, match="must be on"):
        binning.extract_windows(keys, keys[:4].cpu(), 128, 9, 512)


def card_prep(cuda, n=6000, seed=7):
    """Preprocess outputs on the card of random Gaussians before an
    identity camera (the scene of ``tests/test_binning_split.py``'s
    ``make_scene``), at that test's settings with the split's light width
    4: (settings, Preprocessed, heavy rows)."""
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.ops.splat.preprocess import preprocess
    s = RasterSettings(image_height=96, image_width=128, sh_degree=0,
                       max_per_tile=512, max_tiles_per_gaussian=16,
                       light_dup_width=4)
    rng = np.random.default_rng(seed)
    f32 = np.float32
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(2.0, 8.0, n)], -1).astype(f32)
    scales = np.exp(rng.uniform(-3.2, -1.2, (n, 3))).astype(f32)
    rots = rng.standard_normal((n, 4)).astype(f32)
    ops = rng.uniform(0.05, 0.95, (n, 1)).astype(f32)
    colors = rng.uniform(0, 1, (n, 3)).astype(f32)
    view, proj, campos, tfx, tfy = render_mod._raster_common(1.1, 1.1, cuda)

    def t(x):
        return torch.as_tensor(x, device=cuda)
    prep = preprocess(t(means), t(ops), s, viewmatrix=view, projmatrix=proj,
                      campos=campos, colors_precomp=t(colors),
                      scales=t(scales), rotations=t(rots), tan_fovx=tfx,
                      tan_fovy=tfy)
    ntt = torch.clamp_max(prep.n_tiles_touched, s.max_tiles_per_gaussian)
    heavy = int(((ntt > s.light_dup_width) & prep.binnable).sum())
    return s, prep, heavy


def host_heavy_overflow(prep, s):
    """The JAX package's ``heavy_overflow`` on the host: the rect cells past
    L of the heavy rows, in depth order, beyond the first heavy_rows_cap."""
    alive = prep.binnable.cpu().numpy()
    depth = np.where(alive, prep.depth.cpu().numpy(), np.inf)
    order = np.argsort(depth, kind="stable")
    ntt = np.where(alive, np.minimum(prep.n_tiles_touched.cpu().numpy(),
                                     s.max_tiles_per_gaussian), 0)[order]
    heavy = ntt > s.light_dup_width
    h_pos = np.cumsum(heavy) - heavy
    over = heavy & (h_pos >= s.heavy_rows_cap)
    return int((ntt - s.light_dup_width)[over].sum())


def test_split_stream_equals_full_width_stream(cuda):
    """On the card, the split table with an ample cap gives the full-width
    table's keys and both branches' streams bitwise (kernels A and F
    launched); a starved cap reports the JAX formula's heavy_overflow and
    keeps a subset of the full-width keys."""
    import dataclasses
    s, prep, heavy = card_prep(cuda)
    assert heavy > 8
    ample = dataclasses.replace(s, heavy_rows_cap=-(-heavy * 2 // 128) * 128)
    full_keys = binning._sorted_key_stream(prep, s).sorted_packed
    ks = binning._sorted_key_stream(prep, ample)
    assert torch.equal(ks.sorted_packed, full_keys)
    assert int(ks.heavy_overflow) == 0
    before = launched("extract_chunks")
    es, es_full = (binning.bin_entry_stream(prep, st) for st in (ample, s))
    assert launched("extract_chunks") == before + 2
    for f in ("rank", "chunk_tile", "count", "astart", "order"):
        assert torch.equal(getattr(es, f), getattr(es_full, f)), f
    before = launched("extract_windows")
    tb, tb_full = (binning.bin_gaussians(prep, st) for st in (ample, s))
    assert launched("extract_windows") == before + 2
    for f in ("rank", "delta", "count", "full_count"):
        assert torch.equal(getattr(tb, f), getattr(tb_full, f)), f

    starved = dataclasses.replace(
        s, heavy_rows_cap=max(128, (heavy // 3) // 128 * 128))
    ks = binning._sorted_key_stream(prep, starved)
    assert int(ks.heavy_overflow) == host_heavy_overflow(prep, starved) > 0
    assert bool(torch.isin(ks.sorted_packed, full_keys).all())
    assert ks.sorted_packed.numel() < full_keys.numel()


def edge_prep(cuda, seed=5):
    """Preprocess outputs, made by hand, of Gaussians centred on tile edges
    (x and y at 16k + {-0.5, 0, 0.25, 15, 15.5}) and on and past the image
    edges, with radii of 1-48 px, a few non-positive conic diagonals (the
    cull's ``A_safe`` / ``C_safe``) and depths on a 0.1 grid (ties):
    (settings, Preprocessed on the card)."""
    from das3r_tpu_torch.ops.splat.preprocess import Preprocessed
    s = RasterSettings(image_height=72, image_width=88, sh_degree=0,
                       max_tiles_per_gaussian=32)
    rng = np.random.default_rng(seed)
    n = 4000

    def edges(size, tiles):
        grid = (16 * np.arange(tiles + 1)[:, None]
                + np.array([-0.5, 0.0, 0.25, 15.0, 15.5])).ravel()
        return np.concatenate([grid, [-4.0, -0.5, size - 0.5, size,
                                      size + 4.0]])
    mx = rng.choice(edges(s.image_width, s.tiles_x), n)
    my = rng.choice(edges(s.image_height, s.tiles_y), n)
    sx, sy = rng.uniform(0.3, 16, (2, n))
    rho = rng.uniform(-0.9, 0.9, n)
    cxx, cyy, cxy = sx * sx + 0.3, sy * sy + 0.3, rho * sx * sy
    det = cxx * cyy - cxy * cxy
    conic = np.stack([cyy / det, -cxy / det, cxx / det], -1)
    conic[:40, 0] = rng.choice([0.0, -0.01], 40)
    conic[40:80, 2] = rng.choice([0.0, -0.01], 40)
    mid = 0.5 * (cxx + cyy)
    radius = np.ceil(3 * np.sqrt(mid + np.sqrt(np.maximum(
        mid * mid - det, 0.1))))
    tiles = np.array([s.tiles_x, s.tiles_y])
    m2d = np.stack([mx, my], -1).astype(np.float32)
    rect_min = np.clip(np.floor((m2d - radius[:, None]) / s.tile), 0, tiles)
    rect_max = np.clip((m2d + radius[:, None] + s.tile - 1) // s.tile, 0,
                       tiles)
    span = np.maximum(rect_max - rect_min, 0)
    ntt = span[:, 0] * span[:, 1]
    op = rng.uniform(0.002, 1.0, n)
    q_cap = 2 * np.log(np.maximum(op / s.alpha_floor, 1e-12))

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x).astype(dtype), device=cuda)
    f32, i32 = np.float32, np.int32
    prep = Preprocessed(
        mean2d=t(m2d, f32), depth=t(np.round(rng.uniform(1, 9, n), 1), f32),
        conic=t(conic, f32), color=t(rng.uniform(0, 1, (n, 3)), f32),
        opacity=t(op, f32), radius=t(radius, i32), rect_min=t(rect_min, i32),
        rect_max=t(rect_max, i32), n_tiles_touched=t(ntt, i32),
        binnable=t((ntt > 0) & (op >= s.alpha_floor), bool),
        q_cap=t(q_cap, f32))
    return s, prep


def binning_case(case, cuda):
    """(settings, Preprocessed on the card) of a ``DUP_CASES`` case."""
    import dataclasses
    if case == "edges":
        return edge_prep(cuda)
    s, prep, heavy = card_prep(cuda)
    if case == "orbit":            # the serving form: D = 32, no split
        s = dataclasses.replace(s, max_tiles_per_gaussian=32)
    elif case == "train":          # heavy rows past the cap, an entry cap
        s = dataclasses.replace(
            s, heavy_rows_cap=max(128, (heavy // 3) // 128 * 128),
            max_total_entries=12_000)
    elif case == "truncated":      # JAX's compaction to the cap
        s = dataclasses.replace(s, max_total_entries=12_000,
                                full_sort_below=0)
    elif case == "loose":
        s = dataclasses.replace(s, tight_binning=False)
    elif case == "d128":
        s = dataclasses.replace(s, max_tiles_per_gaussian=128)
    elif case == "culled":
        prep = prep._replace(binnable=torch.zeros_like(prep.binnable))
    elif case == "strided":        # column views, as the sharded gather's
        prep = prep._replace(**{
            k: torch.stack([v, v], 1)[:, 0] for k, v in prep._asdict().items()
            if k != "depth"})
        assert not prep.rect_min.is_contiguous()
    return s, prep


DUP_CASES = ["orbit", "train", "truncated", "loose", "d128", "edges",
             "culled", "strided"]


@pytest.mark.parametrize("case", DUP_CASES)
def test_dup_kernels_bin_bitwise_the_plain_table(cuda, case):
    """``_sorted_key_stream`` and ``bin_entry_stream`` on the card, whose
    table is the ``dup_count`` / ``dup_emit`` pair (one launch each per
    binning), equal the plain dense table's on the CPU on the same inputs:
    the sorted keys, ``order``, every overflow count and every
    ``EntryStream`` field."""
    from das3r_tpu_torch.ops.splat.preprocess import Preprocessed
    s, prep = binning_case(case, cuda)
    cpu = Preprocessed(*(x.cpu() for x in prep))
    pair = ("dup_count", "dup_emit")
    want = binning._sorted_key_stream(cpu, s)
    before = [launched(k) for k in pair]
    got = binning._sorted_key_stream(prep, s)
    torch.cuda.synchronize()
    assert [launched(k) for k in pair] == [b + 1 for b in before]
    assert got.nbits == want.nbits
    for f in ("sorted_packed", "order", "dup_overflow", "entry_overflow",
              "heavy_overflow"):
        assert getattr(got, f).device.type == "cuda", f
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    es_want = binning.bin_entry_stream(cpu, s)
    es = binning.bin_entry_stream(prep, s)
    torch.cuda.synchronize()
    assert [launched(k) for k in pair] == [b + 2 for b in before]
    for f in binning.EntryStream._fields:
        assert torch.equal(getattr(es, f).cpu(), getattr(es_want, f)), f
    live = want.sorted_packed.numel()
    if case == "train":
        assert int(want.heavy_overflow) > 0 and int(want.entry_overflow) > 0
    if case == "truncated":
        assert live == s.max_total_entries and int(want.entry_overflow) > 0
    assert (live == 0) == (case == "culled")


def test_dup_keys_raise_on_bad_cuda_input(cuda):
    s, prep = binning_case("orbit", cuda)
    order = torch.argsort(prep.depth)
    for field, bad, match in (
            ("mean2d", prep.mean2d.double(), "float32"),
            ("conic", prep.conic[:, :2], r"must be \(6000, 3\)"),
            ("binnable", prep.binnable.int(), "bool"),
            ("q_cap", prep.q_cap.cpu(), "must be on"),
            ("rect_min", prep.rect_min[:-1], r"must be \(6000, 2\)")):
        with pytest.raises(ValueError, match=match):
            binning.dup_keys(prep._replace(**{field: bad}), order, 13, s)


def test_viewer_panel_matches_plain_render(cuda):
    """A viewer panel on the card (kernels A and B, once each) against the
    same panel on the CPU (their plain versions), float image within 2e-4."""
    from das3r_tpu_torch.data.synthetic import random_gaussian_scene
    from das3r_tpu_torch.gui import ViewerScene
    from das3r_tpu_torch.ops.splat import entry_blend as eb
    params, meta, poses = random_gaussian_scene(
        3000, n_frames=3, height=96, width=128, seed=0, device="cpu")
    s = RasterSettings(image_height=96, image_width=128, sh_degree=3,
                       max_tiles_per_gaussian=32)
    images = {}
    for dev in ("cpu", cuda):
        scene = ViewerScene(params=params, meta=meta, settings=s,
                            train_poses7=poses.all_poses().numpy(),
                            device=dev)
        orbit = scene.default_orbit()
        orbit.orbit(300.0, 80.0)
        before = (launched("extract_chunks"), launched("blend_forward"))
        images[str(dev)] = {m: scene.render_image(orbit, m).cpu()
                            for m in ("rgb", "confidence", "no_soft")}
        counts = (launched("extract_chunks") - before[0],
                  launched("blend_forward") - before[1])
        assert counts == ((0, 0) if dev == "cpu" else (3, 3))
    for m, want in images["cpu"].items():
        got = images[str(torch.device(cuda))][m]
        assert float(want.abs().max()) > 0, m
        assert float((got - want).abs().max()) <= BLEND_TOL, m


@pytest.fixture
def no_tf32():
    """TF32 off in cuBLAS and cuDNN for the test (the repo's parity rule);
    the previous settings restored after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def test_tiny_predictor_on_card_matches_cpu(cuda, no_tf32):
    """The TINY stage-1 predictor on the card against the same weights on
    the CPU, landscape and portrait, each map within 1e-4 x max|CPU|."""
    from das3r_tpu_torch.models.croco.convert import load_reference_state_dict
    from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
    from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                      random_torch_state_dict)
    sd = random_torch_state_dict(TINY, np.random.default_rng(0))
    models = {}
    for dev in ("cpu", cuda):
        models[str(dev)] = AsymmetricCroCo3D(TINY)
        load_reference_state_dict(models[str(dev)], sd)
        models[str(dev)].to(dev)
    rng = np.random.default_rng(1)
    i1, i2 = (torch.as_tensor(rng.standard_normal((2, 3, 32, 48)),
                              dtype=torch.float32) for _ in range(2))
    for portrait in (False, True):
        with torch.no_grad():
            want = models["cpu"](i1, i2, portrait1=portrait,
                                 portrait2=portrait)
            got = models[str(cuda)](i1.to(cuda), i2.to(cuda),
                                    portrait1=portrait, portrait2=portrait)
        for w, g in zip(want, got):
            for k in w:
                err = float((g[k].cpu() - w[k]).abs().max())
                assert err <= 1e-4 * float(w[k].abs().max()), (k, err)


def test_align_on_card_matches_cpu(cuda, no_tf32):
    """Twelve alignment iterations on the card against the CPU on the same
    noisy synthetic predictions (exact pointmaps of 5 views plus noise, a
    symmetrized sliding-window graph, so PnP initializes some poses):
    depths, poses and focals within 1e-5 x max|CPU|."""
    from das3r_tpu_torch.predictor import alignment, pairs
    rng = np.random.default_rng(3)
    f, h, w = 5, 24, 32
    focal, pp = 0.8 * w, np.asarray([w / 2, h / 2], np.float32)
    depths = 4.0 + rng.uniform(-0.5, 0.5, (f, h, w))
    c2w = np.tile(np.eye(4), (f, 1, 1))
    c2w[1:, :3, 3] = rng.uniform(-0.25, 0.25, (f - 1, 3))
    xx, yy = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    cam = [np.concatenate([d[..., None] * (np.stack([xx, yy], -1) - pp)
                           / focal, d[..., None]], -1) for d in depths]
    world = [c @ p[:3, :3].T + p[:3, 3] for c, p in zip(cam, c2w)]
    edges = pairs.make_pairs(f, "swin-2-noncyclic")
    w2c = np.linalg.inv(c2w)

    def in_frame(pts, i):
        return (pts @ w2c[i, :3, :3].T + w2c[i, :3, 3]
                + rng.normal(0, 0.02, pts.shape)).astype(np.float32)
    pred_i = np.stack([in_frame(world[i], i) for i, _ in edges])
    pred_j = np.stack([in_frame(world[j], i) for i, j in edges])
    conf = rng.uniform(5, 15, (2, len(edges), h, w)).astype(np.float32)
    mask = rng.uniform(0, 0.6, (len(edges), h, w)).astype(np.float32)
    cfg = alignment.AlignerConfig(niter=12)
    res = {str(dev): alignment.align(edges, pred_i, pred_j, conf[0],
                                     conf[1], mask, cfg, device=dev)
           for dev in ("cpu", cuda)}
    for k in ("depths", "poses_c2w", "focals"):
        want = getattr(res["cpu"], k)
        err = np.abs(getattr(res[str(torch.device(cuda))], k) - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (k, err)


# --- the table_bf16 form of kernels B and C ---------------------------


@pytest.mark.parametrize("variant", BLEND_CASES)
def test_bf16_encode_on_the_card_is_the_cpus(cuda, variant):
    """The encode of ``blend_case``'s table on the card, bitwise the
    CPU's (round to nearest even in both)."""
    _, args = blend_case(variant)
    want = entry_blend.encode_bf16_table(args[0])
    got = entry_blend.encode_bf16_table(args[0].to(cuda))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("variant", FORWARD_CASES)
def test_bf16_blend_forward_kernel_matches_plain(cuda, variant):
    """B-bf16 (with and without n_last) against the plain forward on the
    decoded table; the launch counted under ``blend_forward_bf16``."""
    s, args = blend_case(variant)
    t16 = entry_blend.encode_bf16_table(args[0])
    plain = entry_blend.blend_forward_plain(
        entry_blend.decode_bf16_table(t16), *args[1:], s)
    dev = [t16.to(cuda)] + [a.to(cuda) for a in args[1:]]
    before = (launched("blend_forward"), launched("blend_forward_bf16"))
    cpre, tfinal = entry_blend.blend_forward(*dev, s)
    cpre_n, tfinal_n, n_last = entry_blend.blend_forward(*dev, s, True)
    torch.cuda.synchronize()
    assert (launched("blend_forward"), launched("blend_forward_bf16")) == (
        before[0], before[1] + 2)
    for c, t in ((cpre, tfinal), (cpre_n, tfinal_n)):
        torch.testing.assert_close(c.cpu(), plain.cpre, atol=BLEND_TOL,
                                   rtol=0)
        torch.testing.assert_close(t.cpu(), plain.tfinal, atol=BLEND_TOL,
                                   rtol=0)
    assert torch.equal(cpre, cpre_n) and torch.equal(tfinal, tfinal_n)


@pytest.mark.parametrize("variant", BLEND_CASES)
def test_bf16_blend_backward_kernel_matches_plain(cuda, variant):
    """C-bf16 against the plain backward on the decoded table: the [M, 9]
    f32 gradient within 2e-5 x max|g| per column group."""
    s, args = blend_case(variant)
    t16 = entry_blend.encode_bf16_table(args[0])
    dec = entry_blend.decode_bf16_table(t16)
    rng = np.random.default_rng(41 + BLEND_CASES.index(variant))
    P = s.tile * s.tile
    g_cpre = torch.as_tensor(rng.normal(size=(s.n_tiles, 3, P)).astype(
        np.float32))
    g_tfinal = torch.as_tensor(rng.normal(size=(s.n_tiles, 1, P)).astype(
        np.float32))
    fwd = entry_blend.blend_forward_plain(dec, *args[1:], s)
    want = entry_blend.blend_backward_plain(
        dec, *args[1:], s, fwd.tfinal, fwd.tin, g_cpre, g_tfinal).g_table
    dev = [t16.to(cuda)] + [a.to(cuda) for a in args[1:]]
    _, tfinal, n_last = entry_blend.blend_forward(*dev, s, True)
    before = launched("blend_backward_bf16")
    got = entry_blend.blend_backward(*dev, s, tfinal, n_last,
                                     g_cpre.to(cuda), g_tfinal.to(cuda))
    torch.cuda.synchronize()
    assert launched("blend_backward_bf16") == before + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.cpu()
    assert torch.isfinite(got).all() and (got[-1] == 0).all()
    for name, cols in GROUPS.items():
        ref = float(want[:, cols].abs().max())
        assert ref > 0, name
        torch.testing.assert_close(got[:, cols], want[:, cols],
                                   atol=GRAD_TOL * ref, rtol=0, msg=name)


# --- kernels D and E in their tile-range form --------------------------


@pytest.mark.parametrize("k_width,mode", [(8, "sparse"), (256, "sparse"),
                                          (384, "saturate")])
def test_window_kernels_at_tile0_match_the_whole_rows(cuda, k_width, mode):
    """D and E on window rows [8, 16) and [24, 30) launched with their
    ``tile0``: D's outputs bitwise the whole-image launch's rows, E's
    gradients of those rows too (E writes each slot once, in a fixed
    order); ``tile0 = 0`` over every row is the whole launch."""
    s, bargs = window_backward_inputs(k_width, mode)
    dev = [a.to(cuda) for a in bargs[:5]]
    whole = window_blend.window_forward(*dev[:4], s)
    g_whole = window_blend.window_backward(*dev, whole[1], whole[2], s)
    zero = window_blend.window_forward(*dev[:4], s, 0)
    for tile0, stop in ((8, 16), (24, s.n_tiles)):
        part = [a[tile0:stop].contiguous() for a in dev[:3]]
        fwd = window_blend.window_forward(*part, dev[3], s, tile0)
        g = window_blend.window_backward(
            *part, dev[3], dev[4][tile0:stop].contiguous(), fwd[1], fwd[2],
            s, tile0)
        torch.cuda.synchronize()
        for x, w in zip(fwd, whole):
            assert torch.equal(x, w[tile0:stop])
        assert torch.equal(g, g_whole[tile0:stop])
    for x, w in zip(zero, whole):
        assert torch.equal(x, w)
