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

pytestmark = pytest.mark.cuda
BLEND_TOL = 2e-4   # serial product vs chunked cumprod near T = 1e-4
# x max|g| per column group: the JAX gradient bar. Kernel C restores T by a
# fast reciprocal where the plain version replays a chunked product, and
# its atomics add in an order that changes from run to run.
GRAD_TOL = 2e-5
GROUPS = {"mean2d": [0, 1], "conic": [2, 3, 4], "color": [5, 6, 7],
          "opacity": [8]}


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
    before = binning.extract_chunks.launches
    got = binning.extract_chunks(*(a.to(cuda) for a in args), nbits, n)
    torch.cuda.synchronize()
    assert binning.extract_chunks.launches == before + 1
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


@pytest.mark.parametrize("variant", ["sparse", "saturate"])
def test_blend_forward_kernel_matches_plain(cuda, variant):
    """See ``blend_case``; with ``saturate`` tiles end early."""
    s, args = blend_case(variant)
    plain = entry_blend.blend_forward_plain(*args, s)
    if variant == "saturate":
        assert plain.chunks_skipped > 0, "fixture no longer saturates"
    before = entry_blend.blend_forward.launches
    cpre, tfinal = entry_blend.blend_forward(*(a.to(cuda) for a in args), s)
    torch.cuda.synchronize()
    assert entry_blend.blend_forward.launches == before + 1
    assert cpre.shape == plain.cpre.shape and tfinal.shape == plain.tfinal.shape
    torch.testing.assert_close(cpre.cpu(), plain.cpre, atol=BLEND_TOL, rtol=0)
    torch.testing.assert_close(tfinal.cpu(), plain.tfinal, atol=BLEND_TOL,
                               rtol=0)
    assert (cpre[0] == 0).all() and (tfinal[0] == 1).all()   # empty tile


# "sparse": random splats; "saturate": broad near-opaque splats that end
# tiles early; "gap": tile 5 holds a run of 100 entries of a row far off
# the image, so whole backward batches are seen by no pixel; "shared_row":
# the first 64 entries of every tile are one broad faint splat's row, so the
# backward's table-row atomics collide within and across blocks.
BLEND_CASES = ["sparse", "saturate", "gap", "shared_row"]


def blend_case(variant):
    """The blend kernels' fixture: tile lists of 0, 1, 255, 256, 257 and
    1500 entries (batch boundaries of the forward's 256-entry and the
    backward's 16- or 32-entry batches, and lengths that are multiples of
    neither), partial edge tiles, and the ``BLEND_CASES`` variant."""
    saturate = variant == "saturate"
    rng = np.random.default_rng(7 + saturate)
    s = RasterSettings(image_height=72, image_width=88)
    counts = rng.integers(0, 700, s.n_tiles)
    counts[:6] = [0, 1, 255, 256, 257, 1500]
    args = random_stream(rng, s, counts, 3000, saturate)
    table, rank, astart, count = args
    if variant == "gap":
        table[0, :2] = -1000.0
        rank[int(astart[5]) + 600:int(astart[5]) + 700] = 0
    elif variant == "shared_row":
        table[0] = torch.tensor([44.0, 36.0, 1 / 1600, 0.0, 1 / 1600,
                                 0.3, 0.6, 0.9, 0.05])
        for a, c in zip(astart.tolist(), count.tolist()):
            rank[a:a + min(c, 64)] = 0
    return s, args


@pytest.mark.parametrize("variant", ["sparse", "saturate"])
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
    before = entry_blend.blend_backward.launches
    got = entry_blend.blend_backward(*dev, s, tfinal, n_last,
                                     g_cpre.to(cuda), g_tfinal.to(cuda))
    torch.cuda.synchronize()
    assert entry_blend.blend_backward.launches == before + 1
    assert got.shape == want.shape and got.device.type == "cuda"
    got = got.cpu()
    assert torch.isfinite(got).all() and (got[-1] == 0).all()  # sentinel
    for name, cols in GROUPS.items():
        ref = float(want[:, cols].abs().max())
        assert ref > 0, name
        torch.testing.assert_close(got[:, cols], want[:, cols],
                                   atol=GRAD_TOL * ref, rtol=0, msg=name)


def test_blend_backward_autograd_launches_both_kernels(cuda):
    s, args = blend_case("sparse")
    table = args[0].to(cuda).requires_grad_(True)
    f0 = entry_blend.blend_forward.launches
    b0 = entry_blend.blend_backward.launches
    cpre, tfinal = entry_blend.blend_entry_stream(
        table, *(a.to(cuda) for a in args[1:]), s)
    (cpre.sum() + tfinal.sum()).backward()
    torch.cuda.synchronize()
    assert entry_blend.blend_forward.launches == f0 + 1
    assert entry_blend.blend_backward.launches == b0 + 1
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
    before = binning.extract_windows.launches
    got = binning.extract_windows(keys.to(cuda), start.to(cuda), k_cap,
                                  nbits, n)
    torch.cuda.synchronize()
    assert binning.extract_windows.launches == before + 1
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


# K = 16384 is the trainer's regrow ceiling (max_per_tile)
WINDOW_CASES = [(64, "sparse"), (256, "sparse"), (256, "saturate"),
                (384, "saturate"), (16384, "faint")]


@pytest.mark.parametrize("k_width,mode", WINDOW_CASES)
def test_window_forward_kernel_matches_plain(cuda, k_width, mode):
    """Kernel D: colours and tfinal within the forward bar; tin's visited
    rows within it too, its unvisited rows exactly 0 where the plain
    version's are; an empty tile gives bg, tfinal 1 and an all-zero tin."""
    s, args = window_case(k_width, mode)
    want = window_blend.window_forward_plain(*args, s)
    before = window_blend.window_forward.launches
    got = window_blend.window_forward(*(a.to(cuda) for a in args), s)
    torch.cuda.synchronize()
    assert window_blend.window_forward.launches == before + 1
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
    before = window_blend.window_backward.launches
    got = window_blend.window_backward(*(a.to(cuda) for a in bargs), s)
    torch.cuda.synchronize()
    assert window_blend.window_backward.launches == before + 1
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


def test_window_blend_autograd_launches_both_kernels(cuda):
    s, args = window_case(256, "sparse")
    attrs = args[0].to(cuda).requires_grad_(True)
    bg = args[3].to(cuda).requires_grad_(True)
    f0 = window_blend.window_forward.launches
    b0 = window_blend.window_backward.launches
    colors = window_blend.blend_tiles_window(
        attrs, args[1].to(cuda), args[2].to(cuda), bg, s)
    colors.sum().backward()
    torch.cuda.synchronize()
    assert window_blend.window_forward.launches == f0 + 1
    assert window_blend.window_backward.launches == b0 + 1
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
    with pytest.raises(ValueError, match=r"attrs must be \[30, 9, K\]"):
        window_blend.window_forward(good[0][:4].contiguous(), *good[1:], s)
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
