"""PyTorch port: the rasterizer options of the [T, K] window path and the
oracle, against the JAX package.

* the quantized-depth binning (``depth_sort_bits``): keys, counts and
  overflows bitwise JAX's, the payload as equal sets within each run of
  equal keys (JAX's sort is not stable; the port's is), the image against
  JAX's where no tile holds a tie;
* the plain window blend against JAX's XLA window blend (``blend.py::
  blend_tiles``), its counterpart;
* the tile-sharded window render in one process (``window_range``), its
  ranges reassembled against the whole image;
* the port's copy of the float64 oracle against JAX's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.ops.splat import binning as jbin
from das3r_tpu.ops.splat import blend as jblend
from das3r_tpu.ops.splat import rasterize as jax_rasterize
from das3r_tpu.ops.splat.reference import (rasterize_reference as
                                           jax_reference)
from das3r_tpu_torch.ops.splat import binning as tbin
from das3r_tpu_torch.ops.splat import blend, rasterize
from das3r_tpu_torch.ops.splat import window_blend as twin
from das3r_tpu_torch.ops.splat.preprocess import Preprocessed
from das3r_tpu_torch.ops.splat.rasterize import range_tiles, window_range
from das3r_tpu_torch.ops.splat.reference import rasterize_reference

from test_splat import make_scene
from test_torch_binning import jax_prep_pair
from test_torch_blend_backward import GROUPS, assert_grads_close
from test_torch_preprocess import raster_kwargs, settings_pair, to_jax

torch.set_num_threads(2)
ATOL = 2e-4     # the JAX image bar


def jax_depth_q(jprep, bits):
    """JAX's quantized depth, as ``_bin_quantized_depth`` computes it
    (binning.py:726-732)."""
    alive = jprep.binnable
    depth = jprep.depth
    dmin = jnp.min(jnp.where(alive, depth, jnp.inf))
    dmax = jnp.max(jnp.where(alive, depth, -jnp.inf))
    scale = (2.0**bits - 1.0) / jnp.maximum(dmax - dmin, 1e-12)
    return np.asarray(jnp.clip((depth - dmin) * scale, 0, 2.0**bits - 1)
                      .astype(jnp.uint32))


@pytest.mark.parametrize("case", [
    dict(n=300, seed=33, image_height=64, image_width=64, max_per_tile=256,
         max_tiles_per_gaussian=32, bits=22),
    dict(n=900, seed=4, image_height=48, image_width=80, max_per_tile=64,
         max_tiles_per_gaussian=16, bits=6, cap=2000),
])
def test_quantized_depth_bins_match_jax(case):
    """22 bits on test_splat.py's scene; 6 bits (many ties), windows that
    overflow and a buffer that drops entries on another."""
    case = dict(case)
    n, seed, bits = case.pop("n"), case.pop("seed"), case.pop("bits")
    cap = case.pop("cap", None)
    js, ts, jprep, tprep = jax_prep_pair(n, seed, sh_degree=0,
                                         max_total_entries=cap,
                                         depth_sort_bits=bits, **case)
    ts = dataclasses.replace(ts, max_total_entries=cap)
    assert tbin.uses_quantized_depth(ts)
    jb = jax.jit(lambda p: jbin.bin_gaussians(p, js))(jprep)
    tb = tbin.bin_gaussians(tprep, ts)
    dq = tbin.quantized_depth(tprep.depth, tprep.binnable.bool(), bits)
    np.testing.assert_array_equal(dq.numpy(), jax_depth_q(jprep, bits))
    np.testing.assert_array_equal(tb.order.numpy(), np.arange(n))
    np.testing.assert_array_equal(np.asarray(jb.order), np.arange(n))
    for f in ("delta", "count", "full_count", "dup_overflow",
              "entry_overflow", "heavy_overflow"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    jrank = np.asarray(jb.rank)
    ties = 0
    for t in range(ts.n_tiles):
        c = int(tb.count[t])
        got, want = tb.rank[t, :c].numpy(), jrank[t, :c]
        keys = (t << bits) | dq.numpy()[got]
        np.testing.assert_array_equal(keys, (t << bits)
                                      | dq.numpy()[want])
        assert (np.diff(keys) >= 0).all()
        # equal keys: the same Gaussians, in any order
        for k in np.unique(keys):
            run = keys == k
            ties += int(run.sum()) - 1
            assert sorted(got[run]) == sorted(want[run])
    if bits == 6:
        assert ties > 0, "fixture no longer has ties"
        assert int(tb.entry_overflow) > 0 and (
            tb.full_count > ts.max_per_tile).any()


def test_quantized_depth_dispatch():
    """Keys that do not fit 32 bits take the exact binning, as in JAX;
    the entry stream ignores ``depth_sort_bits``."""
    _, ts, _, tprep = jax_prep_pair(300, 1, sh_degree=0, image_height=64,
                                    image_width=64, depth_sort_bits=30,
                                    max_per_tile=128)
    assert not tbin.uses_quantized_depth(ts)            # 17 << 30 > 2^32
    exact = tbin.bin_gaussians(tprep, dataclasses.replace(
        ts, depth_sort_bits=0))
    for x, y in zip(tbin.bin_gaussians(tprep, ts), exact):
        assert torch.equal(x, y)
    a = tbin.bin_entry_stream(tprep, ts)
    b = tbin.bin_entry_stream(tprep, dataclasses.replace(
        ts, depth_sort_bits=0))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_quantized_depth_render_matches_jax_and_exact():
    """The window render with 22-bit keys against JAX's (Pallas window
    kernels in interpret mode) within 2e-4, and against the port's exact
    binning: the scene has no tie within a tile, so both orders agree and
    the image is the same."""
    rng = np.random.default_rng(33)
    js, ts = settings_pair(image_height=64, image_width=64, sh_degree=0,
                           max_per_tile=256, max_tiles_per_gaussian=32,
                           max_total_entries=300 * 32, entry_stream=False,
                           depth_sort_bits=22)
    means, scales, rots, ops, colors = make_scene(300, rng)
    kw = raster_kwargs(js, scales, rots, colors=colors,
                       bg=np.array([0.1, 0.2, 0.3], np.float32))
    img_q, _, aux = rasterize(means, ops, ts, device="cpu", **kw)
    img_e, _, _ = rasterize(means, ops, dataclasses.replace(
        ts, depth_sort_bits=0), device="cpu", **kw)
    jimg, _, _ = jax.jit(functools.partial(
        jax_rasterize, settings=js, backend="pallas"))(means, ops,
                                                       **to_jax(kw))
    np.testing.assert_allclose(img_q.numpy(), np.asarray(jimg), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(img_q.numpy(), img_e.numpy(), atol=1e-6,
                               rtol=0)
    assert int(aux.entry_overflow) == 0 and int(aux.tile_overflow) == 0


@pytest.mark.parametrize("case", [
    dict(n=900, seed=4, image_height=48, image_width=64, max_per_tile=64),
    dict(n=600, seed=6, image_height=32, image_width=64, max_per_tile=256),
])
def test_plain_window_blend_is_jax_blend_tiles(case):
    """The port's plain window blend (kernel D's plain version) computes
    the function of JAX's XLA window blend ``blend_tiles`` on the same
    bins: within 2e-4."""
    case = dict(case)
    n, seed = case.pop("n"), case.pop("seed")
    js, ts, jprep, _ = jax_prep_pair(n, seed, sh_degree=0,
                                     max_tiles_per_gaussian=64,
                                     max_total_entries=None, **case)
    bg = np.array([0.3, 0.1, 0.2], np.float32)
    bins = jax.jit(lambda p: jbin.bin_gaussians(p, js))(jprep)
    inputs = jblend.BlendInputs(mean2d=jprep.mean2d, conic=jprep.conic,
                                color=jprep.color, opacity=jprep.opacity)
    want = jax.jit(lambda i, b, g: jblend.blend_tiles(i, b, js, g))(
        inputs, bins, jnp.asarray(bg))
    attr = jnp.concatenate([jprep.mean2d, jprep.conic, jprep.color,
                            jprep.opacity[:, None]], 1)
    wins = np.asarray(jnp.swapaxes(attr[bins.order][bins.rank], 1, 2))
    colors, _, _ = twin.window_forward_plain(
        torch.as_tensor(wins), torch.as_tensor(np.array(bins.count)),
        torch.as_tensor(np.array(bins.delta)), torch.as_tensor(bg), ts)
    got = blend.assemble_image(colors, ts)
    assert (np.asarray(bins.full_count) > ts.max_per_tile).any() or \
        ts.max_per_tile == 256
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.fixture(scope="module")
def window_scene():
    """Preprocess outputs (port) of a 96x64 scene of 24 tiles, its window
    bins and depth-rank table (a leaf)."""
    _, ts, _, tprep = jax_prep_pair(900, 5, sh_degree=0, image_height=64,
                                    image_width=96, max_per_tile=128,
                                    max_tiles_per_gaussian=32,
                                    max_total_entries=None)
    ts = dataclasses.replace(ts, entry_stream=False)
    bins = tbin.bin_gaussians(Preprocessed(*tprep), ts)
    attr = torch.cat([tprep.mean2d, tprep.conic, tprep.color,
                      tprep.opacity[:, None]], 1)
    return ts, bins, attr[bins.order]


@pytest.mark.parametrize("n_ranges", [2, 4, 5])
def test_window_ranges_reassemble_the_whole_render(window_scene, n_ranges):
    """Window rows blended as ``n_ranges`` tile ranges (5: one padded
    tile) and reassembled: bitwise the whole image; the table and bg
    gradients summed over the ranges within 2e-5 x max|g|."""
    ts, bins, attr_rank = window_scene
    bg = torch.tensor([0.2, 0.5, 0.1])
    cot = torch.as_tensor(np.random.default_rng(n_ranges).normal(
        size=(ts.n_tiles, 256, 3)).astype(np.float32))

    def render(n):
        a = attr_rank.clone().requires_grad_(True)
        b = bg.clone().requires_grad_(True)
        rows = torch.cat([window_range(a, bins, b, ts, n, i)
                          for i in range(n)])
        assert rows.shape[0] == n * range_tiles(ts, n)
        tiles = rows[:ts.n_tiles]
        return tiles, torch.autograd.grad(tiles, (a, b), cot)

    want, (ga_w, gb_w) = render(1)
    got, (ga_g, gb_g) = render(n_ranges)
    assert torch.equal(got, want)
    assert float(ga_w.abs().max()) > 0
    assert_grads_close(ga_g.numpy(), ga_w.numpy(), groups=GROUPS)
    assert_grads_close(gb_g.numpy(), gb_w.numpy())


@pytest.mark.parametrize("sh_degree,rotated", [(0, False), (3, True)])
def test_oracle_is_jax_oracle(sh_degree, rotated):
    """The port's copy of the float64 oracle gives JAX's values exactly."""
    rng = np.random.default_rng(11 + sh_degree)
    js, ts = settings_pair(image_height=40, image_width=56,
                           sh_degree=sh_degree)
    means, scales, rots, ops, colors = make_scene(150, rng)
    shs = rng.normal(0, 0.3, (150, 16, 3)).astype(np.float32)
    kw = raster_kwargs(js, scales, rots, bg=np.array([0.1, 0.2, 0.3]),
                       rotated=rotated,
                       **(dict(colors=colors) if sh_degree == 0
                          else dict(shs=shs)))
    kw = {k: v for k, v in kw.items() if v is not None}
    img, radii = rasterize_reference(means, ops, ts, **kw)
    jimg, jradii = jax_reference(means, ops, js, **kw)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(radii, jradii)
    assert img.dtype == np.float64 and float(img.max()) > 0
