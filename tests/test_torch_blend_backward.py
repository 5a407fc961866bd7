"""PyTorch port: the blend backward (the plain version that the CUDA kernel
is held against on the card) against ``jax.vjp`` of the JAX entry-stream
blend, whose Pallas backward kernel runs in interpret mode; and the
gradients of the port's whole ``rasterize`` against JAX
``rasterize(backend="pallas")``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.ops.splat import entry_blend as jblend
from das3r_tpu.ops.splat import rasterize as jax_rasterize
from das3r_tpu_torch.ops.splat import entry_blend as tblend
from das3r_tpu_torch.ops.splat import rasterize

from test_splat import make_scene
from test_torch_blend import jax_stream_and_table, torch_stream
from test_torch_preprocess import raster_kwargs, settings_pair, to_jax

torch.set_num_threads(2)
RTOL = 2e-5      # x max|g|: the JAX bar (tests/test_entry_stream.py:95-98)
# table columns by what they hold: mean2d, conic, color, opacity
GROUPS = {"mean2d": [0, 1], "conic": [2, 3, 4], "color": [5, 6, 7],
          "opacity": [8]}


def assert_grads_close(got, want, rtol=RTOL, groups=None):
    """|got - want| <= rtol * max|want|, per column group when given."""
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    for name, cols in (groups or {"all": slice(None)}).items():
        w, g = want[..., cols], got[..., cols]
        ref = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(g, w, atol=rtol * ref, rtol=0,
                                   err_msg=name)


def saturating_scene():
    """The dense near-opaque scene of the JAX saturation test."""
    rng = np.random.default_rng(17)
    means, scales, rots, _, colors = make_scene(1200, rng, spread=0.6)
    ops = rng.uniform(0.9, 0.98, 1200).astype(np.float32)
    return (means, (scales * 3.0).astype(np.float32), rots, ops, colors)


@pytest.mark.parametrize("case", [
    dict(n=1000, seed=42, image_height=128, image_width=128,
         max_tiles_per_gaussian=64),
    dict(n=1500, seed=3, spread=0.8, image_height=64, image_width=64,
         max_tiles_per_gaussian=64),
    dict(n=400, seed=8, image_height=40, image_width=72,
         max_tiles_per_gaussian=16),
    dict(saturate=True, image_height=64, image_width=64, max_per_tile=2048,
         max_tiles_per_gaussian=64),
])
def test_plain_backward_matches_jax_vjp(case):
    case = dict(case)
    if case.pop("saturate", False):
        scene = saturating_scene()
        seed = 17
    else:
        seed = case.pop("seed")
        scene = make_scene(case.pop("n"), np.random.default_rng(seed),
                           spread=case.pop("spread", 1.5))
    js, ts = settings_pair(sh_degree=0, **case)
    es, table = jax_stream_and_table(js, ts, scene)
    rng = np.random.default_rng(seed + 1000)
    P = ts.tile * ts.tile
    g_cpre = rng.normal(size=(ts.n_tiles, 3, P)).astype(np.float32)
    g_tfinal = rng.normal(size=(ts.n_tiles, 1, P)).astype(np.float32)

    want = jax.jit(lambda t, gc, gt: jax.vjp(
        lambda t: jblend.render_tiles(t, es, jnp.zeros(3), js), t)[1](
        (gc, gt))[0])(table, g_cpre, g_tfinal)

    stream = torch_stream(es, table)
    fwd = tblend.blend_forward_plain(*stream, ts)
    got = tblend.blend_backward_plain(
        *stream, ts, fwd.tfinal, fwd.tin, torch.as_tensor(g_cpre),
        torch.as_tensor(g_tfinal))
    assert got.chunks_skipped == fwd.chunks_skipped
    if case.get("max_per_tile") == 2048:
        assert got.chunks_skipped > 0, "fixture no longer saturates"
    assert_grads_close(got.g_table.numpy(), want, groups=GROUPS)

    # the autograd path of the port takes the same plain backward
    t = stream[0].clone().requires_grad_(True)
    cpre, tfinal = tblend.blend_entry_stream(t, *stream[1:], ts)
    (g_auto,) = torch.autograd.grad(
        (cpre, tfinal), t,
        (torch.as_tensor(g_cpre), torch.as_tensor(g_tfinal)))
    torch.testing.assert_close(g_auto, got.g_table, rtol=0, atol=0)


def test_plain_forward_n_last_marks_the_last_contributor():
    """n_last, where the CUDA backward starts each pixel's walk, is one
    past the pixel's last contributing entry: the pixel renders the same
    once its list is cut there."""
    js, ts = settings_pair(image_height=64, image_width=64, sh_degree=0,
                           max_per_tile=2048, max_tiles_per_gaussian=64)
    es, table = jax_stream_and_table(js, ts, saturating_scene())
    table_t, rank, astart, count = torch_stream(es, table)
    fwd = tblend.blend_forward_plain(table_t, rank, astart, count, ts)
    left = count[:, None] - fwd.n_last
    assert (left >= 0).all() and (fwd.n_last > 0).any()
    t = int(torch.argmax(left.amax(1)))
    p = int(torch.argmax(left[t]))
    n = int(fwd.n_last[t, p])
    assert 0 < n < int(count[t])
    cut = rank.clone()                  # the tail becomes pad slots
    a = int(astart[t])
    cut[a + n:a + int(count[t])] = len(table_t) - 1
    sub = tblend.blend_forward_plain(table_t, cut, astart, count, ts)
    assert torch.equal(sub.cpre[t, :, p], fwd.cpre[t, :, p])
    assert torch.equal(sub.tfinal[t, :, p], fwd.tfinal[t, :, p])
    assert int(sub.n_last[t, p]) == n


@pytest.mark.parametrize("case", [
    dict(n=600, seed=7, sh_degree=0, image_height=64, image_width=96,
         rotated=False),
    dict(n=500, seed=9, sh_degree=3, image_height=64, image_width=96,
         rotated=True),
])
def test_rasterize_gradients_match_jax(case):
    """d(weighted image sum) by means, opacities, bg (and the colours or
    SH coefficients) against JAX's entry-stream Pallas path."""
    case = dict(case)
    n, rotated = case.pop("n"), case.pop("rotated")
    rng = np.random.default_rng(case.pop("seed"))
    js, ts = settings_pair(max_per_tile=1024, max_total_entries=48_000,
                           max_tiles_per_gaussian=64, **case)
    means, scales, rots, ops, colors = make_scene(n, rng)
    bg = np.array([0.1, 0.0, 0.4], np.float32)
    if ts.sh_degree == 0:
        kw = raster_kwargs(js, scales, rots, colors=colors, bg=bg,
                           rotated=rotated)
        ckey = "colors_precomp"
    else:
        kw = raster_kwargs(js, scales, rots, bg=bg, rotated=rotated,
                           shs=rng.normal(0, 0.3, (n, 16, 3)).astype(
                               np.float32))
        ckey = "shs"
    h, w = ts.image_height, ts.image_width
    weight = np.cos(np.arange(3 * h * w).reshape(3, h, w) * 0.01).astype(
        np.float32)

    def jloss(m, o, b, c):
        img, _, _ = jax_rasterize(m, o, js, backend="pallas",
                                  **to_jax(dict(kw, bg=b, **{ckey: c})))
        return jnp.sum(img * weight)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        means, ops, bg, kw[ckey])

    leaves = [torch.tensor(x, requires_grad=True)
              for x in (means, ops, bg, kw[ckey])]
    img, _, _ = rasterize(
        leaves[0], leaves[1], ts, device="cpu",
        **dict(kw, bg=leaves[2], **{ckey: leaves[3]}))
    got = torch.autograd.grad((img * torch.as_tensor(weight)).sum(), leaves)
    for name, g, wv in zip(("means", "opacities", "bg", ckey), got, want):
        assert g.shape == wv.shape, name
        assert float(np.abs(np.asarray(wv)).max()) > 0, name
        assert_grads_close(g.numpy(), wv)


def test_bg_gradient_covers_empty_tiles():
    """Port of tests/test_entry_stream.py:197-219: a scene leaving whole
    tiles empty; d(sum image)/d(bg) counts every pixel's transmittance,
    bg-only tiles included, and agrees with a finite difference."""
    rng = np.random.default_rng(11)
    _, ts = settings_pair(image_height=64, image_width=64, sh_degree=0,
                          max_per_tile=128, max_tiles_per_gaussian=16)
    means, scales, rots, ops, colors = make_scene(5, rng, spread=0.2)
    kw = raster_kwargs(ts, scales, rots, colors=colors)

    def f(b):
        img, _, _ = rasterize(means, ops, ts, device="cpu",
                              **dict(kw, bg=b))
        return img.sum()

    b = torch.zeros(3, requires_grad=True)
    (g,) = torch.autograd.grad(f(b), b)
    assert (g > 0.8 * 64 * 64).all(), g
    eps = 1e-3
    with torch.no_grad():
        f0 = float(f(torch.zeros(3)))
        f1 = float(f(torch.tensor([eps, 0.0, 0.0])))
    np.testing.assert_allclose(float(g[0]), (f1 - f0) / eps, rtol=5e-3)


def test_permute_rows_backward_is_the_inverse_gather():
    from das3r_tpu_torch.ops.splat.rasterize import permute_rows
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(50, 9)), requires_grad=True)
    order = torch.as_tensor(rng.permutation(50))
    g = torch.as_tensor(rng.normal(size=(50, 9)))
    (gx,) = torch.autograd.grad(permute_rows(x, order), x, g)
    want = torch.zeros_like(g).index_add_(0, order, g)
    torch.testing.assert_close(gx, want, rtol=0, atol=0)
