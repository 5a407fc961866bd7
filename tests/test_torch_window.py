"""PyTorch port: the [T, K] window path against the JAX package.

* window binning (``_windows``'s three branches, ``bin_gaussians``) on the
  same inputs, bitwise on the live slots;
* the plain window blend against JAX ``blend_tiles_pallas`` (its Pallas
  kernels in interpret mode): colours, ``tfinal`` and ``tin`` within 2e-4,
  the ``jax.vjp`` gradients within 2e-5 x max|g| per attribute group;
* ``rasterize(entry_stream=False)`` against JAX ``rasterize`` on its window
  path (``backend="pallas"`` and ``"xla"``) and the float64 oracle within
  2e-4, and its gradients against JAX's within 2e-5 x max|g|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.ops.splat import binning as jbin
from das3r_tpu.ops.splat import pallas_blend as jwin
from das3r_tpu.ops.splat import rasterize as jax_rasterize
from das3r_tpu.ops.splat.reference import rasterize_reference
from das3r_tpu_torch.ops.splat import binning as tbin
from das3r_tpu_torch.ops.splat import rasterize
from das3r_tpu_torch.ops.splat import window_blend as twin

from test_splat import make_scene
from test_torch_binning import jax_prep_pair
from test_torch_blend_backward import assert_grads_close, saturating_scene
from test_torch_preprocess import (raster_kwargs, run_both_preprocess,
                                   settings_pair, to_jax)

torch.set_num_threads(2)
ATOL = 2e-4     # image bar of the JAX tests against the oracle
RTOL = 2e-5     # x max|g|: the JAX gradient bar
# attribute rows of the [T, 9, K] windows by what they hold
GROUPS = {"mean2d": [0, 1], "conic": [2, 3, 4], "color": [5, 6, 7],
          "opacity": [8]}


def window_keys(rng, n_tiles, nbits, e):
    """Sorted unique live keys ``tile << nbits | rank``, ranks < 2^nbits."""
    keys = np.unique((rng.integers(0, n_tiles, e) << nbits)
                     | rng.integers(0, 2 ** nbits, e))
    return keys


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("impl", ["aligned", "dma", "element"])
def test_windows_match_jax(seed, impl):
    """The three ``_windows`` branches against the JAX ones on the same
    keys: delta, count and full_count exactly, the live slots' decoded
    ranks bitwise. The port pads its live keys itself; JAX gets them padded
    with K + 128 sentinels as its sort stage pads them."""
    rng = np.random.default_rng(seed)
    t, nbits = 17, 9
    n = 2 ** nbits - 40              # some rank fields exceed n - 1
    k_cap = 128 if impl != "element" else 96
    keys = window_keys(rng, t, nbits, 4000)
    sentinel = ((t + 1) << nbits) - 1
    jkeys = jbin._pad128(jnp.asarray(keys.astype(np.uint32)),
                         jnp.uint32(sentinel), extra=k_cap + 128)
    boundaries = jnp.arange(t + 1, dtype=jnp.uint32) << nbits
    if impl == "dma":
        # the TPU kernel in interpret mode (backend-gated inside _windows)
        bounds = np.searchsorted(np.asarray(jkeys), np.asarray(boundaries))
        win = jbin._extract_windows_pallas(
            jkeys, jnp.asarray(bounds[:-1], jnp.int32), k_cap)
        full = bounds[1:] - bounds[:-1]
        jd, jc, jf = np.zeros(t), np.minimum(full, k_cap), full
    else:
        win, jd, jc, jf = jbin._windows(jkeys, boundaries, k_cap,
                                        use_dma=False)
    jrank = np.minimum(np.asarray(win) & (2 ** nbits - 1), n - 1)
    rank, delta, count, full_count = tbin._windows(
        torch.as_tensor(keys), nbits, n, t, k_cap,
        use_dma=impl != "aligned")
    assert rank.dtype == torch.int32 and rank.shape == jrank.shape
    np.testing.assert_array_equal(delta.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(full_count.numpy(), np.asarray(jf))
    assert (count.numpy() == k_cap).any() and (full_count.numpy() > k_cap).any()
    for ti in range(t):
        d, c = int(delta[ti]), int(count[ti])
        np.testing.assert_array_equal(rank[ti, d:d + c].numpy(),
                                      jrank[ti, d:d + c])
    if impl == "aligned":
        assert int(delta.max()) > 0


def test_extract_windows_plain_is_the_per_element_gather():
    """Kernel F's plain version: the decode of keys[start + j], the index
    clipped to the array."""
    keys = torch.tensor([5, 9 | 16, 3 | 32, 13 | 48], dtype=torch.int64)
    start = torch.tensor([0, 2, 3])
    got = tbin.extract_windows(keys, start, 3, 4, 12)        # CPU: plain
    want = torch.tensor([[5, 9, 3], [3, 11, 11], [11, 11, 11]],
                        dtype=torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [
    dict(n=1500, seed=0, image_height=96, image_width=128,
         max_tiles_per_gaussian=32, max_per_tile=256),
    dict(n=2000, seed=1, spread=0.6, image_height=64, image_width=80,
         max_tiles_per_gaussian=64, max_per_tile=128,
         use_dma_windows=False),
    dict(n=700, seed=2, image_height=72, image_width=40,
         max_tiles_per_gaussian=8, max_per_tile=64),
])
def test_bin_gaussians_matches_jax(case):
    """Both binners get the JAX preprocess outputs. On the CPU JAX takes the
    per-element branch where the port takes kernel F's plain version."""
    case = dict(case)
    n, seed, spread = case.pop("n"), case.pop("seed"), case.pop("spread", 1.5)
    js, ts, jprep, tprep = jax_prep_pair(n, seed, spread, sh_degree=0,
                                         max_total_entries=None, **case)
    jb = jax.jit(lambda p: jbin.bin_gaussians(p, js))(jprep)
    tb = tbin.bin_gaussians(tprep, ts)
    np.testing.assert_array_equal(tb.order.numpy(), np.asarray(jb.order))
    for f in ("delta", "count", "full_count"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert tb.rank.shape == jb.rank.shape
    jrank = np.asarray(jb.rank)
    for t in range(ts.n_tiles):
        d, c = int(tb.delta[t]), int(tb.count[t])
        np.testing.assert_array_equal(tb.rank[t, d:d + c].numpy(),
                                      jrank[t, d:d + c])
    assert int(tb.dup_overflow) == int(jb.dup_overflow)
    assert int((tb.full_count > ts.max_per_tile).sum()) > 0, "no overflow"
    if not ts.use_dma_windows:
        assert int(tb.delta.max()) > 0
    torch.testing.assert_close(tbin.gids(tb), tb.order[tb.rank])


def jax_windows(js, ts, scene):
    """JAX preprocess + window binning of a scene -> ([T, 9, K] windows,
    counts, deltas, full counts) as numpy, the window blend's inputs."""
    means, scales, rots, ops, colors = scene
    jprep, _ = run_both_preprocess(
        js, ts, means, ops, raster_kwargs(js, scales, rots, colors=colors))
    bins = jax.jit(lambda p: jbin.bin_gaussians(p, js))(jprep)
    attr = jnp.concatenate([jprep.mean2d, jprep.conic, jprep.color,
                            jprep.opacity[:, None]], 1)
    wins = jnp.swapaxes(attr[bins.order][bins.rank], 1, 2)
    return (np.asarray(wins), np.asarray(bins.count),
            np.asarray(bins.delta), np.asarray(bins.full_count))


@pytest.mark.parametrize("case", [
    dict(n=900, seed=4, image_height=48, image_width=64, max_per_tile=64),
    dict(n=900, seed=5, image_height=48, image_width=64, max_per_tile=128,
         use_dma_windows=False),
    dict(n=600, seed=6, image_height=32, image_width=64, max_per_tile=256),
    dict(saturate=True, image_height=48, image_width=48, max_per_tile=256),
    dict(n=900, seed=7, image_height=48, image_width=64, max_per_tile=8),
    dict(n=900, seed=8, image_height=48, image_width=64, max_per_tile=32),
])
def test_plain_window_blend_matches_jax_kernels(case):
    """Forward (colours, tfinal, tin) and the ``jax.vjp`` gradients of the
    windows and bg, for K = 64, 128 (+128 aligned, delta > 0) and 256,
    under tile overflow and on the dense near-opaque scene; and for K = 8
    and 32, where the chunk is K itself (JAX takes both widths)."""
    case = dict(case)
    if case.pop("saturate", False):
        scene, seed = saturating_scene(), 17
    else:
        seed = case.pop("seed")
        scene = make_scene(case.pop("n"), np.random.default_rng(seed))
    js, ts = settings_pair(sh_degree=0, max_tiles_per_gaussian=64,
                           max_total_entries=None, **case)
    wins, counts, deltas, full = jax_windows(js, ts, scene)
    bg = np.array([0.3, 0.1, 0.2], np.float32)
    colors_j, tfinal_j, tin_j = jax.jit(
        lambda a, c, d, b: jwin._forward_impl(a, c, d, b, js))(
        wins, counts, deltas, bg)
    args = [torch.as_tensor(np.array(x)) for x in (wins, counts, deltas, bg)]
    colors, tfinal, tin = twin.window_forward(*args, ts)     # CPU: plain
    np.testing.assert_allclose(colors.numpy(), np.asarray(colors_j),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(tfinal_j)[..., 0],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tin.numpy(), np.asarray(tin_j)[..., 0],
                               atol=ATOL, rtol=0)
    assert ((tin.numpy() == 0) == (np.asarray(tin_j)[..., 0] == 0)).all()
    if case.get("max_per_tile") != 256 or seed == 17:
        assert (full > ts.max_per_tile).any(), "fixture no longer overflows"
    if seed == 17:
        n_vis = (tin.amax(2) >= ts.transmittance_eps).sum(1)
        n_run = -(-(deltas + counts) // twin._pick_chunk(wins.shape[2]))
        assert (n_vis.numpy() < n_run).any(), "fixture no longer saturates"

    g = np.random.default_rng(seed + 100).normal(
        size=colors.shape).astype(np.float32)
    want_a, want_bg = jax.jit(lambda a, b, g: jax.vjp(
        lambda a, b: jwin.blend_tiles_pallas(a, counts, deltas, b, js),
        a, b)[1](g))(wins, bg, g)
    a = args[0].clone().requires_grad_(True)
    b = args[3].clone().requires_grad_(True)
    out = twin.blend_tiles_window(a, args[1], args[2], b, ts)
    got_a, got_bg = torch.autograd.grad(out, (a, b), torch.as_tensor(g))
    assert_grads_close(got_a.transpose(1, 2).numpy(),
                       np.swapaxes(np.asarray(want_a), 1, 2), rtol=RTOL,
                       groups=GROUPS)
    assert_grads_close(got_bg.numpy(), np.asarray(want_bg), rtol=RTOL)


def test_pick_chunk_rejects_other_widths():
    assert twin._pick_chunk(384) == 128 and twin._pick_chunk(32) == 32
    with pytest.raises(ValueError, match="multiple of 128"):
        twin._pick_chunk(96)


@pytest.mark.parametrize("case", [
    dict(n=600, seed=42, sh_degree=0, image_height=64, image_width=96,
         max_tiles_per_gaussian=64, max_per_tile=512, rotated=False),
    dict(n=500, seed=9, sh_degree=3, image_height=64, image_width=96,
         max_tiles_per_gaussian=32, max_per_tile=512, rotated=True,
         use_dma_windows=False),
])
def test_rasterize_window_path_matches_jax_and_oracle(case):
    """The image against JAX's window path (Pallas kernels in interpret
    mode, and the XLA blend) and the float64 oracle; the gradients by
    means, opacities and bg against JAX's Pallas window path."""
    case = dict(case)
    n, rotated = case.pop("n"), case.pop("rotated")
    rng = np.random.default_rng(case.pop("seed"))
    js, ts = settings_pair(max_total_entries=None, entry_stream=False,
                           **case)
    means, scales, rots, ops, colors = make_scene(n, rng)
    bg = np.array([0.2, 0.3, 0.1], np.float32)
    if ts.sh_degree == 0:
        kw = raster_kwargs(js, scales, rots, colors=colors, bg=bg,
                           rotated=rotated)
    else:
        kw = raster_kwargs(js, scales, rots, bg=bg, rotated=rotated,
                           shs=rng.normal(0, 0.3, (n, 16, 3)).astype(
                               np.float32))
    h, w = ts.image_height, ts.image_width
    weight = np.cos(np.arange(3 * h * w).reshape(3, h, w) * 0.01).astype(
        np.float32)

    def jloss(m, o, b, backend):
        img, _, aux = jax_rasterize(m, o, js, backend=backend,
                                    **to_jax(dict(kw, bg=b)))
        return jnp.sum(img * weight), (img, aux.tile_overflow)

    jimgs = {}
    for backend in ("pallas", "xla"):
        (_, (jimg, j_ovf)), jgrad = jax.jit(jax.value_and_grad(
            functools.partial(jloss, backend=backend), argnums=(0, 1, 2),
            has_aux=True))(means, ops, bg)
        jimgs[backend] = np.asarray(jimg)
        if backend == "pallas":
            want = jgrad

    leaves = [torch.tensor(x, requires_grad=True) for x in (means, ops, bg)]
    img, radii, aux = rasterize(leaves[0], leaves[1], ts, device="cpu",
                                **dict(kw, bg=leaves[2]))
    ref_img, ref_radii = rasterize_reference(
        means, ops, js, **{k: v for k, v in kw.items() if v is not None})
    assert int(aux.tile_overflow) == int(j_ovf) == 0
    np.testing.assert_array_equal(radii.numpy(), ref_radii)
    for backend, jimg in jimgs.items():
        np.testing.assert_allclose(img.detach().numpy(), jimg, atol=ATOL,
                                   rtol=0, err_msg=backend)
    np.testing.assert_allclose(img.detach().numpy(), ref_img, atol=ATOL,
                               rtol=0)
    got = torch.autograd.grad((img * torch.as_tensor(weight)).sum(), leaves)
    for name, g, wv in zip(("means", "opacities", "bg"), got, want):
        assert float(np.abs(np.asarray(wv)).max()) > 0, name
        assert_grads_close(g.numpy(), np.asarray(wv), rtol=RTOL)


def test_rasterize_window_path_reports_tile_overflow_like_jax():
    """A starved K: the port truncates each tile to its K nearest entries
    and reports the same overflow and image as JAX's window path."""
    rng = np.random.default_rng(21)
    js, ts = settings_pair(max_total_entries=None, entry_stream=False,
                           sh_degree=0, image_height=48, image_width=64,
                           max_tiles_per_gaussian=32, max_per_tile=128)
    means, scales, rots, ops, colors = make_scene(1500, rng)
    kw = raster_kwargs(js, scales, rots, colors=colors)
    img, _, aux = rasterize(means, ops, ts, device="cpu", **kw)
    jimg, _, jaux = jax.jit(functools.partial(
        jax_rasterize, settings=js, backend="pallas"))(means, ops,
                                                       **to_jax(kw))
    assert int(aux.tile_overflow) == int(jaux.tile_overflow) > 0
    np.testing.assert_array_equal(aux.n_contrib_tiles.numpy(),
                                  np.asarray(jaux.n_contrib_tiles))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=ATOL,
                               rtol=0)
