"""PyTorch port: the tile-range form of the entry stream and of kernels B
and C (their plain versions) against the JAX package, in one process.

A tile range is what one rank of the tile-sharded render lays out and
blends (``ops/splat/rasterize.py::render_range``): tiles [tile0, tile0 + t_loc) of the
global sorted key stream, with local output rows and global pixel
coordinates. The range tests use a 96x64 image (24 tiles), so that 5
ranges of 5 tiles leave one padded tile in the last range."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.ops.splat import binning as jbin
from das3r_tpu.ops.splat import entry_blend as jblend
from das3r_tpu.parallel import make_mesh as jax_make_mesh
from das3r_tpu.parallel import sharded as jsharded
from das3r_tpu_torch.models import gaussians
from das3r_tpu_torch.models import render as trender
from das3r_tpu_torch.models.gaussians import activated_opacity, \
    activated_scaling, per_gaussian_conf
from das3r_tpu_torch.ops.splat import binning as tbin
from das3r_tpu_torch.ops.splat import RasterSettings, blend
from das3r_tpu_torch.ops.splat import entry_blend as tblend
from das3r_tpu_torch.ops.splat.preprocess import Preprocessed, preprocess
from das3r_tpu_torch.ops.splat.rasterize import render_range

from test_torch_binning import jax_prep_pair
from test_torch_blend_backward import GROUPS, assert_grads_close
from test_train import build_synthetic_scene

torch.set_num_threads(2)
BLEND_TOL = 2e-4     # the JAX image bar (tests/test_entry_stream.py:51)
RANGES = [(2, 1), (4, 3), (5, 4)]   # (ranges, index); 5: a padded tile


@pytest.fixture(scope="module")
def range_scene():
    """One scene's preprocess outputs in both packages (the JAX ones,
    converted), its sorted keys in both, and JAX's table."""
    js, ts, jprep, tprep = jax_prep_pair(
        900, 5, image_height=64, image_width=96, sh_degree=0,
        max_tiles_per_gaussian=32, max_total_entries=60_000)
    assert ts.n_tiles == 24
    jks = jax.jit(lambda p: jbin._sorted_key_stream(p, js))(jprep)
    tks = tbin._sorted_key_stream(tprep, ts)
    attr = jnp.concatenate([jprep.mean2d, jprep.conic, jprep.color,
                            jprep.opacity[:, None]], 1)
    table = jnp.concatenate([attr[jks.order], jnp.zeros((1, 9))])
    return js, ts, jks, tks, table, jprep.depth.shape[0], tprep


def range_streams(range_scene, n_ranges, index):
    """The JAX and the port stream of one range, at JAX's capacity."""
    js, ts, jks, tks, _, n, _ = range_scene
    t_loc = -(-ts.n_tiles // n_ranges)
    tile0 = index * t_loc
    e_al = jbin.entry_stream_cap(js, n)
    jes = jax.jit(lambda ks, t0: jbin.entry_stream_from_keys(
        ks, js, n, e_al, tile0=t0, t_loc=t_loc))(jks, tile0)
    tes = tbin.entry_stream_from_keys(tks, ts, n, e_al, tile0=tile0,
                                      t_loc=t_loc)
    return jes, tes, tile0, t_loc


@pytest.mark.parametrize("n_ranges,index", RANGES)
def test_range_stream_matches_jax(range_scene, n_ranges, index):
    jes, tes, tile0, t_loc = range_streams(range_scene, n_ranges, index)
    for k in ("rank", "chunk_tile", "count"):
        np.testing.assert_array_equal(getattr(tes, k).numpy(),
                                      np.asarray(getattr(jes, k)), err_msg=k)
    assert int(tes.entry_overflow) == int(jes.entry_overflow)
    al = (tes.count.long() + 127) // 128 * 128
    np.testing.assert_array_equal(tes.astart.numpy(),
                                  (torch.cumsum(al, 0) - al).numpy())
    n_tiles = range_scene[1].n_tiles
    if tile0 + t_loc > n_tiles:        # the padded tail holds nothing
        assert (tes.count[n_tiles - tile0:] == 0).all()
    assert int(tes.count.sum()) > 0
    # the ranges together hold the whole image's entries
    _, ts, _, tks, _, n, _ = range_scene
    whole = tbin.entry_stream_from_keys(tks, ts, n)
    got = sum(int(tbin.entry_stream_from_keys(
        tks, ts, n, None, i * t_loc, t_loc).count.sum())
        for i in range(n_ranges))
    assert got == int(whole.count.sum())


def test_whole_image_is_the_range_from_zero(range_scene):
    """tile0 = 0 with t_loc = n_tiles is the whole-image layout."""
    _, ts, _, tks, _, n, _ = range_scene
    a = tbin.entry_stream_from_keys(tks, ts, n)
    b = tbin.entry_stream_from_keys(tks, ts, n, None, 0, ts.n_tiles)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n_ranges,index", RANGES)
def test_plain_range_blend_matches_jax_kernels(range_scene, n_ranges,
                                               index):
    """The plain B and C of one range against JAX's kernels in interpret
    mode with the same ``tile0`` and ``n_tiles_out``."""
    js, ts, _, _, table, _, _ = range_scene
    jes, tes, tile0, t_loc = range_streams(range_scene, n_ranges, index)
    t0 = jnp.asarray([tile0], jnp.int32)

    def jfwd(t):
        return jblend.render_tiles(t, jes, jnp.zeros(3), js, tile0=t0,
                                   n_tiles_out=t_loc)

    cpre_j, tfinal_j = jax.jit(jfwd)(table)
    table_t = torch.as_tensor(np.array(table))
    stream = (table_t, tes.rank, tes.astart, tes.count)
    fwd = tblend.blend_forward_plain(*stream, ts, tile0, t_loc)
    assert fwd.cpre.shape == (t_loc, 3, 256)
    np.testing.assert_allclose(fwd.cpre.numpy(), np.asarray(cpre_j),
                               atol=BLEND_TOL, rtol=0)
    np.testing.assert_allclose(fwd.tfinal.numpy(), np.asarray(tfinal_j),
                               atol=BLEND_TOL, rtol=0)
    assert (fwd.tfinal.numpy() < 1).any()

    rng = np.random.default_rng(index + 10 * n_ranges)
    g_cpre = rng.normal(size=(t_loc, 3, 256)).astype(np.float32)
    g_tfinal = rng.normal(size=(t_loc, 1, 256)).astype(np.float32)
    want = jax.jit(lambda t, gc, gt: jax.vjp(jfwd, t)[1]((gc, gt))[0])(
        table, g_cpre, g_tfinal)
    got = tblend.blend_backward_plain(
        *stream, ts, fwd.tfinal, fwd.tin, torch.as_tensor(g_cpre),
        torch.as_tensor(g_tfinal), tile0, t_loc)
    assert_grads_close(got.g_table.numpy(), want, groups=GROUPS)


def render_in_ranges(prep, ts, bg, n_ranges):
    """The image of ``prep`` blended as ``n_ranges`` tile ranges in turn
    and reassembled, as the tile-sharded render does across ranks, and
    the depth-rank table (a leaf) it was blended from."""
    n = prep.depth.shape[0]
    ks = tbin._sorted_key_stream(Preprocessed(*(x.detach() for x in prep)),
                                 ts)
    attr = torch.cat([prep.mean2d, prep.conic, prep.color,
                      prep.opacity[:, None]], 1).detach()
    table = torch.cat([attr[ks.order], torch.zeros_like(attr[:1])]
                      ).requires_grad_(True)
    rows = torch.cat([torch.cat(render_range(
        table, ks, ts, n, n_ranges, i)[:2], 1) for i in range(n_ranges)])
    rows = rows[:ts.n_tiles]
    tiles = rows[:, :3] + rows[:, 3:] * bg.reshape(1, 3, 1)
    return blend.assemble_image(tiles.transpose(1, 2), ts), table


@pytest.mark.parametrize("n_ranges", [2, 4, 5])
def test_ranges_reassemble_the_whole_render(range_scene, n_ranges):
    """The image reassembled from the ranges is bitwise the unsharded
    image; the table gradient, summed over the ranges, is within 2e-5 x
    max|g| of the unsharded one (its sum runs in another order)."""
    _, ts, _, _, _, _, prep = range_scene
    bg = torch.tensor([0.2, 0.5, 0.1])
    want, table_w = render_in_ranges(prep, ts, bg, 1)
    got, table_g = render_in_ranges(prep, ts, bg, n_ranges)
    assert torch.equal(got, want)
    cot = torch.as_tensor(np.random.default_rng(n_ranges).normal(
        size=tuple(want.shape)).astype(np.float32))
    (g_want,) = torch.autograd.grad(want, table_w, cot)
    (g_got,) = torch.autograd.grad(got, table_g, cot)
    assert float(g_want.abs().max()) > 0
    assert_grads_close(g_got.numpy(), g_want.numpy(), groups=GROUPS)


def test_range_render_matches_jax_sharded_render():
    """The port's image, blended as 4 tile ranges, against JAX's
    ``make_sharded_render`` on a (data=2, tile=4) mesh with the Pallas
    kernels (interpret mode), on the scene of tests/test_parallel.py."""
    params, meta, poses, js = build_synthetic_scene(n=120, cap=128, f=4,
                                                    hw=32, seed=2)
    js = dataclasses.replace(js, max_total_entries=8192)
    fov = 1.0
    mesh = jax_make_mesh(data=2, tile=4)
    with jax.sharding.set_mesh(mesh):
        want = jsharded.make_sharded_render(mesh, js, backend="pallas")(
            params, meta, poses.pose(0), jnp.zeros(3), jnp.asarray(fov),
            jnp.asarray(fov))

    ts = RasterSettings(**dataclasses.asdict(js))
    tp, tm = gaussians.params_from_numpy(
        {k: np.asarray(v) for k, v in params._asdict().items()},
        {k: np.asarray(v) for k, v in meta._asdict().items()}, "cpu")
    tq = gaussians.poses_from_numpy(
        {k: np.asarray(v) for k, v in poses._asdict().items()}, "cpu")
    # preprocess as render(mode="train") does
    pose = tq.pose(0)
    xyz, rot = trender._camera_frame_gaussians(tp, pose)
    view, proj, campos, tfx, tfy = trender._raster_common(fov, fov, "cpu")
    opacity = (activated_opacity(tp) * per_gaussian_conf(tp, tm)[:, None]
               * tm.alive[:, None])
    with torch.no_grad():
        prep = preprocess(
            xyz, opacity, ts, viewmatrix=view, projmatrix=proj,
            campos=campos, shs=torch.cat([tp.features_dc, tp.features_rest],
                                         1),
            scales=activated_scaling(tp), rotations=rot, tan_fovx=tfx,
            tan_fovy=tfy)
        got, _ = render_in_ranges(prep, ts, torch.zeros(3), 4)
        whole = trender.render(tp, tm, ts, pose, torch.zeros(3), fov, fov,
                               mode="train", device="cpu").image
    assert ts.n_tiles == 4
    assert torch.equal(got, whole)
    assert float(got.max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BLEND_TOL, rtol=0)
