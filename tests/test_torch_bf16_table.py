"""PyTorch port: the bf16 attribute table of the entry stream
(``RasterSettings.table_bf16``) against the JAX package.

The encode is held bitwise against JAX's; the plain bf16 blends (the
decoded table through the f32 plain versions of kernels B and C) against
JAX's bf16 kernels in interpret mode on the same table and stream, at the
f32 bars, since the decoded inputs are bitwise equal; the bf16 render
against each package's f32 render in JAX's envelope
(tests/test_entry_stream.py:266-318); and a few training steps with the
bf16 table."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.ops.splat import entry_blend as jblend
from das3r_tpu.ops.splat import rasterize as jax_rasterize
from das3r_tpu.ops.splat.preprocess import preprocess as jax_preprocess
from das3r_tpu_torch.ops.splat import binning as tbin
from das3r_tpu_torch.ops.splat import entry_blend as tblend
from das3r_tpu_torch.ops.splat import blend, rasterize
from das3r_tpu_torch.ops.splat.preprocess import Preprocessed, preprocess
from das3r_tpu_torch.train import step as tstep
from das3r_tpu_torch.train.config import OptimizationConfig

from test_splat import make_scene
from test_torch_blend_backward import GROUPS, assert_grads_close
from test_torch_preprocess import raster_kwargs, settings_pair, to_jax
from test_torch_tile_range import BLEND_TOL, range_scene  # noqa: F401
from test_torch_tile_range import range_streams
from test_torch_train import small_port_scene

torch.set_num_threads(2)
# JAX's bf16 envelope against the f32 render (test_entry_stream.py:293-318)
ENV_MAX, ENV_MEAN, ENV_GRAD = 1.5e-2, 1e-3, 8e-3


def bits(x) -> np.ndarray:
    """The 16-bit patterns of a bf16 array of either package."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def boundary_table(seed: int) -> np.ndarray:
    """[M, 9] f32: screen-space means over a 1024-px image, conics,
    colours and opacities, with rows on and next to bf16 rounding
    boundaries (a mean exactly halfway between two bf16 values, one ulp to
    either side, a colour at a tie) and the zero sentinel row last."""
    rng = np.random.default_rng(seed)
    m = 400
    t = np.concatenate([rng.uniform(-50, 1100, (m, 2)),
                        rng.uniform(0.001, 2.0, (m, 3)),
                        rng.uniform(0, 1, (m, 3)),
                        rng.uniform(0, 1, (m, 1))], 1).astype(np.float32)
    # bf16 keeps 8 significant bits: 257 lies halfway between 256 and 258
    ties = np.float32([257.0, 513.0, 1.00390625, 0.501953125])
    for i, v in enumerate(ties):
        for k, d in enumerate((0, 1, -1)):
            t[3 * i + k, :] = np.nextafter(v, np.float32(np.inf * d)) \
                if d else v
    return np.concatenate([t, np.zeros((1, 9), np.float32)])


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_is_bitwise_jax(seed):
    table = boundary_table(seed)
    want = jax.jit(jblend.encode_bf16_table)(jnp.asarray(table))
    got = tblend.encode_bf16_table(torch.as_tensor(table))
    assert got.dtype == torch.bfloat16 and got.shape == (table.shape[0], 11)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert (bits(got)[-1] == 0).all()          # the sentinel row
    # the decode: JAX's _load_attrs in f32 (entry_blend.py:77-81)
    raw = jnp.asarray(want).astype(jnp.float32)
    jdec = jnp.concatenate([raw[:, 0:1] + raw[:, 1:2],
                            raw[:, 2:3] + raw[:, 3:4], raw[:, 4:]], 1)
    dec = tblend.decode_bf16_table(got)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    # the mean's hi + lo pair keeps ~17 bits: far below a pixel
    assert np.abs(dec.numpy()[:, :2] - table[:, :2]).max() < 1e-2


@pytest.mark.parametrize("n_ranges,index", [(1, 0), (2, 1), (5, 4)])
def test_plain_bf16_blend_matches_jax_kernels(range_scene, n_ranges, index):
    """The plain bf16 B and C (the whole image and two tile ranges)
    against JAX's bf16 kernels in interpret mode on the same f32 table:
    the image within 2e-4, the table gradient within 2e-5 x max|g| per
    column group, through the port's autograd (encode, blend, gradient
    straight through the encode)."""
    js, ts, _, _, table, _, _ = range_scene
    js = dataclasses.replace(js, table_bf16=True)
    ts = dataclasses.replace(ts, table_bf16=True)
    jes, tes, tile0, t_loc = range_streams(range_scene, n_ranges, index)
    t0 = jnp.asarray([tile0], jnp.int32)

    def jfwd(t):
        return jblend.render_tiles(t, jes, jnp.zeros(3), js, tile0=t0,
                                   n_tiles_out=t_loc)

    cpre_j, tfinal_j = jax.jit(jfwd)(table)
    table_t = torch.as_tensor(np.array(table)).requires_grad_(True)
    cpre, tfinal = tblend.render_tiles(table_t, tes, ts, tile0, t_loc)
    np.testing.assert_allclose(cpre.detach().numpy(), np.asarray(cpre_j),
                               atol=BLEND_TOL, rtol=0)
    np.testing.assert_allclose(tfinal.detach().numpy(), np.asarray(tfinal_j),
                               atol=BLEND_TOL, rtol=0)
    # the bf16 image is not the f32 one: the decode is in the blend
    f32 = tblend.blend_forward_plain(table_t.detach(), tes.rank, tes.astart,
                                     tes.count, ts, tile0, t_loc)
    assert not torch.equal(f32.cpre, cpre.detach())

    rng = np.random.default_rng(7 + index + 10 * n_ranges)
    g_cpre = rng.normal(size=(t_loc, 3, 256)).astype(np.float32)
    g_tfinal = rng.normal(size=(t_loc, 1, 256)).astype(np.float32)
    want = jax.jit(lambda t, gc, gt: jax.vjp(jfwd, t)[1]((gc, gt))[0])(
        table, g_cpre, g_tfinal)
    (got,) = torch.autograd.grad(
        (cpre, tfinal), table_t,
        (torch.as_tensor(g_cpre), torch.as_tensor(g_tfinal)))
    assert got.dtype == torch.float32 and got.shape == table_t.shape
    assert_grads_close(got.numpy(), np.asarray(want), groups=GROUPS)


def bf16_scene(seed, n):
    """TestBf16Table's scene (tests/test_entry_stream.py:275-286)."""
    js, ts = settings_pair(image_height=128, image_width=128, sh_degree=0,
                           max_per_tile=1024, max_tiles_per_gaussian=64,
                           max_total_entries=48_000, table_bf16=True)
    means, scales, rots, ops, colors = make_scene(n, np.random.default_rng(
        seed))
    bg = np.array([0.2, 0.3, 0.1], np.float32)
    return js, ts, means, ops, raster_kwargs(js, scales, rots,
                                             colors=colors, bg=bg)


def port_table(ts, means, ops, kw):
    """The port's depth-rank f32 table and stream of one render."""
    with torch.no_grad():
        p = preprocess(torch.as_tensor(means), torch.as_tensor(ops), ts,
                       **{k: (torch.as_tensor(v) if isinstance(v, np.ndarray)
                              else v) for k, v in kw.items() if k != "bg"})
    es = tbin.bin_entry_stream(Preprocessed(*p), ts)
    attr = torch.cat([p.mean2d, p.conic, p.color, p.opacity[:, None]], 1)
    return torch.cat([attr[es.order], torch.zeros_like(attr[:1])]), es


def test_bf16_render_in_jax_envelope_and_matches_jax():
    """``rasterize`` with ``table_bf16``: against the port's f32 render in
    JAX's envelope, and against JAX's bf16 render within 2e-4 on every
    tile whose entries' rows encode to the same bf16 values in both
    packages (their preprocess differs by ~1e-7, which can move a value
    across a bf16 rounding boundary)."""
    js, ts, means, ops, kw = bf16_scene(21, 1000)
    img_b, radii_b, _ = rasterize(means, ops, ts, device="cpu", **kw)
    img_f, radii_f, _ = rasterize(
        means, ops, dataclasses.replace(ts, table_bf16=False), device="cpu",
        **kw)
    assert torch.equal(radii_b, radii_f)
    err = (img_b - img_f).abs()
    assert float(err.max()) < ENV_MAX and float(err.mean()) < ENV_MEAN
    assert float(err.max()) > 0

    jimg, _, _ = jax.jit(functools.partial(
        jax_rasterize, settings=js, backend="pallas"))(means, ops,
                                                       **to_jax(kw))
    table, es = port_table(ts, means, ops, kw)
    jp = jax.jit(lambda m, o: jax_preprocess(
        m, o, js, **{k: v for k, v in to_jax(kw).items() if k != "bg"}))(
        means, ops)
    jattr = np.concatenate([np.asarray(jp.mean2d), np.asarray(jp.conic),
                            np.asarray(jp.color),
                            np.asarray(jp.opacity)[:, None]], 1)
    jtable = np.concatenate([jattr[es.order.numpy()],
                             np.zeros((1, 9), np.float32)])
    differ = torch.as_tensor(
        bits(tblend.encode_bf16_table(table))
        != bits(tblend.encode_bf16_table(torch.as_tensor(jtable))))
    diff_rows = differ.any(1)
    # the tiles whose lists hold a row that encodes differently
    bad = torch.zeros(ts.n_tiles, dtype=torch.bool)
    for t in range(ts.n_tiles):
        a, c = int(es.astart[t]), int(es.count[t])
        bad[t] = bool(diff_rows[es.rank[a:a + c]].any())
    print(f"bf16 values that encode differently: {int(differ.sum())} in "
          f"{int(diff_rows.sum())} rows; {int(bad.sum())} of {ts.n_tiles} "
          "tiles set aside")
    assert 0 < int(bad.sum()) < ts.n_tiles
    ok = ~bad.reshape(ts.tiles_y, 1, ts.tiles_x, 1).expand(
        ts.tiles_y, 16, ts.tiles_x, 16).reshape(128, 128)
    jimg = torch.as_tensor(np.array(jimg))
    assert float((img_b - jimg).abs()[:, ok].max()) <= BLEND_TOL
    # every tile, from JAX's own f32 table through the port's bf16 blend
    cpre, tfinal = tblend.render_tiles(torch.as_tensor(jtable), es, ts)
    tiles = cpre + tfinal * torch.as_tensor(kw["bg"]).reshape(1, 3, 1)
    img_j = blend.assemble_image(tiles.transpose(1, 2), ts)
    assert float((img_j - jimg).abs().max()) <= BLEND_TOL


def test_bf16_gradients_track_f32():
    """d(sum(img * w)) by the means and opacities with the bf16 table
    within 8e-3 x max|g| of the f32 gradients (JAX's bar,
    test_entry_stream.py:318)."""
    _, ts, means, ops, kw = bf16_scene(22, 600)
    img_w = np.cos(np.arange(3 * 128 * 128).reshape(3, 128, 128) * 0.01)
    w = torch.as_tensor(img_w.astype(np.float32))

    def grads(settings):
        m = torch.tensor(means, requires_grad=True)
        o = torch.tensor(ops, requires_grad=True)
        img, _, _ = rasterize(m, o, settings, device="cpu", **kw)
        return torch.autograd.grad((img * w).sum(), (m, o))

    g_b = grads(ts)
    g_f = grads(dataclasses.replace(ts, table_bf16=False))
    for a, b in zip(g_b, g_f):
        assert torch.isfinite(a).all()
        assert not torch.equal(a, b)
        assert_grads_close(a.numpy(), b.numpy(), rtol=ENV_GRAD)


def test_train_steps_with_bf16_table_lower_the_loss():
    """Five ``train_step``s with the bf16 table: finite, and the loss
    falls."""
    params, meta, poses, ts, bg, gt = small_port_scene(6)
    ts = dataclasses.replace(ts, table_bf16=True)
    target = torch.clamp(gt * 0.8 + 0.1, 0, 1)
    state = tstep.init_train_state(params, poses)
    cfg = OptimizationConfig()
    losses = []
    for _ in range(5):
        state, meta, m = tstep.train_step(state, meta, 0, target, 1.0, 1.0,
                                          bg, ts, cfg)
        losses.append(float(m.loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
