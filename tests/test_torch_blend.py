"""PyTorch port: the plain ``blend_forward`` (what the CUDA kernel is held
against on the card) against the JAX entry-stream Pallas forward kernel,
run in interpret mode, on the same attribute table and stream."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.ops.splat import binning as jbin
from das3r_tpu.ops.splat import entry_blend as jblend
from das3r_tpu_torch.ops.splat import entry_blend as tblend

from test_splat import make_scene
from test_torch_preprocess import raster_kwargs, run_both_preprocess, \
    settings_pair

torch.set_num_threads(2)
ATOL = 2e-5


def jax_stream_and_table(js, ts, scene):
    """The JAX entry stream and depth-ordered attribute table of a scene."""
    means, scales, rots, ops, colors = scene
    jprep, _ = run_both_preprocess(
        js, ts, means, ops, raster_kwargs(js, scales, rots, colors=colors))
    es = jax.jit(lambda p: jbin.bin_entry_stream(p, js))(jprep)
    attr = jnp.concatenate([jprep.mean2d, jprep.conic, jprep.color,
                            jprep.opacity[:, None]], 1)
    table = jnp.concatenate([attr[es.order], jnp.zeros((1, 9))])
    return es, table


def torch_stream(es, table):
    """(table, rank, astart, count) of a JAX stream as the port's tensors."""
    count = torch.as_tensor(np.array(es.count))
    al = (count.long() + 127) // 128 * 128
    return (torch.as_tensor(np.array(table)),
            torch.as_tensor(np.array(es.rank)),
            (torch.cumsum(al, 0) - al).to(torch.int32), count)


def run_both(js, ts, es, table):
    cpre_j, tfinal_j = jblend.render_tiles(table, es, jnp.zeros(3), js)
    plain = tblend.blend_forward_plain(*torch_stream(es, table), ts)
    return np.asarray(cpre_j), np.asarray(tfinal_j), plain


@pytest.mark.parametrize("case", [
    dict(n=1000, seed=42, image_height=128, image_width=128,
         max_tiles_per_gaussian=64),
    dict(n=1500, seed=3, spread=0.8, image_height=64, image_width=64,
         max_tiles_per_gaussian=64),
    dict(n=400, seed=8, image_height=40, image_width=72,
         max_tiles_per_gaussian=16),
])
def test_plain_blend_matches_jax_kernel(case):
    case = dict(case)
    rng = np.random.default_rng(case.pop("seed"))
    scene = make_scene(case.pop("n"), rng, spread=case.pop("spread", 1.5))
    js, ts = settings_pair(sh_degree=0, **case)
    es, table = jax_stream_and_table(js, ts, scene)
    cpre_j, tfinal_j, plain = run_both(js, ts, es, table)
    assert plain.cpre.shape == cpre_j.shape
    assert plain.tfinal.shape == tfinal_j.shape
    np.testing.assert_allclose(plain.cpre.numpy(), cpre_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(plain.tfinal.numpy(), tfinal_j, atol=ATOL,
                               rtol=0)
    empty = np.asarray(es.count) == 0
    assert (plain.cpre.numpy()[empty] == 0).all()
    assert (plain.tfinal.numpy()[empty] == 1).all()


def test_saturation_skip_fires_and_stays_exact():
    """The dense near-opaque scene of the JAX saturation test: whole
    chunks are skipped once every pixel of a tile is saturated, and the
    result still equals the JAX kernel's."""
    rng = np.random.default_rng(17)
    means, scales, rots, _, colors = make_scene(1200, rng, spread=0.6)
    ops = rng.uniform(0.9, 0.98, 1200).astype(np.float32)
    scene = (means, (scales * 3.0).astype(np.float32), rots, ops, colors)
    js, ts = settings_pair(image_height=64, image_width=64, sh_degree=0,
                           max_per_tile=2048, max_tiles_per_gaussian=64)
    es, table = jax_stream_and_table(js, ts, scene)
    cpre_j, tfinal_j, plain = run_both(js, ts, es, table)
    assert plain.chunks_skipped > 0, "fixture no longer saturates"
    live = int(es.count.sum())
    # the serial loop stops at saturation: far fewer evaluations than
    # every pixel testing every entry of its tile
    assert int(plain.n_eval.sum()) < 0.5 * live * 256
    np.testing.assert_allclose(plain.cpre.numpy(), cpre_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(plain.tfinal.numpy(), tfinal_j, atol=ATOL,
                               rtol=0)


def test_blend_backward_runs_on_an_empty_tile():
    """The same 5-row table and empty one-tile stream: the backward runs
    and gives the table a finite (here zero) gradient."""
    t = torch.zeros(5, 9, requires_grad=True)
    from das3r_tpu_torch.ops.splat import RasterSettings
    s = RasterSettings(image_height=16, image_width=16)
    cpre, tfinal = tblend.blend_entry_stream(
        t, torch.full((128,), 4, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
        s)
    assert (cpre == 0).all() and (tfinal == 1).all()
    (cpre.sum() + tfinal.sum()).backward()
    assert t.grad is not None and torch.isfinite(t.grad).all()
    assert (t.grad == 0).all()
