"""PyTorch port: ``rasterize`` (entry-stream branch, plain versions on the
CPU) against JAX ``rasterize(backend="pallas")`` and the float64 oracle."""
import functools

import jax
import numpy as np
import pytest
import torch

from das3r_tpu.ops.splat import rasterize as jax_rasterize
from das3r_tpu.ops.splat.reference import rasterize_reference
from das3r_tpu_torch.ops.splat import rasterize

from test_splat import make_scene
from test_torch_preprocess import raster_kwargs, settings_pair, to_jax

torch.set_num_threads(2)
ATOL = 2e-4     # the JAX entry-stream bar against the oracle


@pytest.mark.parametrize("case", [
    dict(n=800, seed=42, sh_degree=0, image_height=96, image_width=128,
         max_tiles_per_gaussian=64, rotated=False),
    dict(n=500, seed=9, sh_degree=3, image_height=64, image_width=96,
         max_tiles_per_gaussian=32, rotated=True),
])
def test_rasterize_matches_jax_and_oracle(case):
    case = dict(case)
    n, rotated = case.pop("n"), case.pop("rotated")
    rng = np.random.default_rng(case.pop("seed"))
    js, ts = settings_pair(max_per_tile=1024, max_total_entries=48_000,
                           **case)
    means, scales, rots, ops, colors = make_scene(n, rng)
    bg = np.array([0.2, 0.3, 0.1], np.float32)
    if ts.sh_degree == 0:
        kw = raster_kwargs(js, scales, rots, colors=colors, bg=bg,
                           rotated=rotated)
    else:
        shs = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
        kw = raster_kwargs(js, scales, rots, shs=shs, bg=bg, rotated=rotated)

    img, radii, aux = rasterize(means, ops, ts, device="cpu", **kw)
    jimg, jradii, _ = jax.jit(functools.partial(
        jax_rasterize, settings=js, backend="pallas"))(means, ops,
                                                       **to_jax(kw))
    ref_img, ref_radii = rasterize_reference(
        means, ops, js, **{k: v for k, v in kw.items() if v is not None})

    assert img.shape == (3, ts.image_height, ts.image_width)
    np.testing.assert_array_equal(radii.numpy(), ref_radii)
    np.testing.assert_array_equal(radii.numpy(), np.asarray(jradii))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(img.numpy(), ref_img, atol=ATOL, rtol=0)
    assert int(aux.entry_overflow) == 0 and int(aux.tile_overflow) == 0
    assert int(aux.n_contrib_tiles.sum()) > 0

