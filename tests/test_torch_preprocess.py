"""PyTorch port: ``preprocess`` against the JAX package, field by field.

Also holds the camera and scene helpers the other ``test_torch_*`` files
import: inputs are numpy arrays made from a seed, handed to both packages.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.ops.splat import RasterSettings as JaxSettings
from das3r_tpu.ops.splat.preprocess import preprocess as jax_preprocess
from das3r_tpu.utils import transforms as jtf
from das3r_tpu_torch.ops.splat import RasterSettings
from das3r_tpu_torch.ops.splat.preprocess import preprocess

from test_splat import make_scene

torch.set_num_threads(2)

EXACT_FIELDS = ("radius", "rect_min", "rect_max", "n_tiles_touched",
                "binnable")


def settings_pair(**kw):
    """One config for both packages; the JAX side gets the stream cap its
    entry-stream path needs, the port sizes its stream from the counts."""
    cap = kw.pop("max_total_entries", 96_000)
    return JaxSettings(**kw, max_total_entries=cap), RasterSettings(**kw)


def camera(settings, rotated=False, fovx=1.1, fovy=1.1):
    """Row-vector (view, full projection, campos, tan_fovx, tan_fovy).
    ``rotated`` moves the camera off the identity pose."""
    w2c = np.eye(4)
    if rotated:
        ay, ax = 0.15, -0.1
        ry = np.array([[math.cos(ay), 0, math.sin(ay)], [0, 1, 0],
                       [-math.sin(ay), 0, math.cos(ay)]])
        rx = np.array([[1, 0, 0], [0, math.cos(ax), -math.sin(ax)],
                       [0, math.sin(ax), math.cos(ax)]])
        w2c[:3, :3] = rx @ ry
        w2c[:3, 3] = [0.2, -0.1, 0.3]
    proj = np.asarray(jtf.projection_matrix(0.01, 100.0, fovx, fovy),
                      np.float64)
    view = w2c.T
    full = view @ proj.T
    campos = -w2c[:3, :3].T @ w2c[:3, 3]
    f32 = np.float32
    return (view.astype(f32), full.astype(f32), campos.astype(f32),
            math.tan(fovx / 2), math.tan(fovy / 2))


def raster_kwargs(settings, scales, rots, *, colors=None, shs=None,
                  bg=None, rotated=False):
    view, proj, campos, tfx, tfy = camera(settings, rotated)
    return dict(viewmatrix=view, projmatrix=proj, campos=campos,
                bg=np.zeros(3, np.float32) if bg is None else bg,
                tan_fovx=tfx, tan_fovy=tfy, scales=scales, rotations=rots,
                colors_precomp=colors, shs=shs)


def to_jax(kw):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def run_both_preprocess(js, ts, means, ops, kw):
    kw = {k: v for k, v in kw.items() if k != "bg"}
    want = jax_preprocess(jnp.asarray(means), jnp.asarray(ops), js,
                          **to_jax(kw))
    got = preprocess(
        torch.as_tensor(means), torch.as_tensor(ops), ts,
        **{k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    return want, got


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("sh_degree", [0, 3])
def test_preprocess_matches_jax(rotated, sh_degree):
    rng = np.random.default_rng(100 + sh_degree + 10 * rotated)
    js, ts = settings_pair(image_height=96, image_width=128,
                           sh_degree=sh_degree, max_tiles_per_gaussian=32)
    means, scales, rots, ops, colors = make_scene(1500, rng)
    # a few Gaussians behind the near plane, one at the camera, one
    # with an opacity under the floor: the culls must agree too
    means[:5, 2] = rng.uniform(-1.0, 0.0005, 5)
    means[5] = 0.0
    ops[6] = 0.002
    if sh_degree == 0:
        kw = raster_kwargs(js, scales, rots, colors=colors, rotated=rotated)
    else:
        shs = rng.normal(0, 0.3, (1500, 16, 3)).astype(np.float32)
        kw = raster_kwargs(js, scales, rots, shs=shs, rotated=rotated)
    want, got = run_both_preprocess(js, ts, means, ops, kw)
    assert set(want._fields) == set(got._fields)
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.shape == w.shape, name
        if name in EXACT_FIELDS:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            live = np.asarray(want.radius) > 0
            w, g = w[live], g[live]     # culled rows carry no meaning
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    if not rotated:
        assert not got.binnable[:7].any()
    assert got.binnable.sum() > 1000


def test_preprocess_sh_colour_has_finite_gradients_at_the_camera():
    """The double-where safe normalize: a Gaussian at the camera centre
    gets a zero direction and a finite gradient."""
    rng = np.random.default_rng(5)
    _, ts = settings_pair(image_height=32, image_width=32, sh_degree=1)
    means, scales, rots, ops, _ = make_scene(16, rng)
    means[0] = 0.0
    xyz = torch.as_tensor(means).requires_grad_(True)
    kw = raster_kwargs(ts, scales, rots,
                       shs=rng.normal(size=(16, 4, 3)).astype(np.float32))
    kw.pop("bg")
    p = preprocess(xyz, torch.as_tensor(ops), ts,
                   **{k: (torch.as_tensor(v) if isinstance(v, np.ndarray)
                          else v) for k, v in kw.items()})
    p.color.sum().backward()
    assert torch.isfinite(xyz.grad).all()
