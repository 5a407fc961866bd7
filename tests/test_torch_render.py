"""PyTorch port: ``models.render`` in all four modes against the JAX
package's ``render`` on one scene, handed over with ``params_from_numpy``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.data.synthetic import random_gaussian_scene
from das3r_tpu.models import render as jrender
from das3r_tpu_torch.models import params_from_numpy
from das3r_tpu_torch.models import render as trender

from test_torch_preprocess import settings_pair

torch.set_num_threads(2)
ATOL = 2e-4


def scene(n=1500, cap=1600, seed=0, h=64, w=96):
    """A JAX scene with every SH band and the learnable conf in use, dead
    capacity slots holding a degenerate (zero) quaternion."""
    params, meta, poses = random_gaussian_scene(n, cap=cap, n_frames=2,
                                                height=h, width=w, seed=seed)
    rng = np.random.default_rng(seed + 1)
    params = params._replace(
        features_rest=jnp.asarray(rng.normal(
            0, 0.1, params.features_rest.shape).astype(np.float32)),
        conf_static=jnp.asarray(rng.uniform(
            0.2, 1.0, params.conf_static.shape).astype(np.float32)),
        rotation=params.rotation.at[n:].set(0.0))
    pose = np.concatenate([np.asarray(poses.Q[1]), np.asarray(poses.T[1])])
    conf = rng.uniform(0.3, 1.0, cap).astype(np.float32)
    return params, meta, pose, conf


@pytest.mark.parametrize("mode", ["test", "no_soft", "confidence", "train"])
def test_render_modes_match_jax(mode):
    jparams, jmeta, pose, conf = scene(seed=3)
    js, ts = settings_pair(image_height=64, image_width=96, sh_degree=3,
                           max_tiles_per_gaussian=32, max_total_entries=32_768)
    bg = np.array([0.1, 0.0, 0.3], np.float32)
    fovx, fovy = 1.0, 0.75
    cpg = conf if mode in ("test", "confidence") else None

    want = jax.jit(lambda p, m, q, c: jrender.render(
        p, m, js, q, jnp.asarray(bg), fovx, fovy, mode=mode,
        conf_per_gaussian=c, backend="pallas"))(
        jparams, jmeta, jnp.asarray(pose),
        None if cpg is None else jnp.asarray(cpg))

    tparams, tmeta = params_from_numpy(
        {k: np.asarray(v) for k, v in jparams._asdict().items()},
        {k: np.asarray(v) for k, v in jmeta._asdict().items()}, "cpu")
    got = trender.render(tparams, tmeta, ts, torch.as_tensor(pose), bg,
                         fovx, fovy, mode=mode, conf_per_gaussian=cpg,
                         device="cpu")
    assert got.image.shape == (3, 64, 96)
    assert torch.isfinite(got.image).all()
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=ATOL, rtol=0)
    assert float(got.image.std()) > 0.01


def test_params_from_numpy_keeps_every_field():
    jparams, jmeta, _, _ = scene(n=10, cap=12)
    tparams, tmeta = params_from_numpy(
        {k: np.asarray(v) for k, v in jparams._asdict().items()},
        {k: np.asarray(v) for k, v in jmeta._asdict().items()}, "cpu")
    for k, v in jparams._asdict().items():
        np.testing.assert_array_equal(getattr(tparams, k).numpy(),
                                      np.asarray(v))
    for k, v in jmeta._asdict().items():
        np.testing.assert_array_equal(getattr(tmeta, k).numpy(),
                                      np.asarray(v))
    assert tmeta.alive.dtype == torch.bool
    assert tmeta.pix_id.dtype == torch.int64


def test_render_capture_offset_and_unknown_mode():
    jparams, jmeta, pose, _ = scene(n=50, cap=50)
    _, ts = settings_pair(image_height=32, image_width=32, sh_degree=3)
    tparams, tmeta = params_from_numpy(
        {k: np.asarray(v) for k, v in jparams._asdict().items()},
        {k: np.asarray(v) for k, v in jmeta._asdict().items()}, "cpu")
    out = trender.render(tparams, tmeta, ts, pose, np.zeros(3, np.float32),
                         1.0, 1.0, mode="no_soft", capture_mean2d_grad=True,
                         device="cpu")
    assert out.mean2d_grad_capture.shape == (50, 2)
    with pytest.raises(ValueError):
        trender.render(tparams, tmeta, ts, pose, np.zeros(3, np.float32),
                       1.0, 1.0, mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="conf_per_gaussian"):
        trender.render(tparams, tmeta, ts, pose, np.zeros(3, np.float32),
                       1.0, 1.0, mode="test", device="cpu")
