"""PyTorch port: the GUI (``das3r_tpu_torch/gui``) against the JAX viewer.

* the three render panels on the scene of ``tests/test_gui.py`` against
  the JAX viewer with ``backend="pallas"`` (its kernels in interpret
  mode): the float image within 2e-4 (the render bar), the uint8 panel
  within 1 level; the trajectory and mask-blend panels; the confidence
  panel against the float64 oracle on a view where JAX's Pallas path
  strays;
* a PLY checkpoint loaded by both packages' ``from_model_dir``;
* the HTTP server's endpoints, as ``tests/test_gui.py`` drives the JAX
  server's;
* the viewer and its CLI take the card unless told otherwise.
"""
import io
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from das3r_tpu.data.synthetic import random_gaussian_scene
from das3r_tpu.gui import ViewerScene as JaxViewerScene
from das3r_tpu.ops.splat import RasterSettings as JaxSettings
from das3r_tpu.ops.splat.reference import rasterize_reference
from das3r_tpu.utils.quat import w2c_to_pose as jax_w2c_to_pose
from das3r_tpu_torch.data import ply
from das3r_tpu_torch.gui import ViewerScene
from das3r_tpu_torch.gui import server as gui_server
from das3r_tpu_torch.models import render as render_mod
from das3r_tpu_torch.models.gaussians import (activated_scaling,
                                              params_from_numpy,
                                              per_gaussian_conf)
from das3r_tpu_torch.ops.splat import RasterSettings
from das3r_tpu_torch.utils.quat import w2c_to_pose

torch.set_num_threads(2)
ATOL = 2e-4     # the render bar of the JAX tests against the oracle
RASTER = dict(image_height=48, image_width=64, sh_degree=3, max_per_tile=256,
              max_tiles_per_gaussian=32)


def jax_float_image(scene, orbit, mode):
    """The JAX viewer's float image of ``render_panel``, before the clip
    and the uint8 cast, [H, W, 3]."""
    w2c = np.linalg.inv(orbit.pose).astype(np.float32)
    fovx = 2 * np.arctan(np.tan(orbit.fovy / 2) * orbit.W / orbit.H)
    img = scene._renderer(mode)(
        scene.params, scene.meta, scene.conf,
        jax_w2c_to_pose(jnp.asarray(w2c)),
        jnp.asarray(fovx, jnp.float32), jnp.asarray(orbit.fovy, jnp.float32))
    return np.asarray(img).transpose(1, 2, 0)


@pytest.fixture(scope="module")
def scenes():
    """(port scene on the CPU, JAX scene): one random scene from a seed."""
    params, meta, poses = random_gaussian_scene(
        n=400, n_frames=3, height=48, width=64, seed=0)
    poses7 = np.asarray(poses.all_poses())
    jscene = JaxViewerScene(
        params=params, meta=meta,
        settings=JaxSettings(**RASTER, max_total_entries=65_536),
        train_poses7=poses7, backend="pallas")
    tparams, tmeta = params_from_numpy(
        {k: np.asarray(v) for k, v in params._asdict().items()},
        {k: np.asarray(v) for k, v in meta._asdict().items()}, "cpu")
    tscene = ViewerScene(params=tparams, meta=tmeta,
                         settings=RasterSettings(**RASTER),
                         train_poses7=poses7, device="cpu")
    return tscene, jscene


def assert_panels_match(tscene, jscene, orbits,
                        modes=("rgb", "confidence", "no_soft")):
    for (torbit, jorbit) in orbits:
        np.testing.assert_array_equal(torbit.pose, jorbit.pose)
        for mode in modes:
            got = tscene.render_image(torbit, mode)
            assert got.device.type == "cpu" and got.shape == (3, 48, 64)
            np.testing.assert_allclose(
                got.numpy().transpose(1, 2, 0),
                jax_float_image(jscene, jorbit, mode), atol=ATOL, rtol=0,
                err_msg=mode)
            panel = tscene.render_panel(torbit, mode)
            jpanel = jscene.render_panel(jorbit, mode)
            assert panel.shape == (48, 64, 3) and panel.dtype == np.uint8
            diff = np.abs(panel.astype(int) - jpanel.astype(int))
            assert diff.max() <= 1, mode


def test_panels_match_jax_viewer(scenes):
    tscene, jscene = scenes
    orbits = [(tscene.default_orbit(), jscene.default_orbit())]
    for dx, dy in ((-250.0, 120.0),):
        t, j = tscene.default_orbit(), jscene.default_orbit()
        t.orbit(dx, dy)
        j.orbit(dx, dy)
        orbits.append((t, j))
    assert_panels_match(tscene, jscene, orbits)
    # the panels see the scene, differ by mode and by view
    rgb = tscene.render_panel(orbits[0][0], "rgb")
    assert rgb.any()
    assert not np.array_equal(rgb, tscene.render_panel(orbits[0][0],
                                                       "confidence"))
    assert not np.array_equal(rgb, tscene.render_panel(orbits[1][0], "rgb"))


def test_confidence_panel_matches_oracle(scenes):
    """At this orbit JAX's Pallas viewer puts one pixel of the confidence
    panel 5.0e-4 from the float64 oracle (0.87224 against 0.87173), where
    its XLA blend and the port stay within 6e-6: the port's float image is
    held to the oracle there, within 2e-4."""
    tscene, _ = scenes
    orbit = tscene.default_orbit()
    orbit.orbit(400.0, 120.0)
    got = tscene.render_image(orbit, "confidence")
    w2c = np.linalg.inv(orbit.pose).astype(np.float32)
    xyz, rot = render_mod._camera_frame_gaussians(
        tscene.params, w2c_to_pose(torch.as_tensor(w2c)))
    fovx = 2 * np.arctan(np.tan(orbit.fovy / 2) * orbit.W / orbit.H)
    view, proj, campos, tfx, tfy = render_mod._raster_common(
        float(fovx), float(orbit.fovy), "cpu")
    conf = per_gaussian_conf(tscene.params, tscene.meta).detach().numpy()
    want, _ = rasterize_reference(
        xyz.detach().numpy(), np.ones((400, 1), np.float32),
        JaxSettings(**RASTER), viewmatrix=view.numpy(),
        projmatrix=proj.numpy(), campos=campos.numpy(),
        bg=np.zeros(3, np.float32), tan_fovx=float(tfx),
        tan_fovy=float(tfy),
        scales=activated_scaling(tscene.params).detach().numpy(),
        rotations=rot.detach().numpy(),
        colors_precomp=np.repeat(conf[:, None], 3, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_trajectory_and_mask_panels_match_jax_viewer(scenes):
    tscene, jscene = scenes
    for size in (120, 360):
        panel = tscene.trajectory_panel(size=size)
        assert panel.shape == (size, size, 3) and (panel != 24).any()
        np.testing.assert_array_equal(panel, jscene.trajectory_panel(size))
    rng = np.random.default_rng(3)
    img, mask = rng.uniform(-0.2, 1.2, (8, 8, 3)), rng.uniform(0, 1, (8, 8))
    for kw in ({}, dict(color=(0.1, 0.9, 0.2), alpha=0.3)):
        np.testing.assert_array_equal(tscene.mask_blend_panel(img, mask, **kw),
                                      jscene.mask_blend_panel(img, mask, **kw))
    with pytest.raises(ValueError):
        tscene.render_panel(tscene.default_orbit(), "nope")


def test_from_model_dir_matches_jax_viewer(scenes, tmp_path):
    """A PLY checkpoint with per-Gaussian conf (the ``rgb`` panel in test
    mode) and its pose file, loaded by both packages."""
    tscene, _ = scenes
    p = tscene.params
    n = p.xyz.shape[0]
    rng = np.random.default_rng(4)
    ply.write_gaussians(
        str(tmp_path / "point_cloud" / "iteration_7" / "point_cloud.ply"),
        xyz=p.xyz.numpy(), f_dc=p.features_dc.numpy(),
        f_rest=rng.normal(0, 0.05, tuple(p.features_rest.shape)).astype(
            np.float32),
        opacity_logit=p.opacity.numpy(),
        conf_per_gaussian=rng.uniform(0.3, 1.0, n).astype(np.float32),
        scaling=p.scaling.numpy(), rotation=p.rotation.numpy())
    (tmp_path / "pose").mkdir()
    w2c = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    w2c[:, :3, 3] = rng.normal(0, 0.5, (4, 3))
    np.save(tmp_path / "pose" / "pose_7.npy", w2c)

    t = ViewerScene.from_model_dir(str(tmp_path), 7, resolution=(64, 48),
                                   device="cpu")
    j = JaxViewerScene.from_model_dir(str(tmp_path), 7, resolution=(64, 48),
                                      backend="pallas")
    assert t.settings.max_total_entries is None     # no probe render
    assert t.conf is not None and t.conf.shape == (n,)
    np.testing.assert_allclose(t.train_poses7, j.train_poses7, rtol=0,
                               atol=1e-6)
    # the mode this scene adds: ``rgb`` renders in test mode
    assert_panels_match(t, j, [(t.default_orbit(), j.default_orbit())],
                        modes=("rgb",))
    np.testing.assert_array_equal(t.trajectory_panel(),
                                  j.trajectory_panel())


@pytest.fixture(scope="module")
def server(scenes):
    app = gui_server.ViewerApp(scenes[0])
    srv = gui_server.make_server(app, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_server_index_and_state(server):
    code, ctype, body = _get(server + "/")
    assert code == 200 and "text/html" in ctype
    assert b"DAS3R-TPU viewer" in body
    code, ctype, body = _get(server + "/state")
    st = json.loads(body)
    assert code == 200 and ctype == "application/json"
    assert st["n_gaussians"] == 400
    assert st["modes"] == ["rgb", "confidence", "no_soft", "traj"]


def test_server_render_endpoints(server, scenes):
    code, ctype, body = _get(server + "/render?mode=rgb&yaw=100&pitch=20")
    assert code == 200 and ctype == "image/png"
    img = np.asarray(Image.open(io.BytesIO(body)))
    assert img.shape == (48, 64, 3)
    # the panel the request asked for: the same yaw and pitch by hand
    orbit = scenes[0].default_orbit()
    orbit.yaw, orbit.pitch = 0.5, 0.1
    np.testing.assert_array_equal(img, scenes[0].render_panel(orbit, "rgb"))
    code, _, body2 = _get(server + "/render?mode=confidence")
    assert code == 200 and body2 != body
    code, _, body3 = _get(server + "/render?mode=no_soft&radius=3.5")
    assert code == 200 and json.loads(_get(server + "/state")[2])[
        "radius"] == 3.5
    code, ctype, body4 = _get(server + "/traj")
    assert code == 200 and ctype == "image/png" and body4[:4] == b"\x89PNG"
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(body4))),
                                  scenes[0].trajectory_panel())


def test_server_rejects_bad_mode(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server + "/render?mode=evil")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e2:
        _get(server + "/nothing")
    assert e2.value.code == 404


def test_viewer_takes_the_card_unless_told(scenes, tmp_path, monkeypatch):
    """Without a device the viewer and the server's CLI ask for CUDA and
    raise when there is none; ``--device cpu`` is parsed and passed on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tscene, _ = scenes
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ViewerScene(params=tscene.params, meta=tscene.meta,
                    settings=tscene.settings)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ViewerScene.from_model_dir(str(tmp_path), 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gui_server.main(["-m", str(tmp_path), "--iteration", "1"])
    # with --device cpu the CLI gets as far as reading the checkpoint
    with pytest.raises(FileNotFoundError):
        gui_server.main(["-m", str(tmp_path), "--iteration", "1",
                         "--device", "cpu"])
