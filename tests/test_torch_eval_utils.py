"""PyTorch port: the numpy modules the viewer and the trainer's reports
import (``utils/stepfun.py``, ``utils/camera_paths.py``, ``eval/viz.py``,
``eval/trajectory.py``, ``data/readers.load_blender_scene``) against the
JAX package's, on the inputs of ``tests/test_stepfun.py``,
``tests/test_eval.py``, ``tests/test_misc_components.py`` and
``tests/test_inventory_fill.py::test_load_blender_scene``.

The port runs the same numpy code, so every comparison is exact."""
import dataclasses

import numpy as np
import pytest
from PIL import Image
from scipy.spatial.transform import Rotation

from das3r_tpu.data import readers as jreaders
from das3r_tpu.eval import trajectory as jtraj
from das3r_tpu.eval import viz as jviz
from das3r_tpu.utils import camera_paths as jcp
from das3r_tpu.utils import stepfun as jstep
from das3r_tpu_torch.data import readers
from das3r_tpu_torch.eval import trajectory, viz
from das3r_tpu_torch.utils import camera_paths as cp
from das3r_tpu_torch.utils import stepfun

from test_eval import apply_sim3, random_traj
from test_inventory_fill import _write_blender_scene


def assert_same(got, want):
    """Equal structure, equal values, bit for bit."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif dataclasses.is_dataclass(want):
        assert_same(dataclasses.astuple(got), dataclasses.astuple(want))
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _stepfun_cases():
    rng = np.random.default_rng(0)
    t = np.linspace(-2.0, 3.0, 8)
    logits = rng.normal(size=7)
    pts = np.cumsum(np.random.default_rng(3).normal(size=(40, 3)), axis=0)
    return {
        "integrate_weights": lambda m: m.integrate_weights_np(
            np.asarray([0.25, 0.25, 0.25, 0.25])),
        "integrate_weights_batched": lambda m: m.integrate_weights_np(
            np.random.default_rng(1).uniform(0, 1, (3, 6))),
        "invert_cdf": lambda m: m.invert_cdf_np(
            np.linspace(0.0, 1.0, 9), np.linspace(0.0, 4.0, 5), logits[:4]),
        "pdf_weight": lambda m: (m.weight_to_pdf_np(t, np.abs(logits)),
                                 m.pdf_to_weight_np(t, np.abs(logits))),
        "searchsorted": lambda m: m.searchsorted_np(
            np.linspace(0, 1, 6), np.asarray([-0.5, 0.0, 0.3, 0.99, 2.0])),
        "sample_center": lambda m: m.sample_np(
            None, np.linspace(0.0, 1.0, 11), np.zeros(10), 5,
            deterministic_center=True),
        "sample_linspace": lambda m: m.sample_np(None, t, logits, 17),
        "sample_stratified": lambda m: m.sample_np(
            np.random.default_rng(5), t, logits, 32),
        "sample_single_jitter": lambda m: m.sample_np(
            np.random.default_rng(6), t, logits, 32, single_jitter=True),
        "resample_const_speed": lambda m: m.resample_const_speed_stepfun(
            pts, 17),
    }


@pytest.mark.parametrize("case", list(_stepfun_cases()))
def test_stepfun_matches_jax(case):
    fn = _stepfun_cases()[case]
    assert_same(fn(stepfun), fn(jstep))


def _ring_poses(m, f=8, r=3.0):
    """``tests/test_misc_components.py``'s ring of keyframe cameras."""
    out = []
    for k in range(f):
        th = 2 * np.pi * k / f * 0.25
        pos = np.asarray([r * np.sin(th), 0.1 * k, -r * np.cos(th)])
        out.append(m.look_at(pos, np.zeros(3)))
    return np.stack(out).astype(np.float64)


def _path_cases():
    q1 = Rotation.from_euler("y", 90, degrees=True).as_matrix()
    three = np.tile(np.eye(4), (3, 1, 1))
    three[1, :3, 3], three[2, :3, 3] = [1, 0, 0], [1, 1, 0]
    cloud = np.tile(np.eye(4), (10, 1, 1))
    cloud[:, :3, 3] = np.random.default_rng(0).normal(0, 1, (10, 3))
    return {
        "slerp": lambda m: tuple(m.slerp(np.asarray([1.0, 0, 0, 0]),
                                         m.rotmat2qvec(q1), t)
                                 for t in (0.0, 0.5, 1.0)),
        "interpolate_poses": lambda m: m.interpolate_poses(three, factor=2),
        "resample_const_speed": lambda m: m.resample_const_speed(
            np.asarray([[0, 0], [0.1, 0], [1.0, 0]], float), 11),
        "look_at": lambda m: m.look_at(np.asarray([1.0, 2.0, -3.0]),
                                       np.asarray([0.1, 0.0, 0.2])),
        "ellipse_path": lambda m: m.ellipse_path(cloud, n_frames=24),
        "spiral_path": lambda m: m.spiral_path(
            _ring_poses(m), bounds=(2.0, 10.0), n_frames=36, n_rots=2),
        "bspline_path": lambda m: m.bspline_path(
            _ring_poses(m), n_interp=5, smoothness=0.0),
        "bspline_const_speed": lambda m: m.bspline_path(
            _ring_poses(m), n_interp=24, n_interp_as_total=True,
            const_speed=True),
    }


@pytest.mark.parametrize("case", list(_path_cases()))
def test_camera_paths_match_jax(case):
    fn = _path_cases()[case]
    assert_same(fn(cp), fn(jcp))


def test_orbit_camera_matches_jax():
    """The same drag, dolly and pan sequence on both orbit cameras."""
    cams = [m.OrbitCamera(640, 480, radius=3.0) for m in (cp, jcp)]
    for cam in cams:
        cam.center = np.asarray([0.2, -0.1, 1.5])
    seen = [[], []]
    for op, args in (("orbit", (100, 0)), ("orbit", (-40, 250)),
                     ("scale", (2,)), ("pan", (30, -12, 4)),
                     ("orbit", (0, 900))):
        for cam, out in zip(cams, seen):
            getattr(cam, op)(*args)
            out.append((cam.pose, cam.intrinsics, cam.radius, cam.yaw,
                        cam.pitch, cam.center))
    assert_same(tuple(map(tuple, seen[0])), tuple(map(tuple, seen[1])))


def _trajectory_cases():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((30, 3))
    dst = (2.7 * (Rotation.random(rng=rng).as_matrix() @ src.T)).T + 1.0
    rng = np.random.default_rng(1)
    ref = random_traj(20, rng)
    est = apply_sim3(ref, 0.5, Rotation.random(rng=rng).as_matrix(),
                     np.asarray([1.0, -2.0, 3.0]))
    rng = np.random.default_rng(2)
    ref200 = random_traj(200, rng)
    noisy = ref200.copy()
    noisy[:, :3, 3] += rng.normal(0, 0.01, (200, 3))
    rng = np.random.default_rng(3)
    ref50 = random_traj(50, rng)
    rot = ref50.copy()
    d_r = Rotation.from_euler("z", 1.0, degrees=True).as_matrix()
    for i in range(1, 50, 2):
        rot[i, :3, :3] = rot[i, :3, :3] @ d_r
    quats = np.random.default_rng(4).normal(size=(6, 4))
    return {
        "umeyama": lambda m: m.umeyama_sim3(src, dst),
        "umeyama_no_scale": lambda m: m.umeyama_sim3(src, dst,
                                                     with_scale=False),
        "align": lambda m: m.align_trajectory(est, ref),
        "metrics_sim3": lambda m: m.eval_metrics(est, ref),
        "metrics_noise": lambda m: m.eval_metrics(noisy, ref200),
        "metrics_rotation": lambda m: m.eval_metrics(rot, ref50, delta=2),
        "tum_to_matrices": lambda m: m.tum_to_matrices(
            np.random.default_rng(5).normal(size=(6, 3)), quats),
    }


@pytest.mark.parametrize("case", list(_trajectory_cases()))
def test_trajectory_matches_jax(case):
    fn = _trajectory_cases()[case]
    assert_same(fn(trajectory), fn(jtraj))


def test_viz_maps_match_jax():
    rng = np.random.default_rng(0)
    depth = rng.uniform(1, 5, (16, 16))
    flow = rng.normal(scale=3.0, size=(17, 23, 2)).astype(np.float32)
    flow[2, 3] = 0.0
    flow[5, 5, 0] = 1e8
    img = rng.uniform(0, 1, (17, 23, 3))
    mask = rng.uniform(0, 1, (17, 23))
    for m in (viz, jviz):
        assert m.UNKNOWN_FLOW_THRESH == 1e7
    assert_same(viz._flow_color_wheel(), jviz._flow_color_wheel())
    assert_same(viz.colormap_jet(depth), jviz.colormap_jet(depth))
    assert_same(viz.flow_to_image(flow.copy()),
                jviz.flow_to_image(flow.copy()))
    assert_same(viz.flow_to_image(flow.copy(), maxrad=2.0),
                jviz.flow_to_image(flow.copy(), maxrad=2.0))
    assert_same(viz.mask_overlay(img, mask), jviz.mask_overlay(img, mask))


def test_viz_exports_match_jax(tmp_path):
    """The PLY exports, depth maps and mask-overlay GIF: the same bytes."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (2, 8, 8, 3))
    conf = rng.uniform(0, 2, (2, 8, 8))
    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(5, 3))
    depths = rng.uniform(1, 5, (3, 16, 16))
    for name, m in (("port", viz), ("jax", jviz)):
        d = tmp_path / name
        d.mkdir()
        n = m.export_scene_pointcloud(str(d / "scene.ply"), pts, cols, conf,
                                      conf_thre=1.0)
        assert 0 < n < 128
        m.export_camera_trajectory(str(d / "traj.ply"), poses)
        m.save_depth_visualizations(str(d / "depth"), depths)
        for k in range(3):
            Image.fromarray(np.full((16, 20, 3), 100, np.uint8)).save(
                d / f"frame_{k:04d}.png")
            mk = np.zeros((16, 20), np.uint8)
            mk[4:9, 5 + k] = 255
            Image.fromarray(mk).save(d / f"dynamic_mask_{k:04d}.png")
        assert m.save_mask_overlay_gif(str(d)) == str(d / "_overlaied.gif")
    for f in ("scene.ply", "traj.ply", "depth/depth_0002.png",
              "depth/_depth_maps.gif", "_overlaied.gif"):
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f


@pytest.mark.parametrize("eval_mode", [True, False])
def test_load_blender_scene_matches_jax(tmp_path, eval_mode):
    """Each package loads its own copy of the same scene (the random point
    cloud is generated, written and read back in each)."""
    got, want = [], []
    for name, m, out in (("port", readers, got), ("jax", jreaders, want)):
        d = str(tmp_path / name)
        _write_blender_scene(d)
        out.append(m.load_blender_scene(d, white_background=True,
                                        eval_mode=eval_mode))
        out.append(m.load_blender_scene(d, eval_mode=eval_mode))
    for (data, pcd), (jdata, jpcd) in zip(got, want):
        assert data.names == jdata.names
        assert data.n_frames == 6 and (data.height, data.width) == (32, 40)
        for f in dataclasses.fields(jdata):
            if f.name != "names":
                assert_same(getattr(data, f.name), getattr(jdata, f.name))
        assert_same(pcd, jpcd)
