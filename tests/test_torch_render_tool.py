"""PyTorch port end to end: the synthetic scene writers, the PLY carrier
between the packages, and ``render_sets`` against the JAX render tool."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from das3r_tpu.data import ply as jply
from das3r_tpu.data import readers as jreaders
from das3r_tpu.data import rearrange as jrearrange
from das3r_tpu.data import synthetic as jsynth
from das3r_tpu.eval import render_tool as jtool
from das3r_tpu.models import render as jrender
from das3r_tpu_torch.data import ply as tply
from das3r_tpu_torch.data import readers as treaders
from das3r_tpu_torch.data import rearrange as trearrange
from das3r_tpu_torch.data import synthetic as tsynth
from das3r_tpu_torch.eval import render_tool as ttool
from das3r_tpu_torch.models import render as trender

from test_torch_preprocess import settings_pair

torch.set_num_threads(2)
H, W, FRAMES = 48, 64, 3


def _tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_scene_writers_are_byte_identical(tmp_path):
    for pkg, synth, rearr in (("jax", jsynth, jrearrange),
                              ("torch", tsynth, trearrange)):
        synth.make_synthetic_stage1_dir(str(tmp_path / pkg / "stage1"),
                                        n_frames=FRAMES, height=H, width=W,
                                        seed=7)
        rearr.rearrange_scene(str(tmp_path / pkg / "stage1"),
                              str(tmp_path / pkg / "scene"))
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    assert len(want) > 30
    assert want.keys() == got.keys()
    for name in want:
        assert want[name] == got[name], name
    jd = jreaders.load_scene(str(tmp_path / "jax" / "scene"))
    td = treaders.load_scene(str(tmp_path / "torch" / "scene"))
    for f in ("images", "poses_c2w", "poses_w2c_colmap", "intrinsics",
              "fovx", "fovy", "conf", "depth", "dyna_avg", "dynamic_mask"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f),
                                      err_msg=f)
    assert jreaders.train_test_split(20, True)[1].tolist() == \
        treaders.train_test_split(20, True)[1].tolist() == [5, 15]


def _gaussians(n, seed):
    rng = np.random.default_rng(seed)
    params, _, _ = jsynth.random_gaussian_scene(n, height=H, width=W,
                                                seed=seed)
    return dict(
        xyz=np.asarray(params.xyz), f_dc=np.asarray(params.features_dc),
        f_rest=rng.normal(0, 0.1, params.features_rest.shape
                          ).astype(np.float32),
        opacity_logit=np.asarray(params.opacity),
        conf_per_gaussian=rng.uniform(0.4, 1.0, n).astype(np.float32),
        scaling=np.asarray(params.scaling),
        rotation=rng.normal(size=(n, 4)).astype(np.float32))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_ply_written_by_one_package_loads_in_the_other(tmp_path, writer):
    g = _gaussians(300, seed=11)
    path = str(tmp_path / "point_cloud.ply")
    (jply if writer == "jax" else tply).write_gaussians(path, **g)
    want = jply.read_gaussians(path)
    got = tply.read_gaussians(path)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["xyz"], g["xyz"])
    tp, _, tconf = ttool.load_gaussians_ply(path, device="cpu")
    jp, _, jconf = jtool.load_gaussians_ply(path)
    for k in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)
    np.testing.assert_array_equal(tconf.numpy(), np.asarray(jconf))


@pytest.fixture(scope="module")
def trained_scene(tmp_path_factory):
    """A rearranged synthetic scene and a checkpoint at iteration 1."""
    root = tmp_path_factory.mktemp("tool")
    tsynth.make_synthetic_stage1_dir(str(root / "stage1"), n_frames=FRAMES,
                                     height=H, width=W, seed=3)
    trearrange.rearrange_scene(str(root / "stage1"), str(root / "scene"))
    data = treaders.load_scene(str(root / "scene"))
    tply.write_gaussians(
        str(root / "model" / "point_cloud" / "iteration_1" /
            "point_cloud.ply"), **_gaussians(1200, seed=5))
    (root / "model" / "pose").mkdir(parents=True)
    np.save(root / "model" / "pose" / "pose_1.npy",
            np.linalg.inv(data.poses_c2w.astype(np.float64)
                          ).astype(np.float32))
    return root / "scene", root / "model", data


def test_render_sets_matches_the_jax_tool(trained_scene, tmp_path):
    scene, model, data = trained_scene
    stats = []
    out, paths = ttool.render_sets(str(scene), str(model), 1, device="cpu",
                                   stats=stats)
    assert len(paths) == FRAMES
    assert all(st["finite"] and st["entry_overflow"] == 0 for st in stats)
    assert all(st["entries"] > 0 for st in stats)
    got_png = [np.asarray(Image.open(p), np.int16) for p in paths]
    for p in paths:                 # the JAX tool writes the same names
        Path(p).unlink()
    _, jpaths = jtool.render_sets(str(scene), str(model), 1)
    assert [Path(p).name for p in jpaths] == [Path(p).name for p in paths]
    for g, p in zip(got_png, jpaths):
        w = np.asarray(Image.open(p), np.int16)
        assert g.shape == w.shape == (H, W, 3)
        assert np.abs(g - w).max() <= 1
        assert g.std() > 1

    # the float image of view 0 through each package's render
    ply = str(model / "point_cloud" / "iteration_1" / "point_cloud.ply")
    js, ts = settings_pair(image_height=H, image_width=W, sh_degree=3,
                           max_tiles_per_gaussian=32,
                           max_total_entries=65_536)
    w2c = np.load(model / "pose" / "pose_1.npy")
    from das3r_tpu.utils.quat import w2c_to_pose
    pose = np.asarray(w2c_to_pose(jnp.asarray(w2c)))[0]
    jp, jm, jconf = jtool.load_gaussians_ply(ply)
    want = jrender.render(jp, jm, js, jnp.asarray(pose), jnp.zeros(3),
                          float(data.fovx[0]), float(data.fovy[0]),
                          mode="test", conf_per_gaussian=jconf,
                          backend="pallas").image
    tp, tm, tconf = ttool.load_gaussians_ply(ply, device="cpu")
    got = trender.render(tp, tm, ts, pose, np.zeros(3, np.float32),
                         float(data.fovx[0]), float(data.fovy[0]),
                         mode="test", conf_per_gaussian=tconf,
                         device="cpu").image
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)


def test_cli_renders_on_the_named_device(trained_scene, capsys):
    scene, model, _ = trained_scene
    ttool.main(["-s", str(scene), "-m", str(model), "--iteration", "1",
                "--mode", "no_soft", "--get_video", "--device", "cpu"])
    assert f"rendered {FRAMES} views" in capsys.readouterr().out
    out = model / "renders_1"
    assert len(list(out.glob("*.png"))) == FRAMES
    assert list(out.glob("render.*"))
