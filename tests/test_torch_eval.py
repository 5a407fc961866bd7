"""PyTorch port: the evaluation modules (``eval/{masks,depth,harness,
davis_eval,pose_eval}.py``, ``data/sintel_dynamics.py``,
``predictor/sintel_dataset.py``) against the JAX package.

The numpy modules must give JAX's results exactly, on the inputs of
``tests/test_eval.py::TestMaskMetrics``, ``tests/test_harness_tools.py``
and ``tests/test_misc_components.py::TestDavisEval``; the Sintel labels
and dataset on a small Sintel tree written here. ``eval_pose_estimation``
runs both packages' stage 1 on a synthetic ``tum`` layout with the TINY
predictor on seeded random weights (frames at a long side of 64, two
alignment iterations without the smoothing and flow terms), the ATE
within 1e-4 relative.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from das3r_tpu.data import sintel_dynamics as jsd
from das3r_tpu.data.synthetic import make_synthetic_stage1_dir
from das3r_tpu.eval import davis_eval as jdavis
from das3r_tpu.eval import depth as jdepth
from das3r_tpu.eval import harness as jharness
from das3r_tpu.eval import masks as jmasks
from das3r_tpu.eval import pose_eval as jpose
from das3r_tpu.models.croco.convert import convert_torch_state_dict
from das3r_tpu.models.croco.dust3r import AsymmetricCroCo3D as JModel
from das3r_tpu.models.croco.testkit import TINY as JTINY
from das3r_tpu.predictor import alignment as jalign
from das3r_tpu.predictor import runner as jrunner
from das3r_tpu.predictor import sintel_dataset as jsintel
from das3r_tpu_torch.data import sintel_dynamics as tsd
from das3r_tpu_torch.eval import davis_eval as tdavis
from das3r_tpu_torch.eval import depth as tdepth
from das3r_tpu_torch.eval import harness as tharness
from das3r_tpu_torch.eval import masks as tmasks
from das3r_tpu_torch.eval import pose_eval as tpose
from das3r_tpu_torch.models.croco import convert
from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                  random_torch_state_dict)
from das3r_tpu_torch.predictor import alignment as talign
from das3r_tpu_torch.predictor import runner as trunner
from das3r_tpu_torch.predictor import sintel_dataset as tsintel

torch.set_num_threads(2)
ATE_REL = 1e-4


# ---------------------------------------------------------------------------
# masks and depth


def _mask_cases():
    a = np.zeros((10, 10), bool)
    b = np.zeros((10, 10), bool)
    a[2:6, 2:6] = True
    b[4:8, 4:8] = True
    sq = np.zeros((32, 32), bool)
    sq[8:24, 8:24] = True
    corner = np.zeros_like(sq)
    corner[0:2, 0:2] = True
    rng = np.random.default_rng(0)
    noisy = rng.uniform(size=(40, 56)) > 0.6
    return [(a, b), (a, a), (np.zeros((5, 5)), np.zeros((5, 5))),
            (sq, sq), (np.roll(sq, 1, axis=0), sq), (corner, sq),
            (np.zeros_like(sq), sq), (np.zeros_like(sq), np.zeros_like(sq)),
            (noisy, rng.uniform(size=(40, 56)) > 0.5)]


def test_mask_metrics_exact():
    for pred, gt in _mask_cases():
        assert tmasks.mask_iou(pred, gt) == jmasks.mask_iou(pred, gt)
        assert (tmasks.boundary_f_measure(pred, gt)
                == jmasks.boundary_f_measure(pred, gt))
    void = np.zeros((10, 10), bool)
    void[:3] = True
    a, b = _mask_cases()[0]
    assert tmasks.mask_iou(a, b, void) == jmasks.mask_iou(a, b, void)
    seq_p = np.random.default_rng(1).uniform(size=(3, 8, 8)) > 0.5
    seq_g = np.random.default_rng(2).uniform(size=(3, 8, 8)) > 0.5
    assert (tmasks.sequence_mask_iou(seq_p, seq_g)
            == jmasks.sequence_mask_iou(seq_p, seq_g))


def _depth_cases():
    """TestDepthMetrics' inputs: (pred, gt, kwargs)."""
    rng = [np.random.default_rng(i) for i in range(5)]
    gt0 = rng[0].uniform(1, 10, (4, 32, 32))
    gt1 = rng[1].uniform(1, 10, (32, 32))
    gt2 = rng[2].uniform(1, 10, (40, 40))
    noisy2 = gt2.copy()
    noisy2[:4] = 50.0
    gt3 = rng[3].uniform(1, 10, (40, 40))
    noisy3 = gt3.copy()
    noisy3[:4] = 80.0
    gt4 = rng[4].uniform(1, 10, (32, 32))
    return [(gt0.copy(), gt0, {}),
            (gt1 * 0.37 + 1.2, gt1, dict(align="scale&shift")),
            (gt1 * 0.37 + 1.2, gt1, dict(align="none")),
            (gt1 * 0.37 + 1.2, gt1, dict(align="scale")),
            (gt2 / 2.5, gt2, dict(align="scale_weiszfeld")),
            (gt2 / 2.5, noisy2, dict(align="scale_weiszfeld")),
            (gt3 * 0.4 + 0.7, noisy3, dict(align="lad")),
            (gt3 * 0.4 + 0.7, noisy3, dict(align="scale&shift")),
            ((1 / gt4) * 0.3 + 0.05, gt4, dict(align="scale&shift",
                                               disp_input=True)),
            (np.full((16, 16), 5.0), np.full((16, 16), 4.0),
             dict(align="none"))]


@pytest.mark.parametrize("case", range(10))
def test_depth_metrics_exact(case):
    pred, gt, kw = _depth_cases()[case]
    want = jdepth.depth_metrics(pred, gt, **kw)
    got = tdepth.depth_metrics(pred, gt, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    mode = kw.get("align", "scale&shift")
    np.testing.assert_array_equal(
        tdepth.align_depth(pred, gt, np.isfinite(gt), mode),
        jdepth.align_depth(pred, gt, np.isfinite(gt), mode))


# ---------------------------------------------------------------------------
# the harness: scrapers, binary formats, trajectories; DAVIS


def test_scrapers_and_psnr_table(tmp_path):
    for scene, psnrs in [("sceneA", [20.0, 25.5]), ("sceneB", [30.0])]:
        d = tmp_path / scene
        d.mkdir()
        with open(d / "test_log.txt", "w") as f:
            for i, p in enumerate(psnrs):
                f.write(f"[ITER {(i + 1) * 100}] Evaluating test: "
                        f"L1 0.01 PSNR {p}\n")
            f.write("[ITER 300] Evaluating train: L1 0.02 PSNR 19.0\n")
    scenes = ["sceneA", "sceneB", "missing"]
    table = tharness.psnr_table(str(tmp_path), scenes)
    assert table == jharness.psnr_table(str(tmp_path), scenes)
    assert table["sceneA"] == 25.5 and table["missing"] is None
    assert (tharness.format_psnr_table(table)
            == jharness.format_psnr_table(table))
    log = str(tmp_path / "sceneA" / "test_log.txt")
    for split in ("test", "train"):
        assert (tharness.scrape_test_log(log, split)
                == jharness.scrape_test_log(log, split))
    assert tharness.last_psnr(log) == jharness.last_psnr(log)
    assert (tharness.SINTEL_SCENES, tharness.DAVIS_SCENES,
            tharness.TUM_DYNAMICS_SCENES) == (
        jharness.SINTEL_SCENES, jharness.DAVIS_SCENES,
        jharness.TUM_DYNAMICS_SCENES)


def write_cam(path, M, N):
    with open(path, "wb") as f:
        np.asarray([jharness.TAG_FLOAT], np.float32).tofile(f)
        M.astype(np.float64).tofile(f)
        N.astype(np.float64).tofile(f)


def write_grid(path, x):
    """A Sintel .dpt ([H, W]) or Middlebury .flo ([H, W, 2])."""
    with open(path, "wb") as f:
        np.asarray([jharness.TAG_FLOAT], np.float32).tofile(f)
        np.asarray([x.shape[1], x.shape[0]], np.int32).tofile(f)
        x.astype(np.float32).tofile(f)


def test_binary_formats_and_trajectories(tmp_path):
    rng = np.random.default_rng(0)
    cams = tmp_path / "cams"
    cams.mkdir()
    for i in range(3):
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        N = np.hstack([R, rng.normal(size=(3, 1))])
        write_cam(cams / f"frame_{i + 1:04d}.cam", np.diag([100.0, 90, 1]),
                  N)
        got, want = (tharness.sintel_cam_read(str(cams /
                                                  f"frame_{i + 1:04d}.cam")),
                     jharness.sintel_cam_read(str(cams /
                                                  f"frame_{i + 1:04d}.cam")))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    depth = rng.uniform(1, 5, (6, 8))
    flow = rng.standard_normal((6, 8, 2))
    write_grid(tmp_path / "d.dpt", depth)
    write_grid(tmp_path / "f.flo", flow)
    np.testing.assert_array_equal(
        tharness.sintel_depth_read(str(tmp_path / "d.dpt")),
        jharness.sintel_depth_read(str(tmp_path / "d.dpt")))
    np.testing.assert_array_equal(
        tharness.flo_read(str(tmp_path / "f.flo")),
        jharness.flo_read(str(tmp_path / "f.flo")))
    # trajectories: sintel .cam dir, TUM lines, KITTI rows
    tum = tmp_path / "gt.txt"
    with open(tum, "w") as f:
        for i in range(4):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            f.write(" ".join(map(str, [i * 0.1, *rng.normal(size=3),
                                       *q])) + "\n")
    kitti = tmp_path / "kitti.txt"
    np.savetxt(kitti, rng.normal(size=(3, 12)))
    for path, fmt in ((cams, "sintel"), (tum, "tum"), (tum, "replica"),
                      (kitti, "kitti")):
        np.testing.assert_array_equal(
            tharness.load_gt_traj(str(path), fmt),
            jharness.load_gt_traj(str(path), fmt))
    with pytest.raises(ValueError):
        tharness.load_gt_traj(str(kitti), "nope")


def test_davis_eval_matches_jax(tmp_path):
    """tests/test_misc_components.py's DAVIS layout, with a prediction that
    differs from the annotation and an annotation at twice the size."""
    for name in ("scene1", "scene2"):
        pred_dir = tmp_path / "results" / name
        gt_dir = tmp_path / "gt" / name
        pred_dir.mkdir(parents=True)
        gt_dir.mkdir(parents=True)
        for i in range(3):
            m = np.zeros((32, 32), np.uint8)
            m[8:20, 8 + i:20 + 2 * i] = 255
            g = np.zeros((64, 64), np.uint8)
            g[16:40, 16:40] = 255
            Image.fromarray(m).save(pred_dir / f"dynamic_mask_{i:04d}.png")
            Image.fromarray(g if name == "scene2" else m).save(
                gt_dir / f"{i:05d}.png")
    for name in ("scene1", "scene2"):
        args = (str(tmp_path / "results" / name), str(tmp_path / "gt" / name))
        assert (tdavis.eval_sequence_masks(*args)
                == jdavis.eval_sequence_masks(*args))
    args = (str(tmp_path / "results"), str(tmp_path / "gt"),
            ["scene1", "scene2", "missing"])
    assert tdavis.eval_dataset_masks(*args) == jdavis.eval_dataset_masks(
        *args)
    assert tdavis.eval_dataset_masks(*args)[1]["mean_J"] < 1.0


# ---------------------------------------------------------------------------
# Sintel: the dynamic labels and the dataset


def _static_scene():
    """TestSintelDynamics' static scene: (depth, K, w2c1, w2c2, ego flow)."""
    h, w = 24, 32
    depth = np.full((h, w), 5.0, np.float32)
    K = np.asarray([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]])
    m2 = np.eye(4)
    m2[:3, 3] = [0.1, 0, 0]
    label_free = jsd.dynamic_label_from_gt(depth, K, np.eye(4)[:3], m2[:3],
                                           np.zeros((h, w, 2), np.float32))
    assert label_free.shape == (h, w)
    from das3r_tpu.predictor import warping
    c2w2 = np.linalg.inv(m2)
    ego, _ = warping.ego_flow_from_disp(
        jnp.asarray(np.eye(4)[None, :3, :3], jnp.float32),
        jnp.asarray(np.eye(4)[None, :3, 3:], jnp.float32),
        jnp.asarray(c2w2[None, :3, :3], jnp.float32),
        jnp.asarray(c2w2[None, :3, 3:], jnp.float32),
        jnp.asarray(1.0 / depth[None, None]),
        jnp.asarray(K[None], jnp.float32),
        jnp.asarray(np.linalg.inv(K)[None], jnp.float32))
    return depth, K, np.eye(4)[:3], m2[:3], np.asarray(ego)[0, :2].transpose(
        1, 2, 0)


def test_sintel_dynamic_labels_exact():
    depth, K, w2c1, w2c2, flow = _static_scene()
    rng = np.random.default_rng(3)
    moved = flow.copy()
    moved[5:10, 5:10] += 10.0
    for gt_flow, d in ((flow, depth), (moved, depth),
                       (flow + rng.normal(0, 0.3, flow.shape),
                        depth * rng.uniform(0.8, 1.2, depth.shape))):
        want = jsd.dynamic_label_from_gt(d, K, w2c1, w2c2, gt_flow)
        got = tsd.dynamic_label_from_gt(d, K, w2c1, w2c2, gt_flow)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert got.sum() > 0
    assert tsd.dynamic_label_from_gt(depth, K, w2c1, w2c2, flow).sum() == 0


@pytest.fixture
def sintel_root(tmp_path):
    """A two-scene Sintel training tree: 3 frames each at 40x48, frames,
    .dpt depth, .cam cameras and .flo flows."""
    rng = np.random.default_rng(5)
    root = tmp_path / "sintel"
    K = np.asarray([[50.0, 0, 24], [0, 50.0, 20], [0, 0, 1]])
    for scene in ("alley_2", "cave_4"):
        for sub in ("final", "depth", "camdata_left", "flow"):
            (root / "training" / sub / scene).mkdir(parents=True)
        for f in range(1, 4):
            name = f"frame_{f:04d}"
            Image.fromarray(rng.integers(0, 255, (40, 48, 3), np.uint8)).save(
                root / "training" / "final" / scene / f"{name}.png")
            write_grid(root / "training" / "depth" / scene / f"{name}.dpt",
                       rng.uniform(2, 6, (40, 48)))
            write_cam(root / "training" / "camdata_left" / scene
                      / f"{name}.cam", K,
                      np.hstack([np.eye(3), [[0.05 * f], [0], [0]]]))
            write_grid(root / "training" / "flow" / scene / f"{name}.flo",
                       rng.normal(0, 2, (40, 48, 2)))
    return root


def test_sintel_labels_and_dataset_bitwise(sintel_root, tmp_path):
    jdir, tdir = tmp_path / "jlabels", tmp_path / "tlabels"
    jsd.build_sintel_labels(str(sintel_root), str(jdir))
    tsd.build_sintel_labels(str(sintel_root), str(tdir))
    names = sorted(p.relative_to(jdir) for p in jdir.rglob("*.png"))
    assert names == sorted(p.relative_to(tdir) for p in tdir.rglob("*.png"))
    assert len(names) == 4
    for n in names:
        np.testing.assert_array_equal(np.asarray(Image.open(tdir / n)),
                                      np.asarray(Image.open(jdir / n)))
    # the last frame of each scene has no label: give it one to load
    for scene in ("alley_2", "cave_4"):
        shutil.copy(tdir / scene / "frame_0002.png",
                    tdir / scene / "frame_0003.png")
    for kw in (dict(dynamic_label_dir=str(tdir), resolution=(32, 24)),
               dict(stride=2, resolution=(48, 32))):
        jd = jsintel.SintelDataset(str(sintel_root), **kw)
        td = tsintel.SintelDataset(str(sintel_root), **kw)
        assert td.pairs == jd.pairs and len(td) > 0
        for i in range(len(td)):
            a, b = jd[i], td[i]
            for f in dataclasses.fields(a):
                x, y = getattr(a, f.name), getattr(b, f.name)
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)


# ---------------------------------------------------------------------------
# pose evaluation: both packages' stage 1 on a synthetic tum layout


def tum_layout(root, seq="rgbd_synthetic", n_frames=4):
    """``{root}/tum/{seq}/rgb_50`` frames and ``groundtruth_50.txt`` (the
    synthetic scene's TUM trajectory)."""
    gen = root / "gen"
    make_synthetic_stage1_dir(str(gen), n_frames=n_frames, height=48,
                              width=64, seed=2)
    seq_dir = root / "tum" / seq
    (seq_dir / "rgb_50").mkdir(parents=True)
    for p in sorted(gen.glob("frame_*.png")):
        shutil.copy(p, seq_dir / "rgb_50")
    shutil.copy(gen / "pred_traj.txt", seq_dir / "groundtruth_50.txt")
    shutil.rmtree(gen)
    return seq


def test_eval_pose_estimation_matches_jax(tmp_path, monkeypatch):
    seq = tum_layout(tmp_path)
    for mod in (jrunner, trunner):      # frames at a long side of 64
        orig = mod.load_frames
        monkeypatch.setattr(mod, "load_frames",
                            lambda d, size=512, _f=orig, **kw: _f(d, size=64,
                                                                  **kw))
    sd = random_torch_state_dict(TINY, np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, convert_torch_state_dict(sd, JTINY))
    model = AsymmetricCroCo3D(TINY)
    convert.load_reference_state_dict(model, sd)
    cfg = dict(niter=2, flow_loss_weight=0.0, temporal_smoothing_weight=0.0)
    quiet = dict(seq_list=[seq], verbose=lambda *_: None)
    jres, jsum = jpose.eval_pose_estimation(
        "tum", str(tmp_path), str(tmp_path / "jax"), JModel(JTINY), params,
        jalign.AlignerConfig(**cfg), **quiet)
    tres, tsum = tpose.eval_pose_estimation(
        "tum", str(tmp_path), str(tmp_path / "port"), model,
        talign.AlignerConfig(**cfg), device="cpu", **quiet)
    assert tsum["n_ok"] == tsum["n_sequences"] == jsum["n_ok"] == 1, (
        tres, jres)
    for k in ("mean_ate", "mean_rpe_trans", "mean_rpe_rot"):
        assert np.isfinite(tsum[k])
    assert abs(tsum["mean_ate"] - jsum["mean_ate"]) <= ATE_REL * abs(
        jsum["mean_ate"])
    assert (tmp_path / "port" / "tum" / seq / f"{seq}_error_log.txt").exists()
    assert (tmp_path / "port" / "tum_summary.txt").exists()
    # a sequence that fails is caught, logged and left out of the means
    _, bad = tpose.eval_pose_estimation(
        "tum", str(tmp_path), str(tmp_path / "port2"), model,
        talign.AlignerConfig(**cfg), seq_list=[seq, "missing"],
        verbose=lambda *_: None, device="cpu")
    assert (bad["n_sequences"], bad["n_ok"]) == (2, 1)
    assert tpose.DATASET_METADATA == jpose.DATASET_METADATA
