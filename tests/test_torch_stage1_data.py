"""PyTorch port: stage-1 data and the training loop
(``predictor/{datasets,dataset_zoo,train_loop}.py``) against the JAX
package.

The datasets are numpy in both packages: every sample and batch must be
bitwise JAX's, on the synthetic sets, the PointOdyssey fixture of
``tests/test_stage1_loop.py`` and the zoo's twelve layouts written as
``tests/test_dataset_zoo.py`` writes them under ``tmp_path`` (the layouts
that read EXR depth skip where cv2 lacks the codec, as there). ``fit``
runs the port only, TINY at 48x32 on the CPU: resume, the best checkpoint
on the median test loss, numbered keep-checkpoints and the pose hook.
Checkpoints cross between the packages bitwise in both directions.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from das3r_tpu.models.croco.convert import convert_torch_state_dict
from das3r_tpu.models.croco.testkit import TINY as JTINY
from das3r_tpu.predictor import dataset_zoo as jzoo
from das3r_tpu.predictor import datasets as jds
from das3r_tpu.predictor import train_loop as jloop
from das3r_tpu.predictor import training as jtraining
from das3r_tpu_torch.models.croco import convert
from das3r_tpu_torch.models.croco.dpt import untie_upsample_bias
from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                  random_torch_state_dict)
from das3r_tpu_torch.predictor import dataset_zoo as tzoo
from das3r_tpu_torch.predictor import datasets as tds
from das3r_tpu_torch.predictor import train_loop, training

torch.set_num_threads(2)
RES = (64, 48)          # (W, H)
SRC_W, SRC_H = 80, 60
K_SRC = np.array([[70.0, 0, SRC_W / 2], [0, 70.0, SRC_H / 2], [0, 0, 1]],
                 np.float32)


def assert_clips_equal(a, b):
    for f in ("img1", "img2", "gt_pts3d_1", "gt_pts3d_2", "camera_pose_1",
              "valid_1", "valid_2", "gt_mask_1", "gt_mask_2"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def assert_datasets_equal(jd, td):
    """Equal lengths and samples (at most 16, spread over the set)."""
    assert len(jd) == len(td) > 0
    for i in sorted(set(np.linspace(0, len(jd) - 1, 16).astype(int))):
        assert_clips_equal(jd[i], td[i])


def assert_batches_equal(jit, tit):
    jb, tb = list(jit), list(tit)
    assert len(jb) == len(tb) > 0
    for (j1, j2, jbatch), (t1, t2, tbatch) in zip(jb, tb):
        np.testing.assert_array_equal(j1, t1)
        np.testing.assert_array_equal(j2, t2)
        for f, x, y in zip(jbatch._fields, jbatch, tbatch):
            x = np.asarray(x)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


# ---------------------------------------------------------------------------
# the synthetic sets, the combinators, the batches


@pytest.mark.parametrize("name", ["SyntheticTwoViewDataset",
                                  "WallTwoViewDataset"])
def test_synthetic_sets_and_batches_bitwise(name):
    kw = dict(n=10, resolution=(64, 48), seed=1)
    jd, td = getattr(jds, name)(**kw), getattr(tds, name)(**kw)
    assert_datasets_equal(jd, td)
    for seed, shuffle, drop_last in ((0, True, True), (5, False, False)):
        assert_batches_equal(
            jds.batch_iterator(jd, 4, seed=seed, shuffle=shuffle,
                               drop_last=drop_last),
            tds.batch_iterator(td, 4, seed=seed, shuffle=shuffle,
                               drop_last=drop_last))
    img1, _, batch = next(tds.batch_iterator(td, 4, seed=0))
    assert img1.shape == (4, 3, 48, 64)
    assert batch.gt_pts3d_1.shape == (4, 48, 64, 3)
    assert batch.valid_1.dtype == bool
    assert len(list(tds.batch_iterator(td, 4))) == 2        # drop_last
    t = batch.to("cpu")
    assert t.valid_1.dtype == torch.bool and t.gt_pts3d_1.shape[0] == 4


def test_combinators_bitwise():
    ja, jb = (jds.SyntheticTwoViewDataset(n=3, seed=1),
              jds.SyntheticTwoViewDataset(n=2, seed=2))
    ta, tb = (tds.SyntheticTwoViewDataset(n=3, seed=1),
              tds.SyntheticTwoViewDataset(n=2, seed=2))
    assert_datasets_equal(jds.RepeatedDataset(ja, 7),
                          tds.RepeatedDataset(ta, 7))
    assert_datasets_equal(jds.ConcatDataset(ja, jb),
                          tds.ConcatDataset(ta, tb))
    clips = ([("a", i, i + 1, 1) for i in range(10)]
             + [("a", i, i + 2, 2) for i in range(6)]
             + [("a", i, i + 3, 3) for i in range(4)])
    assert (tds.resample_clips_by_stride(clips, (1, 2, 3), "linear_1_2", 3)
            == jds.resample_clips_by_stride(clips, (1, 2, 3), "linear_1_2",
                                            3))


def write_pointodyssey(root):
    """tests/test_stage1_loop.py's PointOdyssey fixture."""
    seq = root / "train" / "seq0"
    for sub in ("rgbs", "depths", "trajs_3d", "extrinsics", "intrinsics"):
        (seq / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    traj_static = rng.uniform(-1, 1, (50, 3)) + [0, 0, 5]
    for f in range(4):
        img = (rng.uniform(0, 255, (48, 64, 3))).astype(np.uint8)
        cv2.imwrite(str(seq / "rgbs" / f"rgb_{f:05d}.jpg"), img)
        depth_m = rng.uniform(2, 8, (48, 64))
        d16 = (depth_m / 1000.0 * 65535.0).astype(np.uint16)
        cv2.imwrite(str(seq / "depths" / f"depth_{f:05d}.png"), d16)
        K = np.asarray([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
        np.save(seq / "intrinsics" / f"intrinsic_{f:05d}.npy", K)
        ext = np.eye(4)
        ext[:3, 3] = [0.01 * f, 0, 0]
        np.save(seq / "extrinsics" / f"extrinsic_{f:05d}.npy", ext)
        traj = traj_static.copy()
        traj[:10] += 0.1 * f  # first 10 points move
        np.save(seq / "trajs_3d" / f"traj_3d_{f:05d}.npy", traj)


@pytest.mark.parametrize("dist_type", [None, "linear_1_2"])
def test_pointodyssey_bitwise(tmp_path, dist_type):
    write_pointodyssey(tmp_path)
    kw = dict(strides=(1, 2), clip_step=1, resolution=(64, 48),
              dist_type=dist_type)
    jd = jds.PointOdysseyDataset(str(tmp_path), "train", **kw)
    td = tds.PointOdysseyDataset(str(tmp_path), "train", **kw)
    assert td.clips == jd.clips
    assert_datasets_equal(jd, td)
    assert td[0].gt_mask_1.max() == 1.0      # the moving points


# ---------------------------------------------------------------------------
# the zoo: tests/test_dataset_zoo.py's fixtures, each layout bitwise


def _cv2_has_exr() -> bool:
    """tests/test_dataset_zoo.py's gate: some OpenCV builds lack the
    OpenEXR codec."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        try:
            return bool(cv2.imwrite(os.path.join(d, "probe.exr"),
                                    np.zeros((2, 2), np.float32)))
        except cv2.error:
            return False


def _png(path, rng):
    cv2.imwrite(str(path), (rng.uniform(0, 255, (SRC_H, SRC_W, 3)))
                .astype(np.uint8))


def _exr(path, value=3.0, far=None):
    dep = np.full((SRC_H, SRC_W), value, np.float32)
    if far is not None:
        dep[0, 0] = far
    cv2.imwrite(str(path), dep)


def _u16(path, value):
    cv2.imwrite(str(path), np.full((SRC_H, SRC_W), value, np.uint16))


def zoo_tartanair(root, rng):
    seq = root / "office" / "Hard" / "P000"
    (seq / "image_left").mkdir(parents=True)
    (seq / "depth_left").mkdir()
    for i in range(6):
        _png(seq / "image_left" / f"{i:06d}_left.png", rng)
        np.save(seq / "depth_left" / f"{i:06d}_left_depth.npy",
                np.full((SRC_H, SRC_W), 3.0, np.float32))
    q = rng.normal(size=(6, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.savetxt(seq / "pose_left.txt",
               np.concatenate([rng.normal(0, 0.1, (6, 3)), q], 1))
    return "TartanAirDataset", dict(split="Hard", strides=(1, 2),
                                    clip_step=1, resolution=RES,
                                    dist_type="linear_1_2", seed=0)


def zoo_spring(root, rng):
    h5py = pytest.importorskip("h5py")
    seq = root / "train" / "0001"
    for sub in ("frame_left", "disp1_left", "cam_data"):
        (seq / sub).mkdir(parents=True)
    fx = 70.0
    extr, intr = [], []
    for i in range(1, 6):
        _png(seq / "frame_left" / f"frame_left_{i:04d}.png", rng)
        disp = np.full((2 * SRC_H, 2 * SRC_W),
                       fx * tzoo.SpringDataset.BASELINE / 3.0, np.float32)
        disp[0, :4] = 0.0                     # infinite depth: invalid
        with h5py.File(seq / "disp1_left" / f"disp1_left_{i:04d}.dsp5",
                       "w") as f:
            f.create_dataset("disparity", data=disp)
        w2c = np.eye(4)
        w2c[2, 3] = 0.05 * i
        extr.append(w2c.reshape(-1))
        intr.append([fx, fx, SRC_W / 2, SRC_H / 2])
    np.savetxt(seq / "cam_data" / "extrinsics.txt", np.asarray(extr))
    np.savetxt(seq / "cam_data" / "intrinsics.txt", np.asarray(intr))
    return "SpringDataset", dict(split="train", strides=(1,), clip_step=1,
                                 resolution=RES)


def zoo_waymo(root, rng):
    scene = root / "seg0"
    scene.mkdir()
    frames = ["f000", "f001", "f002"]
    for k, f in enumerate(frames):
        _png(scene / (f + ".jpg"), rng)
        _exr(scene / (f + ".exr"))
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = 0.2 * k
        np.savez(scene / (f + ".npz"), intrinsics=K_SRC, cam2world=c2w)
    np.savez(root / "waymo_pairs_video.npz", scenes=np.array(["seg0"]),
             frames=np.array(frames), pairs=np.array([[0, 0, 1], [0, 1, 2]]))
    return "WaymoDataset", dict(resolution=RES)


def _metadata(path, scene, names, rng):
    np.savez(path, scenes=np.array([scene]), sceneids=np.array([0, 0]),
             images=np.array(names), intrinsics=np.stack([K_SRC, K_SRC]),
             trajectories=np.stack([np.eye(4, dtype=np.float32)] * 2),
             pairs=np.array([[0, 1]]))


def zoo_scannetpp(root, rng):
    scene = root / "sc0"
    (scene / "images").mkdir(parents=True)
    (scene / "depth").mkdir()
    for nm in ("DSC0", "DSC1"):
        _png(scene / "images" / (nm + ".jpg"), rng)
        _u16(scene / "depth" / (nm + ".png"), 3000)
    _metadata(root / "all_metadata.npz", "sc0", ["DSC0", "DSC1"], rng)
    return "ScanNetppDataset", dict(resolution=RES)


def zoo_staticthings3d(root, rng):
    seq = root / "TRAIN" / "A" / "0000"
    for cam in ("left", "right"):
        (seq / cam).mkdir(parents=True)
        for i in (6, 7):
            _png(seq / cam / f"{i:04d}_clean.jpg", rng)
            _exr(seq / cam / f"{i:04d}.exr", far=500.0)
            np.savez(seq / cam / f"{i:04d}.npz", intrinsics=K_SRC,
                     cam2world=np.eye(4, dtype=np.float32))
    np.save(root / "staticthings_pairs.npy",
            np.array([(b"A", 0, b"l", 6, b"r", 7)], dtype=object),
            allow_pickle=True)
    return "StaticThings3DDataset", dict(resolution=RES)


def zoo_co3d(root, rng):
    inst = root / "apple" / "110_1"
    for sub in ("images", "depths", "masks"):
        (inst / sub).mkdir(parents=True)
    for idx in (0, 1, 2):
        _png(inst / "images" / f"frame{idx:06d}.jpg", rng)
        _u16(inst / "depths" / f"frame{idx:06d}.jpg.geometric.png", 32767)
        mask = np.full((SRC_H, SRC_W), 255, np.uint8)
        mask[:4, :4] = 0
        cv2.imwrite(str(inst / "masks" / f"frame{idx:06d}.png"), mask)
        np.savez(inst / "images" / f"frame{idx:06d}.npz",
                 camera_pose=np.eye(4, dtype=np.float32),
                 camera_intrinsics=K_SRC, maximum_depth=6.0)
    with open(root / "selected_seqs_train.json", "w") as f:
        json.dump({"apple": {"110_1": [0, 1, 2]}}, f)
    return "Co3dDataset", dict(split="train", resolution=RES)


def zoo_wildrgbd(root, rng):
    inst = root / "cup" / "scene0"
    for sub in ("rgb", "depth", "masks", "metadata"):
        (inst / sub).mkdir(parents=True)
    for idx in (0, 5):
        _png(inst / "rgb" / f"{idx:05d}.jpg", rng)
        _u16(inst / "depth" / f"{idx:05d}.png", 3000)
        cv2.imwrite(str(inst / "masks" / f"{idx:05d}.png"),
                    np.full((SRC_H, SRC_W), 255, np.uint8))
        np.savez(inst / "metadata" / f"{idx:05d}.npz",
                 camera_pose=np.eye(4, dtype=np.float32),
                 camera_intrinsics=K_SRC, maximum_depth=0.0)
    with open(root / "selected_seqs_train.json", "w") as f:
        json.dump({"cup": {"scene0": [0, 5]}}, f)
    return "WildRGBDDataset", dict(split="train", resolution=RES)


def zoo_arkitscenes(root, rng):
    scene = root / "Training" / "sc0"
    (scene / "vga_wide").mkdir(parents=True)
    (scene / "lowres_depth").mkdir()
    names = ["img0.png", "img1.png"]
    for nm in names:
        _png(scene / "vga_wide" / nm.replace(".png", ".jpg"), rng)
        _u16(scene / "lowres_depth" / nm, 3000)
    _metadata(root / "Training" / "all_metadata.npz", "sc0", names, rng)
    return "ARKitScenesDataset", dict(split="train", resolution=RES)


def zoo_blendedmvs(root, rng):
    seqh, seql = 0x12, 0x345
    seq = root / f"{seqh:08x}{seql:016x}"
    seq.mkdir()
    for idx in (0, 1, 2):
        _png(seq / f"{idx:08d}.jpg", rng)
        _exr(seq / f"{idx:08d}.exr")
        np.savez(seq / f"{idx:08d}.npz", intrinsics=K_SRC,
                 R_cam2world=np.eye(3, dtype=np.float32),
                 t_cam2world=np.zeros(3, np.float32))
    np.save(root / "blendedmvs_pairs.npy", np.array(
        [(seqh, seql, 0, 1, 0.5), (seqh, seql, 1, 2, 0.5)],
        dtype=[("seq_high", "i8"), ("seq_low", "i8"), ("im1", "i4"),
               ("im2", "i4"), ("score", "f4")]))
    return "BlendedMVSDataset", dict(split="train", resolution=RES)


def zoo_megadepth(root, rng):
    seq = root / "0001" / "dense0"
    seq.mkdir(parents=True)
    for img in ("a", "b"):
        _png(seq / (img + ".jpg"), rng)
        _exr(seq / (img + ".exr"))
        np.savez(seq / (img + ".npz"), intrinsics=K_SRC,
                 cam2world=np.eye(4, dtype=np.float32))
    np.savez(root / "all_metadata.npz", scenes=np.array(["0001 dense0"]),
             images=np.array(["a", "b"]), pairs=np.array(
                 [(0, 0, 1, 0.5)], dtype=[("scene_id", "i4"),
                                          ("im1_id", "i4"),
                                          ("im2_id", "i4"),
                                          ("score", "f4")]))
    return "MegaDepthDataset", dict(split="train", resolution=RES)


def zoo_habitat(root, rng):
    scene_dir = root / "room0"
    scene_dir.mkdir()
    for i in range(1, 6):
        _png(scene_dir / f"key_{i}.png", rng)
        os.rename(scene_dir / f"key_{i}.png", scene_dir / f"key_{i}.jpeg")
        _exr(scene_dir / f"key_{i}_depth.exr")
        with open(scene_dir / f"key_{i}_camera_params.json", "w") as f:
            json.dump({"camera_intrinsics": K_SRC.tolist(),
                       "R_cam2world": np.eye(3).tolist(),
                       "t_cam2world": [0.0, 0.0, 0.0]}, f)
    with open(root / "Habitat_1000_scenes_train.txt", "w") as f:
        f.write("room0/key\n")
    return "HabitatDataset", dict(size=1000, split="train", resolution=RES)


def zoo_dynamic_replica(root, rng):
    from PIL import Image
    (root / "seqA").mkdir()
    anno = []
    for i in range(5):
        img_rel, dep_rel = f"seqA/img_{i:04d}.png", f"seqA/dep_{i:04d}.png"
        _png(root / img_rel, rng)
        d16 = np.full((SRC_H, SRC_W), 3.0, np.float16).view(np.uint16)
        Image.fromarray(d16).save(root / dep_rel)
        anno.append({"sequence_name": "seqA", "image": {"path": img_rel},
                     "depth": {"path": dep_rel},
                     "viewpoint": {"focal_length": [2.0, 2.0],
                                   "principal_point": [0.1, -0.2],
                                   "intrinsics_format": "ndc_isotropic",
                                   "R": np.eye(3).tolist(),
                                   "T": [0.0, 0.0, 0.3 * i]}})
    with open(root / "frame_annotations_train.json", "w") as f:
        json.dump(anno, f)
    return "DynamicReplicaDataset", dict(strides=(1, 2), clip_step=1,
                                         resolution=RES,
                                         dist_type="linear_1_2")


ZOO = {"tartanair": (zoo_tartanair, False), "spring": (zoo_spring, False),
       "waymo": (zoo_waymo, True), "scannetpp": (zoo_scannetpp, False),
       "staticthings3d": (zoo_staticthings3d, True),
       "co3d": (zoo_co3d, False), "wildrgbd": (zoo_wildrgbd, False),
       "arkitscenes": (zoo_arkitscenes, False),
       "blendedmvs": (zoo_blendedmvs, True),
       "megadepth": (zoo_megadepth, True), "habitat": (zoo_habitat, True),
       "dynamic_replica": (zoo_dynamic_replica, False)}


@pytest.mark.parametrize("layout", sorted(ZOO))
def test_zoo_layout_bitwise(tmp_path, layout):
    writer, exr = ZOO[layout]
    if exr and not _cv2_has_exr():
        pytest.skip("cv2 lacks the OpenEXR codec")
    name, kw = writer(tmp_path, np.random.default_rng(len(layout)))
    jd = getattr(jzoo, name)(str(tmp_path), **kw)
    td = getattr(tzoo, name)(str(tmp_path), **kw)
    assert_datasets_equal(jd, td)
    assert_batches_equal(jds.batch_iterator(jd, 1, seed=2),
                         tds.batch_iterator(td, 1, seed=2))


def test_ndc_intrinsics_match_jax():
    for fmt in ("ndc_isotropic", "ndc_norm_image_bounds"):
        np.testing.assert_array_equal(
            tzoo.ndc_to_pixel_intrinsics([2.0, 1.5], [0.1, -0.2], 80, 60,
                                         fmt),
            jzoo.ndc_to_pixel_intrinsics([2.0, 1.5], [0.1, -0.2], 80, 60,
                                         fmt))
    with pytest.raises(ValueError):
        tzoo.ndc_to_pixel_intrinsics([1, 1], [0, 0], 8, 6, "nope")


# ---------------------------------------------------------------------------
# the loop (port only: JAX's are slow) and the checkpoints


@pytest.fixture
def work(tmp_path):
    """``tmp_path``, emptied after the test: TINY's mask heads are 36M
    parameters, so a training checkpoint is ~434 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def tiny_model(seed, sd=None):
    model = AsymmetricCroCo3D(TINY)
    convert.load_reference_state_dict(model, sd or random_torch_state_dict(
        TINY, np.random.default_rng(seed)))
    return model


def fit_sets():
    return (tds.SyntheticTwoViewDataset(n=4, resolution=(48, 32)),
            tds.SyntheticTwoViewDataset(n=2, resolution=(48, 32), seed=9))


TCFG = training.Stage1TrainConfig(lr=1e-3, warmup_epochs=0.0,
                                  steps_per_epoch=2, epochs=4)


def test_fit_resume_and_best_on_median(work):
    train_ds, test_ds = fit_sets()
    out = work / "ck"
    lcfg = train_loop.Stage1LoopConfig(epochs=2, batch_size=2,
                                       out_dir=str(out))
    model, hist = train_loop.fit(tiny_model(1), train_ds, {"syn": test_ds},
                                 TCFG, lcfg, progress=lambda *_: None,
                                 device="cpu")
    assert len(hist) == 2
    for f in ("checkpoint-last.npz", "checkpoint-final.npz",
              "checkpoint-best.npz"):
        assert (out / f).exists(), f
    lines = (out / "log.txt").read_text().splitlines()
    assert len(lines) == 2
    entry = json.loads(lines[-1])
    assert {"train_loss", "train_lr", "test_syn_loss",
            "test_syn_loss_med"} <= set(entry)
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    best = float(np.load(out / "checkpoint-best.npz")["__best"])
    assert best == min(h["test_syn_loss_med"] for h in hist)
    # JAX's file names and layout: JAX's loader restores it
    sd = random_torch_state_dict(TINY, np.random.default_rng(1))
    tp, _ = jtraining.split_params(jax.tree.map(
        jnp.asarray, convert_torch_state_dict(sd, JTINY)))
    _, _, epoch, jbest, _ = jloop._load_ckpt(
        str(out / "checkpoint-last.npz"), tp, jtraining.adamw_init(tp))
    assert (epoch, jbest) == (2, best)

    # resume: epochs=3 continues from epoch 2 (runs exactly 1 more), from
    # the trained heads, not from the fresh model it is given
    lcfg3 = train_loop.Stage1LoopConfig(epochs=3, batch_size=2,
                                        out_dir=str(out))
    resumed, hist2 = train_loop.fit(tiny_model(1), train_ds, {}, TCFG, lcfg3,
                                    progress=lambda *_: None, device="cpu")
    assert len(hist2) == 1
    assert json.loads((out / "log.txt").read_text().splitlines()[-1])[
        "epoch"] == 2
    k = "downstream_head_dynamic_mask1.dpt.head.4.weight"
    assert not torch.equal(resumed.state_dict()[k],
                           tiny_model(1).state_dict()[k])


def test_fit_pose_hook_and_keep_checkpoints(work):
    """In-train pose eval (training.py:311-331): fires every
    pose_eval_freq epochs, tracks the best mean ATE, saves best_pose and
    numbered keep checkpoints; a None ATE (the reference's 'bug' flag)
    never updates the best."""
    train_ds, test_ds = fit_sets()
    calls = []
    ates = {1: 0.5, 2: 0.2, 3: None, 4: 0.4}  # 3 fails, 4 not better

    def pose_eval_fn(model, epoch):
        assert isinstance(model, AsymmetricCroCo3D)
        calls.append(epoch)
        return {"mean_ate": ates[epoch], "n_ok": 1}

    out = work / "pk"
    lcfg = train_loop.Stage1LoopConfig(
        epochs=4, batch_size=2, out_dir=str(out), pose_eval_freq=1,
        keep_freq=2, save_best_pose=True)
    _, hist = train_loop.fit(tiny_model(2), train_ds, {"syn": test_ds},
                             TCFG, lcfg, progress=lambda *_: None,
                             pose_eval_fn=pose_eval_fn, device="cpu")
    assert calls == [1, 2, 3, 4]
    for f in ("checkpoint-best_pose.npz", "checkpoint-2.npz",
              "checkpoint-4.npz"):
        assert (out / f).exists(), f
    assert not (out / "checkpoint-1.npz").exists()
    data = np.load(out / "checkpoint-last.npz")
    assert float(data["__best_pose"]) == 0.2
    assert float(np.load(out / "checkpoint-best_pose.npz")["__epoch"]) == 2
    assert hist[-1]["pose_mean_ate"] == 0.4
    assert hist[2]["pose_mean_ate"] is None
    assert "test_syn_loss_med" in hist[-1]


# the checkpoint tests write a part of the model: every kind of leaf
# (linear, norm, patchify, conv, the untied upsampling) in a few MB, as
# JAX's writers compress (~16 MB/s)
PART = ("patch_embed", "enc_norm", "enc_blocks.1.", "dec_blocks2.0.",
        "downstream_head_dynamic_mask2.dpt.act_postprocess.0.",
        "downstream_head_dynamic_mask2.dpt.act_postprocess.1.",
        "downstream_head_dynamic_mask2.dpt.head.")


def part(d: dict) -> dict:
    return {k: v for k, v in d.items() if k.startswith(PART)}


def jpart(tree: dict, names) -> dict:
    """The sub-tree of the JAX ``tree`` that holds the leaves ``names``."""
    out = {}
    for k in names:
        *parents, leaf = convert.jax_path(k)
        src, dst = tree, out
        for p in parents:
            src, dst = src[p], dst.setdefault(p, {})
        dst[leaf] = src[leaf]
    return out


def perturbed(tree, rng):
    """Every leaf moved by its own noise (untied bias taps differ)."""
    return jax.tree.map(lambda x: np.asarray(
        x + rng.normal(0, 0.01, np.shape(x)), np.asarray(x).dtype), tree)


def assert_npz_equal(a, b):
    a, b = np.load(a), np.load(b)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_bitwise(work, direction):
    """A training checkpoint (``_save_ckpt``) and a parameter file
    (``save_params_npz``) written by one package, loaded by the other and
    written again: the two files bitwise equal."""
    rng = np.random.default_rng(7)
    sd = random_torch_state_dict(TINY, np.random.default_rng(4))
    params = jax.tree.map(np.asarray, convert_torch_state_dict(sd, JTINY))
    model = tiny_model(4, sd)
    train, _ = training.split_params(model, "none")   # untied
    train = part(train)
    opt = training.adamw_init(train)
    jtrain = jpart(params, train)
    jopt = jtraining.adamw_init(jtrain)
    a, b = work / "a.npz", work / "b.npz"
    pa, pb = work / "pa.npz", work / "pb.npz"
    if direction == "jax_to_port":
        jtrain = perturbed(jtrain, rng)
        jopt = jtraining.AdamWState(
            count=jnp.asarray(5, jnp.int32), mu=perturbed(jopt.mu, rng),
            nu=jax.tree.map(np.abs, perturbed(jopt.nu, rng)))
        jloop._save_ckpt(str(a), jtrain, jopt, 3, 0.25, 0.125)
        assert train_loop._load_ckpt(str(a), train, opt) == (3, 0.25, 0.125)
        assert int(opt.count) == 5
        train_loop._save_ckpt(str(b), train, opt, 3, 0.25, 0.125)
        jloop.save_params_npz(str(pa), perturbed(jtrain, rng))
        train_loop.save_params_npz(
            str(pb), train_loop.load_params_npz(str(pa), train))
    else:
        with torch.no_grad():
            for t in list(opt.mu.values()) + list(train.values()):
                t.add_(torch.as_tensor(rng.normal(0, 0.01, t.shape),
                                       dtype=t.dtype))
            for t in opt.nu.values():
                t.add_(torch.as_tensor(rng.uniform(0, 0.01, t.shape),
                                       dtype=t.dtype))
            opt.count.fill_(5)
        train_loop._save_ckpt(str(a), train, opt, 3, 0.25, 0.125)
        got = jloop._load_ckpt(str(a), jtrain, jopt)
        assert got[2:] == (3, 0.25, 0.125) and int(got[1].count) == 5
        jloop._save_ckpt(str(b), got[0], got[1], 3, 0.25, 0.125)
        train_loop.save_params_npz(str(pa), train)
        jloop.save_params_npz(str(pb), jloop.load_params_npz(str(pa),
                                                             jtrain))
    assert_npz_equal(a, b)
    assert_npz_equal(pa, pb)
    # a whole model's file holds every key of JAX's
    train_loop.save_params_npz(str(pa), model)
    assert sorted(np.load(pa).files) == sorted(
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_flatten_with_path(params)[0])
