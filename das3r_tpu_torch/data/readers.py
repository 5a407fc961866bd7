"""Stage-2 scene reader: the COLMAP-dir + DAS3R side-channel loader of
``das3r_tpu/data/readers.py`` (numpy only). Produces densely stacked numpy
arrays; the per-scene dataset is small (<= ~200 frames at 512 px).
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
from PIL import Image

from das3r_tpu_torch.data import colmap, trajectory
from das3r_tpu_torch.utils import transforms


@dataclasses.dataclass
class SceneData:
    """All frames of one scene, stacked. Arrays are float32 numpy."""
    images: np.ndarray            # [F, 3, H, W] in [0, 1]
    poses_c2w: np.ndarray         # [F, 4, 4] stage-1 predicted (pred_traj)
    poses_w2c_colmap: np.ndarray  # [F, 4, 4] from sparse/0/images.txt
    intrinsics: np.ndarray        # [F, 3, 3] (pred_intrinsics.txt)
    fovx: np.ndarray              # [F]
    fovy: np.ndarray              # [F]
    conf: np.ndarray | None       # [F, H, W] stage-1 log-confidence
    depth: np.ndarray | None      # [F, H, W]
    dyna_avg: np.ndarray | None   # [F, H, W]
    dyna_max: np.ndarray | None   # [F, H, W]
    dynamic_mask: np.ndarray | None        # [F, H, W] bool
    enlarged_dynamic_mask: np.ndarray | None
    gt_dynamic_mask: np.ndarray | None     # [F, H, W] float (resized nearest)
    names: list
    train_idx: np.ndarray         # indices into the stacked arrays
    test_idx: np.ndarray

    @property
    def n_frames(self) -> int:
        return self.images.shape[0]

    @property
    def height(self) -> int:
        return self.images.shape[2]

    @property
    def width(self) -> int:
        return self.images.shape[3]

    def subset(self, idx: np.ndarray) -> "SceneData":
        take = lambda a: None if a is None else a[idx]
        return dataclasses.replace(
            self, images=self.images[idx], poses_c2w=self.poses_c2w[idx],
            poses_w2c_colmap=self.poses_w2c_colmap[idx],
            intrinsics=self.intrinsics[idx], fovx=self.fovx[idx],
            fovy=self.fovy[idx], conf=take(self.conf),
            depth=take(self.depth), dyna_avg=take(self.dyna_avg),
            dyna_max=take(self.dyna_max),
            dynamic_mask=take(self.dynamic_mask),
            enlarged_dynamic_mask=take(self.enlarged_dynamic_mask),
            gt_dynamic_mask=take(self.gt_dynamic_mask),
            names=[self.names[i] for i in idx],
            train_idx=np.arange(len(idx)), test_idx=np.empty(0, np.int64))


def train_test_split(n: int, eval_mode: bool, offset: int = 5,
                     hold: int = 10):
    """The published protocol: test frames are (idx + 5) % 10 == 0
    (reference dataset_readers.py:342-347)."""
    idx = np.arange(n)
    if not eval_mode:
        return idx, np.empty(0, np.int64)
    test = idx[(idx + offset) % hold == 0]
    train = idx[(idx + offset) % hold != 0]
    return train, test


def _load_side_npy(scene_dir, sub, prefix, frame_ids):
    out = []
    for i in frame_ids:
        p = os.path.join(scene_dir, sub, f"{prefix}_{i:04d}.npy")
        if not os.path.exists(p):
            return None
        out.append(np.load(p))
    return np.stack(out).astype(np.float32)


def _load_side_png_mask(scene_dir, sub, prefix, frame_ids):
    out = []
    for i in frame_ids:
        p = os.path.join(scene_dir, sub, f"{prefix}_{i:04d}.png")
        if not os.path.exists(p):
            return None
        out.append(np.asarray(Image.open(p), np.float32) / 255.0 > 0.5)
    return np.stack(out)


def _resize_nearest(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbor resize (reference scene/cameras.py:60-67)."""
    if mask.shape == (h, w):
        return mask.astype(np.float32)
    ys = (np.arange(h) * mask.shape[0] / h).astype(np.int64)
    xs = (np.arange(w) * mask.shape[1] / w).astype(np.int64)
    return mask[np.ix_(ys, xs)].astype(np.float32)


def load_scene(scene_dir: str, eval_mode: bool = False,
               gt_dynamic_mask_dir: str | None = None,
               gt_mask_kind: str = "davis",
               max_width: int = 1600) -> SceneData:
    """Load a rearranged DAS3R scene directory.

    Layout (produced by ``das3r_tpu_torch.data.rearrange`` or the reference's
    utils/rearrange.py): images/, sparse/0/{cameras,images}.txt,
    pred_traj.txt, pred_intrinsics.txt, confidence_maps/, depth_maps/,
    dyna_avg/, dyna_max/, dynamic_masks/ [, enlarged_dynamic_masks/].
    """
    cams = colmap.read_cameras_text(
        os.path.join(scene_dir, "sparse/0/cameras.txt"))
    imgs = colmap.read_images_text(
        os.path.join(scene_dir, "sparse/0/images.txt"))

    order = sorted(imgs.keys(), key=lambda k: imgs[k].name)
    names = [imgs[k].name for k in order]
    frame_ids = [int(os.path.splitext(n)[0].split("_")[-1]) for n in names]

    # stage-1 trajectory (c2w) indexed by the frame number embedded in the
    # file name (reference dataset_readers.py:218)
    ts, pos, quat = trajectory.read_tum(
        os.path.join(scene_dir, "pred_traj.txt"))
    all_c2w = trajectory.tum_to_c2w(pos, quat)
    poses_c2w = np.stack([all_c2w[i] for i in frame_ids]).astype(np.float32)

    K_flat = np.loadtxt(os.path.join(scene_dir, "pred_intrinsics.txt"),
                        dtype=np.float32).reshape(-1, 3, 3)
    intrinsics = np.stack([K_flat[i] for i in frame_ids])

    images, fovx, fovy, w2c_colmap = [], [], [], []
    for k in order:
        im = imgs[k]
        cam = cams[im.camera_id]
        img = Image.open(os.path.join(scene_dir, "images",
                                      os.path.basename(im.name)))
        # resolution -1 logic: cap width at ``max_width``
        # (reference utils/camera_utils.py:22-55)
        if img.width > max_width:
            scale = img.width / max_width
            img = img.resize((int(img.width / scale),
                              int(img.height / scale)))
        images.append(np.asarray(img.convert("RGB"), np.float32) / 255.0)
        fx, fy = cam.focal_xy
        fovx.append(transforms.focal2fov(fx, cam.width))
        fovy.append(transforms.focal2fov(fy, cam.height))
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = colmap.qvec2rotmat(im.qvec)
        m[:3, 3] = im.tvec
        w2c_colmap.append(m)

    images = np.stack(images).transpose(0, 3, 1, 2).clip(0.0, 1.0)
    F, _, H, W = images.shape

    conf = _load_side_npy(scene_dir, "confidence_maps", "conf", frame_ids)
    depth = _load_side_npy(scene_dir, "depth_maps", "frame", frame_ids)
    dyna_avg = _load_side_npy(scene_dir, "dyna_avg", "dyna_avg", frame_ids)
    dyna_max = _load_side_npy(scene_dir, "dyna_max", "dyna_max", frame_ids)
    dynamic_mask = _load_side_png_mask(scene_dir, "dynamic_masks",
                                       "dynamic_mask", frame_ids)
    enlarged = _load_side_png_mask(scene_dir, "enlarged_dynamic_masks",
                                   "enlarged_dynamic_mask", frame_ids)

    gt_dyn = None
    if gt_dynamic_mask_dir is not None:
        seq = os.path.basename(os.path.normpath(scene_dir))
        loaded = []
        for i in frame_ids:
            if gt_mask_kind == "sintel":
                p = os.path.join(gt_dynamic_mask_dir, seq,
                                 f"frame_{i + 1:04d}.png")
                arr = np.asarray(Image.open(p), np.float32) / 255.0 > 0.5
            else:  # davis: raw palette values, no /255 (ref :209-213)
                p = os.path.join(gt_dynamic_mask_dir, seq, f"{i:05d}.png")
                arr = np.asarray(Image.open(p), np.float32) > 0.5
            loaded.append(_resize_nearest(arr, H, W))
        gt_dyn = np.stack(loaded)

    train_idx, test_idx = train_test_split(F, eval_mode)
    return SceneData(
        images=images, poses_c2w=poses_c2w,
        poses_w2c_colmap=np.stack(w2c_colmap), intrinsics=intrinsics,
        fovx=np.asarray(fovx, np.float32), fovy=np.asarray(fovy, np.float32),
        conf=conf, depth=depth, dyna_avg=dyna_avg, dyna_max=dyna_max,
        dynamic_mask=dynamic_mask, enlarged_dynamic_mask=enlarged,
        gt_dynamic_mask=gt_dyn, names=names,
        train_idx=train_idx, test_idx=test_idx)
