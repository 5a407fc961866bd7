"""Sintel two-view dataset for stage-1 training/testing (port of
``das3r_tpu/predictor/sintel_dataset.py``, numpy; reference
dynamic_predictor/dust3r/datasets/sintel.py): frames from training/final,
GT depth from .dpt, cameras from camdata_left .cam (w2c), dynamic labels
from the ``dynamic_label_perfect`` directory built by
``das3r_tpu_torch.data.sintel_dynamics``; z_far = 80.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from das3r_tpu_torch.eval.harness import sintel_cam_read, sintel_depth_read
from das3r_tpu_torch.predictor.datasets import (TwoViewClip, center_crop_resize,
                                          depth_to_world_pts, imgnorm)


class SintelDataset:
    def __init__(self, root: str, dynamic_label_dir: str | None = None,
                 stride: int = 1, resolution=(512, 224), z_far: float = 80.0,
                 scenes=None):
        self.root = root
        self.dyn_dir = dynamic_label_dir
        self.resolution = resolution
        self.z_far = z_far
        img_root = os.path.join(root, "training", "final")
        scenes = scenes or sorted(os.listdir(img_root))
        self.pairs = []
        for scene in scenes:
            frames = sorted(glob.glob(os.path.join(img_root, scene,
                                                   "frame_*.png")))
            for i in range(len(frames) - stride):
                self.pairs.append((scene, i + 1, i + 1 + stride))
                # sintel frames are 1-indexed (frame_0001.png)

    def __len__(self):
        return len(self.pairs)

    def _load_view(self, scene: str, fid: int):
        import cv2
        img = cv2.cvtColor(cv2.imread(os.path.join(
            self.root, "training", "final", scene,
            f"frame_{fid:04d}.png")), cv2.COLOR_BGR2RGB)
        depth = sintel_depth_read(os.path.join(
            self.root, "training", "depth", scene, f"frame_{fid:04d}.dpt"))
        K, N = sintel_cam_read(os.path.join(
            self.root, "training", "camdata_left", scene,
            f"frame_{fid:04d}.cam"))
        w2c = np.eye(4)
        w2c[:3] = N
        c2w = np.linalg.inv(w2c).astype(np.float32)
        if self.dyn_dir is not None:
            from PIL import Image
            m = np.asarray(Image.open(os.path.join(
                self.dyn_dir, scene, f"frame_{fid:04d}.png")),
                np.float32) / 255.0 > 0.5
        else:
            m = np.zeros(depth.shape, bool)
        return img, depth, np.asarray(K, np.float64), c2w, m.astype(
            np.float32)

    def __getitem__(self, index: int) -> TwoViewClip:
        import cv2
        scene, i, j = self.pairs[index]
        views = []
        for fid in (i, j):
            img, depth, K, c2w, dyn = self._load_view(scene, fid)
            h, w = depth.shape
            # resize the mask alongside (nearest)
            img2, depth2, K2 = center_crop_resize(img, depth, K,
                                                  self.resolution)
            W, H = self.resolution
            scale = max(W / w, H / h)
            nw, nh = round(w * scale), round(h * scale)
            dynr = cv2.resize(dyn, (nw, nh),
                              interpolation=cv2.INTER_NEAREST)
            x0, y0 = (nw - W) // 2, (nh - H) // 2
            dynr = dynr[y0:y0 + H, x0:x0 + W]
            pts, valid = depth_to_world_pts(depth2, K2, c2w, self.z_far)
            views.append((imgnorm(img2), pts, valid, dynr, c2w))
        (i1, p1, v1, m1, pose1), (i2, p2, v2, m2, _) = views
        return TwoViewClip(img1=i1, img2=i2, gt_pts3d_1=p1, gt_pts3d_2=p2,
                           camera_pose_1=pose1, valid_1=v1, valid_2=v2,
                           gt_mask_1=m1, gt_mask_2=m2)
