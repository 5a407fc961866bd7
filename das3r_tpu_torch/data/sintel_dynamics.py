"""Sintel GT dynamic-label preprocessing (port of ``das3r_tpu/data/
sintel_dynamics.py``): mark pixels whose GT optical flow disagrees with
the ego-motion flow induced by GT depth + GT camera motion (reference
datasets_preprocess/sintel_get_dynamics.py:110-156, run with threshold
0.1 into ``dynamic_label_perfect`` per data/download_sintel.sh). The ego
flow is ``predictor/warping.py``'s, in float32 on the CPU.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from PIL import Image

from das3r_tpu_torch.eval.harness import (flo_read, sintel_cam_read,
                                          sintel_depth_read)
from das3r_tpu_torch.predictor import warping


def dynamic_label_from_gt(depth: np.ndarray, K: np.ndarray,
                          w2c_1: np.ndarray, w2c_2: np.ndarray,
                          gt_flow: np.ndarray,
                          threshold: float = 0.1) -> np.ndarray:
    """Per-pixel dynamic label: relative ego-flow error > threshold.

    depth [H, W] (frame 1), K [3,3], w2c_* [3,4] or [4,4] world-to-camera,
    gt_flow [H, W, 2] forward flow 1->2.
    """
    def c2w(m):
        full = np.eye(4)
        full[:3] = m[:3]
        return np.linalg.inv(full)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    c2w1 = c2w(w2c_1)
    c2w2 = c2w(w2c_2)
    disp = f32(1.0 / np.clip(depth, 1e-6, None))
    Kt = f32(K[None])
    ego, _ = warping.ego_flow_from_disp(
        f32(c2w1[None, :3, :3]), f32(c2w1[None, :3, 3:]),
        f32(c2w2[None, :3, :3]), f32(c2w2[None, :3, 3:]),
        disp[None, None], Kt, torch.linalg.inv(Kt))
    ego_xy = ego[0, :2].permute(1, 2, 0).numpy()           # [H, W, 2]

    err = np.linalg.norm(ego_xy - gt_flow, axis=-1)
    mag = np.linalg.norm(gt_flow, axis=-1) + 1e-6
    rel_err = err / np.maximum(mag, 1.0)
    return (rel_err > threshold).astype(np.float32)


def build_sintel_labels(sintel_root: str, save_dir: str,
                        threshold: float = 0.1, scenes=None) -> None:
    """Walk training/{depth,camdata_left,flow}/<scene> and write per-frame
    dynamic-label pngs into save_dir/<scene>/frame_XXXX.png."""
    root = Path(sintel_root) / "training"
    depth_root = root / "depth"
    cam_root = root / "camdata_left"
    flow_root = root / "flow"
    scenes = scenes or sorted(p.name for p in depth_root.iterdir()
                              if p.is_dir())
    for scene in scenes:
        out = Path(save_dir) / scene
        out.mkdir(parents=True, exist_ok=True)
        frames = sorted((depth_root / scene).glob("frame_*.dpt"))
        for dpt in frames[:-1]:
            fid = dpt.stem  # frame_XXXX
            depth = sintel_depth_read(str(dpt))
            K, N1 = sintel_cam_read(str(cam_root / scene / f"{fid}.cam"))
            nxt = f"frame_{int(fid.split('_')[1]) + 1:04d}"
            _, N2 = sintel_cam_read(str(cam_root / scene / f"{nxt}.cam"))
            flow = flo_read(str(flow_root / scene / f"{fid}.flo"))
            label = dynamic_label_from_gt(depth, K, N1, N2, flow,
                                          threshold)
            Image.fromarray((label * 255).astype(np.uint8)).save(
                out / f"{fid}.png")
