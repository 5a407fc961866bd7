"""The fine-tune cell's training pairs, made by the benchmark from the
seed: two views each of a bumpy textured wall with a red square that
moves between them, ray-traced on the host, with the exact pointmaps,
validity, view 1's pose and the square as the dynamic mask.

A copy of the port's ``predictor/datasets.py::WallTwoViewDataset`` (with
``data/synthetic.py::render_wall_view`` and ``datasets.depth_to_world_pts``,
``imgnorm``), kept here so that the traffic stays fixed whatever the
program's copy becomes: the same seed and index give the same arrays,
value for value.
"""
from __future__ import annotations

import numpy as np

DYN_COLOR = np.asarray([0.95, 0.2, 0.1], np.float32)
DYN_DEPTH = 2.5


def _wall_z(x, y):
    return 5.0 + 0.5 * np.sin(1.1 * x) + 0.3 * np.sin(1.7 * y)


def _wall_color(x, y):
    r = 0.5 + 0.25 * np.sin(2.1 * x + 0.3) + 0.15 * np.sin(5.3 * y)
    g = 0.5 + 0.25 * np.sin(1.7 * y + 1.1) + 0.15 * np.sin(4.1 * (x + y))
    b = 0.5 + 0.25 * np.sin(2.9 * (x - y)) + 0.15 * np.cos(3.7 * x)
    return np.clip(np.stack([r, g, b], -1), 0.05, 0.95).astype(np.float32)


def _render(cam_t, height: int, width: int, focal: float, square_xy,
            square_size: int):
    """One view from a translated camera (identity rotation): image
    [H, W, 3] in [0, 1], depth [H, W], the square's mask [H, W]."""
    gx, gy = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
    dirx = (gx - width / 2) / focal
    diry = (gy - height / 2) / focal
    tx, ty, tz = cam_t
    z = np.full((height, width), 5.0)
    for _ in range(25):
        z = _wall_z(tx + z * dirx, ty + z * diry) - tz
    img = _wall_color(tx + z * dirx, ty + z * diry)
    depth = z.astype(np.float32)
    dyn = np.zeros((height, width), np.float32)
    x0, y0 = square_xy
    dyn[y0:y0 + square_size, x0:x0 + square_size] = 1.0
    img = np.where(dyn[..., None] > 0, DYN_COLOR, img)
    depth = np.where(dyn > 0, DYN_DEPTH, depth).astype(np.float32)
    return img, depth, dyn


def _world(depth, K, c2w, z_far=80.0):
    h, w = depth.shape
    xx, yy = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    z = depth
    x = z * (xx - K[0, 2]) / K[0, 0]
    y = z * (yy - K[1, 2]) / K[1, 1]
    world = np.stack([x, y, z], -1) @ c2w[:3, :3].T + c2w[:3, 3]
    valid = (z > 0) & (z < z_far) & np.isfinite(world).all(-1)
    return world.astype(np.float32), valid


def _imgnorm(img):
    x = (img * 255).astype(np.uint8).astype(np.float32) / 255.0
    return ((x - 0.5) / 0.5).transpose(2, 0, 1)


def pair(seed: int, index: int, width: int, height: int) -> dict:
    """Pair ``index`` of the seed's set: the fields of
    ``reference/stage1_finetune.FIELDS``."""
    rng = np.random.default_rng(seed * 100003 + index)
    focal = 0.9 * width
    K = np.asarray([[focal, 0, width / 2], [0, focal, height / 2],
                    [0, 0, 1.0]])
    t1 = rng.normal(0, 0.15, 3)
    t2 = t1 + rng.normal(0, 0.08, 3)
    c2w1 = np.eye(4, dtype=np.float32)
    c2w1[:3, 3] = t1
    c2w2 = np.eye(4, dtype=np.float32)
    c2w2[:3, 3] = t2
    out = {"camera_pose_1": c2w1}
    for v, t, c2w in (("1", t1, c2w1), ("2", t2, c2w2)):
        sz = max(4, int(height * rng.uniform(0.15, 0.3)))
        x0 = int(rng.uniform(0, width - sz))
        y0 = int(rng.uniform(0, height - sz))
        img, depth, dyn = _render(t, height, width, focal, (x0, y0), sz)
        out[f"img{v}"] = _imgnorm(img)
        out[f"gt_pts3d_{v}"], out[f"valid_{v}"] = _world(depth, K, c2w)
        out[f"gt_mask_{v}"] = dyn
    return out
