"""Scene visualization exports — the SceneViz/viz_demo role (reference
dynamic_predictor/dust3r/viz.py, utils/viz_demo.py) using PLY point clouds
(trimesh/glb is not available in this image) plus colormapped map dumps
(the reference's jet-colormap depth pngs, base_opt.py:411-425).

Port of ``das3r_tpu/eval/viz.py``: the same numpy code, on the port's
``data/ply.py``.
"""
from __future__ import annotations

import os

import numpy as np

from das3r_tpu_torch.data import ply as ply_io


def export_scene_pointcloud(path: str, pts3d: np.ndarray,
                            colors01: np.ndarray,
                            conf: np.ndarray | None = None,
                            conf_thre: float = 0.0) -> int:
    """World-frame pointmaps [F, H, W, 3] + colors [F, H, W, 3] -> PLY.
    Optionally filter by confidence. Returns point count."""
    pts = pts3d.reshape(-1, 3)
    col = colors01.reshape(-1, 3)
    keep = np.isfinite(pts).all(-1)
    if conf is not None:
        keep &= conf.reshape(-1) > conf_thre
    pts = pts[keep]
    col = (np.clip(col[keep], 0, 1) * 255).astype(np.uint8)
    ply_io.write_point_cloud(path, pts.astype(np.float32), col)
    return int(pts.shape[0])


def export_camera_trajectory(path: str, poses_c2w: np.ndarray,
                             scale: float = 0.05) -> None:
    """Camera frusta as colored points: center (white), +z apex (red),
    rainbow ordering along the trajectory."""
    F = poses_c2w.shape[0]
    pts, cols = [], []
    for i, m in enumerate(poses_c2w):
        c = m[:3, 3]
        z = m[:3, 2]
        hue = i / max(F - 1, 1)
        base = np.asarray([255 * hue, 80, 255 * (1 - hue)])
        pts += [c, c + scale * z]
        cols += [base, [255, 0, 0]]
    ply_io.write_point_cloud(path, np.asarray(pts, np.float32),
                             np.asarray(cols, np.uint8))


def colormap_jet(x: np.ndarray) -> np.ndarray:
    """[H, W] scalars -> [H, W, 3] uint8 jet colormap (matplotlib-free to
    keep the hot path dependency-light; piecewise-linear jet)."""
    v = x.astype(np.float64)
    lo, hi = np.nanmin(v), np.nanmax(v)
    t = (v - lo) / max(hi - lo, 1e-12)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


UNKNOWN_FLOW_THRESH = 1e7


def _flow_color_wheel() -> np.ndarray:
    """The 55-color Middlebury wheel (flow_vis.make_color_wheel): six hue
    arcs RY/YG/GC/CB/BM/MR with 15/6/4/11/13/6 steps."""
    arcs = [(15, [255, 0, 0], [255, 255, 0]),
            (6, [255, 255, 0], [0, 255, 0]),
            (4, [0, 255, 0], [0, 255, 255]),
            (11, [0, 255, 255], [0, 0, 255]),
            (13, [0, 0, 255], [255, 0, 255]),
            (6, [255, 0, 255], [255, 0, 0])]
    rows = []
    for n, a, b in arcs:
        t = np.arange(n)[:, None] / n
        rows.append(np.floor((1 - t) * np.asarray(a) + t * np.asarray(b)))
    return np.concatenate(rows, 0)          # [55, 3]


def flow_to_image(flow: np.ndarray, maxrad: float | None = None
                  ) -> np.ndarray:
    """[H, W, 2] optical flow -> [H, W, 3] uint8 Middlebury color code
    (reference dust3r/utils/flow_vis.py:41-132, vectorized: hue = flow
    angle along the color wheel, saturation = radius / maxrad; unknown
    (>1e7) flow renders black)."""
    u = flow[..., 0].astype(np.float64).copy()
    v = flow[..., 1].astype(np.float64).copy()
    unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) | \
        (np.abs(v) > UNKNOWN_FLOW_THRESH) | ~np.isfinite(u) | ~np.isfinite(v)
    u[unknown] = 0.0
    v[unknown] = 0.0
    if maxrad is None:
        maxrad = max(-1.0, float(np.max(np.sqrt(u * u + v * v))))
    u = u / (maxrad + np.finfo(float).eps)
    v = v / (maxrad + np.finfo(float).eps)

    wheel = _flow_color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u * u + v * v)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1) + 1
    k0 = np.floor(fk).astype(int)
    k1 = np.where(k0 + 1 == ncols + 1, 1, k0 + 1)
    f = fk - k0
    col = (1 - f[..., None]) * wheel[k0 - 1] / 255 \
        + f[..., None] * wheel[k1 - 1] / 255
    inside = rad <= 1
    col = np.where(inside[..., None], 1 - rad[..., None] * (1 - col),
                   col * 0.75)
    img = np.floor(255 * col * ~unknown[..., None]).astype(np.uint8)
    img[(u == 0) & (v == 0)] = 0
    return img


def mask_overlay(image01: np.ndarray, mask: np.ndarray,
                 color=(0.12, 0.56, 0.90), alpha: float = 0.6
                 ) -> np.ndarray:
    """Blend a [H, W] mask over an RGB image [H, W, 3] in [0,1] -> uint8
    (the show_mask tab10-blue overlay of dust3r/utils/image.py:285-294)."""
    m = np.clip(mask.astype(np.float64), 0, 1)[..., None]
    out = image01 * (1 - alpha * m) + np.asarray(color) * alpha * m
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def save_mask_overlay_gif(folder: str, img_format: str = "frame_*.png",
                          mask_format: str = "dynamic_mask_*.png",
                          output_name: str = "_overlaied.gif") -> str:
    """Per-frame mask-over-image blend -> animated GIF in ``folder``
    (get_overlaied_gif, dust3r/utils/image.py:296-323 — matplotlib-free)."""
    import glob as globmod

    from PIL import Image
    imgs = sorted(globmod.glob(os.path.join(folder, img_format)))
    masks = sorted(globmod.glob(os.path.join(folder, mask_format)),
                   key=lambda x: int(x.split("_")[-1].split(".")[0]))
    assert len(imgs) == len(masks), (len(imgs), len(masks))
    frames = []
    for ip, mp in zip(imgs, masks):
        img = np.asarray(Image.open(ip).convert("RGB"), np.float64) / 255
        mask = np.asarray(Image.open(mp).convert("L"), np.float64) / 255
        frames.append(Image.fromarray(mask_overlay(img, mask)))
    out = os.path.join(folder, output_name)
    frames[0].save(out, save_all=True, append_images=frames[1:],
                   duration=100, loop=0)
    return out


def save_depth_visualizations(out_dir: str, depths: np.ndarray) -> None:
    """Colormapped depth pngs + an animated gif (save_depth_maps,
    base_opt.py:411-425)."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    frames = []
    for i, d in enumerate(depths):
        img = Image.fromarray(colormap_jet(d))
        img.save(os.path.join(out_dir, f"depth_{i:04d}.png"))
        frames.append(img)
    if frames:
        frames[0].save(os.path.join(out_dir, "_depth_maps.gif"),
                       save_all=True, append_images=frames[1:],
                       duration=100, loop=0)
