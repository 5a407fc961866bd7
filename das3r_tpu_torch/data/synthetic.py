"""Synthetic stage-1 output generator and random scenes (port of
``das3r_tpu/data/synthetic.py``): test and bench fixtures.

Writes a directory in the exact flat layout the stage-1 runner produces
(see data/rearrange.py docstring) so the full bridge -> loader -> init ->
train pipeline can be exercised hermetically without DAVIS/Sintel data.

The scene is a textured fronto-parallel "wall" at varying depth with a
moving square (the dynamic object), seen from a slowly translating camera —
enough structure for reconstruction losses to be meaningful.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
from PIL import Image

from das3r_tpu_torch.data import trajectory


def random_gaussian_scene(n: int, cap: int | None = None, n_frames: int = 4,
                          height: int = 64, width: int = 64, seed: int = 0,
                          sh_degree: int = 3, device=None):
    """In-memory random Gaussian scene (params/meta/poses) for benches and
    kernel checks: Gaussians filling the frustum of an identity camera.
    Draws the same numbers as the JAX package's ``random_gaussian_scene``
    for the same seed. Tensors land on ``device`` (default CUDA; a
    RuntimeError without it)."""
    import torch

    from das3r_tpu_torch.models.gaussians import (GaussianMeta,
                                                  GaussianParams, PoseParams)
    from das3r_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cap = cap or n
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, f32)
        out[:n] = x
        return out

    def t(x):
        return torch.as_tensor(x, device=dev)

    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(2.5, 9.0, n)], -1).astype(f32)
    n_rest = (sh_degree + 1) ** 2 - 1
    params = GaussianParams(
        xyz=t(pad(means)),
        features_dc=t(pad(rng.normal(0, 0.4, (n, 1, 3)).astype(f32))),
        features_rest=t(np.zeros((cap, n_rest, 3), f32)),
        scaling=t(pad(rng.uniform(-4.5, -2.5, (n, 3)).astype(f32))),
        rotation=t(np.tile(np.asarray([1, 0, 0, 0], f32), (cap, 1))),
        opacity=t(pad(rng.uniform(-1.0, 2.0, (n, 1)).astype(f32),
                      fill=-1e4)),
        conf_static=t(np.ones((n_frames, height, width), f32)),
    )
    meta = GaussianMeta(
        alive=t(pad(np.ones(n, f32)) > 0),
        pix_id=t((np.arange(cap) % (n_frames * height * width))
                 .astype(np.int64)),
        max_radii2d=t(np.zeros(cap, f32)),
        xyz_grad_accum=t(np.zeros(cap, f32)),
        denom=t(np.zeros(cap, f32)))
    Q = np.tile(np.asarray([1, 0, 0, 0], f32), (n_frames, 1))
    Q += rng.normal(0, 0.01, Q.shape).astype(f32)
    T = rng.normal(0, 0.05, (n_frames, 3)).astype(f32)
    poses = PoseParams(Q=t(Q), T=t(T), fovx=t(np.asarray(1.0, f32)),
                       fovy=t(np.asarray(1.0, f32)))
    return params, meta, poses


def wall_z(x, y):
    """World-space wall surface z = 5 + 0.5 sin(1.1 x) + 0.3 sin(1.7 y)."""
    return 5.0 + 0.5 * np.sin(1.1 * x) + 0.3 * np.sin(1.7 * y)


def wall_color(x, y):
    """Smooth multi-octave world-space texture in [0.05, 0.95]."""
    r = 0.5 + 0.25 * np.sin(2.1 * x + 0.3) + 0.15 * np.sin(5.3 * y)
    g = 0.5 + 0.25 * np.sin(1.7 * y + 1.1) + 0.15 * np.sin(4.1 * (x + y))
    b = 0.5 + 0.25 * np.sin(2.9 * (x - y)) + 0.15 * np.cos(3.7 * x)
    return np.clip(np.stack([r, g, b], -1), 0.05, 0.95).astype(np.float32)


DYN_COLOR = np.asarray([0.95, 0.2, 0.1], np.float32)
DYN_DEPTH = 2.5


def render_wall_view(cam_t, height: int, width: int, focal: float,
                     square_xy=None, square_size: int | None = None):
    """Ray-trace one view of the wall world from a translated camera
    (identity rotation): returns (img [H, W, 3] float in [0,1],
    depth [H, W], dyn_mask [H, W]). ``square_xy`` places the red dynamic
    square (pixel coords of its top-left); None renders background only."""
    gx, gy = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
    dirx = (gx - width / 2) / focal
    diry = (gy - height / 2) / focal
    tx, ty, tz = cam_t
    # world point along the pixel ray is t + z * (dirx, diry, 1); solve
    # z = wall_z(...) by fixed point (gentle slopes, converges fast)
    z = np.full((height, width), 5.0)
    for _ in range(25):
        z = wall_z(tx + z * dirx, ty + z * diry) - tz
    img = wall_color(tx + z * dirx, ty + z * diry)
    depth = z.astype(np.float32)
    dyn = np.zeros((height, width), np.float32)
    if square_xy is not None:
        x0, y0 = square_xy
        sz = square_size if square_size is not None else height // 5
        dyn[y0:y0 + sz, x0:x0 + sz] = 1.0
        img = np.where(dyn[..., None] > 0, DYN_COLOR, img)
        depth = np.where(dyn > 0, DYN_DEPTH, depth).astype(np.float32)
    return img, depth, dyn


def make_synthetic_stage1_dir(
    out_dir: str,
    n_frames: int = 8,
    height: int = 64,
    width: int = 96,
    seed: int = 0,
) -> None:
    rng = np.random.default_rng(seed)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    focal = 0.9 * width
    K = np.zeros((n_frames, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = focal
    K[:, 0, 2] = width / 2
    K[:, 1, 2] = height / 2
    K[:, 2, 2] = 1.0
    np.savetxt(out / "pred_intrinsics.txt", K.reshape(n_frames, 9))

    # slowly translating camera looking down +z
    poses = np.tile(np.eye(4, dtype=np.float64), (n_frames, 1, 1))
    for f in range(n_frames):
        poses[f, 0, 3] = 0.02 * f
        poses[f, 1, 3] = -0.01 * f
    pos, quat = trajectory.c2w_to_tum(poses)
    trajectory.write_tum(str(out / "pred_traj.txt"), pos, quat)

    # Static background: a bumpy wall defined in WORLD space —
    # z = 5 + 0.5 sin(1.1 x) + 0.3 sin(1.7 y) — textured by a smooth
    # world-space color function. Each frame's image and depth come from
    # exact ray/surface intersection with the written pose+intrinsics, so
    # the multi-view supervision is subpixel-consistent (a perfect
    # reconstruction scores arbitrarily high PSNR; the old generator's
    # integer-shifted noise texture capped ANY method at ~17 dB).
    for f in range(n_frames):
        x0 = int(width * 0.1 + f * width * 0.08)
        y0 = int(height * 0.35)
        img, depth, dyn = render_wall_view(
            poses[f, :3, 3], height, width, focal, square_xy=(x0, y0))

        Image.fromarray((img * 255).astype(np.uint8)).save(
            out / f"frame_{f:04d}.png")
        np.save(out / f"frame_{f:04d}.npy", depth)
        # stage-1 confidence is exp-mode (>=1) and saved RAW; the stage-2
        # loader compares it against log(conf_thre) (reference quirk,
        # gaussian_model.py:624)
        conf = rng.uniform(1.5, 8.0, (height, width)).astype(np.float32)
        np.save(out / f"conf_{f:04d}.npy", conf)
        np.save(out / f"dyna_avg_{f:04d}.npy",
                (dyn * 0.9).astype(np.float32))
        np.save(out / f"dyna_max_{f:04d}.npy", dyn)
        Image.fromarray((dyn * 255).astype(np.uint8)).save(
            out / f"dynamic_mask_{f:04d}.png")
