"""The stage-2 scene of a splat configuration, made from the seed on the
device: a textured wall seen by a hand-held camera over ``frames``
frames, with a pixel-aligned dense init of at most ``max_points``
Gaussians drawn from the train frames' most confident pixels, the
frames' ground-truth images and a moving dynamic region in the static
confidence.

Every seed gives the same sizes (frames, pixels, Gaussians) and the same
geometry class; the seed draws the texture, the camera's path, the
confidences, the dynamic region's track and the Gaussians' residual
attributes. Everything is made in a few large calls with one
``torch.Generator`` on the device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

SH_C0 = 0.28209479177387814


class Scene(NamedTuple):
    params: dict           # GaussianParams fields: xyz, features_dc, ...
    pix_id: torch.Tensor   # [N] int64 train-frame * H * W + pixel
    poses: torch.Tensor    # [F_train, 7] world-to-camera (wxyz, t)
    centers: torch.Tensor  # [F_train, 3] camera centres in the world
    gt: torch.Tensor       # [F_train, 3, H, W] ground-truth images
    fovx: float
    fovy: float
    focus: torch.Tensor    # [3] the point the cameras look at
    spatial_lr_scale: float
    height: int
    width: int


def train_frames(cfg: dict) -> list[int]:
    """DAS3R's evaluation split: frame i is held out when
    ``(i + test_offset) % test_every == 0``."""
    return [i for i in range(cfg["frames"])
            if (i + cfg["test_offset"]) % cfg["test_every"] != 0]


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """[F, 3, 3] rotations near the identity -> [F, 4] wxyz."""
    w = torch.sqrt(torch.clamp_min(1.0 + m[:, 0, 0] + m[:, 1, 1]
                                   + m[:, 2, 2], 1e-12)) * 0.5
    return torch.stack([w, (m[:, 2, 1] - m[:, 1, 2]) / (4 * w),
                        (m[:, 0, 2] - m[:, 2, 0]) / (4 * w),
                        (m[:, 1, 0] - m[:, 0, 1]) / (4 * w)], -1)


def euler(yaw: torch.Tensor, pitch: torch.Tensor) -> torch.Tensor:
    """Camera-to-world rotations [F, 3, 3]: yaw about y, then pitch
    about x (OpenCV axes: x right, y down, z forward)."""
    cy, sy, cp, sp = yaw.cos(), yaw.sin(), pitch.cos(), pitch.sin()
    o, z = torch.ones_like(yaw), torch.zeros_like(yaw)
    ry = torch.stack([torch.stack([cy, z, sy], -1),
                      torch.stack([z, o, z], -1),
                      torch.stack([-sy, z, cy], -1)], -2)
    rx = torch.stack([torch.stack([o, z, z], -1),
                      torch.stack([z, cp, -sp], -1),
                      torch.stack([z, sp, cp], -1)], -2)
    return ry @ rx


def texture(p: torch.Tensor, freq: torch.Tensor,
            phase: torch.Tensor) -> torch.Tensor:
    """RGB in [0.15, 0.85] at world points p [..., 3]: per channel, a
    product of two low-frequency waves along the wall."""
    x, y = p[..., 0:1], p[..., 1:2]
    return 0.5 + 0.35 * torch.sin(freq[:, 0] * x + phase[:, 0]) \
        * torch.cos(freq[:, 1] * y + phase[:, 1])


def make_scene(cfg: dict, seed: int, device) -> Scene:
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    H, W = cfg["height"], cfg["width"]
    frames = train_frames(cfg)
    F = len(frames)
    fovx = math.radians(cfg["fovx_deg"])
    focal = W / (2.0 * math.tan(fovx / 2))
    fovy = 2.0 * math.atan(H / (2.0 * focal))
    wall = cfg["wall"]                         # z = depth + tilt * x

    # a hand-held pan: x sweeps the travel, y and z wobble; yaw follows
    u = torch.linspace(-1.0, 1.0, cfg["frames"], device=dev)[frames]
    wob = rand(4) * 2 * math.pi
    travel = cfg["camera_travel"]
    centers = torch.stack([
        travel * u,
        0.05 * travel * torch.sin(3 * u + wob[0]),
        0.05 * travel * torch.sin(2 * u + wob[1])], -1)
    yaw = math.radians(cfg["camera_yaw_deg"]) * (-u + 0.2 * torch.sin(
        5 * u + wob[2]))
    pitch = math.radians(cfg["camera_pitch_deg"]) * torch.sin(4 * u + wob[3])
    c2w = euler(yaw, pitch)                                  # [F, 3, 3]
    w2c = c2w.transpose(1, 2)
    t = -(w2c @ centers[:, :, None])[:, :, 0]
    poses = torch.cat([rotmat_to_quat(w2c), t], -1)

    freq = (rand(3, 2) * 1.5 + 0.5) * 2 * math.pi / wall["width"]
    phase = rand(3, 2) * 2 * math.pi

    # rays of every train pixel hit the wall: points, depths, colours
    v, uu = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                           torch.arange(W, device=dev, dtype=torch.float32),
                           indexing="ij")
    d_cam = torch.stack([(uu - W / 2.0) / focal, (v - H / 2.0) / focal,
                         torch.ones_like(uu)], -1)           # [H, W, 3]

    def hit(f_idx: torch.Tensor, pix: torch.Tensor):
        d = d_cam.reshape(-1, 3)[pix]
        dw = (c2w[f_idx] @ d[:, :, None])[:, :, 0]
        c = centers[f_idx]
        s = (wall["depth"] + wall["tilt"] * c[:, 0] - c[:, 2]) / (
            dw[:, 2] - wall["tilt"] * dw[:, 0])
        return c + s[:, None] * dw, s

    n_pix = F * H * W
    conf = rand(n_pix)
    n = min(cfg["max_points"], n_pix)
    pick = torch.topk(conf, n, sorted=False).indices
    pick = torch.sort(pick).values
    f_idx, pix = pick // (H * W), pick % (H * W)
    xyz, depth = hit(f_idx, pix)

    gt = torch.empty(F, 3, H, W, device=dev)
    all_pix = torch.arange(H * W, device=dev)
    for f in range(F):
        p, _ = hit(torch.full_like(all_pix, f), all_pix)
        gt[f] = texture(p, freq, phase).T.reshape(3, H, W)

    # Gaussians: one pixel's footprint at its depth, jittered per axis
    a = cfg["attributes"]
    jit = torch.exp((rand(n, 3) * 2 - 1) * a["scale_jitter"])
    scaling = torch.log(depth / focal)[:, None] + torch.log(jit)
    q = torch.randn(n, 4, generator=gen, device=dev)
    rotation = q / q.norm(dim=-1, keepdim=True)
    lo, hi = a["opacity_range"]
    opac = lo + (hi - lo) * rand(n, 1)
    rgb = texture(xyz, freq, phase)
    k = (cfg["sh_degree"] + 1) ** 2 - 1
    params = dict(
        xyz=xyz.contiguous(),
        features_dc=((rgb - 0.5) / SH_C0)[:, None, :].contiguous(),
        features_rest=(torch.randn(n, k, 3, generator=gen, device=dev)
                       * a["sh_rest_std"]),
        scaling=scaling.contiguous(),
        rotation=rotation.contiguous(),
        opacity=torch.log(opac / (1 - opac)),
        conf_static=_static_confidence(cfg, F, H, W, rand, dev))
    radius = float((centers - centers.mean(0)).norm(dim=-1).max()) * 1.1
    focus = centers.mean(0) + torch.tensor(
        [0.0, 0.0, wall["depth"]], device=dev)
    return Scene(params=params, pix_id=pick, poses=poses.contiguous(),
                 centers=centers, gt=gt, fovx=fovx, fovy=fovy, focus=focus,
                 spatial_lr_scale=radius, height=H, width=W)


def _static_confidence(cfg, F, H, W, rand, dev):
    """[F, H, W] static confidence: 1 but for a moving dynamic region,
    a soft disc whose centre crosses the frame over the clip."""
    d = cfg["dynamic_region"]
    start, end = rand(2) * torch.tensor([W, H], device=dev), \
        rand(2) * torch.tensor([W, H], device=dev)
    s = torch.linspace(0, 1, F, device=dev)[:, None]
    ctr = start * (1 - s) + end * s                         # [F, 2]
    v, u = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                          torch.arange(W, device=dev, dtype=torch.float32),
                          indexing="ij")
    r2 = ((u[None] - ctr[:, 0, None, None]) ** 2
          + (v[None] - ctr[:, 1, None, None]) ** 2)
    return 1.0 - d["depth"] * torch.exp(-r2 / (2 * d["radius_px"] ** 2))


def look_at(pos: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """[V, 7] world-to-camera poses at ``pos`` [V, 3] looking at
    ``target`` [3], world +y down (OpenCV)."""
    z = target - pos
    z = z / z.norm(dim=-1, keepdim=True)
    down = torch.tensor([0.0, 1.0, 0.0], device=pos.device).expand_as(z)
    x = torch.linalg.cross(down, z)
    x = x / x.norm(dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x)
    c2w = torch.stack([x, y, z], -1)
    w2c = c2w.transpose(1, 2)
    t = -(w2c @ pos[:, :, None])[:, :, 0]
    return torch.cat([rotmat_to_quat(w2c), t], -1)


def orbit(scene: Scene, views: int, widen: float) -> torch.Tensor:
    """[views, 7] novel views on an ellipse through the train cameras'
    plane: radii ``widen`` x the 90th percentile of their spread from
    their centroid (in y at least half that in x), every view looking at
    the scene's focus (mip-NeRF 360's ellipse path, at constant angular
    speed)."""
    c = scene.centers
    ctr = c.mean(0)
    radii = torch.quantile((c - ctr).abs(), 0.9, dim=0).clamp_min(1e-3)
    # a hand-held pan barely moves in y: give the ellipse half its width
    radii[1] = torch.maximum(radii[1], 0.5 * radii[0])
    th = torch.arange(views, device=c.device) * (2 * math.pi / views)
    pos = torch.stack([ctr[0] + widen * radii[0] * th.cos(),
                       ctr[1] + widen * radii[1] * th.sin(),
                       ctr[2].expand_as(th)], -1)
    return look_at(pos, scene.focus)
