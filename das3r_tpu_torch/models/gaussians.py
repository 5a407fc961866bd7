"""Gaussian scene state: the parameter groups of
``das3r_tpu/models/gaussians.py`` as dataclasses of tensors.

  * ``GaussianParams``: the main Adam group (Gaussian attributes and the
    learnable per-frame, per-pixel static confidence ``conf_static``);
  * ``PoseParams``: per-frame quaternion / translation stacks and the FoV;
  * ``TestPoseParams``: held-out test-frame poses;
  * ``GaussianMeta``: capacity alive-mask, per-Gaussian source-pixel ids and
    densification statistics.

Arrays keep the JAX package's capacity-padded layout: dead slots carry
identity quaternions and an opacity logit of -1e4. ``init_from_frames``
and ``init_from_point_cloud`` select the points in numpy, as the JAX
package does, and run the k-NN scale init on the device they are given.

The ``*_from_numpy`` functions take the JAX package's state (its
NamedTuples' fields as numpy arrays) into the port's types, so that a test
can start both packages from one state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from das3r_tpu_torch.ops.knn import knn_mean_sq_dist
from das3r_tpu_torch.utils import sh as sh_lib
from das3r_tpu_torch.utils.device import on_device, resolve_device
from das3r_tpu_torch.utils.quat import w2c_to_pose


@dataclasses.dataclass
class GaussianParams:
    """Learnable Gaussian attributes, capacity-padded to [Nc, ...]."""
    xyz: torch.Tensor            # [Nc, 3]
    features_dc: torch.Tensor    # [Nc, 1, 3]
    features_rest: torch.Tensor  # [Nc, K-1, 3]
    scaling: torch.Tensor        # [Nc, 3] log-scale
    rotation: torch.Tensor       # [Nc, 4] wxyz (unnormalized storage)
    opacity: torch.Tensor        # [Nc, 1] logit
    conf_static: torch.Tensor    # [F, H, W] learnable staticness per pixel


@dataclasses.dataclass
class PoseParams:
    """Per-frame learnable camera parameters (the separate Adam group)."""
    Q: torch.Tensor     # [F, 4]
    T: torch.Tensor     # [F, 3]
    fovx: torch.Tensor  # []
    fovy: torch.Tensor  # []

    def pose(self, uid) -> torch.Tensor:
        """[7] wxyz+t pose tensor for frame ``uid``."""
        return torch.cat([self.Q[uid], self.T[uid]])

    def all_poses(self) -> torch.Tensor:
        return torch.cat([self.Q, self.T], -1)


@dataclasses.dataclass
class TestPoseParams:
    """Held-out test-frame poses (optimised alone at test time)."""
    Q: torch.Tensor     # [Ft, 4]
    T: torch.Tensor     # [Ft, 3]

    def pose(self, uid) -> torch.Tensor:
        return torch.cat([self.Q[uid], self.T[uid]])


@dataclasses.dataclass
class GaussianMeta:
    """Non-learnable per-Gaussian state (same capacity Nc)."""
    alive: torch.Tensor           # [Nc] bool
    pix_id: torch.Tensor          # [Nc] int64 flat (frame*H*W + pixel) id
    max_radii2d: torch.Tensor     # [Nc] float
    xyz_grad_accum: torch.Tensor  # [Nc] float
    denom: torch.Tensor           # [Nc] float


@dataclasses.dataclass(frozen=True)
class GaussianScene:
    """Static scene description shared by train/render code."""
    max_sh_degree: int
    n_frames: int
    height: int
    width: int
    capacity: int
    spatial_lr_scale: float = 1.0


def activated_scaling(params: GaussianParams) -> torch.Tensor:
    return torch.exp(params.scaling)


def activated_opacity(params: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(params.opacity)


def per_gaussian_conf(params: GaussianParams,
                      meta: GaussianMeta) -> torch.Tensor:
    """Gather the learnable per-pixel staticness onto each Gaussian
    (``_conf_static.reshape(-1, 1)[aggregated_mask]`` of the reference)."""
    return params.conf_static.reshape(-1)[meta.pix_id]


def num_rest_coeffs(max_sh_degree: int) -> int:
    return (max_sh_degree + 1) ** 2 - 1


def _round_capacity(n: int, granularity: int = 4096) -> int:
    return max(granularity, -(-n // granularity) * granularity)


def _logit(p: float) -> float:
    return float(np.log(p / (1 - p)))


def _padded_state(pts, colors, opacity_logit, pix_id, conf_static,
                  max_sh_degree, cap, dev):
    """Capacity-padded (GaussianParams, GaussianMeta) on ``dev`` from the
    live points (numpy): SH-DC from the colours, log-scales from the 3-NN
    mean distance (computed on ``dev``), identity rotations everywhere and
    opacity -1e4 in the dead slots, so they are never binned."""
    n = pts.shape[0]
    xyz = torch.as_tensor(np.ascontiguousarray(pts, np.float32), device=dev)
    dist2 = torch.clamp_min(knn_mean_sq_dist(xyz, k=3), 1e-7)
    scales_live = torch.log(torch.sqrt(dist2))[:, None].expand(n, 3)

    def pad(x, fill=0.0):
        x = torch.as_tensor(x, device=dev)
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=dev)
        out[:n] = x
        return out

    f_dc = sh_lib.rgb_to_sh(np.asarray(colors, np.float32))[:, None, :]
    params = GaussianParams(
        xyz=pad(xyz),
        features_dc=pad(np.ascontiguousarray(f_dc, np.float32)),
        features_rest=torch.zeros(cap, num_rest_coeffs(max_sh_degree), 3,
                                  device=dev),
        scaling=pad(scales_live),
        # identity quaternions EVERYWHERE, dead slots included: a zero
        # quaternion has a NaN normalize-gradient
        rotation=torch.tensor([1.0, 0.0, 0.0, 0.0],
                              device=dev).repeat(cap, 1),
        opacity=pad(np.full((n, 1), opacity_logit, np.float32), fill=-1e4),
        conf_static=torch.as_tensor(np.ascontiguousarray(
            conf_static, np.float32), device=dev))
    meta = GaussianMeta(
        alive=pad(torch.ones(n, dtype=torch.bool, device=dev), fill=False),
        # dead slots point at pixel 0; their opacity is 0, so the gathered
        # conf never matters
        pix_id=pad(torch.as_tensor(pix_id, dtype=torch.int64, device=dev)),
        max_radii2d=torch.zeros(cap, device=dev),
        xyz_grad_accum=torch.zeros(cap, device=dev),
        denom=torch.zeros(cap, device=dev))
    return params, meta


def init_from_frames(
    images: np.ndarray,        # [F, 3, H, W] in [0, 1]
    depths: np.ndarray,        # [F, H, W]
    confs: np.ndarray,         # [F, H, W] log-confidence from stage 1
    dyna_avg: np.ndarray,      # [F, H, W] dynamic-ness in [0, 1]
    poses_c2w: np.ndarray,     # [F, 4, 4]
    focals: np.ndarray,        # [F]
    max_sh_degree: int = 3,
    conf_thre: float = 1.0,
    capacity: int | None = None,
    spatial_lr_scale: float = 1.0,
    max_points: int | None = 1_500_000,
    device=None,
):
    """Scene init from stage-1 frames (``create_from_cameras``, reference
    gaussian_model.py:573-659) on ``device`` (default CUDA; a RuntimeError
    without it). Returns (GaussianParams, GaussianMeta, GaussianScene).

    Unprojects every frame's depth with per-frame intrinsics and stage-1
    poses, keeps pixels whose confidence exceeds ``log(conf_thre)`` (at
    most ``max_points``, the highest-confidence ones), sets scales from the
    3-NN mean distance and opacity to 1/n_frames. The selection is numpy,
    as in the JAX package; the result is padded to ``capacity``.
    """
    dev = resolve_device(device)
    F, _, H, W = images.shape
    # the reference uses W/2, H/2 whatever the stored principal point
    pp = np.asarray([W / 2.0, H / 2.0], np.float32)
    gx, gy = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    grid = np.stack([gx, gy], -1).astype(np.float32)          # [H, W, 2]
    pts_world = np.empty((F, H, W, 3), np.float32)
    for f in range(F):
        z = depths[f][..., None]
        xy = z * (grid - pp) / focals[f]
        cam = np.concatenate([xy, z], -1)
        R, t = poses_c2w[f, :3, :3], poses_c2w[f, :3, 3]
        pts_world[f] = cam @ R.T + t

    mask = confs.reshape(-1) > np.log(conf_thre)
    if max_points and int(mask.sum()) > max_points:
        # keep the max_points highest-confidence pixels (the reference
        # keeps every passing pixel; disable with max_points=None/0)
        flat = confs.reshape(-1)
        thresh = np.partition(np.where(mask, flat, -np.inf),
                              -max_points)[-max_points]
        mask = mask & (flat >= thresh)
        extra = int(mask.sum()) - max_points      # exact cap on ties
        if extra > 0:
            ties = np.where(mask & (flat == thresh))[0]
            mask[ties[:extra]] = False
    pix_id = np.nonzero(mask)[0]
    n = pix_id.size
    pts = pts_world.reshape(-1, 3)[mask]
    colors = images.transpose(0, 2, 3, 1).reshape(-1, 3)[mask]
    cap = capacity or _round_capacity(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < live points {n}")
    params, meta = _padded_state(pts, colors, _logit(1.0 / F), pix_id,
                                 1.0 - dyna_avg.astype(np.float32),
                                 max_sh_degree, cap, dev)
    scene = GaussianScene(max_sh_degree=max_sh_degree, n_frames=F, height=H,
                          width=W, capacity=cap,
                          spatial_lr_scale=spatial_lr_scale)
    return params, meta, scene


def init_from_point_cloud(
    points: np.ndarray,           # [N, 3]
    colors: np.ndarray,           # [N, 3] in [0, 1]
    max_sh_degree: int = 3,
    capacity: int | None = None,
    spatial_lr_scale: float = 1.0,
    n_frames: int = 1,
    height: int = 1,
    width: int = 1,
    device=None,
):
    """Classic 3DGS init from a sparse point cloud (``create_from_pcd``,
    reference gaussian_model.py:203-226) on ``device`` (default CUDA):
    opacity 0.1 and ``conf_static`` all ones (fully static)."""
    dev = resolve_device(device)
    n = points.shape[0]
    cap = capacity or _round_capacity(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < live points {n}")
    params, meta = _padded_state(
        np.asarray(points, np.float32), colors, _logit(0.1),
        np.zeros(n, np.int64), np.ones((n_frames, height, width), np.float32),
        max_sh_degree, cap, dev)
    scene = GaussianScene(max_sh_degree=max_sh_degree, n_frames=n_frames,
                          height=height, width=width, capacity=cap,
                          spatial_lr_scale=spatial_lr_scale)
    return params, meta, scene


def init_pose_params(poses_w2c: np.ndarray, fovx: float, fovy: float,
                     device=None) -> PoseParams:
    """Per-frame pose stacks from stage-1 world-to-camera matrices
    (init_RT_seq + init_fov, reference :149-166), on ``device`` (default
    CUDA; a RuntimeError without it)."""
    dev = resolve_device(device)
    pose7 = w2c_to_pose(on_device(poses_w2c, dev, torch.float32))
    return PoseParams(Q=pose7[:, :4].contiguous(),
                      T=pose7[:, 4:].contiguous(),
                      fovx=torch.tensor(fovx, dtype=torch.float32,
                                        device=dev),
                      fovy=torch.tensor(fovy, dtype=torch.float32,
                                        device=dev))


def init_test_pose_params(poses_w2c: np.ndarray,
                          device=None) -> TestPoseParams:
    dev = resolve_device(device)
    pose7 = w2c_to_pose(on_device(poses_w2c, dev, torch.float32))
    return TestPoseParams(Q=pose7[:, :4].contiguous(),
                          T=pose7[:, 4:].contiguous())


def _group_from_numpy(cls, arrays: dict, device):
    return cls(**{f.name: on_device(np.asarray(arrays[f.name]), device,
                                    torch.float32)
                  for f in dataclasses.fields(cls)})


def poses_from_numpy(poses: dict[str, np.ndarray], device) -> PoseParams:
    """The JAX package's ``PoseParams`` fields (numpy) -> the port's."""
    return _group_from_numpy(PoseParams, poses, device)


def test_poses_from_numpy(poses: dict[str, np.ndarray],
                          device) -> TestPoseParams:
    """The JAX package's ``TestPoseParams`` fields (numpy) -> the port's."""
    return _group_from_numpy(TestPoseParams, poses, device)


def adam_state_from_numpy(count, mu: dict[str, np.ndarray],
                          nu: dict[str, np.ndarray], group, device):
    """The JAX package's ``AdamState`` (its count and the fields of its
    moments, as numpy) -> the port's ``train.optim.AdamState`` for the
    parameter group ``group`` (``GaussianParams``, ``PoseParams`` or
    ``TestPoseParams``)."""
    from das3r_tpu_torch.train.optim import AdamState
    return AdamState(
        count=on_device(np.asarray(count, np.int32), device, torch.int32),
        mu=_group_from_numpy(group, mu, device),
        nu=_group_from_numpy(group, nu, device))


def params_from_numpy(params: dict[str, np.ndarray],
                      meta: dict[str, np.ndarray],
                      device) -> tuple[GaussianParams, GaussianMeta]:
    """The JAX package's ``GaussianParams`` / ``GaussianMeta`` fields (as
    numpy arrays, e.g. ``{k: np.asarray(v) for k, v in p._asdict().items()}``)
    -> the port's types on ``device``."""
    def t(x, dtype=None):
        return on_device(np.asarray(x), device, dtype)

    gp = GaussianParams(**{f.name: t(params[f.name], torch.float32)
                           for f in dataclasses.fields(GaussianParams)})
    gm = GaussianMeta(
        alive=t(meta["alive"], torch.bool),
        pix_id=t(meta["pix_id"], torch.int64),
        max_radii2d=t(meta["max_radii2d"], torch.float32),
        xyz_grad_accum=t(meta["xyz_grad_accum"], torch.float32),
        denom=t(meta["denom"], torch.float32))
    return gp, gm
