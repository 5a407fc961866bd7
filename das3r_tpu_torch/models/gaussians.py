"""Gaussian scene state: the parameter groups of
``das3r_tpu/models/gaussians.py`` as dataclasses of tensors.

  * ``GaussianParams``: the main Adam group (Gaussian attributes and the
    learnable per-frame, per-pixel static confidence ``conf_static``);
  * ``PoseParams``: per-frame quaternion / translation stacks and the FoV;
  * ``TestPoseParams``: held-out test-frame poses;
  * ``GaussianMeta``: capacity alive-mask, per-Gaussian source-pixel ids and
    densification statistics.

Arrays keep the JAX package's capacity-padded layout: dead slots carry
opacity 0 and identity quaternions. Initialisation from frames needs the
k-NN op and comes with the trainer (ROADMAP.md).

The ``*_from_numpy`` functions take the JAX package's state (its
NamedTuples' fields as numpy arrays) into the port's types, so that a test
can start both packages from one state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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


def activated_scaling(params: GaussianParams) -> torch.Tensor:
    return torch.exp(params.scaling)


def activated_opacity(params: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(params.opacity)


def per_gaussian_conf(params: GaussianParams,
                      meta: GaussianMeta) -> torch.Tensor:
    """Gather the learnable per-pixel staticness onto each Gaussian
    (``_conf_static.reshape(-1, 1)[aggregated_mask]`` of the reference)."""
    return params.conf_static.reshape(-1)[meta.pix_id]


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
