"""Differentiable quaternion / rigid-transform math in torch.

Conventions as in ``das3r_tpu/utils/quat.py``: quaternions are (w, x, y, z)
and not normalized in storage; a camera pose tensor is
``[qw qx qy qz tx ty tz]`` mapping world to camera as
``X_cam = R(q) @ X_world + t``.
"""
from __future__ import annotations

import torch

from das3r_tpu_torch.utils import trace

_EPS = 1e-12


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(_EPS)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation (normalize first)."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions (broadcasts over leading dims)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        -1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4)."""
    return torch.einsum("...ij,...j->...i", quat_to_rotmat(q), v)


def se3_inverse(m: torch.Tensor) -> torch.Tensor:
    """Invert (..., 4, 4) rigid transform(s) without a linear solve."""
    rt = m[..., :3, :3].transpose(-1, -2)
    t = -(rt @ m[..., :3, 3:])
    bottom = torch.zeros_like(m[..., 3:, :])
    bottom[..., 3] = 1.0
    return torch.cat([torch.cat([rt, t], -1), bottom], -2)


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at 0 (double where)."""
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, torch.sqrt(safe), torch.zeros_like(x))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 4) wxyz quaternion (pytorch3d's
    branch-robust 4-candidate selection)."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.flatten(-2).unbind(-1)
    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], -1))
    cand = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], -2)
    cand = cand / (2.0 * q_abs[..., None].clamp_min(0.1))
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    return torch.gather(cand, -2, idx).squeeze(-2)


def pose_to_w2c(pose: torch.Tensor) -> torch.Tensor:
    """[..., 7] (wxyz quat + t) -> (..., 4, 4) world-to-camera matrix,
    differentiable w.r.t. the pose tensor."""
    q, t = pose[..., :4], pose[..., 4:7]
    top = torch.cat([quat_to_rotmat(q), t[..., :, None]], -1)
    with trace.sync("pose_row_to_device"):
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=pose.dtype,
                              device=pose.device)
    bottom = bottom.expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], -2)


def w2c_to_pose(w2c: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> [..., 7] quat + t."""
    return torch.cat([rotmat_to_quat(w2c[..., :3, :3]), w2c[..., :3, 3]], -1)
