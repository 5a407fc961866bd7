"""Depth <-> pointmap geometry (port of ``das3r_tpu/utils/geometry.py``;
the reference's ``xy_grid`` / ``depthmap_to_pts3d``, dynamic_predictor/
dust3r/utils/geometry.py:15,114-226, and utils/pose_utils.py:572-683)."""
from __future__ import annotations

import torch


def xy_grid(w: int, h: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(H, W, 2) grid of pixel coordinates (x, y)."""
    gy, gx = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([gx, gy], -1)


def depthmap_to_camera_coords(depth: torch.Tensor,
                              K: torch.Tensor) -> torch.Tensor:
    """Unproject (..., H, W) depth with (..., 3, 3) intrinsics K ->
    (..., H, W, 3) camera-frame points (z = depth); zero skew."""
    h, w = depth.shape[-2:]
    grid = xy_grid(w, h, depth.dtype, depth.device)
    fu, fv = K[..., 0, 0, None, None], K[..., 1, 1, None, None]
    cu, cv = K[..., 0, 2, None, None], K[..., 1, 2, None, None]
    x = depth * (grid[..., 0] - cu) / fu
    y = depth * (grid[..., 1] - cv) / fv
    return torch.stack([x, y, depth], -1)


def depthmap_to_pts3d(depth: torch.Tensor, K: torch.Tensor,
                      c2w: torch.Tensor | None = None) -> torch.Tensor:
    """Depth (..., H, W) + intrinsics (..., 3, 3) [+ cam2world (..., 4, 4)]
    -> world-frame pointmap (..., H, W, 3)."""
    pts_cam = depthmap_to_camera_coords(depth, K)
    if c2w is None:
        return pts_cam
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    return (torch.einsum("...ij,...hwj->...hwi", R, pts_cam)
            + t[..., None, None, :])


def pts3d_to_depthmap(pts_cam: torch.Tensor) -> torch.Tensor:
    return pts_cam[..., 2]


def project_points(pts_cam: torch.Tensor, K: torch.Tensor,
                   eps: float = 1e-8) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixel coords (..., 2)."""
    z = pts_cam[..., 2:3]
    uv = pts_cam[..., :2] / torch.where(z.abs() < eps,
                                        torch.full_like(z, eps), z)
    u = uv[..., 0] * K[..., 0, 0] + K[..., 0, 2]
    v = uv[..., 1] * K[..., 1, 1] + K[..., 1, 2]
    return torch.stack([u, v], -1)


def intrinsics_matrix(focal, pp, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """(..., 3, 3) K from focal (scalar or (...,)) and pp (..., 2)."""
    focal = torch.as_tensor(focal, dtype=dtype, device=device)
    pp = torch.as_tensor(pp, dtype=dtype, device=device)
    z = torch.zeros_like(focal)
    o = torch.ones_like(focal)
    row0 = torch.stack([focal, z, pp[..., 0]], -1)
    row1 = torch.stack([z, focal, pp[..., 1]], -1)
    row2 = torch.stack([z, z, o], -1)
    return torch.stack([row0, row1, row2], -2)


def normalize_pointcloud_avg_dis(pts: torch.Tensor, valid: torch.Tensor,
                                 eps: float = 1e-8):
    """Scale pointmaps so the average distance to the origin over valid
    pixels is 1 (reference geometry.py:253, 'avg_dis'). Returns
    (pts / s, s)."""
    dis = torch.linalg.norm(pts, dim=-1)
    w = valid.to(pts.dtype)
    s = (dis * w).sum() / w.sum().clamp(min=1.0)
    s = torch.clamp_min(s, eps)
    return pts / s, s
