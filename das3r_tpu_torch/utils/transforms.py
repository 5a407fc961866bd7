"""Projection matrices and FoV conversions in torch.

Conventions follow ``das3r_tpu/utils/transforms.py``: the OpenGL-style
perspective matrix with z mapped to [0, 1] and z_sign = +1, in
column-vector form; the rasterizer consumes its transpose (row-vector form,
``p' = [x y z 1] @ M``).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def world_to_view(R: np.ndarray, t: np.ndarray, translate=np.zeros(3),
                  scale: float = 1.0) -> np.ndarray:
    """COLMAP (R, t) -> 4x4 world-to-view float32 (getWorld2View2)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
    return np.float32(np.linalg.inv(c2w))


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float,
                      dtype=torch.float32) -> torch.Tensor:
    """[4, 4] perspective matrix of fixed FoVs (reference
    utils/graphics_utils.py:80-100), built in float64 on the host as JAX
    builds it; ``projection_matrix_dyn`` is the differentiable form."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    top = tan_y * znear
    right = tan_x * znear
    P = np.zeros((4, 4))
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return torch.as_tensor(P, dtype=dtype)


def projection_matrix_dyn(znear: float, zfar: float, fovx, fovy) -> torch.Tensor:
    """[4, 4] perspective matrix; ``fovx``/``fovy`` may be tensors that
    carry gradients (the learnable-FoV render path) or python floats."""
    fovx = torch.as_tensor(fovx, dtype=torch.float32)
    fovy = torch.as_tensor(fovy, dtype=torch.float32, device=fovx.device)
    inv_tan_x = 1.0 / torch.tan(fovx / 2)
    inv_tan_y = 1.0 / torch.tan(fovy / 2)
    z = torch.zeros((), dtype=torch.float32, device=fovx.device)
    o = torch.ones_like(z)
    c = torch.full_like(z, zfar / (zfar - znear))
    d = torch.full_like(z, -(zfar * znear) / (zfar - znear))
    return torch.stack([
        torch.stack([inv_tan_x, z, z, z]),
        torch.stack([z, inv_tan_y, z, z]),
        torch.stack([z, z, c, d]),
        torch.stack([z, z, o, z]),
    ])


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal, pixels):
    """Works on python floats or tensors (learnable-FoV path)."""
    if isinstance(focal, torch.Tensor):
        return 2 * torch.atan(pixels / (2 * focal))
    return 2 * math.atan(pixels / (2 * focal))


def geotrf(T: torch.Tensor, pts: torch.Tensor,
           ncol: int | None = None) -> torch.Tensor:
    """Apply (..., 4, 4) (or 3x4 / 3x3) transform(s) to (..., N, 3) points
    (the reference's ``geotrf``, dynamic_predictor/dust3r/utils/
    geometry.py:40, in its affine cases)."""
    d = pts.shape[-1]
    out = torch.einsum("...ij,...nj->...ni", T[..., :d, :d], pts)
    if T.shape[-1] > d:
        out = out + T[..., :d, d][..., None, :]
    if ncol is not None:
        out = out[..., :ncol]
    return out


def homogenize(pts: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 4) with trailing ones."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
