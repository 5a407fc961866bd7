"""Projection matrices and FoV conversions in torch.

Conventions follow ``das3r_tpu/utils/transforms.py``: the OpenGL-style
perspective matrix with z mapped to [0, 1] and z_sign = +1, in
column-vector form; the rasterizer consumes its transpose (row-vector form,
``p' = [x y z 1] @ M``).
"""
from __future__ import annotations

import math

import torch


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
