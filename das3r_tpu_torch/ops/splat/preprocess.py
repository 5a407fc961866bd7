"""Per-Gaussian preprocessing: cull, project, EWA conic, radius, SH color.

Port of ``das3r_tpu/ops/splat/preprocess.py`` in differentiable torch ops
(the CUDA rasterizer's ``preprocessCUDA``). Matrices are in ROW-VECTOR form
(``p' = [x y z 1] @ M``). Culling is a validity mask, so every output has
one row per input Gaussian.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from das3r_tpu_torch.ops.splat.settings import RasterSettings
from das3r_tpu_torch.utils import sh as sh_lib
from das3r_tpu_torch.utils import trace


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities (all [N, ...])."""
    mean2d: torch.Tensor      # [N, 2] pixel coords of projected center
    depth: torch.Tensor       # [N]   view-space z
    conic: torch.Tensor       # [N, 3] inverse 2D covariance (xx, xy, yy)
    color: torch.Tensor       # [N, 3] RGB after SH eval (or passthrough)
    opacity: torch.Tensor     # [N]
    radius: torch.Tensor      # [N]   int32 screen radius; 0 == culled
    rect_min: torch.Tensor    # [N, 2] int32 inclusive tile rect (x, y)
    rect_max: torch.Tensor    # [N, 2] int32 exclusive tile rect
    n_tiles_touched: torch.Tensor  # [N] int32
    binnable: torch.Tensor    # [N] bool: radius > 0 and opacity >= floor
    q_cap: torch.Tensor       # [N] conic-quadratic level where alpha
                              # crosses the floor: 2 ln(op / alpha_floor)


def build_cov3d(scales: torch.Tensor, rotations: torch.Tensor,
                scale_modifier: float) -> torch.Tensor:
    """Activated scales [N,3] + quats [N,4] -> [N, 6] upper-triangular 3D
    covariance (xx, xy, xz, yy, yz, zz), Sigma = R S^2 R^T."""
    q = rotations / torch.linalg.vector_norm(
        rotations, dim=-1, keepdim=True).clamp_min(1e-12)
    r, x, y, z = q.unbind(-1)
    R00 = 1 - 2 * (y * y + z * z)
    R01 = 2 * (x * y - r * z)
    R02 = 2 * (x * z + r * y)
    R10 = 2 * (x * y + r * z)
    R11 = 1 - 2 * (x * x + z * z)
    R12 = 2 * (y * z - r * x)
    R20 = 2 * (x * z - r * y)
    R21 = 2 * (y * z + r * x)
    R22 = 1 - 2 * (x * x + y * y)
    s0, s1, s2 = (scales * scale_modifier).unbind(-1)
    L00, L01, L02 = R00 * s0, R01 * s1, R02 * s2
    L10, L11, L12 = R10 * s0, R11 * s1, R12 * s2
    L20, L21, L22 = R20 * s0, R21 * s1, R22 * s2
    return torch.stack([
        L00 * L00 + L01 * L01 + L02 * L02,
        L00 * L10 + L01 * L11 + L02 * L12,
        L00 * L20 + L01 * L21 + L02 * L22,
        L10 * L10 + L11 * L11 + L12 * L12,
        L10 * L20 + L11 * L21 + L12 * L22,
        L20 * L20 + L21 * L21 + L22 * L22,
    ], -1)


def _cov2d(mean_view, cov3d, viewmatrix, focal_x, focal_y, tan_fovx,
           tan_fovy) -> torch.Tensor:
    """EWA projection of the 3D covariance ([N, 3] = xx, xy, yy), with the
    1.3 * tan_fov frustum clamp on the Jacobian point and the +0.3
    screen-space dilation of CUDA ``computeCov2D``."""
    tx, ty, tz = mean_view.unbind(-1)
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    txtz = torch.clamp(tx / tz, -limx, limx) * tz
    tytz = torch.clamp(ty / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * txtz * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * tytz * inv_z2
    # Row-vector convention: viewmatrix[:3, :3] is R^T of the math rotation.
    Wr = viewmatrix[:3, :3].T
    T00 = j00 * Wr[0, 0] + j02 * Wr[2, 0]
    T01 = j00 * Wr[0, 1] + j02 * Wr[2, 1]
    T02 = j00 * Wr[0, 2] + j02 * Wr[2, 2]
    T10 = j11 * Wr[1, 0] + j12 * Wr[2, 0]
    T11 = j11 * Wr[1, 1] + j12 * Wr[2, 1]
    T12 = j11 * Wr[1, 2] + j12 * Wr[2, 2]

    c0, c1, c2, c3, c4, c5 = cov3d.unbind(-1)
    s00 = T00 * c0 + T01 * c1 + T02 * c2
    s01 = T00 * c1 + T01 * c3 + T02 * c4
    s02 = T00 * c2 + T01 * c4 + T02 * c5
    s10 = T10 * c0 + T11 * c1 + T12 * c2
    s11 = T10 * c1 + T11 * c3 + T12 * c4
    s12 = T10 * c2 + T11 * c4 + T12 * c5
    xx = s00 * T00 + s01 * T01 + s02 * T02 + 0.3
    xy = s00 * T10 + s01 * T11 + s02 * T12
    yy = s10 * T10 + s11 * T11 + s12 * T12 + 0.3
    return torch.stack([xx, xy, yy], -1)


def preprocess(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    settings: RasterSettings,
    *,
    viewmatrix: torch.Tensor,
    projmatrix: torch.Tensor,
    campos: torch.Tensor,
    shs: torch.Tensor | None = None,
    colors_precomp: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
    rotations: torch.Tensor | None = None,
    cov3d_precomp: torch.Tensor | None = None,
    mean2d_offset: torch.Tensor | None = None,
    tan_fovx,
    tan_fovy,
) -> Preprocessed:
    """Project N Gaussians to screen space. ``mean2d_offset`` (zeros
    [N, 2]) is added to the projected centers; its gradient is the
    densification statistic of the reference's ``screenspace_points``."""
    s = settings
    n = means3d.shape[0]
    dev = means3d.device

    focal_x = s.image_width / (2.0 * tan_fovx)
    focal_y = s.image_height / (2.0 * tan_fovy)

    homo = torch.cat([means3d, torch.ones_like(means3d[:, :1])], -1)
    p_view = homo @ viewmatrix
    p_hom = homo @ projmatrix
    depth = p_view[:, 2]

    in_front = depth > s.near                            # cull z <= 0.001

    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]
    # ndc2Pix(v, S) = ((v + 1) * S - 1) / 2
    mean2d = torch.stack([
        ((p_proj[:, 0] + 1) * s.image_width - 1) * 0.5,
        ((p_proj[:, 1] + 1) * s.image_height - 1) * 0.5,
    ], -1)
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset

    if cov3d_precomp is not None:
        cov3d = cov3d_precomp
    else:
        if scales is None or rotations is None:
            raise ValueError("need scales and rotations, or cov3d_precomp")
        cov3d = build_cov3d(scales, rotations, s.scale_modifier)

    safe_view = torch.where(in_front[:, None], p_view[:, :3],
                            torch.ones_like(p_view[:, :3]))
    cov2d = _cov2d(safe_view, cov3d, viewmatrix,
                   focal_x, focal_y, tan_fovx, tan_fovy)

    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] ** 2
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([cov2d[:, 2] * inv_det, -cov2d[:, 1] * inv_det,
                         cov2d[:, 0] * inv_det], -1)

    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lam_max = torch.maximum(mid + disc, mid - disc)
    radius_f = torch.ceil(3.0 * torch.sqrt(lam_max))

    # alpha-floor crossing of the conic quadratic: alpha = op e^{-q/2} >=
    # floor iff q <= q_cap (an exact shrink of the 3-sigma rect, capped at
    # the reference's rect below).
    op_sg = opacities.reshape(n).detach()
    q_cap = 2.0 * torch.log(torch.clamp_min(op_sg / s.alpha_floor, 1e-12))

    # The CUDA getRect formula verbatim, including its quirk of dropping
    # the last tile when mu + r lands within 1px past a tile boundary.
    with trace.sync("tile_grid_to_device"):
        tgrid = torch.tensor([s.tiles_x, s.tiles_y], dtype=torch.int32,
                             device=dev)
    zero = torch.zeros_like(tgrid)
    mean2d_sg = mean2d.detach()
    rect_min = torch.clamp(
        torch.floor((mean2d_sg - radius_f[:, None]) / s.tile).to(torch.int32),
        zero, tgrid)
    rect_max = torch.clamp(
        ((mean2d_sg + radius_f[:, None] + s.tile - 1)
         // s.tile).to(torch.int32),
        zero, tgrid)
    s3 = torch.clamp_min(rect_max - rect_min, 0)
    span3 = s3[:, 0] * s3[:, 1]

    if s.tight_binning:
        # Intersect with the alpha-floor support box, with a proper
        # floor/ceil (the (x + T - 1) // T idiom is only ceil for integers).
        r_t = torch.sqrt(torch.clamp_min(q_cap, 0.0) * lam_max.detach())[:, None]
        tmin = torch.floor((mean2d_sg - r_t) / s.tile).to(torch.int32)
        tmax = torch.floor((mean2d_sg + r_t) / s.tile).to(torch.int32) + 1
        rect_min = torch.clamp(torch.maximum(rect_min, tmin), zero, tgrid)
        rect_max = torch.clamp(torch.minimum(rect_max, tmax), zero, tgrid)
    span = torch.clamp_min(rect_max - rect_min, 0)
    n_tiles_touched = span[:, 0] * span[:, 1]

    # radius stays 3-sigma-based for reference parity (densify stats and
    # the visibility filter read it).
    valid = in_front & det_ok & (span3 > 0)
    radius = torch.where(valid, radius_f.detach(),
                         torch.zeros_like(radius_f)).to(torch.int32)
    n_tiles_touched = torch.where(valid, n_tiles_touched,
                                  torch.zeros_like(n_tiles_touched))
    binnable = valid & (op_sg >= s.alpha_floor) & (n_tiles_touched > 0)

    if colors_precomp is not None:
        color = colors_precomp
    else:
        if shs is None:
            raise ValueError("need shs or colors_precomp")
        direction = means3d - campos[None, :]
        # Double-where safe normalize: dead slots and the first camera sit
        # at the origin, where the plain norm has a NaN gradient.
        sq = torch.sum(direction * direction, -1, keepdim=True)
        safe = torch.where(sq > 0.0, sq, torch.ones_like(sq))
        direction = torch.where(sq > 0.0, direction / torch.sqrt(safe),
                                torch.zeros_like(direction))
        raw = sh_lib.eval_sh(s.sh_degree, shs.transpose(-1, -2), direction)
        color = torch.clamp_min(raw + 0.5, 0.0)

    return Preprocessed(
        mean2d=mean2d,
        depth=depth,
        conic=conic,
        color=color,
        opacity=opacities.reshape(n),
        radius=radius,
        rect_min=rect_min,
        rect_max=rect_max,
        n_tiles_touched=n_tiles_touched,
        binnable=binnable,
        q_cap=q_cap,
    )
