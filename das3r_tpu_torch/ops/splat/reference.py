"""Brute-force NumPy oracle for the rasterizer (float64, no tiling): a copy
of ``das3r_tpu/ops/splat/reference.py`` (numpy only, so the copy computes
the same values), kept in the port so that it holds its own renders
against an oracle without importing the JAX package.

An independent per-pixel re-implementation of the CUDA rasterizer's forward
semantics (SURVEY.md §2.9; INRIA diff-gaussian-rasterization with the
``p_view.z <= 0.001`` near-plane patch, reference README.md:41-44), written
against the spec rather than sharing any code with the production path.
Used by the tests and by ``chip_smoke.py``'s ``reference`` phase: the
port's tiled renders must ``allclose`` this oracle.
"""
from __future__ import annotations

import numpy as np

from das3r_tpu_torch.ops.splat.settings import RasterSettings


def _quat_rotmats(q: np.ndarray) -> np.ndarray:
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], -2)


_SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = [1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396]
_SH_C3 = [-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
          0.3731763325901154, -0.4570457994644658, 1.445305721320277,
          -0.5900435899266435]


def _eval_sh(deg: int, sh: np.ndarray, d: np.ndarray) -> np.ndarray:
    """sh: [N, K, 3], d: [N, 3] unit. Returns [N, 3] (pre +0.5/clamp)."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    res = _SH_C0 * sh[:, 0]
    if deg >= 1:
        res = res - _SH_C1 * y * sh[:, 1] + _SH_C1 * z * sh[:, 2] \
            - _SH_C1 * x * sh[:, 3]
    if deg >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        res = (res + _SH_C2[0] * xy * sh[:, 4] + _SH_C2[1] * yz * sh[:, 5]
               + _SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
               + _SH_C2[3] * xz * sh[:, 7] + _SH_C2[4] * (xx - yy) * sh[:, 8])
    if deg >= 3:
        res = (res + _SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
               + _SH_C3[1] * xy * z * sh[:, 10]
               + _SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + _SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + _SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + _SH_C3[5] * z * (xx - yy) * sh[:, 14]
               + _SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return res


def rasterize_reference(
    means3d: np.ndarray,
    opacities: np.ndarray,
    settings: RasterSettings,
    *,
    viewmatrix: np.ndarray,
    projmatrix: np.ndarray,
    campos: np.ndarray,
    bg: np.ndarray,
    tan_fovx: float,
    tan_fovy: float,
    shs: np.ndarray | None = None,
    colors_precomp: np.ndarray | None = None,
    scales: np.ndarray | None = None,
    rotations: np.ndarray | None = None,
    cov3d_precomp: np.ndarray | None = None,
):
    """Returns (image [3, H, W] float64, radii [N] int32)."""
    s = settings
    f = np.float64
    means3d = np.asarray(means3d, f)
    opacities = np.asarray(opacities, f).reshape(-1)
    viewmatrix = np.asarray(viewmatrix, f)
    projmatrix = np.asarray(projmatrix, f)
    n = means3d.shape[0]
    W, H = s.image_width, s.image_height
    focal_x = W / (2.0 * tan_fovx)
    focal_y = H / (2.0 * tan_fovy)

    homo = np.concatenate([means3d, np.ones((n, 1))], 1)
    p_view = homo @ viewmatrix
    p_hom = homo @ projmatrix
    depth = p_view[:, 2]
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]
    mean2d = np.stack([((p_proj[:, 0] + 1) * W - 1) * 0.5,
                       ((p_proj[:, 1] + 1) * H - 1) * 0.5], -1)

    if cov3d_precomp is not None:
        c6 = np.asarray(cov3d_precomp, f)
        sigma = np.empty((n, 3, 3))
        sigma[:, 0, 0], sigma[:, 0, 1], sigma[:, 0, 2] = c6[:, 0], c6[:, 1], c6[:, 2]
        sigma[:, 1, 0], sigma[:, 1, 1], sigma[:, 1, 2] = c6[:, 1], c6[:, 3], c6[:, 4]
        sigma[:, 2, 0], sigma[:, 2, 1], sigma[:, 2, 2] = c6[:, 2], c6[:, 4], c6[:, 5]
    else:
        R = _quat_rotmats(np.asarray(rotations, f))
        S = np.asarray(scales, f) * s.scale_modifier
        L = R * S[:, None, :]
        sigma = L @ np.swapaxes(L, 1, 2)

    # EWA projection with frustum-clamped Jacobian evaluation point
    tz = p_view[:, 2].copy()
    tz[tz == 0] = 1e-12
    txc = np.clip(p_view[:, 0] / tz, -1.3 * tan_fovx, 1.3 * tan_fovx) * tz
    tyc = np.clip(p_view[:, 1] / tz, -1.3 * tan_fovy, 1.3 * tan_fovy) * tz
    J = np.zeros((n, 2, 3))
    J[:, 0, 0] = focal_x / tz
    J[:, 0, 2] = -focal_x * txc / tz**2
    J[:, 1, 1] = focal_y / tz
    J[:, 1, 2] = -focal_y * tyc / tz**2
    Wr = viewmatrix[:3, :3].T
    T = J @ Wr
    cov2d = T @ sigma @ np.swapaxes(T, 1, 2)
    cov2d[:, 0, 0] += 0.3
    cov2d[:, 1, 1] += 0.3

    det = cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        conic = np.stack([cov2d[:, 1, 1], -cov2d[:, 0, 1],
                          cov2d[:, 0, 0]], -1) / det[:, None]
    mid = 0.5 * (cov2d[:, 0, 0] + cov2d[:, 1, 1])
    disc = np.sqrt(np.maximum(0.1, mid * mid - det))
    radius = np.ceil(3.0 * np.sqrt(np.maximum(mid + disc, mid - disc)))

    if colors_precomp is not None:
        color = np.asarray(colors_precomp, f)
    else:
        d = means3d - np.asarray(campos, f)[None]
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        color = np.maximum(_eval_sh(s.sh_degree, np.asarray(shs, f), d) + 0.5,
                           0.0)

    alive = (depth > s.near) & (det != 0) & (radius > 0)
    # require a non-empty tile rect like getRect (also culls off-screen)
    tx0 = np.clip(np.floor((mean2d[:, 0] - radius) / s.tile), 0, s.tiles_x)
    tx1 = np.clip((mean2d[:, 0] + radius + s.tile - 1) // s.tile, 0, s.tiles_x)
    ty0 = np.clip(np.floor((mean2d[:, 1] - radius) / s.tile), 0, s.tiles_y)
    ty1 = np.clip((mean2d[:, 1] + radius + s.tile - 1) // s.tile, 0, s.tiles_y)
    alive &= ((tx1 - tx0) * (ty1 - ty0)) > 0
    radii_out = np.where(alive, radius, 0).astype(np.int32)

    order = np.argsort(np.where(alive, depth, np.inf), kind="stable")
    image = np.zeros((H, W, 3))
    bg = np.asarray(bg, f)

    for py in range(H):
        for px in range(W):
            Tcur = 1.0
            Cacc = np.zeros(3)
            tx, ty = px // s.tile, py // s.tile
            for gi in order:
                if not alive[gi]:
                    break  # sorted: all dead at the end
                # tile-rect membership mirrors the binning stage
                if not (tx0[gi] <= tx < tx1[gi] and ty0[gi] <= ty < ty1[gi]):
                    continue
                dx = mean2d[gi, 0] - px
                dy = mean2d[gi, 1] - py
                power = (-0.5 * (conic[gi, 0] * dx * dx
                                 + conic[gi, 2] * dy * dy)
                         - conic[gi, 1] * dx * dy)
                if power > 0:
                    continue
                alpha = min(s.alpha_clip, opacities[gi] * np.exp(power))
                if alpha < s.alpha_floor:
                    continue
                test_T = Tcur * (1 - alpha)
                if test_T < s.transmittance_eps:
                    break
                Cacc += color[gi] * alpha * Tcur
                Tcur = test_T
            image[py, px] = Cacc + Tcur * bg
    return image.transpose(2, 0, 1), radii_out
