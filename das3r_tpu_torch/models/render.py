"""Scene-level render paths: the four renderers of
``das3r_tpu/models/render.py`` (train / test / no_soft / confidence).

All use the identity-view trick: the rasterizer sees viewmatrix = I and
Gaussians moved into the camera frame inside the autograd graph
(xyz' = w2c(q, t) @ xyz, rot' = q * rot), so the photometric loss can reach
the learnable camera pose. Gradients reach every ``GaussianParams`` field
(``conf_static`` through the per-Gaussian gather in mode 'train'), the
pose and the FoV.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from das3r_tpu_torch.models.gaussians import (
    GaussianMeta, GaussianParams, activated_opacity, activated_scaling,
    per_gaussian_conf)
from das3r_tpu_torch.ops.splat import RasterSettings, rasterize
from das3r_tpu_torch.parallel import collectives
from das3r_tpu_torch.utils import transforms
from das3r_tpu_torch.utils.device import on_device, resolve_device
from das3r_tpu_torch.utils.quat import pose_to_w2c, quat_mul


class RenderOutput(NamedTuple):
    image: torch.Tensor      # [3, H, W]
    radii: torch.Tensor      # [Nc] int32 (visibility_filter == radii > 0)
    mean2d_grad_capture: torch.Tensor | None  # zeros [Nc, 2] that was fed
    aux: object


def _camera_frame_gaussians(params: GaussianParams, camera_pose):
    """Means and orientations in the camera frame."""
    w2c = pose_to_w2c(camera_pose)
    xyz_cam = params.xyz @ w2c[:3, :3].T + w2c[:3, 3]
    rot_cam = quat_mul(camera_pose[:4], params.rotation)
    return xyz_cam, rot_cam


def _raster_common(fovx, fovy, device, znear=0.01, zfar=100.0):
    """Identity viewmatrix + row-vector projection; the FoV may carry
    gradients (learnable-FoV path)."""
    fovx = torch.as_tensor(fovx, dtype=torch.float32, device=device)
    fovy = torch.as_tensor(fovy, dtype=torch.float32, device=device)
    proj = transforms.projection_matrix_dyn(znear, zfar, fovx, fovy).T
    view = torch.eye(4, dtype=torch.float32, device=device)
    campos = torch.zeros(3, dtype=torch.float32, device=device)
    return view, proj, campos, torch.tan(fovx * 0.5), torch.tan(fovy * 0.5)


def render(
    params: GaussianParams,
    meta: GaussianMeta,
    settings: RasterSettings,
    camera_pose,                   # [7] learnable (quat, t)
    bg,                            # [3]
    fovx,
    fovy,
    *,
    mode: str = "train",           # train | test | no_soft | confidence
    conf_per_gaussian=None,        # test mode (PLY-loaded)
    capture_mean2d_grad: bool = False,
    mean2d_offset=None,
    device=None,
    tile_group=None,
    gauss_group=None,
) -> RenderOutput:
    """One render of the scene from ``camera_pose`` on ``device`` (default
    CUDA; a RuntimeError without it).

    ``tile_group`` / ``gauss_group``: the process groups of the mesh's
    tile and Gaussian axes (JAX's ``tile_axis``, ``gauss_axis`` and
    ``mesh``; ``parallel/mesh.py``). With ``gauss_group``, ``params``'
    per-Gaussian fields and ``meta`` are this rank's slice; the pose, the
    FoV and ``conf_static`` are whole on every rank, and since each rank
    uses them for its own Gaussians, their gradients are summed over the
    group (``collectives.sum_grads``). Either way the image is whole on
    every rank.

    mode='train'      opacity *= conf_static gathered per Gaussian
    mode='test'       opacity *= ``conf_per_gaussian``
    mode='no_soft'    no conf modulation
    mode='confidence' opacity = 1, colors = conf -> staticness image
    """
    dev = resolve_device(device)
    params = GaussianParams(**{f.name: getattr(params, f.name).to(dev)
                               for f in dataclasses.fields(params)})
    meta = GaussianMeta(**{f.name: getattr(meta, f.name).to(dev)
                           for f in dataclasses.fields(meta)})
    camera_pose = on_device(camera_pose, dev)
    if collectives.size(gauss_group) > 1:
        fovx, fovy, conf = (
            torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (fovx, fovy, params.conf_static))
        camera_pose, fovx, fovy, conf = collectives.sum_grads(
            gauss_group, "replicated_grads", camera_pose, fovx, fovy, conf)
        params = dataclasses.replace(params, conf_static=conf)
    # Dead capacity slots: a degenerate stored quaternion would inject NaN
    # into the backward through quat normalization.
    safe_rot = torch.where(
        meta.alive[:, None], params.rotation,
        torch.tensor([1.0, 0, 0, 0], dtype=params.rotation.dtype,
                     device=dev).expand_as(params.rotation))
    params = dataclasses.replace(params, rotation=safe_rot)
    xyz_cam, rot_cam = _camera_frame_gaussians(params, camera_pose)
    opacity = activated_opacity(params)          # [Nc, 1]
    alive_f = meta.alive[:, None].to(opacity.dtype)

    colors_precomp = None
    shs = torch.cat([params.features_dc, params.features_rest], 1)

    if mode == "train":
        opacity = opacity * per_gaussian_conf(params, meta)[:, None]
    elif mode == "test":
        if conf_per_gaussian is None:
            raise ValueError("mode='test' needs conf_per_gaussian")
        opacity = opacity * on_device(conf_per_gaussian,
                                      dev).reshape(-1, 1)
    elif mode == "no_soft":
        pass
    elif mode == "confidence":
        conf = (per_gaussian_conf(params, meta) if conf_per_gaussian is None
                else on_device(conf_per_gaussian, dev))
        opacity = torch.ones_like(opacity)
        colors_precomp = conf.reshape(-1, 1).expand(-1, 3).to(torch.float32)
        shs = None
    else:
        raise ValueError(mode)

    opacity = opacity * alive_f

    view, proj, campos, tfx, tfy = _raster_common(fovx, fovy, dev)

    # The capture is a zeros leaf: its gradient is the screen-space signal
    # of the densification statistics.
    offset = mean2d_offset
    if offset is None and capture_mean2d_grad:
        offset = torch.zeros_like(params.xyz[:, :2]).requires_grad_(True)
    img, radii, aux = rasterize(
        xyz_cam, opacity, settings,
        viewmatrix=view, projmatrix=proj, campos=campos,
        bg=on_device(bg, dev, torch.float32),
        tan_fovx=tfx, tan_fovy=tfy,
        shs=shs, colors_precomp=colors_precomp,
        scales=activated_scaling(params), rotations=rot_cam,
        mean2d_offset=offset, device=dev, tile_group=tile_group,
        gauss_group=gauss_group)
    return RenderOutput(image=img, radii=radii,
                        mean2d_grad_capture=offset, aux=aux)
