"""Stage-2 training steps (port of ``das3r_tpu/train/step.py``).

``train_step`` is one iteration of the reference's loop
(train_gui.py:530-641): render with the frame's learnable pose, the
conf-weighted L1 + SSIM loss, gradients, the main Adam step (always) and
the camera Adam step gated on the frame's PSNR (a tensor gate inside
``adam_step``, so the step never waits for the device to decide).
``test_pose_step`` is the test-time pose-only optimisation of
train_test_psnr.py:109-149. ``train_chunk`` and ``test_pose_chunk``, one
``lax.scan`` each in the JAX package, are plain loops here.

The parameters and the optimiser state are updated in place; the step
returns the same ``TrainState``. Named ``das3r::`` ranges mark the stages
for ``torch.profiler`` (the render's own ranges are in ``rasterize``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

from das3r_tpu_torch.models import densify as densify_mod
from das3r_tpu_torch.models import render as render_mod
from das3r_tpu_torch.models.gaussians import (
    GaussianMeta, GaussianParams, PoseParams, TestPoseParams)
from das3r_tpu_torch.ops.splat import RasterSettings
from das3r_tpu_torch.train import loss as loss_mod
from das3r_tpu_torch.train import optim
from das3r_tpu_torch.train.config import OptimizationConfig
from das3r_tpu_torch.utils import image as image_utils


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    poses: PoseParams
    opt: optim.AdamState       # main group
    opt_cam: optim.AdamState   # camera group
    step: int                  # 1-based after the first call


@dataclasses.dataclass
class TestPoseState:
    poses: TestPoseParams
    opt: optim.AdamState


class StepMetrics(NamedTuple):
    """0-d tensors on the state's device; reading one waits for the step."""
    loss: torch.Tensor
    psnr: torch.Tensor
    cam_stepped: torch.Tensor
    radii_nonzero: torch.Tensor
    # entries dropped by a set ``max_total_entries`` (0 with the port's
    # default, which sizes the stream from the counts)
    entry_overflow: torch.Tensor
    # the [T, K] window path's truncation (always 0 on the entry stream)
    # and the (Gaussian, tile) pairs cut by ``max_tiles_per_gaussian``
    tile_overflow: torch.Tensor
    dup_overflow: torch.Tensor
    # the split duplication table's drops and the live count of
    # Gaussians wider than ``light_dup_width``
    heavy_overflow: torch.Tensor
    heavy_rows: torch.Tensor


def init_train_state(params: GaussianParams,
                     poses: PoseParams) -> TrainState:
    return TrainState(params=params, poses=poses,
                      opt=optim.adam_init(params),
                      opt_cam=optim.adam_init(poses), step=0)


def _require_grad(*groups) -> None:
    """Mark every field of the parameter groups as an autograd leaf."""
    for g in groups:
        for f in dataclasses.fields(g):
            getattr(g, f.name).requires_grad_(True)


def _grads(loss, groups, extra=()):
    """d loss / d every field of ``groups`` (each returned as its own
    dataclass type; None where no gradient reached a field) and the list
    of d loss / d each tensor of ``extra``."""
    names = [[f.name for f in dataclasses.fields(g)] for g in groups]
    flat = [getattr(g, n) for g, ns in zip(groups, names) for n in ns]
    got = iter(torch.autograd.grad(loss, flat + list(extra),
                                   allow_unused=True))
    return ([type(g)(**{n: next(got) for n in ns})
             for g, ns in zip(groups, names)], list(got))


def train_step(
    state: TrainState,
    meta: GaussianMeta,
    uid,                       # frame index
    gt_image: torch.Tensor,    # [3, H, W]
    fovx,                      # per-frame FoV (from stage-1 intrinsics)
    fovy,
    bg: torch.Tensor,          # [3]
    settings: RasterSettings,
    cfg: OptimizationConfig,
    spatial_lr_scale: float = 1.0,
    optim_pose: bool = True,
    track_stats: bool = False,
):
    """One training iteration on the state's device. Returns (state,
    new_meta, StepMetrics); ``state`` is updated in place.

    With ``track_stats`` the screen-space positional gradient (the
    reference's ``screenspace_points.grad``, train_gui.py:604-608) is
    captured through a zeros offset leaf and accumulated into a new meta
    (``add_densification_stats``); otherwise meta is returned as it is.
    """
    step = state.step + 1
    params, poses = state.params, state.poses
    dev = params.xyz.device
    offset = (torch.zeros_like(params.xyz[:, :2]).requires_grad_(True)
              if track_stats else None)
    _require_grad(params, poses)
    out = render_mod.render(params, meta, settings, poses.pose(uid), bg,
                            fovx, fovy, mode="train", mean2d_offset=offset,
                            device=dev)
    with record_function("das3r::loss"):
        ph = loss_mod.photometric_loss(out.image, gt_image,
                                       params.conf_static[uid],
                                       cfg.lambda_dssim)
    with record_function("das3r::backward"):
        (g_params, g_poses), g_extra = _grads(
            ph.loss, (params, poses), [offset] if track_stats else [])

    new_meta = meta
    if track_stats:
        g_offset = g_extra[0]
        if g_offset is None:
            g_offset = torch.zeros_like(offset)
        new_meta = densify_mod.add_densification_stats(meta, g_offset,
                                                       out.radii)
    with record_function("das3r::adam"):
        optim.adam_step(params, g_params, state.opt,
                        optim.gaussian_lrs(step, cfg, spatial_lr_scale))
        gate = (ph.psnr_frame.detach() > cfg.psnr_threshold if optim_pose
                else torch.zeros((), dtype=torch.bool, device=dev))
        optim.adam_step(poses, g_poses, state.opt_cam,
                        optim.camera_lrs(step, cfg), gate=gate)
    state.step = step
    aux = out.aux
    metrics = StepMetrics(
        loss=ph.loss.detach(), psnr=ph.psnr_frame.detach(),
        cam_stepped=gate, radii_nonzero=torch.sum(out.radii > 0),
        entry_overflow=aux.entry_overflow, tile_overflow=aux.tile_overflow,
        dup_overflow=aux.dup_overflow, heavy_overflow=aux.heavy_overflow,
        heavy_rows=aux.heavy_rows)
    return state, new_meta, metrics


def _stack_metrics(ms: list[StepMetrics]) -> StepMetrics:
    return StepMetrics(*(torch.stack(x) for x in zip(*ms)))


def train_chunk(state: TrainState, meta: GaussianMeta, uids,
                gt_images: torch.Tensor, fovx: torch.Tensor,
                fovy: torch.Tensor, bg: torch.Tensor,
                settings: RasterSettings, cfg: OptimizationConfig,
                spatial_lr_scale: float = 1.0, optim_pose: bool = True,
                track_stats: bool = False):
    """``train_step`` over the frame schedule ``uids`` (ints). Returns
    (state, meta, StepMetrics with a leading step axis)."""
    ms = []
    for uid in uids:
        state, meta, m = train_step(
            state, meta, uid, gt_images[uid], fovx[uid], fovy[uid], bg,
            settings, cfg, spatial_lr_scale=spatial_lr_scale,
            optim_pose=optim_pose, track_stats=track_stats)
        ms.append(m)
    return state, meta, _stack_metrics(ms)


def test_pose_step(tp_state: TestPoseState, params: GaussianParams,
                   meta: GaussianMeta, uid, gt_image: torch.Tensor,
                   gt_dynamic_mask: torch.Tensor, fovx, fovy,
                   bg: torch.Tensor, step, settings: RasterSettings,
                   cfg: OptimizationConfig):
    """Test-time pose alignment: optimise ONLY the held-out frame's pose
    against the GT-static-masked photometric loss, Gaussians frozen
    (train_test_psnr.py:109-149). Returns (tp_state, loss, psnr);
    ``tp_state`` is updated in place.

    The reference intends this, but its step is a silent no-op: it steps
    ``optimizer_cam`` (the training poses, whose grads are None in the test
    pass) and never ``optimizer_cam_test`` (train_test_psnr.py:144-149),
    so its published PSNRs use unoptimised test poses. This is the working
    version; the trainer's ``--no-optim-test-pose`` gives strict parity.
    """
    poses = tp_state.poses
    _require_grad(poses)
    out = render_mod.render(params, meta, settings, poses.pose(uid), bg,
                            fovx, fovy, mode="train",
                            device=poses.Q.device)
    m = 1.0 - gt_dynamic_mask
    p = out.image * m
    g = gt_image * m
    ssim_map = image_utils.ssim(p, g, size_average=False)
    lossv = ((1.0 - cfg.lambda_dssim) * torch.abs(p - g)
             + cfg.lambda_dssim * (1.0 - ssim_map)).mean()
    psnr_v = image_utils.psnr(p[None], g[None]).mean()
    (g_poses,), _ = _grads(lossv, (poses,))
    optim.adam_step(poses, g_poses, tp_state.opt,
                    optim.test_camera_lrs(step, cfg))
    return tp_state, lossv.detach(), psnr_v.detach()


def test_pose_chunk(tp_state: TestPoseState, params: GaussianParams,
                    meta: GaussianMeta, uids, gt_images: torch.Tensor,
                    gt_dynamic_masks: torch.Tensor, fovx: torch.Tensor,
                    fovy: torch.Tensor, bg: torch.Tensor, step,
                    settings: RasterSettings, cfg: OptimizationConfig):
    """``test_pose_step`` over the test-frame schedule ``uids`` (ints).
    Returns (tp_state, (losses, psnrs))."""
    out = [test_pose_step(tp_state, params, meta, uid, gt_images[uid],
                          gt_dynamic_masks[uid], fovx[uid], fovy[uid], bg,
                          step, settings, cfg)[1:] for uid in uids]
    losses, psnrs = zip(*out)
    return tp_state, (torch.stack(losses), torch.stack(psnrs))
