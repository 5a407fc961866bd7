"""Gated, externally scheduled Adam groups (port of
``das3r_tpu/train/optim.py``).

The reference drives three ``torch.optim.Adam(eps=1e-15)`` instances whose
learning rates are rewritten from the global iteration each step
(gaussian_model.py:259-324) and whose camera group steps only when the
frame PSNR clears a threshold (train_gui.py:581-586). As in the JAX
package, this module writes Adam out:

  * the bias-correction count advances only on taken steps (gating), and
    the gate is a tensor, so a step never waits for the device to say
    whether it is taken;
  * per-field learning rates are passed in each call, computed from the
    global step by the ``*_lrs`` helpers.

Parameter groups are the dataclasses of ``models.gaussians``
(``GaussianParams``, ``PoseParams``, ``TestPoseParams``); the moments are
the same dataclass type. Unlike the JAX package, ``adam_step`` updates the
parameters and the state in place, under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses

import torch

from das3r_tpu_torch.models.gaussians import (GaussianParams, PoseParams,
                                              TestPoseParams)
from das3r_tpu_torch.train.config import OptimizationConfig
from das3r_tpu_torch.utils import schedules


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor  # [] int32: number of steps actually taken
    mu: object           # same dataclass type as the parameters
    nu: object


def _fields(x) -> list[str]:
    return [f.name for f in dataclasses.fields(x)]


def adam_init(params) -> AdamState:
    def zeros():
        return type(params)(**{k: torch.zeros_like(getattr(params, k))
                               for k in _fields(params)})
    return AdamState(
        count=torch.zeros((), dtype=torch.int32,
                          device=getattr(params, _fields(params)[0]).device),
        mu=zeros(), nu=zeros())


@torch.no_grad()
def adam_step(params, grads, state: AdamState, lrs, *, gate=None,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15) -> None:
    """One (possibly gated) Adam step, in place on ``params`` and ``state``.

    Args:
      grads: the same dataclass type as ``params``; a field may be None
        (no gradient reached it), which counts as zero.
      lrs: the same dataclass type, of scalar learning rates, typically
        from ``gaussian_lrs`` / ``camera_lrs``.
      gate: optional [] bool tensor; where False the step changes nothing,
        parameters and state alike, as a skipped ``optimizer.step()``.
    """
    if gate is None:
        g = 1.0
        state.count += 1
    else:
        g = gate.to(torch.float32)
        state.count += gate.to(torch.int32)
    # bias correction from the post-step count; clamped to >= 1 so a
    # gated-off first step (count still 0) does not divide by zero: the
    # whole update is multiplied by the gate anyway.
    c = torch.clamp_min(state.count.to(torch.float32), 1.0)
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)
    for k in _fields(params):
        p, gr = getattr(params, k), getattr(grads, k)
        mu, nu = getattr(state.mu, k), getattr(state.nu, k)
        if gr is None:
            gr = torch.zeros_like(p)
        mu += g * ((b1 * mu + (1 - b1) * gr) - mu)
        nu += g * ((b2 * nu + (1 - b2) * gr * gr) - nu)
        p -= g * (getattr(lrs, k) * (mu / bc1) / (torch.sqrt(nu / bc2) + eps))


def gaussian_lrs(step, cfg: OptimizationConfig,
                 spatial_lr_scale: float) -> GaussianParams:
    """Per-field lrs of the main group at global (1-based) ``step``
    (training_setup + update_learning_rate, gaussian_model.py:228-324)."""
    xyz_lr = schedules.expon_lr(
        step, cfg.position_lr_init * spatial_lr_scale,
        cfg.position_lr_final * spatial_lr_scale,
        lr_delay_mult=cfg.position_lr_delay_mult,
        max_steps=cfg.position_lr_max_steps)
    conf_lr = schedules.expon_lr(
        step, cfg.conf_lr_init, cfg.conf_lr_final,
        lr_delay_mult=cfg.position_lr_delay_mult,
        max_steps=cfg.iterations)
    # Opt-in ablation: zero the attribute lrs (not reference parity: the
    # reference trains every attribute, see OptimizationConfig).
    attr = 0.0 if cfg.freeze_attrs else 1.0

    def f32(x):
        return torch.tensor(x, dtype=torch.float32)
    return GaussianParams(
        xyz=xyz_lr, features_dc=f32(attr * cfg.feature_lr),
        features_rest=f32(attr * cfg.feature_lr / 20.0),
        scaling=f32(attr * cfg.scaling_lr),
        rotation=f32(attr * cfg.rotation_lr),
        opacity=f32(attr * cfg.opacity_lr), conf_static=conf_lr)


def _cam_lr(step, cfg: OptimizationConfig) -> torch.Tensor:
    return schedules.expon_lr(
        step, cfg.cam_lr_init, cfg.cam_lr_final,
        lr_delay_mult=cfg.position_lr_delay_mult,
        max_steps=cfg.cam_lr_max_steps)


def camera_lrs(step, cfg: OptimizationConfig) -> PoseParams:
    cam_lr = _cam_lr(step, cfg)
    fov_lr = torch.tensor(cfg.fov_lr, dtype=torch.float32)
    return PoseParams(Q=cam_lr, T=cam_lr, fovx=fov_lr, fovy=fov_lr)


def test_camera_lrs(step, cfg: OptimizationConfig) -> TestPoseParams:
    cam_lr = _cam_lr(step, cfg)
    return TestPoseParams(Q=cam_lr, T=cam_lr)
