"""Learning-rate schedules (port of ``das3r_tpu/utils/schedules.py``).

``expon_lr`` is the log-linear decay with an optional warm-up delay used by
every stage-2 parameter group (reference utils/general_utils.py:29-62);
``cosine_lr`` / ``linear_lr`` / ``cycled_lr`` are the global-alignment
schedules (reference dynamic_predictor/dust3r/cloud_opt/commons.py:88-103).
Each returns a 0-d float32 tensor on the CPU, computed in float32 as the
JAX package computes it; PyTorch takes a 0-d CPU tensor beside tensors on
any device.
"""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> torch.Tensor:
    """Log-lerp decay from lr_init to lr_final over max_steps, with a cosine
    delay ramp. 0 when step < 0 or both lrs are 0 (the reference's
    disabled-parameter convention)."""
    step = _f32(step)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(torch.log(_f32(lr_init)) * (1 - t)
                         + torch.log(_f32(lr_final)) * t)
    return torch.where(step < 0, torch.zeros_like(step),
                       delay_rate * log_lerp)


def cosine_lr(t, lr_base: float, lr_min: float = 0.0) -> torch.Tensor:
    """t in [0, 1] -> cosine from lr_base to lr_min."""
    return lr_min + (lr_base - lr_min) * (torch.cos(_f32(t) * math.pi) + 1) / 2


def linear_lr(t, lr_base: float, lr_min: float = 0.0) -> torch.Tensor:
    t = _f32(t)
    return lr_base * (1 - t) + lr_min * t


def cycled_lr(t, lr_base: float, lr_min: float = 0.0,
              num_cycles: int = 2) -> torch.Tensor:
    """Restarted cosine cycles over t in [0, 1] (commons.py:96-103)."""
    return cosine_lr((_f32(t) * num_cycles) % 1.0, lr_base, lr_min)
