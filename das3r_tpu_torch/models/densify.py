"""Densification statistics (port of the first function of
``das3r_tpu/models/densify.py``). Clone, split, prune and the opacity
reset come with the trainer (ROADMAP.md)."""
from __future__ import annotations

import dataclasses

import torch

from das3r_tpu_torch.models.gaussians import GaussianMeta


def add_densification_stats(meta: GaussianMeta, mean2d_grad: torch.Tensor,
                            radii: torch.Tensor) -> GaussianMeta:
    """Accumulate screen-space gradient norms over visible Gaussians
    (reference gaussian_model.py:568-570; visibility_filter == radii > 0).
    Returns a new ``GaussianMeta``; ``meta`` is left as it was."""
    vis = (radii > 0) & meta.alive
    gnorm = torch.linalg.vector_norm(mean2d_grad, dim=-1)
    zero = torch.zeros_like(gnorm)
    return dataclasses.replace(
        meta,
        xyz_grad_accum=meta.xyz_grad_accum + torch.where(vis, gnorm, zero),
        denom=meta.denom + vis.to(meta.denom.dtype),
        max_radii2d=torch.maximum(meta.max_radii2d, torch.where(
            vis, radii.to(torch.float32), zero)))
