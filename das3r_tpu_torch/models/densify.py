"""Densification and pruning with capacity-padded state (port of
``das3r_tpu/models/densify.py``).

New Gaussians are written into dead capacity slots and their Adam moments
are cleared (the zeros the reference's ``cat_tensors_to_optimizer``
appends); pruning clears the alive mask and sends the slot's opacity
logit to -1e4, so it is never binned. When free slots run out the trainer
can grow the capacity (``grow_capacity``), a real reallocation here.

The reference ships with clone and split commented out
(train_gui.py:612-623, gaussian_model.py:556-557) and only prunes; both
are implemented and flag-gated, as in the JAX package. The split noise
comes from an explicit ``torch.Generator``, so its draws differ from the
JAX package's ``jax.random`` ones.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from das3r_tpu_torch.models.gaussians import GaussianMeta, GaussianParams
from das3r_tpu_torch.utils.quat import quat_to_rotmat

# the fields a new Gaussian copies from its source row
_ROW_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
               "opacity")


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    grad_threshold: float = 2e-4
    min_opacity: float = 0.005
    percent_dense: float = 0.01
    split_n: int = 2
    max_screen_size: float = 0.0      # 0 = disabled (no size pruning)
    extent: float = 1.0
    enable_clone: bool = False        # reference default: disabled
    enable_split: bool = False        # reference default: disabled


class DensifyReport(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_overflow: torch.Tensor   # candidates dropped for lack of free slots


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


def _moment_fields(group, nc: int):
    """Names of the fields of an Adam moment group with one row per
    Gaussian (``conf_static`` has one per frame)."""
    return [f.name for f in dataclasses.fields(group)
            if getattr(group, f.name).dim() > 0
            and getattr(group, f.name).shape[0] == nc]


@torch.no_grad()
def densify_and_prune(params: GaussianParams, meta: GaussianMeta, opt_state,
                      generator: torch.Generator, cfg: DensifyConfig):
    """One densification round. Returns (params, meta, opt_state, report):
    new ``GaussianParams`` and ``GaussianMeta``; the Adam state of the main
    group is updated in place, its moments cleared at every written slot
    and kept for survivors. ``generator`` (on the parameters' device) draws
    the split offsets."""
    nc = params.xyz.shape[0]
    dev = params.xyz.device
    alive = meta.alive
    scales = torch.exp(params.scaling)
    max_scale = scales.amax(-1)
    opacity = torch.sigmoid(params.opacity[:, 0])

    grads = torch.where(meta.denom > 0, meta.xyz_grad_accum / meta.denom,
                        torch.zeros_like(meta.denom))
    hot = alive & (grads >= cfg.grad_threshold)
    small = max_scale <= cfg.percent_dense * cfg.extent
    none = torch.zeros(nc, dtype=torch.bool, device=dev)
    clone_mask = hot & small if cfg.enable_clone else none
    split_mask = hot & ~small if cfg.enable_split else none

    prune_mask = alive & (opacity < cfg.min_opacity)
    if cfg.max_screen_size > 0:
        prune_mask |= alive & ((meta.max_radii2d > cfg.max_screen_size)
                               | (max_scale > 0.1 * cfg.extent))
    prune_mask |= split_mask          # split originals are removed (ref :534)

    # free-slot allocation: dead slots (after the prune) first, in order
    idx = torch.arange(nc, device=dev)
    free = ~alive | prune_mask
    free_list = torch.argsort(torch.where(free, idx, nc + idx))
    n_free = free.sum()
    clone_rank = torch.cumsum(clone_mask, 0) - 1
    split_rank = torch.cumsum(split_mask, 0) - 1
    new_alive = alive & ~prune_mask

    # Sources are always the rows as they were before any write: the free
    # list holds the split originals' own slots.
    out = {name: getattr(params, name).detach().clone()
           for name in _ROW_FIELDS}
    moments = [(grp, _moment_fields(grp, nc))
               for grp in (opt_state.mu, opt_state.nu)]

    def write_new(dst_slots, do, transform=None):
        """Copy candidate rows k to free_list[dst_slots[k]] where ``do``;
        clear their Adam moments. Returns the rows written."""
        do = do & (dst_slots < n_free) & (dst_slots < nc)
        src = do.nonzero().squeeze(1)
        dst = free_list[dst_slots[src]]
        for name in _ROW_FIELDS:
            rows = getattr(params, name)[src]
            if transform and name in transform:
                rows = transform[name](rows, src)
            out[name][dst] = rows
        for grp, names in moments:
            for name in names:
                getattr(grp, name)[dst] = 0
        new_alive[dst] = True
        return do.sum()

    n_clone_used = write_new(clone_rank, clone_mask)
    overflow = clone_mask.sum() - n_clone_used

    # splits: cfg.split_n samples from N(0, scale) rotated into the world,
    # scale shrunk by 0.8 * split_n (reference :521-527)
    R = quat_to_rotmat(params.rotation)
    n_split = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(cfg.split_n):
        noise = torch.randn(params.xyz.shape, generator=generator,
                            device=dev) * scales
        offset = torch.einsum("nij,nj->ni", R, noise)
        transform = {
            "xyz": lambda rows, src, o=offset: rows + o[src],
            "scaling": lambda rows, src: rows - math.log(0.8 * cfg.split_n),
        }
        slot = n_clone_used + split_rank * cfg.split_n + s
        written = write_new(slot, split_mask, transform)
        overflow += split_mask.sum() - written
        n_split += written

    # dead slots: an opacity logit of -1e4, so they are never binned
    out["opacity"] = torch.where(new_alive[:, None], out["opacity"],
                                 torch.full_like(out["opacity"], -1e4))
    new_params = dataclasses.replace(params, **out)
    new_meta = dataclasses.replace(
        meta, alive=new_alive,
        xyz_grad_accum=torch.zeros_like(meta.xyz_grad_accum),
        denom=torch.zeros_like(meta.denom),
        max_radii2d=torch.zeros_like(meta.max_radii2d))
    report = DensifyReport(n_cloned=n_clone_used, n_split=n_split,
                           n_pruned=prune_mask.sum(), n_overflow=overflow)
    return new_params, new_meta, opt_state, report


@torch.no_grad()
def reset_opacity(params: GaussianParams, opt_state,
                  max_opacity: float = 0.01):
    """Clamp every opacity to at most ``max_opacity`` and clear the
    opacity's Adam moments (reference ``reset_opacity`` and its optimizer
    state wipe, gaussian_model.py:426-434, 445-461). Returns (new params,
    the Adam state updated in place)."""
    logit = math.log(max_opacity / (1.0 - max_opacity))
    opacity = torch.clamp_max(params.opacity.detach(), logit)
    opt_state.mu.opacity.zero_()
    opt_state.nu.opacity.zero_()
    return dataclasses.replace(params, opacity=opacity), opt_state


@torch.no_grad()
def grow_capacity(params: GaussianParams, meta: GaussianMeta, opt_state,
                  extra: int):
    """Reallocate every per-Gaussian array with ``extra`` more dead slots
    (identity rotation, opacity logit -1e4, zero Adam moments). Returns
    (params, meta, opt_state), all new."""
    nc = meta.alive.shape[0]

    def pad(arr, fill=0.0):
        if arr.dim() == 0 or arr.shape[0] != nc:
            return arr
        block = torch.full((extra,) + tuple(arr.shape[1:]), fill,
                           dtype=arr.dtype, device=arr.device)
        return torch.cat([arr.detach(), block], 0)

    def pad_group(group, **fills):
        return type(group)(**{
            f.name: pad(getattr(group, f.name), fills.get(f.name, 0.0))
            for f in dataclasses.fields(group)})

    new_params = pad_group(params, opacity=-1e4)
    new_params.rotation[nc:, 0] = 1.0
    new_meta = pad_group(meta)
    new_opt = dataclasses.replace(opt_state, mu=pad_group(opt_state.mu),
                                  nu=pad_group(opt_state.nu))
    return new_params, new_meta, new_opt
