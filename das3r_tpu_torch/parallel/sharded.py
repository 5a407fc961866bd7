"""The multi-device training step and render (port of
``das3r_tpu/parallel/sharded.py``): data-parallel over a batch of frames,
tile-parallel inside each render, and optionally Gaussian-sharded
parameters, on a (data, gauss, tile) mesh (``parallel/mesh.py``).

Semantics, as in the JAX package: one step minimises the MEAN loss over a
batch of B frames (B a multiple of the data size; each data rank takes
B / data consecutive frames), the large-batch form of the reference's one
frame per iteration; the camera Adam step is gated on the mean PSNR.
Every rank is given the whole batch and the same call.

Communication (``parallel/collectives.py``, counted by ``comm_stats``):

* tile: each rank blends its range; the tile rows are gathered so the
  image is whole on every rank before ``photometric_loss`` (as JAX
  replicates it, sharded.py:89-97, so the loss does not depend on the
  partition), and the attribute table's gradient is summed over the axis;
* gauss (``gauss_axis="gauss"``): each rank holds its [Nc / g] rows of the
  parameters and Adam moments (``shard_state``, ``shard_meta``),
  preprocesses them, and the screen-space outputs are gathered; the pose,
  FoV and ``conf_static`` gradients are summed over the axis;
* data: the gradients, the loss and the PSNR sums are summed over the
  axis in one all-reduce, the overflow counters take their max in
  another. Every rank then takes the same Adam step on its rows.

The step is a loss-and-gradients pass (``ShardedTrainStep.
loss_and_grads``) and the Adam update (``ShardedTrainStep.update``);
calling the step runs both. Densification stays outside, as in JAX.
Parameters and moments are updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist

from das3r_tpu_torch.models import render as render_mod
from das3r_tpu_torch.models.gaussians import GaussianMeta, GaussianParams
from das3r_tpu_torch.ops.splat import RasterSettings
from das3r_tpu_torch.parallel import collectives
from das3r_tpu_torch.parallel.mesh import Mesh
from das3r_tpu_torch.train import loss as loss_mod
from das3r_tpu_torch.train import optim
from das3r_tpu_torch.train import step as step_mod
from das3r_tpu_torch.train.config import OptimizationConfig
from das3r_tpu_torch.utils.device import on_device, resolve_device

# GaussianParams fields with one row per Gaussian (conf_static is per
# frame and pixel, whole on every rank)
GAUSSIAN_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                   "rotation", "opacity")


def gauss_rows(mesh: Mesh, capacity: int) -> slice:
    """This rank's rows of the Gaussian axis."""
    g = mesh.shape["gauss"]
    if capacity % g:
        raise ValueError(f"capacity {capacity} does not divide by the "
                         f"gauss axis ({g})")
    m = capacity // g
    return slice(mesh.coords["gauss"] * m, (mesh.coords["gauss"] + 1) * m)


def _shard_params(params: GaussianParams, rows: slice) -> GaussianParams:
    return dataclasses.replace(params, **{
        k: getattr(params, k)[rows].clone() for k in GAUSSIAN_FIELDS})


def shard_state(state: step_mod.TrainState, mesh: Mesh
                ) -> step_mod.TrainState:
    """This rank's part of a whole ``TrainState`` under Gaussian sharding:
    its rows of the parameters and both Adam moments (copies), the rest as
    it is (the JAX package's ``gauss_state_spec``)."""
    rows = gauss_rows(mesh, state.params.xyz.shape[0])
    opt = state.opt
    return dataclasses.replace(
        state, params=_shard_params(state.params, rows),
        opt=optim.AdamState(count=opt.count.clone(),
                            mu=_shard_params(opt.mu, rows),
                            nu=_shard_params(opt.nu, rows)))


def shard_meta(meta: GaussianMeta, mesh: Mesh) -> GaussianMeta:
    """This rank's rows of ``meta`` (``gauss_meta_spec``)."""
    rows = gauss_rows(mesh, meta.alive.shape[0])
    return GaussianMeta(**{f.name: getattr(meta, f.name)[rows].clone()
                           for f in dataclasses.fields(meta)})


class LossStats(NamedTuple):
    """The batch's loss and mean PSNR (summed over the data axis) and its
    overflow counters (max over the data axis), 0-d tensors."""
    loss: torch.Tensor
    psnr: torch.Tensor
    entry_overflow: torch.Tensor
    tile_overflow: torch.Tensor
    dup_overflow: torch.Tensor
    heavy_overflow: torch.Tensor
    heavy_rows: torch.Tensor


def _flat(groups) -> list[torch.Tensor]:
    return [getattr(g, f.name) for g in groups
            for f in dataclasses.fields(g)]


class ShardedTrainStep:
    """``make_sharded_train_step``'s step (module docstring)."""

    def __init__(self, mesh: Mesh, settings: RasterSettings,
                 cfg: OptimizationConfig, spatial_lr_scale: float = 1.0,
                 gauss_axis: str | None = None, device=None):
        if gauss_axis not in (None, "gauss"):
            raise ValueError(f"gauss_axis must be 'gauss' or None, not "
                             f"{gauss_axis!r}")
        self.mesh, self.settings, self.cfg = mesh, settings, cfg
        self.spatial_lr_scale = spatial_lr_scale
        self.device = resolve_device(device)
        self.tile_group = mesh.group("tile")
        self.gauss_group = mesh.group("gauss") if gauss_axis else None
        self.data_group = mesh.group("data")

    def frames(self, batch: int) -> range:
        """This rank's frames of a batch of ``batch``."""
        d = self.mesh.shape["data"]
        if batch % d:
            raise ValueError(f"a batch of {batch} frames does not divide "
                             f"over data={d}")
        per = batch // d
        i = self.mesh.coords["data"]
        return range(i * per, (i + 1) * per)

    def loss_and_grads(self, state: step_mod.TrainState, meta: GaussianMeta,
                       uids, gts, fovx, fovy, bg):
        """(gradients of the parameters, of the poses, ``LossStats``) of the
        batch's mean loss: each rank's gradients are those of the rows it
        holds, summed over the mesh as the module docstring says, so every
        rank of a data line holds the same."""
        dev = self.device
        params, poses = state.params, state.poses
        groups = (params, poses)
        batch = len(uids)
        gts, bg = on_device(gts, dev), on_device(bg, dev, torch.float32)
        step_mod._require_grad(*groups)
        flat = torch.zeros(sum(x.numel() for x in _flat(groups)) + 2,
                           device=dev)
        maxes = torch.zeros(5, dtype=torch.int64, device=dev)
        for f in self.frames(batch):
            uid = int(uids[f])
            out = render_mod.render(
                params, meta, self.settings, poses.pose(uid), bg, fovx[f],
                fovy[f], mode="train", device=dev,
                tile_group=self.tile_group, gauss_group=self.gauss_group)
            ph = loss_mod.photometric_loss(out.image, gts[f],
                                           params.conf_static[uid],
                                           self.cfg.lambda_dssim)
            (g_params, g_poses), _ = step_mod._grads(ph.loss / batch,
                                                     groups)
            flat += torch.cat(
                [torch.zeros(x.numel(), device=dev) if g is None
                 else g.reshape(-1) for g, x in zip(
                     _flat((g_params, g_poses)), _flat(groups))]
                + [ph.loss.detach().reshape(1),
                   ph.psnr_frame.detach().reshape(1)])
            a = out.aux
            maxes = torch.maximum(maxes, torch.stack([
                a.entry_overflow, a.tile_overflow, a.dup_overflow,
                a.heavy_overflow, a.heavy_rows]).to(torch.int64))
        collectives.all_reduce(flat, self.data_group, tag="grads")
        collectives.all_reduce(maxes, self.data_group, dist.ReduceOp.MAX,
                               tag="overflow")
        grads, i = [], 0
        for g in groups:
            fields = {}
            for fld in dataclasses.fields(g):
                x = getattr(g, fld.name)
                fields[fld.name] = flat[i:i + x.numel()].view_as(x)
                i += x.numel()
            grads.append(type(g)(**fields))
        stats = LossStats(flat[i] / batch, flat[i + 1] / batch, *maxes)
        return grads[0], grads[1], stats

    def update(self, state: step_mod.TrainState, g_params, g_poses,
               stats: LossStats) -> step_mod.StepMetrics:
        """The Adam steps of ``state``, in place: the main group always, the
        camera group gated on the mean PSNR (the same on every rank)."""
        gstep = state.step + 1
        optim.adam_step(state.params, g_params, state.opt,
                        optim.gaussian_lrs(gstep, self.cfg,
                                           self.spatial_lr_scale))
        gate = stats.psnr > self.cfg.psnr_threshold
        optim.adam_step(state.poses, g_poses, state.opt_cam,
                        optim.camera_lrs(gstep, self.cfg), gate=gate)
        state.step = gstep
        return step_mod.StepMetrics(
            loss=stats.loss, psnr=stats.psnr, cam_stepped=gate,
            radii_nonzero=torch.zeros((), dtype=torch.int64,
                                      device=gate.device),
            entry_overflow=stats.entry_overflow,
            tile_overflow=stats.tile_overflow,
            dup_overflow=stats.dup_overflow,
            heavy_overflow=stats.heavy_overflow,
            heavy_rows=stats.heavy_rows)

    def __call__(self, state: step_mod.TrainState, meta: GaussianMeta, uids,
                 gts, fovx, fovy, bg):
        """One step: returns (state, ``StepMetrics``); ``state`` is
        updated in place."""
        g_params, g_poses, stats = self.loss_and_grads(
            state, meta, uids, gts, fovx, fovy, bg)
        return state, self.update(state, g_params, g_poses, stats)


def make_sharded_train_step(mesh: Mesh, settings: RasterSettings,
                            cfg: OptimizationConfig,
                            spatial_lr_scale: float = 1.0,
                            gauss_axis: str | None = None,
                            device=None) -> ShardedTrainStep:
    """``step(state, meta, uids[B], gts[B, 3, H, W], fovx[B], fovy[B], bg)
    -> (state, StepMetrics)``: B frames over the data axis, each frame's
    tiles over the tile axis, and, with ``gauss_axis="gauss"``, the
    Gaussian rows of ``state`` and ``meta`` over the gauss axis (give each
    rank ``shard_state`` and ``shard_meta``; the capacity must divide by
    the axis). The mesh of ``make_mesh(world_size=1)`` is the unsharded
    batched step."""
    return ShardedTrainStep(mesh, settings, cfg, spatial_lr_scale,
                            gauss_axis, device)


def make_sharded_render(mesh: Mesh, settings: RasterSettings, device=None):
    """``render_fn(params, meta, pose, bg, fovx, fovy) -> [3, H, W]``: one
    frame (mode "train") with its tiles over the mesh's tile axis; the
    image is whole on every rank."""
    dev = resolve_device(device)

    def render_fn(params, meta, pose, bg, fovx, fovy):
        return render_mod.render(params, meta, settings, pose, bg, fovx,
                                 fovy, mode="train", device=dev,
                                 tile_group=mesh.group("tile")).image

    return render_fn


def main(argv=None) -> None:
    """Three sharded steps on a random scene (4096 Gaussians, 64x96), one
    process per rank:

        torchrun --nproc_per_node 2 -m das3r_tpu_torch.parallel.sharded \\
            --tile 2 --device cpu

    Each rank joins through ``torchrun``'s ``env://`` variables; the
    primary rank prints each step's metrics and the collectives' bytes as
    one JSON line."""
    import argparse
    import json

    import numpy as np

    from das3r_tpu_torch.data import synthetic
    from das3r_tpu_torch.parallel import comm_stats, multihost
    from das3r_tpu_torch.parallel.mesh import make_mesh

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n\n")[0])
    for axis in ("data", "gauss", "tile"):
        ap.add_argument(f"--{axis}", type=int, default=None)
    ap.add_argument("--gauss_sharded", action="store_true",
                    help="shard the Gaussians over the gauss axis")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    multihost.initialize_distributed(device=dev.type)
    try:
        mesh = make_mesh(data=args.data, tile=args.tile, gauss=args.gauss)
        h, w = 64, 96
        batch = mesh.shape["data"]
        params, meta, poses = synthetic.random_gaussian_scene(
            4096, n_frames=batch, height=h, width=w, seed=0, device=dev)
        gts = torch.as_tensor(np.random.default_rng(1).uniform(
            0, 1, (batch, 3, h, w)).astype(np.float32), device=dev)
        state = step_mod.init_train_state(params, poses)
        gauss_axis = "gauss" if args.gauss_sharded else None
        if gauss_axis:
            state, meta = shard_state(state, mesh), shard_meta(meta, mesh)
        settings = RasterSettings(image_height=h, image_width=w)
        step = make_sharded_train_step(mesh, settings, OptimizationConfig(),
                                       gauss_axis=gauss_axis, device=dev)
        fov = torch.ones(batch)
        for k in range(3):
            with comm_stats.CommStats() as stats:
                _, m = step(state, meta, list(range(batch)), gts, fov, fov,
                            torch.zeros(3))
            if multihost.is_primary():
                print(json.dumps(dict(step=k + 1, mesh=mesh.shape,
                                      loss=float(m.loss),
                                      psnr=float(m.psnr),
                                      comm=stats.families())), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
