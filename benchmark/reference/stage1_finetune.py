"""The plain reference of DAS3R's stage-1 fine-tuning step: the published
criterion ``ConfLoss(Regr3D_MMask(L21, norm_mode='avg_dis'), alpha=0.2)``
(dynamic_predictor/dust3r/losses.py:54-61, 142-338, as SURVEY.md cites
it; DAS3R_b32_g4.sh:10), the recipe's AdamW (beta2 0.95, weight decay
0.05) and its per-iteration learning rate (croco's
``misc.adjust_learning_rate``: a linear warm-up, then a half cosine), on
the model of ``dust3r_model.py`` with only the two mask heads trained.

A global batch is taken in blocks of rows: each block's loss divides its
sums by the whole batch's counts of valid pixels, so the blocks' losses
and gradients add up to the batch's.

Departures from the published trainer, each shared with the port (and
the JAX package it follows):

* the heads' ``ConvTranspose2d`` biases train one per kernel tap
  (``dust3r_model.untie_upsample_bias``), where the published model ties
  them per output channel;
* the weight decay acts on every trained tensor; the published parameter
  groups (croco ``misc.get_parameter_groups``) leave biases and other
  1-D tensors undecayed;
* the mask heads' ``Dropout(0.1)`` is the identity (a random mask cannot
  be followed step by step), and the criterion runs in float32 without
  the published AMP loss scaler;
* the mask term is taken over the valid pixels, as the pointmap terms
  are (every pixel of the benchmark's stand-in data is valid).

Imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import dust3r_model as ref_model

TRAINED = ("downstream_head_dynamic_mask1", "downstream_head_dynamic_mask2")
FIELDS = ("img1", "img2", "gt_pts3d_1", "gt_pts3d_2", "camera_pose_1",
          "valid_1", "valid_2", "gt_mask_1", "gt_mask_2")


@dataclasses.dataclass(frozen=True)
class Recipe:
    lr: float = 5e-5
    min_lr: float = 1e-8
    warmup_epochs: float = 1.0
    epochs: int = 50
    steps_per_epoch: int = 312
    weight_decay: float = 0.05
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    alpha: float = 0.2


def lr_at(step: int, r: Recipe) -> float:
    """croco ``misc.adjust_learning_rate`` at iteration ``step`` (from 0):
    the epoch is fractional, ``step / steps_per_epoch``."""
    epoch = step / r.steps_per_epoch
    if epoch < r.warmup_epochs:
        return r.lr * epoch / r.warmup_epochs
    t = (epoch - r.warmup_epochs) / (r.epochs - r.warmup_epochs)
    return r.min_lr + (r.lr - r.min_lr) * 0.5 * (1 + math.cos(math.pi * t))


def trained_model(model: torch.nn.Module) -> dict:
    """The mask heads' parameters by state-dict name, after untying the
    upsampling biases; every other parameter frozen."""
    ref_model.untie_upsample_bias(model)
    out = {}
    for name, p in model.named_parameters():
        p.requires_grad_(name.split(".")[0] in TRAINED)
        if p.requires_grad:
            out[name] = p
    return out


def _to_camera1(pts: torch.Tensor, pose1: torch.Tensor) -> torch.Tensor:
    """World points [B, H, W, 3] into view 1's camera: the inverse of the
    rigid cam-to-world ``pose1`` [B, 4, 4]."""
    rot = pose1[:, :3, :3]
    t = pose1[:, :3, 3]
    local = (pts - t[:, None, None, :])
    return torch.einsum("bhwj,bjk->bhwk", local, rot)


def _avg_dis(p1, p2, v1, v2):
    """Both views over one factor per row: the mean distance from the
    origin of the valid points of both (``normalize_pointcloud``,
    norm_mode 'avg_dis')."""
    d = ((p1.norm(dim=-1) * v1).sum((1, 2)) + (p2.norm(dim=-1) * v2).sum((1, 2)))
    n = v1.sum((1, 2)) + v2.sum((1, 2))
    f = (d / (n + 1e-8)).clamp(min=1e-8)[:, None, None, None]
    return p1 / f, p2 / f


def _bce(p, t):
    """``nn.BCELoss(reduction='none')``: each log clamped at -100."""
    return -(t * p.log().clamp(min=-100)
             + (1 - t) * (1 - p).log().clamp(min=-100))


def counts(rows: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The global batch's valid pixels of each view: the denominators of
    every mean."""
    return rows["valid_1"].sum(), rows["valid_2"].sum()


def block_loss(res1: dict, res2: dict, rows: dict, dens, alpha: float):
    """This block's share of the batch's criterion: each of the four
    conf-weighted means (pointmap and mask, either view) summed over the
    block's valid pixels and divided by the batch's count ``dens``."""
    v1, v2 = rows["valid_1"].float(), rows["valid_2"].float()
    gt1 = _to_camera1(rows["gt_pts3d_1"], rows["camera_pose_1"])
    gt2 = _to_camera1(rows["gt_pts3d_2"], rows["camera_pose_1"])
    pr1, pr2 = _avg_dis(res1["pts3d"], res2["pts3d_in_other_view"], v1, v2)
    gt1, gt2 = _avg_dis(gt1, gt2, v1, v2)
    total = 0.0
    for dist, mask, res, v, den in (
            ((pr1 - gt1).norm(dim=-1), (res1["dynamic_mask"],
                                        rows["gt_mask_1"]), res1, v1,
             dens[0]),
            ((pr2 - gt2).norm(dim=-1), (res2["dynamic_mask"],
                                        rows["gt_mask_2"]), res2, v2,
             dens[1])):
        conf = res["conf"].detach()
        for term in (dist, _bce(*mask)):
            total = total + ((term * conf - alpha * conf.log()) * v).sum() / den
    return total


@torch.no_grad()
def adamw(params: dict, grads: dict, state: dict, step: int, lr: float,
          r: Recipe) -> None:
    """``torch.optim.AdamW``'s update of every tensor, step ``step`` from 1:
    decoupled decay, then the bias-corrected moment ratio."""
    bc1, bc2 = 1 - r.b1 ** step, 1 - r.b2 ** step
    for k, p in params.items():
        g = grads[k]
        m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(r.b1).add_(g, alpha=1 - r.b1)
        v.mul_(r.b2).addcmul_(g, g, value=1 - r.b2)
        p.mul_(1 - lr * r.weight_decay)
        p.addcdiv_(m, (v.sqrt() / math.sqrt(bc2)).add_(r.eps),
                   value=-lr / bc1)


def follow(model: torch.nn.Module, params: dict, batches, block: int,
           r: Recipe, dev, first_step: int = 0) -> tuple[list, dict, dict]:
    """``len(batches)`` steps on global batches (dicts of ``FIELDS`` ->
    [B, ...] host arrays), the learning rate's iterations counted from
    ``first_step`` and AdamW's moments from zero. Returns each step's
    loss, each trained tensor's first gradient norm and its change's norm
    after the last step."""
    start = {k: p.detach().clone() for k, p in params.items()}
    state: dict = {}
    losses, g1 = [], None
    for i, batch in enumerate(batches):
        rows = {k: torch.as_tensor(batch[k], device=dev) for k in FIELDS}
        dens = counts(rows)
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        loss = 0.0
        for a in range(0, len(rows["img1"]), block):
            blk = {k: v[a:a + block] for k, v in rows.items()}
            res1, res2 = model(blk["img1"], blk["img2"])
            part = block_loss(res1, res2, blk, dens, r.alpha)
            for k, g in zip(params, torch.autograd.grad(
                    part, list(params.values()))):
                grads[k] += g
            loss += float(part.detach())
            del res1, res2, part
        losses.append(loss)
        if i == 0:
            g1 = norms(grads)
        adamw(params, grads, state, i + 1, lr_at(first_step + i, r), r)
        del rows, grads
    change = norms({k: params[k] - start[k] for k in params})
    return losses, g1, change


@torch.no_grad()
def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}
