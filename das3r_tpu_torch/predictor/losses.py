"""Stage-1 training criteria (port of ``das3r_tpu/predictor/losses.py``):
the mask-head training losses of the reference
(dynamic_predictor/dust3r/losses.py):

  * ``regr3d_mmask``: anchor-frame pointmap regression (L21 on avg-dis
    normalized points, :142-194) + BCE on the dynamic masks (:196-288);
  * ``conf_loss``: confidence-weighted total, ``loss*conf - alpha*log conf``
    applied to BOTH the pts3d and the mask terms (:290-338).

The DAS3R training criterion is
``ConfLoss(Regr3D_MMask(L21, norm_mode='avg_dis'), alpha=0.2)``
(DAS3R_b32_g4.sh:10). Every reduction is a masked mean over the whole
batch; with a process ``group`` (the data axis of the sharded step) its
numerator and denominator are summed over the group's ranks before the
division, so a shard's loss is the global batch's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from das3r_tpu_torch.parallel import collectives
from das3r_tpu_torch.utils.device import on_device
from das3r_tpu_torch.utils.quat import se3_inverse
from das3r_tpu_torch.utils.transforms import geotrf


def _masked_mean(x, mask, group=None):
    m = mask.to(x.dtype)
    num = collectives.reduce_sum((x * m).sum(), group, "stage1_loss")
    den = collectives.reduce_sum(m.sum(), group, "stage1_loss")
    return num / torch.clamp_min(den, 1.0)


def normalize_pointcloud_pair(pts1, pts2, valid1, valid2, eps=1e-8):
    """Joint 'avg_dis' normalization over both views, per batch element
    (reference dust3r/utils/geometry.py:253-316)."""
    d1 = torch.linalg.norm(pts1, dim=-1)
    d2 = torch.linalg.norm(pts2, dim=-1)
    w1 = valid1.to(pts1.dtype)
    w2 = valid2.to(pts2.dtype)
    num = (d1 * w1).sum(dim=(1, 2)) + (d2 * w2).sum(dim=(1, 2))
    den = w1.sum(dim=(1, 2)) + w2.sum(dim=(1, 2))
    norm = torch.clamp_min(num / torch.clamp_min(den, 1.0), eps)
    norm = norm[:, None, None, None]
    return pts1 / norm, pts2 / norm


class Stage1Batch(NamedTuple):
    """One two-view training batch (all [B, ...]): numpy arrays as the
    datasets yield them, tensors after ``to``."""
    gt_pts3d_1: object        # [B, H, W, 3] world frame
    gt_pts3d_2: object
    camera_pose_1: object     # [B, 4, 4] cam-to-world of view 1
    valid_1: object           # [B, H, W] bool
    valid_2: object
    gt_mask_1: object         # [B, H, W] in {0, 1}
    gt_mask_2: object

    def to(self, device) -> "Stage1Batch":
        return Stage1Batch(*(on_device(x, device) for x in self))


class Stage1LossOut(NamedTuple):
    total: torch.Tensor
    pts3d_1: torch.Tensor
    pts3d_2: torch.Tensor
    mask_1: torch.Tensor
    mask_2: torch.Tensor


def bce(pred_prob, target, eps=1e-7):
    """JAX's clipped BCE (``F.binary_cross_entropy`` instead clamps the
    log at -100)."""
    p = torch.clamp(pred_prob, eps, 1 - eps)
    return -(target * torch.log(p) + (1 - target) * torch.log1p(-p))


def _in_cam1(batch: Stage1Batch):
    """Both views' ground-truth points in view 1's camera frame."""
    in_cam1 = se3_inverse(batch.camera_pose_1)
    B, H, W, _ = batch.gt_pts3d_1.shape

    def trf(p):
        return geotrf(in_cam1, p.reshape(B, -1, 3)).reshape(B, H, W, 3)
    return trf(batch.gt_pts3d_1), trf(batch.gt_pts3d_2)


def conf_regr3d_mmask_loss(batch: Stage1Batch, res1: dict, res2: dict,
                           alpha: float = 0.2, norm_gt: bool = True,
                           group=None) -> Stage1LossOut:
    """The full DAS3R criterion for one batch of pairs (tensors). With
    ``group``, the batch is this rank's rows of the group's and every
    mean is over the whole (module docstring)."""
    gt1, gt2 = _in_cam1(batch)
    valid1, valid2 = batch.valid_1, batch.valid_2
    pr1, pr2 = normalize_pointcloud_pair(res1["pts3d"],
                                         res2["pts3d_in_other_view"],
                                         valid1, valid2)
    if norm_gt:
        gt1, gt2 = normalize_pointcloud_pair(gt1, gt2, valid1, valid2)

    l1 = torch.linalg.norm(pr1 - gt1, dim=-1)     # L21, [B, H, W]
    l2 = torch.linalg.norm(pr2 - gt2, dim=-1)
    m1 = bce(res1["dynamic_mask"], batch.gt_mask_1)
    m2 = bce(res2["dynamic_mask"], batch.gt_mask_2)

    # confidence weighting (conf comes from the frozen heads: constants)
    conf1 = res1["conf"].detach()
    conf2 = res2["conf"].detach()
    logc1 = torch.log(conf1)
    logc2 = torch.log(conf2)

    def mean(x, v):
        return _masked_mean(x, v, group)
    cl1 = mean(l1 * conf1 - alpha * logc1, valid1)
    cl2 = mean(l2 * conf2 - alpha * logc2, valid2)
    cm1 = mean(m1 * conf1 - alpha * logc1, valid1)
    cm2 = mean(m2 * conf2 - alpha * logc2, valid2)
    return Stage1LossOut(total=cl1 + cl2 + cm1 + cm2,
                         pts3d_1=mean(l1, valid1), pts3d_2=mean(l2, valid2),
                         mask_1=mean(m1, valid1), mask_2=mean(m2, valid2))


def _nanmedian(x, dim, keepdim=False):
    """JAX's ``nanmedian``: the mean of the two middle values on an even
    count (``torch.nanmedian`` takes the lower one)."""
    return torch.nanquantile(x, 0.5, dim=dim, keepdim=keepdim)


def _nan_where(x, valid):
    return torch.where(valid, x, torch.full_like(x, float("nan")))


def joint_median_depth(z1, z2, valid1, valid2):
    """Median z over both views, invalid -> NaN-ignored
    (reference dust3r/utils/geometry.py:317-330). Returns [B]."""
    B = z1.shape[0]
    z = torch.cat([_nan_where(z1, valid1).reshape(B, -1),
                   _nan_where(z2, valid2).reshape(B, -1)], -1)
    return _nanmedian(z, -1)


def joint_center_scale(pts1, pts2, valid1, valid2):
    """Median center + median distance-to-center over both views
    (geometry.py:332-347). Returns (center [B,1,1,3], scale [B])."""
    B = pts1.shape[0]
    p = torch.cat([_nan_where(pts1, valid1[..., None]).reshape(B, -1, 3),
                   _nan_where(pts2, valid2[..., None]).reshape(B, -1, 3)], 1)
    center = _nanmedian(p, 1, keepdim=True)                  # [B, 1, 3]
    norm = torch.linalg.norm(p - center, dim=-1)
    return center[:, None], _nanmedian(norm, 1)


@torch.no_grad()
def regr3d_scale_shift_inv_loss(batch: Stage1Batch, res1: dict, res2: dict,
                                gt_scale: bool = True) -> Stage1LossOut:
    """Regr3D_ScaleShiftInv(L21, gt_scale=True), the stage-1 TEST criterion
    (reference losses.py:341-400, MRO runs ShiftInv then ScaleInv):
    avg-dis normalize predictions, subtract the joint median depth from
    both, then rescale predictions onto the GT's median scale before the
    L21. Every median is over the valid pixels; an evaluation metric, so
    no gradient."""
    gt1, gt2 = _in_cam1(batch)
    valid1, valid2 = batch.valid_1, batch.valid_2
    # Regr3D.get_all_pts3d with gt_scale=True: preds normalized, gt raw
    pr1, pr2 = normalize_pointcloud_pair(res1["pts3d"],
                                         res2["pts3d_in_other_view"],
                                         valid1, valid2)

    # ShiftInv: subtract the joint median depth (z channel only)
    gt_shift = joint_median_depth(gt1[..., 2], gt2[..., 2], valid1, valid2)
    pr_shift = joint_median_depth(pr1[..., 2], pr2[..., 2], valid1, valid2)

    def shift(p, s):
        return torch.cat([p[..., :2], p[..., 2:] - s[:, None, None, None]],
                         -1)
    gt1, gt2 = shift(gt1, gt_shift), shift(gt2, gt_shift)
    pr1, pr2 = shift(pr1, pr_shift), shift(pr2, pr_shift)

    # ScaleInv: rescale predictions onto the GT scale (or both to unit)
    _, gts = joint_center_scale(gt1, gt2, valid1, valid2)
    _, prs = joint_center_scale(pr1, pr2, valid1, valid2)
    prs = torch.clamp(prs, 1e-3, 1e3)
    if gt_scale:
        r = (gts / prs)[:, None, None, None]
        pr1, pr2 = pr1 * r, pr2 * r
    else:
        pr1 = pr1 / prs[:, None, None, None]
        pr2 = pr2 / prs[:, None, None, None]
        gt1 = gt1 / gts[:, None, None, None]
        gt2 = gt2 / gts[:, None, None, None]

    l1 = torch.linalg.norm(pr1 - gt1, dim=-1)
    l2 = torch.linalg.norm(pr2 - gt2, dim=-1)
    z = torch.zeros((), device=l1.device)
    return Stage1LossOut(
        total=_masked_mean(l1, valid1) + _masked_mean(l2, valid2),
        pts3d_1=_masked_mean(l1, valid1), pts3d_2=_masked_mean(l2, valid2),
        mask_1=z, mask_2=z)
