"""Mask-quality metrics (port of ``das3r_tpu/eval/masks.py``, numpy):
region IoU (J) and boundary F-measure, matching the vendored DAVIS-2017
toolkit the reference evaluates with (dynamic_predictor/davis/davis2017/
metrics.py: db_eval_iou, db_eval_boundary), plus the simple dynamic-mask
IoU used for the table_mask numbers.
"""
from __future__ import annotations

import cv2
import numpy as np


def mask_iou(pred: np.ndarray, gt: np.ndarray, void: np.ndarray | None = None
             ) -> float:
    """Jaccard index of two boolean masks; returns 1.0 when both are empty
    (DAVIS convention)."""
    pred = pred.astype(bool)
    gt = gt.astype(bool)
    if void is not None:
        keep = ~void.astype(bool)
        pred = pred & keep
        gt = gt & keep
    inter = np.logical_and(pred, gt).sum(dtype=np.float64)
    union = np.logical_or(pred, gt).sum(dtype=np.float64)
    if union == 0:
        return 1.0
    return float(inter / union)


def boundary_f_measure(pred: np.ndarray, gt: np.ndarray,
                       bound_th: float = 0.008) -> float:
    """Boundary F-measure with a distance tolerance of
    ``bound_th * image diagonal`` (db_eval_boundary)."""
    pred = pred.astype(bool)
    gt = gt.astype(bool)
    bound_pix = max(1, int(np.ceil(bound_th * np.linalg.norm(pred.shape))))

    fg = _boundary(pred)
    gtb = _boundary(gt)

    # dilate with a disk of radius bound_pix via distance transform
    fg_dil = _dilate(fg, bound_pix)
    gt_dil = _dilate(gtb, bound_pix)

    gt_match = gtb & fg_dil
    fg_match = fg & gt_dil

    n_fg = fg.sum()
    n_gt = gtb.sum()
    if n_fg == 0 and n_gt > 0:
        return 0.0
    if n_fg > 0 and n_gt == 0:
        return 0.0
    if n_fg == 0 and n_gt == 0:
        return 1.0
    precision = fg_match.sum() / n_fg
    recall = gt_match.sum() / n_gt
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))


def _boundary(mask: np.ndarray) -> np.ndarray:
    m = mask.astype(np.uint8)
    er = cv2.erode(m, np.ones((3, 3), np.uint8))
    return (m - er).astype(bool)


def _dilate(mask: np.ndarray, radius: int) -> np.ndarray:
    if not mask.any():
        return mask
    dist = cv2.distanceTransform(
        (~mask).astype(np.uint8), cv2.DIST_L2, 5)
    return dist <= radius


def sequence_mask_iou(preds: np.ndarray, gts: np.ndarray) -> float:
    """Mean per-frame IoU over a sequence [F, H, W] (table_mask metric)."""
    return float(np.mean([mask_iou(p, g) for p, g in zip(preds, gts)]))
