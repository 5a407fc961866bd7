"""Monocular/video depth evaluation (port of ``das3r_tpu/eval/depth.py``,
numpy): abs-rel / delta metrics with least-squares or median
scale(-shift) alignment (reference dynamic_predictor/dust3r/
depth_eval.py:94-148+).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DepthMetrics:
    abs_rel: float
    sq_rel: float
    rmse: float
    rmse_log: float
    delta_1: float   # d < 1.25
    delta_2: float   # d < 1.25^2
    delta_3: float   # d < 1.25^3


def align_depth(pred: np.ndarray, gt: np.ndarray, valid: np.ndarray,
                mode: str = "scale&shift"):
    """Align pred to gt over valid pixels. Returns aligned pred.

    Modes mirror the reference depth_evaluation alignment flags
    (depth_eval.py:148-262): ``scale&shift`` = align_with_lstsq,
    ``scale`` = the default median-ratio path, ``scale_weiszfeld`` =
    align_with_scale (closed-form L2 scale + 10 Weiszfeld IRLS rounds,
    clamped at 1e-3), ``lad`` = align_with_lad (L1-optimal scale+shift,
    solved by IRLS instead of scipy.minimize — same objective),
    ``none`` = raw."""
    p = pred[valid].astype(np.float64)
    g = gt[valid].astype(np.float64)
    if mode == "scale&shift":
        A = np.stack([p, np.ones_like(p)], 1)
        (s, t), *_ = np.linalg.lstsq(A, g, rcond=None)
        return pred * s + t
    if mode == "scale":
        s = np.median(g) / max(np.median(p), 1e-12)
        return pred * s
    if mode == "scale_weiszfeld":
        s = np.mean(g) / max(np.mean(p), 1e-12)
        for _ in range(10):
            w = 1.0 / (np.abs(s * p - g) + 1e-8)
            s = np.sum(w * p * g) / max(np.sum(w * p * p), 1e-12)
        return pred * max(s, 1e-3)
    if mode == "lad":
        # L1-optimal s, t via IRLS (the reference minimizes the same
        # sum |s p + t - g| with scipy; IRLS converges to the same
        # optimum and is dependency-free)
        s = np.median(g) / max(np.median(p), 1e-12)
        t = 0.0
        for _ in range(50):
            w = 1.0 / (np.abs(s * p + t - g) + 1e-8)
            A = np.stack([p, np.ones_like(p)], 1) * np.sqrt(w)[:, None]
            b = g * np.sqrt(w)
            (s, t), *_ = np.linalg.lstsq(A, b, rcond=None)
        return pred * s + t
    if mode == "none":
        return pred
    raise ValueError(mode)


def depth_metrics(pred: np.ndarray, gt: np.ndarray,
                  valid: np.ndarray | None = None,
                  align: str = "scale&shift",
                  min_depth: float = 1e-3,
                  max_depth: float = 80.0,
                  disp_input: bool = False) -> DepthMetrics:
    """Per-sequence (or per-frame) depth metrics; pred/gt any same shape.

    ``disp_input``: ``pred`` is a DISPARITY map — align it against the GT
    disparity 1/(gt+1e-8) and convert back to depth for the metrics
    (reference depth_evaluation's disp_input branch,
    depth_eval.py:203-268)."""
    if valid is None:
        valid = np.isfinite(gt)
    valid = valid & (gt > min_depth) & (gt < max_depth) & np.isfinite(pred)
    if disp_input:
        gt_disp = 1.0 / (gt + 1e-8)
        pred = align_depth(pred, gt_disp, valid, align)
        pred = 1.0 / np.maximum(pred, 1e-8)      # back to depth
    else:
        pred = align_depth(pred, gt, valid, align)
    p = np.clip(pred[valid], min_depth, None)
    g = gt[valid]
    thresh = np.maximum(p / g, g / p)
    err = p - g
    return DepthMetrics(
        abs_rel=float(np.mean(np.abs(err) / g)),
        sq_rel=float(np.mean(err ** 2 / g)),
        rmse=float(np.sqrt(np.mean(err ** 2))),
        rmse_log=float(np.sqrt(np.mean((np.log(p) - np.log(g)) ** 2))),
        delta_1=float(np.mean(thresh < 1.25)),
        delta_2=float(np.mean(thresh < 1.25 ** 2)),
        delta_3=float(np.mean(thresh < 1.25 ** 3)))
