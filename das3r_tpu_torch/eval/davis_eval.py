"""DAVIS dynamic-mask evaluation (port of ``das3r_tpu/eval/
davis_eval.py``, numpy): the table_mask IoU protocol (reference
assets/table_mask.png numbers; predicted ``dynamic_mask_*.png`` vs DAVIS
annotations) and per-sequence J&F in the DAVIS-2017 toolkit's style
(davis2017/metrics.py + evaluation.py).
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
from PIL import Image

from das3r_tpu_torch.eval import masks as mask_metrics


def _load_mask(path: str, shape=None) -> np.ndarray:
    m = np.asarray(Image.open(path))
    if m.ndim == 3:
        m = m[..., 0]
    m = m > 0
    if shape is not None and m.shape != shape:
        ys = (np.arange(shape[0]) * m.shape[0] / shape[0]).astype(int)
        xs = (np.arange(shape[1]) * m.shape[1] / shape[1]).astype(int)
        m = m[np.ix_(ys, xs)]
    return m


def eval_sequence_masks(pred_dir: str, gt_dir: str,
                        pred_pattern: str = "dynamic_mask_{i:04d}.png",
                        gt_pattern: str = "{i:05d}.png"):
    """Per-sequence mean IoU (J) and boundary F over aligned frames."""
    preds = sorted(Path(pred_dir).glob(
        pred_pattern.replace("{i:04d}", "*")))
    js, fs = [], []
    for p in preds:
        i = int(p.stem.split("_")[-1])
        gt_path = os.path.join(gt_dir, gt_pattern.format(i=i))
        if not os.path.exists(gt_path):
            continue
        pred = _load_mask(str(p))
        gt = _load_mask(gt_path, shape=pred.shape)
        js.append(mask_metrics.mask_iou(pred, gt))
        fs.append(mask_metrics.boundary_f_measure(pred, gt))
    if not js:
        return None
    return {"J": float(np.mean(js)), "F": float(np.mean(fs)),
            "JF": float((np.mean(js) + np.mean(fs)) / 2),
            "n_frames": len(js)}


def eval_dataset_masks(results_root: str, annotations_root: str,
                       sequences, **kw):
    """The table_mask protocol: average mask IoU across sequences."""
    table = {}
    for seq in sequences:
        r = eval_sequence_masks(os.path.join(results_root, seq),
                                os.path.join(annotations_root, seq), **kw)
        table[seq] = r
    oks = [v for v in table.values() if v]
    summary = {
        "mean_J": float(np.mean([v["J"] for v in oks])) if oks else None,
        "mean_F": float(np.mean([v["F"] for v in oks])) if oks else None,
    }
    return table, summary
