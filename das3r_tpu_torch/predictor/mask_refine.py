"""Dynamic-mask video refinement (a copy of ``das3r_tpu/predictor/
mask_refine.py``, which is numpy only, so the copy computes the same
masks) — the SAM2 hook of the reference
(cloud_opt/optimizer.py:226-301 ``refine_motion_mask_w_sam2``, default-off
``sam2_mask_refine=False`` training.py:122; the sam2 import itself is
commented out upstream :14-16).

The reference protocol is parity-split cross-propagation: seed a video
propagator with the ODD frames' masks and keep its predictions on EVEN
frames, then the reverse, finally OR the propagated masks into the
originals. That protocol is reproduced here around a pluggable
``VideoMaskPropagator``; two implementations ship:

* ``NeighborPropagator`` (default, dependency-free): each unseeded frame
  takes its nearest seeded neighbor's mask dilated proportionally to the
  temporal distance, optionally intersected with the frame's own soft
  dynamicness prior (``dyna_avg``) so dilation cannot leak into
  confidently-static regions.
* ``Sam2Propagator``: binds to an external `sam2` package when one is
  installed (the repository holds neither — an external checkpoint, same
  status as the reference).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _dilate(mask: np.ndarray, iterations: int) -> np.ndarray:
    if iterations <= 0:
        return mask
    try:
        from scipy import ndimage
        return ndimage.binary_dilation(mask, iterations=iterations)
    except ImportError:        # numpy fallback: iterated 4-neighbour max
        m = mask.copy()
        for _ in range(iterations):
            g = m.copy()
            g[1:] |= m[:-1]
            g[:-1] |= m[1:]
            g[:, 1:] |= m[:, :-1]
            g[:, :-1] |= m[:, 1:]
            m = g
        return m


@dataclasses.dataclass
class NeighborPropagator:
    """Flow-free stand-in for SAM2 video propagation: nearest seeded
    neighbor's mask, dilated by ``dilate_per_step`` px per frame of
    temporal distance; with a ``prior`` ([F, H, W] soft dynamicness) the
    dilated mask is confined to ``prior > prior_thre``."""

    dilate_per_step: int = 2
    prior: np.ndarray | None = None
    prior_thre: float = 0.2

    def propagate(self, images01, seeds: dict[int, np.ndarray],
                  n_frames: int) -> dict[int, np.ndarray]:
        del images01
        out = {}
        seed_idx = sorted(seeds)
        if not seed_idx:
            return out
        for t in range(n_frames):
            if t in seeds:
                continue
            s = min(seed_idx, key=lambda i: abs(i - t))
            m = _dilate(seeds[s].astype(bool),
                        self.dilate_per_step * abs(t - s))
            if self.prior is not None:
                m = m & (self.prior[t] > self.prior_thre)
            out[t] = m
        return out


class Sam2Propagator:
    """Adapter for an externally-installed SAM2 video predictor (the
    reference's exact backend). Raises at construction when `sam2` is not
    importable: the repository holds no external checkpoint."""

    def __init__(self, checkpoint: str, model_cfg: str):
        try:
            from sam2.build_sam import build_sam2_video_predictor
        except ImportError as e:
            raise ImportError(
                "Sam2Propagator needs the external `sam2` package and "
                "checkpoint (reference optimizer.py:233-241); install them "
                "or use the default NeighborPropagator") from e
        self._predictor = build_sam2_video_predictor(model_cfg, checkpoint)

    def propagate(self, images01, seeds, n_frames):
        state = self._predictor.init_state(video_path=np.asarray(images01))
        self._predictor.reset_state(state)
        for idx, mask in seeds.items():
            self._predictor.add_new_mask(state, frame_idx=idx, obj_id=1,
                                         mask=mask)
        out = {}
        for f_idx, obj_ids, logits in \
                self._predictor.propagate_in_video(state, start_frame_idx=0):
            out[f_idx] = np.asarray(logits[0] > 0.0).squeeze()
        return {t: m for t, m in out.items() if t not in seeds}


def refine_motion_masks(masks: np.ndarray, images01=None,
                        propagator=None) -> np.ndarray:
    """Parity-split cross-propagation + OR (optimizer.py:248-292).

    ``masks``: [F, H, W] bool. Seeds odd frames -> keeps propagated even
    frames; seeds even -> keeps odd; result = original | propagated."""
    masks = np.asarray(masks).astype(bool)
    F = masks.shape[0]
    if propagator is None:
        propagator = NeighborPropagator()
    out = masks.copy()
    for keep_parity in (0, 1):
        seeds = {i: masks[i] for i in range(F) if i % 2 != keep_parity}
        prop = propagator.propagate(images01, seeds, F)
        for t, m in prop.items():
            if t % 2 == keep_parity:
                out[t] |= m.astype(bool)
    return out
