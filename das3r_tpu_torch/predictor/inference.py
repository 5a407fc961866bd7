"""Pairwise inference: run the predictor over a scene graph of frame pairs
(port of ``das3r_tpu/predictor/inference.py``).

Instead of the reference's re-encoding of both images of every pair
(dust3r/inference.py:155-174), every unique frame is encoded once, in
batches, and the decoder and heads run over batches of pairs that gather
the cached encoder tokens. Unlike the JAX package, a last short batch is
not padded: PyTorch needs no static shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from das3r_tpu_torch.models.croco.dust3r import (AsymmetricCroCo3D,
                                                 transposed_result)
from das3r_tpu_torch.utils import trace

# ImgNorm: the stage-1 model takes images normalized to mean .5 / std .5
# (reference dust3r/utils/image.py ImgNorm)
IMG_MEAN = 0.5
IMG_STD = 0.5


def normalize_images(images01: np.ndarray) -> np.ndarray:
    """[F, 3, H, W] in [0, 1] -> ImgNorm'ed."""
    return (images01 - IMG_MEAN) / IMG_STD


@dataclasses.dataclass
class PairPredictions:
    """Stacked per-edge outputs (numpy, ready for alignment)."""
    pred_i: np.ndarray   # [E, H, W, 3]
    pred_j: np.ndarray   # [E, H, W, 3]
    conf_i: np.ndarray   # [E, H, W]
    conf_j: np.ndarray   # [E, H, W]
    mask_i: np.ndarray   # [E, H, W]
    mask_j: np.ndarray   # [E, H, W]


@torch.no_grad()
def encode_frames(model: AsymmetricCroCo3D, imgs: torch.Tensor,
                  encode_batch: int = 8, portrait: bool = False):
    """Encoder tokens and positions of every frame of ``imgs`` [F, 3, H, W]
    (ImgNorm'ed, on the model's device), ``encode_batch`` frames a call."""
    feats, poss = [], []
    for b in range(0, imgs.shape[0], encode_batch):
        f, pos = model.encode(imgs[b:b + encode_batch], portrait=portrait)
        feats.append(f)
        poss.append(pos)
    return torch.cat(feats), torch.cat(poss)


@torch.no_grad()
def decode_pairs(model: AsymmetricCroCo3D, feats, poss, ei, ej,
                 img_h: int, img_w: int, portrait: bool = False):
    """One batch of pairs (index tensors ``ei``, ``ej`` into the cached
    tokens) through the decoder and heads; maps in the buffer layout."""
    r1, r2 = model.decode(feats[ei], poss[ei], feats[ej], poss[ej],
                          img_h, img_w)
    if portrait:
        r1, r2 = transposed_result(r1), transposed_result(r2)
    return r1, r2


def run_pairs(
    model: AsymmetricCroCo3D,
    images01: np.ndarray,          # [F, 3, H, W] in [0, 1]
    edges: list,
    encode_batch: int = 8,
    decode_batch: int = 8,
    portrait: bool = False,
) -> PairPredictions:
    """Encode once, then decode each pair of ``edges``, on the model's
    device.

    ``portrait``: the frames are portrait images stored transposed in the
    landscape [F, 3, H, W] stack (ManyAR); predictions come back in the
    landscape buffer layout, like the reference's transpose_to_landscape
    heads.
    """
    dev = next(model.parameters()).device
    F, _, H, W = images01.shape
    th, tw = (W, H) if portrait else (H, W)     # true orientation
    with trace.span("das3r::run_pairs", frames=F, pairs=len(edges)):
        with trace.sync("frames_to_device"):
            imgs = torch.as_tensor(normalize_images(images01),
                                   dtype=torch.float32, device=dev)
        feats, poss = encode_frames(model, imgs, encode_batch, portrait)

        with trace.sync("edges_to_device", 2):
            ei = torch.as_tensor([i for i, _ in edges], device=dev)
            ej = torch.as_tensor([j for _, j in edges], device=dev)
        out = {k: [] for k in ("pred_i", "pred_j", "conf_i", "conf_j",
                               "mask_i", "mask_j")}
        for b in range(0, len(edges), decode_batch):
            sl = slice(b, b + decode_batch)
            r1, r2 = decode_pairs(model, feats, poss, ei[sl], ej[sl], th, tw,
                                  portrait)
            maps = (("pred_i", r1["pts3d"]),
                    ("pred_j", r2["pts3d_in_other_view"]),
                    ("conf_i", r1["conf"]), ("conf_j", r2["conf"]),
                    ("mask_i", r1["dynamic_mask"]),
                    ("mask_j", r2["dynamic_mask"]))
            with trace.sync("to_host", len(maps)):
                for key, t in maps:
                    out[key].append(t.cpu().numpy())
        return PairPredictions(**{k: np.concatenate(v, 0)
                                  for k, v in out.items()})


def find_opt_scaling(gt_pts1, gt_pts2, pr_pts1, pr_pts2=None,
                     fit_mode: str = "weiszfeld_stop_grad",
                     valid1=None, valid2=None):
    """Per-batch optimal scale s minimizing ||pr - s * gt|| over valid
    pixels (reference dust3r/inference.py:208-252).

    gt/pr: [B, H, W, 3]; validX: [B, H, W] bool or None. As in the JAX
    package, invalid pixels carry weight 0 rather than the reference's
    NaNs. Modes: ``avg`` (closed-form L2), ``median`` (the lower middle
    element, as torch.nanmedian), ``weiszfeld`` (10 IRLS iterations);
    ``*_stop_grad`` detaches."""
    def ones(x):
        return torch.ones(x.shape[:3], dtype=x.dtype, device=x.device)

    pts_g, pts_p = [gt_pts1], [pr_pts1]
    w = [ones(gt_pts1) if valid1 is None else valid1.to(gt_pts1.dtype)]
    if gt_pts2 is not None:
        pts_g.append(gt_pts2)
        pts_p.append(pr_pts2)
        w.append(ones(gt_pts2) if valid2 is None
                 else valid2.to(gt_pts2.dtype))
    B = gt_pts1.shape[0]
    all_gt = torch.cat([p.reshape(B, -1, 3) for p in pts_g], 1)
    all_pr = torch.cat([p.reshape(B, -1, 3) for p in pts_p], 1)
    valid = torch.cat([m.reshape(B, -1) for m in w], 1)

    dot_gt_pr = (all_pr * all_gt).sum(-1)
    dot_gt_gt = (all_gt * all_gt).sum(-1)

    def wmean(x, wt):
        return (x * wt).sum(1) / torch.clamp_min(wt.sum(1), 1e-8)

    if fit_mode.startswith("avg"):
        scaling = wmean(dot_gt_pr, valid) / wmean(dot_gt_gt, valid)
    elif fit_mode.startswith("median"):
        r = dot_gt_pr / torch.clamp_min(dot_gt_gt, 1e-12)
        n_valid = valid.sum(1).to(torch.int64)
        r_s = torch.sort(torch.where(valid > 0, r, torch.inf), dim=1).values
        lo = torch.clamp_min((n_valid - 1) // 2, 0)
        scaling = torch.gather(r_s, 1, lo[:, None])[:, 0]
    elif fit_mode.startswith("weiszfeld"):
        scaling = wmean(dot_gt_pr, valid) / wmean(dot_gt_gt, valid)
        for _ in range(10):
            dis = torch.linalg.norm(
                all_pr - scaling[:, None, None] * all_gt, dim=-1)
            wt = valid / torch.clamp_min(dis, 1e-8)
            scaling = wmean(dot_gt_pr, wt) / wmean(dot_gt_gt, wt)
    else:
        raise ValueError(f"bad {fit_mode=}")

    if fit_mode.endswith("stop_grad"):
        scaling = scaling.detach()
    return torch.clamp_min(scaling, 1e-3)


def apply_manyar(model: AsymmetricCroCo3D, img1, img2,
                 true_shape1: np.ndarray, true_shape2: np.ndarray, **kw):
    """Mixed-orientation two-view forward (the reference's ManyAR boolean
    split, patch_embed.py:55-70, and transpose_to_landscape): the batch is
    grouped by its (portrait1, portrait2) combination, each group runs the
    forward with its flags, and the results merge back in input order, in
    the landscape buffer layout.

    img1/img2: [B, 3, H, W] landscape buffers; true_shapeX: [B, 2] (h, w).
    """
    B = img1.shape[0]
    p1 = np.asarray(true_shape1)[:, 0] > np.asarray(true_shape1)[:, 1]
    p2 = np.asarray(true_shape2)[:, 0] > np.asarray(true_shape2)[:, 1]
    res1: dict = {}
    res2: dict = {}
    for a in (False, True):
        for b in (False, True):
            idx = np.nonzero((p1 == a) & (p2 == b))[0]
            if idx.size == 0:
                continue
            sel = torch.as_tensor(idx, device=img1.device)
            r1, r2 = model(img1[sel], img2[sel], portrait1=a, portrait2=b,
                           **kw)
            for res, r in ((res1, r1), (res2, r2)):
                for k, v in r.items():
                    if k not in res:
                        res[k] = v.new_empty((B,) + v.shape[1:])
                    res[k][sel] = v
    return res1, res2
