"""Global alignment: pairwise pointmap and mask predictions -> one
consistent set of per-frame depth maps, camera poses, intrinsics and
dynamic-ness maps (port of ``das3r_tpu/predictor/alignment.py``; the
reference's PointCloudOptimizer stack, dynamic_predictor/dust3r/cloud_opt/
base_opt.py:44-619, optimizer.py:30-781, init_im_poses.py:88-364).

  * graph construction, confidence and dynamic-mask aggregation and the
    MST initialization (weighted Umeyama, Weiszfeld focal, RANSAC-PnP by
    cv2) run on the host in numpy, copied from the JAX package as they are;
  * the optimization is one Adam(0.9, 0.9) loop over stacked parameters
    on the device, with autograd: the conf-weighted pairwise 3D loss,
    temporal pose smoothing, the optional ego-flow against precomputed
    optical flow, and the optional scale-invariant depth prior.

Conventions follow the reference: quaternions XYZW (roma), translations
stored signed-log1p, pairwise poses carry a log-scale whose mean is
normalized to base_scale=0.5, focal stored as focal_break * log(f).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from das3r_tpu_torch.data.colmap import rotmat2qvec
from das3r_tpu_torch.predictor import warping
from das3r_tpu_torch.train.optim import adam_init, adam_step
from das3r_tpu_torch.utils import schedules
from das3r_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# config and containers


@dataclasses.dataclass(frozen=True)
class AlignerConfig:
    niter: int = 300
    lr: float = 0.01
    lr_min: float = 1e-3
    schedule: str = "linear"            # linear | cosine | cycleN
    dist: str = "l1"
    conf_mode: str = "log"              # weight transform for confidences
    min_conf_thr: float = 3.0
    base_scale: float = 0.5
    pw_break: float = 20.0
    focal_break: float = 20.0
    shared_focal: bool = True
    optimize_pp: bool = False
    temporal_smoothing_weight: float = 0.01
    translation_weight: float = 0.1
    flow_loss_weight: float = 0.01
    flow_loss_start_ratio: float = 0.15
    flow_loss_thre: float = 25.0
    pxl_thre: float = 50.0
    depth_regularize_weight: float = 0.0
    motion_mask_thre: float = 0.35
    # Known focals (reference preset_focal, optimizer.py:309-334): per
    # frame in model pixels, or one shared value; focal_log starts from
    # them and is FROZEN (lr 0).
    preset_focals: tuple | None = None


class EdgeData(NamedTuple):
    """Stacked pairwise predictions for E edges over F frames of H x W."""
    ei: torch.Tensor       # [E] int64
    ej: torch.Tensor       # [E] int64
    pred_i: torch.Tensor   # [E, H, W, 3]  view i's pointmap in frame i
    pred_j: torch.Tensor   # [E, H, W, 3]  view j's pointmap in frame i
    conf_i: torch.Tensor   # [E, H, W]
    conf_j: torch.Tensor   # [E, H, W]
    mask_i: torch.Tensor   # [E, H, W]  frame i's dynamic prob from edge e


@dataclasses.dataclass
class AlignParams:
    pw_poses: torch.Tensor   # [E, 8]  xyzw quat, signed-log t, log scale
    im_poses: torch.Tensor   # [F, 7]  xyzw quat, signed-log t (cam-to-world)
    depth_log: torch.Tensor  # [F, H, W]
    focal_log: torch.Tensor  # [1] or [F]  focal_break * log(f)
    pp_off: torch.Tensor     # [F, 2]


class AlignedScene(NamedTuple):
    """Host numpy results (the stage-1 -> stage-2 handoff)."""
    depths: np.ndarray          # [F, H, W]
    poses_c2w: np.ndarray       # [F, 4, 4]
    focals: np.ndarray          # [F]
    intrinsics: np.ndarray      # [F, 3, 3]
    im_conf: np.ndarray         # [F, H, W]  max-aggregated confidence
    dyna_avg: np.ndarray        # [F, H, W]
    dyna_max: np.ndarray        # [F, H, W]
    dynamic_masks: np.ndarray   # [F, H, W] bool (dyna_avg > thre)
    final_loss: float


# ---------------------------------------------------------------------------
# differentiable helpers


def _safe_norm(d, dim=-1):
    """L2 norm whose gradient at 0 is 0 (torch.norm's subgradient), where
    a plain sqrt would give NaN on an exact residual."""
    sq = (d * d).sum(dim)
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def signed_log1p(x):
    return torch.sign(x) * torch.log1p(x.abs())


def signed_expm1(x):
    return torch.sign(x) * torch.expm1(x.abs())


def quat_xyzw_to_rotmat(q):
    """Rotation of possibly unnormalized xyzw quaternions [..., 4]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rotmat_to_quat_xyzw(R: np.ndarray) -> np.ndarray:
    w, x, y, z = rotmat2qvec(np.asarray(R, np.float64))
    return np.asarray([x, y, z, w], np.float32)


def _rigid(R, t, pts):
    """R [B, 3, 3], t [B, 3], pts [B, N, 3] -> R p + t [B, N, 3], as three
    broadcast products: cuBLAS runs a batched matmul with K = 3 poorly,
    and its gradient in R (a reduction over N) worst of all."""
    out = torch.addcmul(t[:, None], pts[..., 0:1], R[:, None, :, 0])
    out = torch.addcmul(out, pts[..., 1:2], R[:, None, :, 1])
    return torch.addcmul(out, pts[..., 2:3], R[:, None, :, 2])


def pose7_to_mat(p):
    """[..., 7] xyzw + signed-log t -> [..., 4, 4] (base_opt._get_poses)."""
    R = quat_xyzw_to_rotmat(p[..., :4])
    t = signed_expm1(p[..., 4:7])
    top = torch.cat([R, t[..., :, None]], -1)
    # [0, 0, 0, 1] made on the device: a tensor from a host list would
    # be a copy that waits for the device
    bottom = torch.eye(4, dtype=p.dtype, device=p.device)[3]
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], -2)


# ---------------------------------------------------------------------------
# host numpy: registration, focal, aggregation, MST init (as in JAX)


def weighted_rigid_registration(x: np.ndarray, y: np.ndarray,
                                w: np.ndarray):
    """Weighted Umeyama: (s, R, T) minimizing sum w |s R x + T - y|^2
    (in place of roma.rigid_points_registration, base_opt.py:252/267)."""
    x = x.reshape(-1, 3).astype(np.float64)
    y = y.reshape(-1, 3).astype(np.float64)
    w = w.reshape(-1).astype(np.float64)
    w = w / w.sum().clip(1e-12)
    mx = (w[:, None] * x).sum(0)
    my = (w[:, None] * y).sum(0)
    xc = x - mx
    yc = y - my
    cov = (w[:, None] * yc).T @ xc
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_x = (w * (xc ** 2).sum(1)).sum()
    s = float(np.trace(np.diag(D) @ S) / max(var_x, 1e-12))
    T = my - s * R @ mx
    return s, R.astype(np.float32), T.astype(np.float32)


def estimate_focal_weiszfeld(pts3d: np.ndarray, pp: np.ndarray,
                             iters: int = 10) -> float:
    """Reprojection focal estimator (post_process.py:12-60, weiszfeld)."""
    H, W, _ = pts3d.shape
    xx, yy = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    pixels = np.stack([xx, yy], -1).reshape(-1, 2) - pp[None]
    p = pts3d.reshape(-1, 3).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        xy_over_z = np.nan_to_num(p[:, :2] / p[:, 2:3],
                                  posinf=0, neginf=0)
    dot_xy_px = (xy_over_z * pixels).sum(-1)
    dot_xy_xy = (xy_over_z ** 2).sum(-1)
    focal = dot_xy_px.mean() / max(dot_xy_xy.mean(), 1e-12)
    for _ in range(iters):
        dis = np.linalg.norm(pixels - focal * xy_over_z, axis=-1)
        w = 1.0 / np.clip(dis, 1e-8, None)
        focal = (w * dot_xy_px).mean() / max((w * dot_xy_xy).mean(), 1e-12)
    return float(focal)


def aggregate_frame_maps(edges, conf_i, conf_j, mask_i, n_frames):
    """Per-frame max confidence and avg / max dynamic-ness
    (base_opt._compute_img_conf :233-239, _compute_img_mmask :220-231)."""
    H, W = conf_i.shape[1:]
    im_conf = np.zeros((n_frames, H, W), np.float32)
    dyn_sum = np.zeros((n_frames, H, W), np.float32)
    dyn_max = np.zeros((n_frames, H, W), np.float32)
    i_count = np.zeros(n_frames, np.int64)
    for e, (i, j) in enumerate(edges):
        im_conf[i] = np.maximum(im_conf[i], conf_i[e])
        im_conf[j] = np.maximum(im_conf[j], conf_j[e])
        dyn_sum[i] += mask_i[e]
        dyn_max[i] = np.maximum(dyn_max[i], mask_i[e])
        i_count[i] += 1
    dyn_avg = dyn_sum / np.maximum(i_count, 1)[:, None, None]
    return im_conf, dyn_avg, dyn_max


def _pnp_c2w(pts, pixels, focal, pp, iterations: int, dtype):
    """cam-to-world pose by cv2's RANSAC-PnP (SQPnP, 5 px), or None; the
    world-to-camera matrix is built in ``dtype`` and inverted, as each of
    the JAX package's two call sites does."""
    import cv2
    K = np.float32([[focal, 0, pp[0]], [0, focal, pp[1]], [0, 0, 1]])
    ok, rvec, tvec, _ = cv2.solvePnPRansac(
        pts, pixels, K, None, iterationsCount=iterations,
        reprojectionError=5, flags=cv2.SOLVEPNP_SQPNP)
    if not ok:
        return None
    w2c = np.eye(4, dtype=dtype)
    w2c[:3, :3] = cv2.Rodrigues(rvec)[0]
    w2c[:3, 3] = tvec.ravel()
    return np.linalg.inv(w2c)


def mst_init(edges, pred_i, pred_j, conf_i, conf_j, im_conf,
             cfg: AlignerConfig):
    """Minimum-spanning-tree pose / depth / focal initialization
    (init_im_poses.py:88-254). Returns (pts3d [F, H, W, 3] world,
    im_poses [F, 4, 4] c2w, im_focals [F])."""
    import scipy.sparse as sp

    n = im_conf.shape[0]
    H, W = im_conf.shape[1:]
    pp = np.asarray([W / 2, H / 2], np.float32)

    escore = {}
    for e, (i, j) in enumerate(edges):
        escore[(i, j)] = float(conf_i[e].mean() * conf_j[e].mean())
    graph = sp.dok_array((n, n))
    for (i, j), v in escore.items():
        graph[i, j] = -v
    msp = sp.csgraph.minimum_spanning_tree(graph.tocsr()).tocoo()

    edge_lookup = {(i, j): e for e, (i, j) in enumerate(edges)}
    todo = sorted(zip(-msp.data, msp.row, msp.col))
    pts3d = [None] * n
    im_poses: list = [None] * n
    im_focals: list = [None] * n

    score, i, j = todo.pop()
    e = edge_lookup[(int(i), int(j))]
    pts3d[i] = pred_i[e].copy()
    pts3d[j] = pred_j[e].copy()
    done = {int(i), int(j)}
    im_poses[i] = np.eye(4, dtype=np.float32)
    im_focals[i] = estimate_focal_weiszfeld(pred_i[e], pp)

    while todo:
        score, i, j = todo.pop()
        i, j = int(i), int(j)
        e = edge_lookup[(i, j)]
        if im_focals[i] is None:
            im_focals[i] = estimate_focal_weiszfeld(pred_i[e], pp)
        if i in done:
            s, R, T = weighted_rigid_registration(pred_i[e], pts3d[i],
                                                  conf_i[e])
            trf = np.eye(4, dtype=np.float32)
            trf[:3, :3] = s * R
            trf[:3, 3] = T
            pts3d[j] = pred_j[e] @ trf[:3, :3].T + trf[:3, 3]
            done.add(j)
            if im_poses[i] is None:
                pose = np.eye(4, dtype=np.float32)
                pose[:3, :3] = R
                pose[:3, 3] = T
                im_poses[i] = pose
        elif j in done:
            s, R, T = weighted_rigid_registration(pred_j[e], pts3d[j],
                                                  conf_j[e])
            trf = np.eye(4, dtype=np.float32)
            trf[:3, :3] = s * R
            trf[:3, 3] = T
            pts3d[i] = pred_i[e] @ trf[:3, :3].T + trf[:3, 3]
            done.add(i)
            if im_poses[i] is None:
                pose = np.eye(4, dtype=np.float32)
                pose[:3, :3] = R
                pose[:3, 3] = T
                im_poses[i] = pose
        else:
            todo.insert(0, (score, i, j))

    # missing focals from the best remaining edges
    for (i, j), v in sorted(escore.items(), key=lambda kv: -kv[1]):
        if im_focals[i] is None:
            im_focals[i] = estimate_focal_weiszfeld(
                pred_i[edge_lookup[(i, j)]], pp)

    # missing poses by RANSAC-PnP (init_im_poses.fast_pnp :292-335)
    xx, yy = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    pixels = np.stack([xx, yy], -1).astype(np.float32)
    for i in range(n):
        if im_poses[i] is None and pts3d[i] is not None:
            msk = im_conf[i] > cfg.min_conf_thr
            if msk.sum() >= 4:
                import cv2
                focal = im_focals[i] or max(H, W)
                try:
                    c2w = _pnp_c2w(pts3d[i][msk], pixels[msk], focal, pp,
                                   10, np.float32)
                except cv2.error:
                    c2w = None
                if c2w is not None:
                    im_poses[i] = c2w
        if im_poses[i] is None:
            im_poses[i] = np.eye(4, dtype=np.float32)
        if im_focals[i] is None:
            im_focals[i] = float(max(H, W))
        if pts3d[i] is None:
            pts3d[i] = np.zeros((H, W, 3), np.float32)

    return (np.stack(pts3d), np.stack(im_poses),
            np.asarray(im_focals, np.float32))


def build_init_params(edges, pred_i, conf_i, pts3d, im_poses, im_focals,
                      cfg: AlignerConfig) -> dict:
    """The MST solution written into the parameter stacks (init_from_pts3d,
    init_im_poses.py:106-153), as numpy arrays keyed by ``AlignParams``'s
    fields."""
    E = len(edges)
    F, H, W = pts3d.shape[:3]
    pw = np.zeros((E, 8), np.float32)
    for e, (i, j) in enumerate(edges):
        s, R, T = weighted_rigid_registration(pred_i[e], pts3d[i], conf_i[e])
        pw[e, :4] = rotmat_to_quat_xyzw(R)
        pw[e, 4:7] = np.sign(T / s) * np.log1p(np.abs(T / s))
        pw[e, 7] = np.log(max(s, 1e-8))

    # scale normalization factor (get_pw_norm_scale_factor :276-281)
    s_factor = float(np.exp(np.log(cfg.base_scale) - pw[:, 7].mean()))
    im_poses = im_poses.copy()
    im_poses[:, :3, 3] *= s_factor
    pts3d = pts3d * s_factor

    im7 = np.zeros((F, 7), np.float32)
    depth_log = np.zeros((F, H, W), np.float32)
    for i in range(F):
        im7[i, :4] = rotmat_to_quat_xyzw(im_poses[i][:3, :3])
        t = im_poses[i][:3, 3]
        im7[i, 4:7] = np.sign(t) * np.log1p(np.abs(t))
        w2c = np.linalg.inv(im_poses[i])
        cam_pts = pts3d[i] @ w2c[:3, :3].T + w2c[:3, 3]
        depth_log[i] = np.log(np.clip(cam_pts[..., 2], 1e-8, None))

    if cfg.shared_focal:
        focal_log = np.asarray(
            [cfg.focal_break * np.log(im_focals.mean())], np.float32)
    else:
        focal_log = cfg.focal_break * np.log(im_focals)
    return dict(pw_poses=pw, im_poses=im7, depth_log=depth_log,
                focal_log=np.asarray(focal_log, np.float32),
                pp_off=np.zeros((F, 2), np.float32))


# ---------------------------------------------------------------------------
# the optimization


def _conf_weight(conf, mode):
    if mode == "log":
        return torch.log(conf)
    if mode == "sqrt":
        return torch.sqrt(conf)
    if mode == "m1":
        return conf - 1
    return conf


def make_align_loss(edge: EdgeData, dyn_masks, flows, cfg: AlignerConfig,
                    n_frames: int, height: int, width: int,
                    init_depth=None):
    """The loss(params, it) closure.

    dyn_masks: [F, H, W] bool (dyna_avg > thre); flows: None, or
    (flow_ij [E, 2, H, W], flow_ji, valid_i [E, 1, H, W], valid_j);
    init_depth: [F, H, W] depth for the scale-invariant prior (reference
    optimizer.py:581-587, on when ``cfg.depth_regularize_weight > 0``),
    dynamic pixels weighted 2x as in goem_opt.py:15-36.
    """
    F, H, W = n_frames, height, width
    E = edge.ei.shape[0]
    dev = edge.pred_i.device
    w_i = _conf_weight(edge.conf_i, cfg.conf_mode).reshape(E, -1)
    w_j = _conf_weight(edge.conf_j, cfg.conf_mode).reshape(E, -1)
    pred_i = edge.pred_i.reshape(E, -1, 3)
    pred_j = edge.pred_j.reshape(E, -1, 3)
    total_area = E * H * W
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([xx, yy], -1).reshape(1, -1, 2)     # [1, HW, 2]
    base_pp = torch.tensor([W / 2, H / 2], dtype=torch.float32, device=dev)
    eye3 = torch.eye(3, device=dev)

    def get_focals(params):
        f = torch.exp(params.focal_log / cfg.focal_break)
        return f.expand(F) if cfg.shared_focal else f

    def get_pts3d_world(params):
        focals = get_focals(params)[:, None, None]
        pp = base_pp[None] + 10 * params.pp_off            # [F, 2]
        depth = torch.exp(params.depth_log).reshape(F, -1, 1)
        xy = depth * (grid - pp[:, None, :]) / focals
        pts_cam = torch.cat([xy, depth], -1)               # [F, HW, 3]
        c2w = pose7_to_mat(params.im_poses)
        return _rigid(c2w[:, :3, :3], c2w[:, :3, 3], pts_cam), c2w

    def get_pw_mats(params):
        RT = pose7_to_mat(params.pw_poses[:, :7])
        logs = params.pw_poses[:, 7]
        norm = torch.exp(math.log(cfg.base_scale) - logs.mean())
        scale = torch.exp(logs) * norm
        return torch.cat([RT[:, :3] * scale[:, None, None], RT[:, 3:]], 1)

    def loss_fn(params: AlignParams, it: int):
        pts_world, c2w = get_pts3d_world(params)
        pw = get_pw_mats(params)

        ali = _rigid(pw[:, :3, :3], pw[:, :3, 3], pred_i)
        alj = _rigid(pw[:, :3, :3], pw[:, :3, 3], pred_j)
        pi = pts_world[edge.ei]
        pj = pts_world[edge.ej]
        if cfg.dist == "l1":
            li = (_safe_norm(pi - ali) * w_i).sum()
            lj = (_safe_norm(pj - alj) * w_j).sum()
        else:
            li = (((pi - ali) ** 2).sum(-1) * w_i).sum()
            lj = (((pj - alj) ** 2).sum(-1) * w_j).sum()
        loss = (li + lj) / total_area

        if cfg.temporal_smoothing_weight > 0:
            # the _ex forms skip the error check, which waits for the
            # device (JAX's solve and inv check nothing either)
            rel = torch.linalg.solve_ex(c2w[:-1], c2w[1:]).result
            rot_l = _safe_norm((rel[:, :3, :3] - eye3).reshape(-1, 9))
            tr_l = _safe_norm(rel[:, :3, 3])
            loss = loss + cfg.temporal_smoothing_weight * (
                rot_l + cfg.translation_weight * tr_l).sum()

        if flows is not None and cfg.flow_loss_weight > 0:
            flow_ij, flow_ji, _, _ = flows
            focals = get_focals(params)
            pp = base_pp[None] + 10 * params.pp_off
            zero = torch.zeros_like(focals)
            K = torch.stack([
                torch.stack([focals, zero, pp[:, 0]], -1),
                torch.stack([zero, focals, pp[:, 1]], -1),
                torch.stack([zero, zero, zero + 1.0], -1)], -2)
            inv_K = torch.linalg.inv_ex(K).inverse
            depth = torch.exp(params.depth_log)[:, None]    # [F, 1, H, W]
            disp = 1.0 / (depth + 1e-6)
            R = c2w[:, :3, :3]
            T = c2w[:, :3, 3:]
            ei, ej = edge.ei, edge.ej
            ego_ij, _ = warping.ego_flow_from_disp(
                R[ei], T[ei], R[ej], T[ej], disp[ei], K[ej], inv_K[ei])
            ego_ji, _ = warping.ego_flow_from_disp(
                R[ej], T[ej], R[ei], T[ei], disp[ej], K[ei], inv_K[ej])
            static_i = (~dyn_masks[ei])[:, None]
            static_j = (~dyn_masks[ej])[:, None]
            fl = (warping.smooth_l1_flow_loss(
                ego_ij[:, :2], flow_ij, static_i,
                per_pixel_thre=cfg.pxl_thre)
                + warping.smooth_l1_flow_loss(
                    ego_ji[:, :2], flow_ji, static_j,
                    per_pixel_thre=cfg.pxl_thre))
            active = it >= cfg.niter * cfg.flow_loss_start_ratio
            over_thre = (fl > cfg.flow_loss_thre) & (cfg.flow_loss_thre > 0)
            fl = torch.where(~over_thre & active, fl, 0.0)
            loss = loss + cfg.flow_loss_weight * fl

        if cfg.depth_regularize_weight > 0 and init_depth is not None:
            depth = torch.exp(params.depth_log)[:, None]    # [F, 1, H, W]
            prior = warping.depth_regularization_si_weighted(
                depth, init_depth[:, None],
                pixel_wise_weight=dyn_masks[:, None].to(torch.float32))
            loss = loss + cfg.depth_regularize_weight * prior

        return loss

    return loss_fn


def schedule_lr(it: int, cfg: AlignerConfig) -> torch.Tensor:
    """The learning rate of iteration ``it`` (float32, as in JAX)."""
    t = it / cfg.niter
    if cfg.schedule == "cosine":
        return schedules.cosine_lr(t, cfg.lr, cfg.lr_min)
    if cfg.schedule.startswith("cycle"):
        return schedules.cycled_lr(t, cfg.lr, cfg.lr_min)
    return schedules.linear_lr(t, cfg.lr, cfg.lr_min)


def optimize(params: AlignParams, edge: EdgeData, dyn_masks,
             cfg: AlignerConfig, n_frames: int, height: int, width: int,
             flows=None, callback=None, init_depth=None, losses=None):
    """The Adam(0.9, 0.9) alignment loop (base_opt global_alignment_loop
    :510-580), in place on ``params``. Returns (params, final_loss): the
    loss of the last iteration, before its step.

    A plain loop of ``cfg.niter`` iterations: the JAX package's chunked
    ``lax.scan`` gives the same iterations. ``callback(it, loss)`` fires
    after every iteration (each call waits for the device); ``losses``,
    when a list, receives each iteration's loss as a tensor on the device
    (no wait)."""
    if cfg.depth_regularize_weight > 0 and init_depth is None:
        # the prior anchors to the depth AT ENTRY (the reference snapshots
        # init_depthmaps before the loop, optimizer.py:476-482)
        init_depth = torch.exp(params.depth_log).detach()
    loss_fn = make_align_loss(edge, dyn_masks, flows, cfg, n_frames,
                              height, width, init_depth=init_depth)
    state = adam_init(params)
    pp_lr_scale = 1.0 if cfg.optimize_pp else 0.0
    fields = [f.name for f in dataclasses.fields(AlignParams)]
    for p in (getattr(params, k) for k in fields):
        p.requires_grad_(True)
    lossv = torch.tensor(float("inf"))
    for it in range(cfg.niter):
        lr = schedule_lr(it, cfg)
        lossv = loss_fn(params, it)
        grads = torch.autograd.grad(lossv, [getattr(params, k)
                                            for k in fields])
        lossv = lossv.detach()
        if losses is not None:
            losses.append(lossv)
        focal_lr = lr * 0.0 if cfg.preset_focals is not None else lr
        lrs = AlignParams(pw_poses=lr, im_poses=lr, depth_log=lr,
                          focal_log=focal_lr, pp_off=lr * pp_lr_scale)
        adam_step(params, AlignParams(*grads), state, lrs, b1=0.9, b2=0.9,
                  eps=1e-8)
        if callback is not None:
            callback(it, float(lossv))
    for p in (getattr(params, k) for k in fields):
        p.requires_grad_(False)
    return params, float(lossv)


# ---------------------------------------------------------------------------
# top-level API


def align(edges: list, pred_i, pred_j, conf_i, conf_j, mask_i,
          cfg: AlignerConfig = AlignerConfig(), flows=None,
          callback=None, device=None, stats: dict | None = None
          ) -> AlignedScene:
    """Aggregation -> MST init -> optimization on ``device`` (default
    CUDA; a RuntimeError without it) -> results (the ``global_aligner`` +
    ``compute_global_alignment`` flow, cloud_opt/__init__.py:19-30,
    base_opt.py:456-471).

    Inputs are numpy stacks over E edges; ``edges`` is a list of (i, j).
    ``flows``: numpy or tensors, as in ``make_align_loss``. ``stats``,
    when a dict, receives the seconds of the host initialization
    (``init_s``: aggregation, MST, parameter stacks), of the copy to the
    device (``to_device_s``) and of the loop (``loop_s``, ended by a
    synchronize), and the first and last loss."""
    dev = resolve_device(device)
    pred_i = np.asarray(pred_i, np.float32)
    pred_j = np.asarray(pred_j, np.float32)
    conf_i = np.asarray(conf_i, np.float32)
    conf_j = np.asarray(conf_j, np.float32)
    mask_i = np.asarray(mask_i, np.float32)
    n_frames = max(max(e) for e in edges) + 1
    E, H, W = conf_i.shape

    t0 = time.perf_counter()
    im_conf, dyna_avg, dyna_max = aggregate_frame_maps(
        edges, conf_i, conf_j, mask_i, n_frames)
    dyn_bin = dyna_avg > cfg.motion_mask_thre

    pts3d, im_poses, im_focals = mst_init(
        edges, pred_i, pred_j, conf_i, conf_j, im_conf, cfg)
    if cfg.preset_focals is not None:
        im_focals = np.broadcast_to(
            np.asarray(cfg.preset_focals, np.float32).reshape(-1),
            (n_frames,)).copy()
    init = build_init_params(edges, pred_i, conf_i, pts3d, im_poses,
                             im_focals, cfg)
    t1 = time.perf_counter()

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    params = AlignParams(**{k: t(v) for k, v in init.items()})
    edge_data = EdgeData(
        ei=t([i for i, _ in edges], torch.int64),
        ej=t([j for _, j in edges], torch.int64),
        pred_i=t(pred_i), pred_j=t(pred_j), conf_i=t(conf_i),
        conf_j=t(conf_j), mask_i=t(mask_i))
    if flows is not None:
        flows = tuple(t(f if isinstance(f, torch.Tensor) else np.asarray(f),
                        None) for f in flows)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    losses: list = []
    params, final_loss = optimize(
        params, edge_data, t(dyn_bin, torch.bool), cfg, n_frames, H, W,
        flows=flows, callback=callback, losses=losses)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if stats is not None:
        stats.update(init_s=t1 - t0, to_device_s=t2 - t1,
                     loop_s=time.perf_counter() - t2,
                     first_loss=float(losses[0]) if losses else None,
                     last_loss=final_loss if losses else None)

    # results
    depths = torch.exp(params.depth_log).cpu().numpy()
    c2w = pose7_to_mat(params.im_poses).cpu().numpy()
    if cfg.shared_focal:
        focals = np.full(
            n_frames, float(torch.exp(params.focal_log[0] / cfg.focal_break)),
            np.float32)
    else:
        focals = torch.exp(params.focal_log / cfg.focal_break).cpu().numpy()
    pp = np.asarray([W / 2, H / 2], np.float32)[None] \
        + 10 * params.pp_off.cpu().numpy()
    K = np.zeros((n_frames, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = focals
    K[:, :2, 2] = pp
    K[:, 2, 2] = 1
    return AlignedScene(
        depths=depths, poses_c2w=c2w, focals=focals, intrinsics=K,
        im_conf=im_conf, dyna_avg=dyna_avg, dyna_max=dyna_max,
        dynamic_masks=dyn_bin, final_loss=final_loss)


def clean_pointcloud(im_confs: np.ndarray, intrinsics: np.ndarray,
                     poses_c2w: np.ndarray, depths: np.ndarray,
                     tol: float = 0.001, bad_conf: float = 0.0
                     ) -> np.ndarray:
    """Cross-view depth-consistency confidence suppression
    (base_opt.clean_pointcloud :584-619): a pixel whose 3D point lands IN
    FRONT of another view's depth map while less confident gets its
    confidence clipped to ``bad_conf``. Host numpy, as in JAX.

    im_confs / depths [F, H, W]; intrinsics [F, 3, 3]; poses_c2w [F, 4, 4].
    """
    F, H, W = im_confs.shape
    res = im_confs.copy()
    w2c = np.linalg.inv(poses_c2w)

    xx, yy = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    pts_world = np.empty((F, H, W, 3), np.float32)
    for f in range(F):
        K = intrinsics[f]
        z = depths[f]
        cam = np.stack([z * (xx - K[0, 2]) / K[0, 0],
                        z * (yy - K[1, 2]) / K[1, 1], z], -1)
        pts_world[f] = cam @ poses_c2w[f, :3, :3].T + poses_c2w[f, :3, 3]

    for i in range(F):
        for j in range(F):
            if i == j:
                continue
            proj = pts_world[i] @ w2c[j, :3, :3].T + w2c[j, :3, 3]
            z = proj[..., 2]
            K = intrinsics[j]
            with np.errstate(divide="ignore", invalid="ignore"):
                u = np.round(proj[..., 0] / z * K[0, 0] + K[0, 2])
                v = np.round(proj[..., 1] / z * K[1, 1] + K[1, 2])
            msk = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
            ui = np.where(msk, u, 0).astype(np.int64)
            vi = np.where(msk, v, 0).astype(np.int64)
            bad = (msk
                   & (z < (1 - tol) * depths[j][vi, ui])
                   & (res[i] < res[j][vi, ui]))
            res[i][bad] = np.minimum(res[i][bad], bad_conf)
    return res


def pair_view(edges: list, pred_i, pred_j, conf_i, conf_j, mask_i,
              cfg: AlignerConfig = AlignerConfig()) -> AlignedScene:
    """Closed-form two-frame scene, no optimization (the reference's
    PairViewer, cloud_opt/pair_viewer.py:15-112, for exactly one
    symmetrized pair). Per view: Weiszfeld focal from its own pointmap,
    relative pose by RANSAC-PnP of the cross-view pointmap against the
    pixel grid; the more confident direction anchors the world at its
    camera. Host numpy and cv2, as in JAX."""
    if sorted(edges) != [(0, 1), (1, 0)]:
        raise ValueError(f"pair_view needs one symmetrized pair, got {edges}")
    pred_i = np.asarray(pred_i, np.float32)
    pred_j = np.asarray(pred_j, np.float32)
    conf_i = np.asarray(conf_i, np.float32)
    conf_j = np.asarray(conf_j, np.float32)
    mask_i = np.asarray(mask_i, np.float32)
    E, H, W = conf_i.shape
    pp = np.asarray([W / 2, H / 2], np.float32)
    eidx = {tuple(e): k for k, e in enumerate(edges)}

    im_conf, dyna_avg, dyna_max = aggregate_frame_maps(
        edges, conf_i, conf_j, mask_i, 2)

    xx, yy = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    pixels = np.stack([xx, yy], -1).astype(np.float32)    # [H, W, (x, y)]

    confs, focals, rel_poses = [], [], []
    for i in range(2):
        e = eidx[(i, 1 - i)]
        confs.append(float(conf_i[e].mean() * conf_j[e].mean()))
        focal = estimate_focal_weiszfeld(pred_i[e], pp)
        focals.append(focal)

        # camera i's pose from its pointmap expressed in the OTHER view
        pts = pred_j[eidx[(1 - i, i)]]
        msk = im_conf[i] > cfg.min_conf_thr
        pose = np.eye(4, dtype=np.float32)
        if int(msk.sum()) >= 6:
            c2w = _pnp_c2w(pts[msk].astype(np.float64),
                           pixels[msk].astype(np.float64), focal, pp, 100,
                           np.float64)
            if c2w is not None:
                pose = c2w.astype(np.float32)
        rel_poses.append(pose)

    def _transformed_depth(pose, pts):
        inv_pose = np.linalg.inv(pose)
        flat = pts.reshape(-1, 3) @ inv_pose[:3, :3].T + inv_pose[:3, 3]
        return flat[:, 2].reshape(H, W)

    if confs[0] > confs[1]:           # world = camera 1's frame
        e = eidx[(0, 1)]
        poses = np.stack([np.eye(4, dtype=np.float32), rel_poses[1]])
        depths = np.stack([pred_i[e][..., 2],
                           _transformed_depth(rel_poses[1], pred_j[e])])
    else:                             # world = camera 2's frame
        e = eidx[(1, 0)]
        poses = np.stack([rel_poses[0], np.eye(4, dtype=np.float32)])
        depths = np.stack([_transformed_depth(rel_poses[0], pred_j[e]),
                           pred_i[e][..., 2]])

    f = np.asarray(focals, np.float32)
    K = np.zeros((2, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = f
    K[:, :2, 2] = pp
    K[:, 2, 2] = 1
    return AlignedScene(
        depths=depths.astype(np.float32), poses_c2w=poses, focals=f,
        intrinsics=K, im_conf=im_conf, dyna_avg=dyna_avg,
        dyna_max=dyna_max, dynamic_masks=dyna_avg > cfg.motion_mask_thre,
        final_loss=0.0)
