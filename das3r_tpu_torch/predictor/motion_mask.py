"""Per-pair motion masks from the disagreement of optical flow with ego
flow (port of ``das3r_tpu/predictor/motion_mask.py``; the reference's
legacy RAFT motion-mask path, dynamic_predictor/dust3r/cloud_opt/
motion_mask_from_raft.py:54-94 and camera_estimator.py:10-62): for each
pair, estimate the intrinsics and the relative pose from the predictor's
pointmaps, compute the flow a static scene would show under that camera
motion (ego flow), and mark as dynamic the pixels whose observed flow
disagrees with it above ``motion_mask_thre`` after a per-pair min-max
normalisation.

DAS3R itself uses the predictor's learned dynamic masks instead
(``use_pred_mask``); this module keeps the legacy path. It is made of the
Weiszfeld focal (``alignment.estimate_focal_weiszfeld``), SQPnP
extrinsics (cv2), ``warping.ego_flow_from_disp`` and flows from
``flow.compute_edge_flows``.

Fidelity note (as in the JAX package): the reference's ``get_flow``
stacks the same image list twice (motion_mask_from_raft.py:22), so its
observed flow is zero and its mask is the thresholded, normalised
ego-flow magnitude; this takes real (i -> j) flows: pass zero flows for
the reference's literal behaviour.
"""
from __future__ import annotations

import numpy as np
import torch

from das3r_tpu_torch.predictor.alignment import estimate_focal_weiszfeld
from das3r_tpu_torch.predictor.warping import ego_flow_from_disp
from das3r_tpu_torch.utils.device import resolve_device


def estimate_pair_camera(pts3d_n: np.ndarray, pts3d_m_in_n: np.ndarray,
                         im_conf_m: np.ndarray, min_conf_thr: float = 3.0):
    """The camera of one pair (camera_estimator.py:10-62).

    ``pts3d_n`` [H, W, 3]: view n's pointmap in its own frame, which gives
    the focal (Weiszfeld) and depth_n. ``pts3d_m_in_n`` [H, W, 3]: view m's
    pointmap in n's frame; SQPnP against m's pixel grid gives m's pose
    (camera to world) in n's frame.

    Returns (K [3, 3], focal, R_mn [3, 3], T_mn [3], depth_n [H, W],
    depth_m [H, W]); the identity pose where PnP fails, as the
    reference's try/except gives."""
    import cv2

    H, W, _ = pts3d_n.shape
    pp = np.asarray([W / 2.0, H / 2.0], np.float64)
    focal = estimate_focal_weiszfeld(pts3d_n, pp)
    K = np.float32([[focal, 0, pp[0]], [0, focal, pp[1]], [0, 0, 1]])

    xx, yy = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    pixels = np.stack([xx, yy], -1).reshape(-1, 2).astype(np.float64)
    msk = (im_conf_m > min_conf_thr).reshape(-1)
    pose = np.eye(4, dtype=np.float32)
    pts = pts3d_m_in_n.reshape(-1, 3).astype(np.float64)
    if int(msk.sum()) >= 6:
        ok, rvec, tvec, _ = cv2.solvePnPRansac(
            pts[msk], pixels[msk], K, None, iterationsCount=100,
            reprojectionError=5, flags=cv2.SOLVEPNP_SQPNP)
        if ok:
            w2c = np.eye(4)
            w2c[:3, :3] = cv2.Rodrigues(rvec)[0]
            w2c[:3, 3] = tvec.ravel()
            pose = np.linalg.inv(w2c).astype(np.float32)  # cam m in frame n

    depth_n = pts3d_n[..., 2]
    inv_pose = np.linalg.inv(pose)
    flat = pts3d_m_in_n.reshape(-1, 3) @ inv_pose[:3, :3].T + inv_pose[:3, 3]
    depth_m = flat.reshape(H, W, 3)[..., 2]
    return K, focal, pose[:3, :3], pose[:3, 3], depth_n, depth_m


def pair_motion_mask(pts3d_n: np.ndarray, pts3d_m_in_n: np.ndarray,
                     im_conf_m: np.ndarray, flow_nm,
                     motion_mask_thre: float = 0.35, eps: float = 1e-6,
                     device=None):
    """The dynamic mask of one pair (motion_mask_from_raft.py:65-92), on
    ``device`` (default CUDA; a RuntimeError without it).

    ``flow_nm`` [2, H, W]: the observed flow n -> m. Returns (mask [H, W]
    bool, err_norm [H, W] float32) as numpy."""
    dev = resolve_device(device)
    K, _, R, T, depth_n, _ = estimate_pair_camera(
        pts3d_n, pts3d_m_in_n, im_conf_m)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    Kt = f32(K)[None]
    # the reference's call: the source pose is the identity, the target
    # (R_mn, T_mn), camera to world as relative_transform takes them
    disp = f32(1.0 / (depth_n + eps))[None, None]
    ego, _ = ego_flow_from_disp(
        torch.eye(3, device=dev)[None], torch.zeros(1, 3, 1, device=dev),
        f32(R)[None], f32(T).reshape(1, 3, 1), disp, Kt,
        torch.linalg.inv(Kt))
    flow = flow_nm if isinstance(flow_nm, torch.Tensor) else f32(flow_nm)
    err = torch.linalg.norm(ego[0, :2] - flow.to(dev, torch.float32), dim=0)
    err = (err - err.min()) / (err.max() - err.min() + eps)
    return ((err > motion_mask_thre).cpu().numpy(),
            err.cpu().numpy().astype(np.float32))


def motion_masks_from_pairs(pred1_pts3d, pred2_pts3d_in_other, im_confs,
                            flows_ij, motion_mask_thre: float = 0.35,
                            device=None):
    """Every pair (``get_motion_mask_from_pairs``): [E, H, W, 3]
    pointmaps, [E, H, W] confidences and [E, 2, H, W] flows -> a list of
    [H, W] bool masks."""
    return [pair_motion_mask(
        np.asarray(pred1_pts3d[e]), np.asarray(pred2_pts3d_in_other[e]),
        np.asarray(im_confs[e]), flows_ij[e],
        motion_mask_thre=motion_mask_thre, device=device)[0]
        for e in range(len(pred1_pts3d))]
