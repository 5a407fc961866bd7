"""Camera-trajectory metrics — a self-contained replacement for the evo
dependency, reproducing the reference protocol exactly
(utils/vo_eval.py:159-244):

  * ATE: Sim(3) Umeyama alignment (align=True, correct_scale=True) of the
    estimated positions to the reference, then RMSE of translation residuals;
  * RPE trans / RPE rot: relative-pose error at delta = 1 frame over all
    consecutive pairs, RMSE of translation norm / rotation angle (degrees),
    computed on the Sim(3)-aligned estimate (evo aligns before RPE when
    align=True).

Port of ``das3r_tpu/eval/trajectory.py``: the same numpy code, on the
port's ``data/trajectory.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def umeyama_sim3(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares Sim(3): returns (s, R, t) with dst ~= s * R @ src + t.

    Umeyama 1991; equivalent to evo's ``geometry.umeyama_alignment``.
    src/dst: [N, 3] (rows are points).
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    n = src.shape[0]
    cov = xd.T @ xs / n
    var_s = (xs**2).sum() / n
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def _rot_angle_deg(R: np.ndarray) -> float:
    c = (np.trace(R) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


@dataclasses.dataclass
class TrajectoryMetrics:
    ate: float        # RMSE, Sim(3)-aligned absolute translation error
    rpe_trans: float  # RMSE relative translation @ 1 frame
    rpe_rot: float    # RMSE relative rotation (deg) @ 1 frame


def align_trajectory(est_c2w: np.ndarray, ref_c2w: np.ndarray,
                     correct_scale: bool = True) -> np.ndarray:
    """Sim(3)-align est to ref; returns transformed est poses [F, 4, 4]."""
    s, R, t = umeyama_sim3(est_c2w[:, :3, 3], ref_c2w[:, :3, 3],
                           with_scale=correct_scale)
    out = est_c2w.copy()
    out[:, :3, 3] = (s * (R @ est_c2w[:, :3, 3].T)).T + t
    out[:, :3, :3] = np.einsum("ij,fjk->fik", R, est_c2w[:, :3, :3])
    return out


def eval_metrics(est_c2w: np.ndarray, ref_c2w: np.ndarray,
                 delta: int = 1) -> TrajectoryMetrics:
    """Reference-protocol ATE / RPE for two [F, 4, 4] c2w trajectories."""
    est_aligned = align_trajectory(est_c2w, ref_c2w, correct_scale=True)

    # ATE
    resid = est_aligned[:, :3, 3] - ref_c2w[:, :3, 3]
    ate = float(np.sqrt((np.linalg.norm(resid, axis=1) ** 2).mean()))

    # RPE over all pairs with index difference == delta
    t_errs, r_errs = [], []
    F = est_c2w.shape[0]
    inv = np.linalg.inv
    for i in range(F - delta):
        j = i + delta
        rel_ref = inv(ref_c2w[i]) @ ref_c2w[j]
        rel_est = inv(est_aligned[i]) @ est_aligned[j]
        err = inv(rel_ref) @ rel_est
        t_errs.append(np.linalg.norm(err[:3, 3]))
        r_errs.append(_rot_angle_deg(err[:3, :3]))
    rpe_trans = float(np.sqrt((np.asarray(t_errs) ** 2).mean()))
    rpe_rot = float(np.sqrt((np.asarray(r_errs) ** 2).mean()))
    return TrajectoryMetrics(ate=ate, rpe_trans=rpe_trans, rpe_rot=rpe_rot)


def tum_to_matrices(positions: np.ndarray,
                    quats_wxyz: np.ndarray) -> np.ndarray:
    from das3r_tpu_torch.data.trajectory import tum_to_c2w
    return tum_to_c2w(positions, quats_wxyz)
