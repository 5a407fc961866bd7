"""Stage-1 pose evaluation harness (port of ``das3r_tpu/eval/
pose_eval.py``): the ``launch.py --mode=eval_pose`` equivalent
(reference dynamic_predictor/dust3r/pose_eval.py:19-252 +
eval_metadata.py): per-sequence stage-1 run, ATE/RPE against GT
trajectories, per-sequence ``_error_log`` files and dataset averages.

Robustness follows the reference: failures in one sequence are caught,
logged, and the sequence skipped (pose_eval.py:209-222); the summary's
``n_ok`` against ``n_sequences`` says how many ran.
"""
from __future__ import annotations

import dataclasses
import os
import traceback

import numpy as np

from das3r_tpu_torch.eval import harness
from das3r_tpu_torch.eval import trajectory as traj_eval
from das3r_tpu_torch.predictor import runner
from das3r_tpu_torch.utils.device import resolve_device

# per-dataset path templates / sequence lists / GT trajectory formats
# (reference dust3r/eval_metadata.py:6-131)
DATASET_METADATA = {
    "davis": {
        "img_path": "{root}/DAVIS/JPEGImages/480p/{seq}",
        "gt_traj": None,                      # no GT poses
        "traj_format": None,
        "seq_list": harness.DAVIS_SCENES,
        "max_frames": 50,                     # pose_eval.py:92-93
    },
    "sintel": {
        "img_path": "{root}/sintel/training/final/{seq}",
        "gt_traj": "{root}/sintel/training/camdata_left/{seq}",
        "traj_format": "sintel",
        "seq_list": ["alley_2", "ambush_4", "ambush_5", "ambush_6",
                     "cave_2", "cave_4", "market_2", "market_5",
                     "market_6", "shaman_3", "sleeping_1", "sleeping_2",
                     "temple_2", "temple_3"],
        "max_frames": None,
    },
    "tum": {
        "img_path": "{root}/tum/{seq}/rgb_50",
        "gt_traj": "{root}/tum/{seq}/groundtruth_50.txt",
        "traj_format": "tum",
        "seq_list": harness.TUM_DYNAMICS_SCENES,
        "max_frames": None,
    },
    "kitti": {
        "img_path": "{root}/kitti/depth_selection/val_selection_cropped/"
                    "image_gathered/{seq}",
        "gt_traj": None,
        "traj_format": "kitti",
        "seq_list": None,
        "max_frames": None,
    },
}


@dataclasses.dataclass
class SeqResult:
    seq: str
    ate: float | None
    rpe_trans: float | None
    rpe_rot: float | None
    error: str | None = None


def evaluate_sequence(seq: str, image_dir: str, out_dir: str, model,
                      gt_traj_path: str | None, traj_format: str | None,
                      aligner_cfg, max_frames=None, verbose=print,
                      device=None) -> SeqResult:
    """Stage 1 on one sequence with ``model`` (its weights loaded) and its
    ATE / RPE against the ground truth; any failure is caught and kept in
    ``error`` (the reference's per-sequence robustness)."""
    try:
        res = runner.run_scene(image_dir, out_dir, model,
                               aligner_cfg=aligner_cfg,
                               max_frames=max_frames, verbose=verbose,
                               device=device)
        if gt_traj_path is None:
            return SeqResult(seq, None, None, None)
        gt = harness.load_gt_traj(gt_traj_path, traj_format)
        n = min(len(gt), res.scene.poses_c2w.shape[0])
        m = traj_eval.eval_metrics(res.scene.poses_c2w[:n], gt[:n])
        with open(os.path.join(out_dir, f"{seq}_error_log.txt"), "w") as f:
            f.write(f"{seq} ATE: {m.ate:.5f} RPE trans: {m.rpe_trans:.5f} "
                    f"RPE rot: {m.rpe_rot:.5f}\n")
        return SeqResult(seq, m.ate, m.rpe_trans, m.rpe_rot)
    except Exception as e:  # per-sequence robustness (ref :209-222)
        verbose(f"[{seq}] FAILED: {e}\n{traceback.format_exc()}")
        return SeqResult(seq, None, None, None, error=str(e))


def eval_pose_estimation(dataset: str, data_root: str, output_root: str,
                         model, aligner_cfg, seq_list=None, verbose=print,
                         device=None):
    """Every sequence of ``dataset`` (or ``seq_list``) on ``device``
    (default CUDA; a RuntimeError without it, before any sequence runs).
    Returns (per-sequence results, summary)."""
    dev = resolve_device(device)
    meta = DATASET_METADATA[dataset]
    seqs = seq_list or meta["seq_list"]
    results = []
    for seq in seqs:
        img_dir = meta["img_path"].format(root=data_root, seq=seq)
        gt = (meta["gt_traj"].format(root=data_root, seq=seq)
              if meta["gt_traj"] else None)
        out_dir = os.path.join(output_root, dataset, seq)
        results.append(evaluate_sequence(
            seq, img_dir, out_dir, model, gt, meta["traj_format"],
            aligner_cfg, max_frames=meta["max_frames"], verbose=verbose,
            device=dev))

    ok = [r for r in results if r.ate is not None]
    summary = {
        "n_sequences": len(results),
        "n_ok": len(ok),
        "mean_ate": float(np.mean([r.ate for r in ok])) if ok else None,
        "mean_rpe_trans": (float(np.mean([r.rpe_trans for r in ok]))
                           if ok else None),
        "mean_rpe_rot": (float(np.mean([r.rpe_rot for r in ok]))
                         if ok else None),
    }
    with open(os.path.join(output_root, f"{dataset}_summary.txt"),
              "w") as f:
        for r in results:
            f.write(f"{r.seq}: ate={r.ate} rpe_t={r.rpe_trans} "
                    f"rpe_r={r.rpe_rot} err={r.error}\n")
        f.write(f"AVG: {summary}\n")
    return results, summary
