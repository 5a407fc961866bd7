#!/usr/bin/env python3
"""End-to-end quality of the PyTorch port on a synthetic dynamic scene:
the port's counterpart of ``scripts/quality_e2e.py``, with the same
arguments, structure and record.

    python3 scripts/torch_quality_e2e.py --work <dir> --stage1 gt \\
        --frames 16 --height 144 --width 192 --iters 4000 --pose_noise 0.02
    python3 scripts/torch_quality_e2e.py --work <dir> --stage1 predictor \\
        --frames 12 --height 96 --width 128 --iters 2000 \\
        --stage1_ckpt stage1_tiny.npz
    python3 scripts/torch_quality_e2e.py ... --device cpu    # small sizes

Stage-1 artifacts come from the synthetic generator (``gt``: "stage 1 was
perfect") or from the TINY CroCo predictor with global alignment
(``predictor``; ``--stage1_ckpt`` loads trained weights in the JAX
package's npz format, e.g. ``predictor/train_loop.save_params_npz``'s),
then the rearrange bridge, then the stage-2 trainer with the (i+5)%10
eval split, the PSNR-gated camera Adam and the test-pose protocol, then
the masked test PSNR from ``test_log.txt`` and the trajectory ATE/RPE on
the training frames. ``--pose_noise`` perturbs the stage-1 trajectory with
the JAX script's draws in its order, so one noise seed gives both packages
the same noisy trajectory.

Prints one JSON line, the JAX script's record plus the card's
``nvidia-smi`` line and the seconds of each part, and ``main`` returns it.
Runs on the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from das3r_tpu_torch.utils.device import card_line  # noqa: E402

PSNR_BAR_DB = 30.0


def predictor_stage1(args, gen: str, stage1_dir: str) -> dict:
    """TINY CroCo (testkit weights of seed 0, or ``--stage1_ckpt``) and
    global alignment on the generator's frames into ``stage1_dir``; the
    dynamic-mask IoU (at the model's resolution) and the ATE of the
    aligned poses against the generator's."""
    import numpy as np
    from PIL import Image

    from das3r_tpu_torch.data import trajectory as traj_io
    from das3r_tpu_torch.eval import trajectory as traj_eval
    from das3r_tpu_torch.eval.masks import mask_iou
    from das3r_tpu_torch.models.croco.convert import load_reference_state_dict
    from das3r_tpu_torch.models.croco.dpt import untie_upsample_bias
    from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
    from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                      random_torch_state_dict)
    from das3r_tpu_torch.predictor import alignment, runner, train_loop

    frames_dir = os.path.join(args.work, "frames")
    os.makedirs(frames_dir, exist_ok=True)
    for p in sorted(Path(gen).glob("frame_*.png")):
        shutil.copy(p, frames_dir)
    model = AsymmetricCroCo3D(TINY)
    load_reference_state_dict(model, random_torch_state_dict(
        TINY, np.random.default_rng(0)))
    if args.stage1_ckpt:
        # JAX's parameters: each upsampling bias untied into its k*k taps,
        # which stage-1 training trains apart (a tied model would keep
        # only the first tap of each channel)
        untie_upsample_bias(model)
        train_loop.load_params_npz(args.stage1_ckpt, model)
    runner.run_scene(
        frames_dir, stage1_dir, model, scene_graph="swin-2-noncyclic",
        aligner_cfg=alignment.AlignerConfig(niter=50), size=64,
        verbose=lambda *_: None, device=args.device)
    ious = []
    for p_pred in sorted(Path(stage1_dir).glob("dynamic_mask_*.png")):
        i = int(p_pred.stem.split("_")[-1])
        pred = np.asarray(Image.open(p_pred).convert("L")) > 127
        gt_p = Path(gen) / f"dynamic_mask_{i:04d}.png"
        gt = np.asarray(Image.open(gt_p).convert("L").resize(
            (pred.shape[1], pred.shape[0]), Image.NEAREST)) > 127
        ious.append(mask_iou(pred, gt))
    _, gpos, gquat = traj_io.read_tum(os.path.join(gen, "pred_traj.txt"))
    _, ppos, pquat = traj_io.read_tum(os.path.join(stage1_dir,
                                                   "pred_traj.txt"))
    s1_ate = traj_eval.eval_metrics(traj_io.tum_to_c2w(ppos, pquat),
                                    traj_io.tum_to_c2w(gpos, gquat)).ate
    return {"stage1_mask_iou": round(float(np.mean(ious)), 4),
            "stage1_ate": round(float(s1_ate), 5),
            "stage1_ckpt": args.stage1_ckpt}


def perturb_trajectory(traj_path: str, sigma: float, seed: int):
    """Rewrite the TUM trajectory at ``traj_path`` with translation noise
    of ``sigma`` and a rotation of ``sigma`` radians about a random axis
    per frame (the JAX script's draws, in its order). Returns the true
    camera-to-world poses."""
    import numpy as np

    from das3r_tpu_torch.data import trajectory as traj_io

    _, pos, quat = traj_io.read_tum(traj_path)
    gt_c2w = traj_io.tum_to_c2w(pos, quat)
    rng = np.random.default_rng(seed)
    noisy = gt_c2w.copy()
    noisy[:, :3, 3] += rng.normal(0, sigma, (len(pos), 3))
    for f in range(len(pos)):
        ax = rng.normal(size=3)
        ax /= np.linalg.norm(ax)
        ang = rng.normal(0, sigma)
        K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                      [-ax[1], ax[0], 0]])
        R = (np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K)
        noisy[f, :3, :3] = R @ noisy[f, :3, :3]
    npos, nquat = traj_io.c2w_to_tum(noisy)
    traj_io.write_tum(traj_path, npos, nquat)
    return gt_c2w


def final_test_psnr(test_log: str, iters: int) -> float:
    """The masked test PSNR of iteration ``iters`` in ``test_log.txt``."""
    psnr = None
    with open(test_log) as f:
        for line in f:
            m = re.search(r"\[ITER (\d+)\] Evaluating test: L1 \S+ "
                          r"PSNR (\S+)", line)
            if m and int(m.group(1)) == iters:
                psnr = float(m.group(2))
    if psnr is None:
        raise RuntimeError(f"no final test PSNR in {test_log}")
    return psnr


def pose_metrics(args, model_dir: str, gt_c2w) -> dict:
    """Initial (noisy) and final ATE/RPE of the training frames' poses
    against the true trajectory."""
    import numpy as np

    from das3r_tpu_torch.eval import trajectory as traj_eval

    train_idx = [i for i in range(args.frames)
                 if (i + 5) % 10 != 0]          # (i+5)%10==0 is test
    gt_train = gt_c2w[train_idx]
    est_w2c = np.load(os.path.join(model_dir, "pose",
                                   f"pose_{args.iters}.npy"))
    noisy_w2c = np.load(os.path.join(model_dir, "pose", "pose_org.npy"))
    m_final = traj_eval.eval_metrics(np.linalg.inv(est_w2c), gt_train)
    m_init = traj_eval.eval_metrics(np.linalg.inv(noisy_w2c), gt_train)
    return {"pose_noise": args.pose_noise,
            "optim_pose": args.optim_pose,
            "psnr_threshold": args.psnr_threshold,
            "ate_init": round(m_init.ate, 5),
            "ate_final": round(m_final.ate, 5),
            "rpe_trans_final": round(m_final.rpe_trans, 5),
            "rpe_rot_final": round(m_final.rpe_rot, 4)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--work", required=True, help="scratch directory")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--stage1", choices=("gt", "predictor"), default="gt")
    ap.add_argument("--device", default=None,
                    help="torch device for stage 1 and the trainer's "
                         "--device; default cuda (fails without it)")
    ap.add_argument("--max_points", type=int, default=0,
                    help="0 = reference dense init (all confident pixels)")
    ap.add_argument("--pose_noise", type=float, default=0.0,
                    help="perturb the stage-1 trajectory before training "
                         "(translation sigma in world units; rotation "
                         "sigma = same value in radians) and report "
                         "Sim3-ATE of the learned train poses vs the true "
                         "trajectory")
    ap.add_argument("--no-optim-pose", dest="optim_pose",
                    action="store_false", default=True,
                    help="freeze the camera Adam")
    ap.add_argument("--psnr_threshold", type=float, default=26.0,
                    help="camera-Adam gate (0 disables the gate)")
    ap.add_argument("--noise_seed", type=int, default=11)
    ap.add_argument("--stage1_ckpt", default=None,
                    help="TINY params npz (the JAX package's format) for "
                         "--stage1 predictor")
    args = ap.parse_args(argv)

    from das3r_tpu_torch.data import rearrange
    from das3r_tpu_torch.data.synthetic import make_synthetic_stage1_dir
    from das3r_tpu_torch.train import trainer

    stage1_dir = os.path.join(args.work, "stage1")
    scene_dir = os.path.join(args.work, "scene")
    model_dir = os.path.join(args.work, "model")
    seconds = {}

    t0 = time.perf_counter()
    if args.stage1 == "gt":
        make_synthetic_stage1_dir(stage1_dir, n_frames=args.frames,
                                  height=args.height, width=args.width)
        stage1_detail = {}
        seconds["generate"] = time.perf_counter() - t0
    else:
        gen = os.path.join(args.work, "gen")
        make_synthetic_stage1_dir(gen, n_frames=args.frames,
                                  height=args.height, width=args.width)
        seconds["generate"] = time.perf_counter() - t0
        t = time.perf_counter()
        stage1_detail = predictor_stage1(args, gen, stage1_dir)
        seconds["stage1_predictor"] = time.perf_counter() - t

    # the noise goes into the stage-1 dir before the bridge: rearrange
    # derives both pred_traj.txt and the COLMAP images.txt (the trainer's
    # pose init) from this file
    gt_c2w = None
    if args.pose_noise > 0:
        t = time.perf_counter()
        gt_c2w = perturb_trajectory(os.path.join(stage1_dir,
                                                 "pred_traj.txt"),
                                    args.pose_noise, args.noise_seed)
        seconds["pose_noise"] = time.perf_counter() - t

    t = time.perf_counter()
    rearrange.rearrange_scene(stage1_dir, scene_dir)
    # GT dynamic masks in the DAVIS layout (<root>/<seq>/00000.png), so the
    # test PSNR is masked per protocol
    seq = os.path.basename(os.path.normpath(scene_dir))
    gt_mask_root = os.path.join(args.work, "gt_masks")
    os.makedirs(os.path.join(gt_mask_root, seq), exist_ok=True)
    for p in sorted(Path(stage1_dir).glob("dynamic_mask_*.png")):
        i = int(p.stem.split("_")[-1])
        shutil.copy(p, os.path.join(gt_mask_root, seq, f"{i:05d}.png"))
    seconds["rearrange"] = time.perf_counter() - t
    t_stage1 = time.perf_counter() - t0

    t1 = time.perf_counter()
    train_args = [
        "-s", scene_dir, "-m", model_dir,
        "--iter", str(args.iters), "--eval",
        "--test_iterations", str(args.iters),
        "--save_iterations", str(args.iters),
        "--log_every", "200",
        "--max_points", str(args.max_points),
        "--psnr_threshold", str(args.psnr_threshold),
        "--gt_dynamic_mask", gt_mask_root, "--dataset", "davis",
    ]
    if not args.optim_pose:
        train_args.append("--no-optim-pose")
    if args.device is not None:
        train_args += ["--device", args.device]
    trainer.main(train_args)
    t_train = time.perf_counter() - t1
    seconds["train"] = t_train

    t = time.perf_counter()
    psnr = final_test_psnr(os.path.join(model_dir, "test_log.txt"),
                           args.iters)
    pose_detail = ({} if gt_c2w is None
                   else pose_metrics(args, model_dir, gt_c2w))
    seconds["metrics"] = time.perf_counter() - t

    record = {
        "metric": f"synthetic_e2e_masked_test_psnr_{args.iters}it",
        "value": round(psnr, 3),
        "unit": "dB",
        "vs_baseline": round(psnr / PSNR_BAR_DB, 3),
        "detail": {"frames": args.frames, "hw": [args.height, args.width],
                   "stage1": args.stage1,
                   "stage1_s": round(t_stage1, 1),
                   "train_s": round(t_train, 1), **stage1_detail,
                   **pose_detail},
        "card": card_line(),
        "seconds": seconds,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
