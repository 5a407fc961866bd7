"""Benchmark harnesses: PSNR log scraping, trajectory files, GT loaders
(port of ``das3r_tpu/eval/harness.py``, numpy).

Covers the reference's end-to-end metric plumbing: the test_log scrapers
(scripts/get_testing_psnr_{davis,sintel}.py:8-22), trajectory GT loading for
sintel .cam / TUM / kitti formats (utils/vo_eval.py:98-124 ``load_traj``,
dust3r/utils/image.py:30-73 sintel cam_read), and per-sequence error-log
averaging (utils/vo_eval.py:316-339).
"""
from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np

TAG_FLOAT = 202021.25


def sintel_cam_read(path: str):
    """Sintel camdata .cam: intrinsics M [3,3] + extrinsics N (w2c) [3,4]."""
    with open(path, "rb") as f:
        tag = np.fromfile(f, np.float32, 1)[0]
        assert abs(tag - TAG_FLOAT) < 1e-3, f"bad tag in {path}"
        M = np.fromfile(f, np.float64, 9).reshape(3, 3)
        N = np.fromfile(f, np.float64, 12).reshape(3, 4)
    return M, N


def sintel_depth_read(path: str) -> np.ndarray:
    """Sintel .dpt depth (reference image.py:30-48)."""
    with open(path, "rb") as f:
        tag = np.fromfile(f, np.float32, 1)[0]
        assert abs(tag - TAG_FLOAT) < 1e-3, f"bad tag in {path}"
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        return np.fromfile(f, np.float32, w * h).reshape(h, w)


def flo_read(path: str) -> np.ndarray:
    """Middlebury .flo optical flow -> [H, W, 2]."""
    with open(path, "rb") as f:
        tag = np.fromfile(f, np.float32, 1)[0]
        assert abs(tag - TAG_FLOAT) < 1e-3, f"bad tag in {path}"
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        return np.fromfile(f, np.float32, 2 * w * h).reshape(h, w, 2)


def load_gt_traj(path_or_dir: str, fmt: str) -> np.ndarray:
    """GT trajectory -> [F, 4, 4] c2w (``load_traj`` formats)."""
    from das3r_tpu_torch.data import trajectory
    if fmt == "sintel":
        cams = sorted(Path(path_or_dir).glob("*.cam"))
        poses = []
        for c in cams:
            _, N = sintel_cam_read(str(c))
            w2c = np.eye(4)
            w2c[:3] = N
            poses.append(np.linalg.inv(w2c))
        return np.stack(poses)
    if fmt in ("tum", "replica", "tartanair"):
        ts, pos, quat = trajectory.read_tum(path_or_dir)
        return trajectory.tum_to_c2w(pos, quat)
    if fmt == "kitti":
        data = np.loadtxt(path_or_dir).reshape(-1, 3, 4)
        out = np.tile(np.eye(4), (len(data), 1, 1))
        out[:, :3] = data
        return out
    raise ValueError(fmt)


_PSNR_RE = re.compile(
    r"\[ITER (\d+)\] Evaluating (\w+): L1 ([\d.eE+-]+) PSNR ([\d.eE+-]+)")


def scrape_test_log(log_path: str, split: str = "test"):
    """Parse a test_log.txt; returns list of (iter, l1, psnr)."""
    out = []
    with open(log_path) as f:
        for line in f:
            m = _PSNR_RE.search(line)
            if m and m.group(2) == split:
                out.append((int(m.group(1)), float(m.group(3)),
                            float(m.group(4))))
    return out


def last_psnr(log_path: str) -> float | None:
    rows = scrape_test_log(log_path)
    return rows[-1][2] if rows else None


def psnr_table(results_root: str, scenes: list[str],
               log_name: str = "test_log.txt") -> dict:
    """The get_testing_psnr_* table: last PSNR per scene + average."""
    table = {}
    for scene in scenes:
        p = os.path.join(results_root, scene, log_name)
        table[scene] = last_psnr(p) if os.path.exists(p) else None
    vals = [v for v in table.values() if v is not None]
    table["average"] = float(np.mean(vals)) if vals else None
    return table


def format_psnr_table(table: dict) -> str:
    scenes = [k for k in table if k != "average"]
    header = " & ".join(scenes + ["avg"])
    vals = " & ".join(
        f"{table[s]:.2f}" if table[s] is not None else "--"
        for s in scenes + ["average"])
    return header + "\n" + vals


DAVIS_SCENES = ["blackswan", "camel", "car-shadow", "dog",
                "horsejump-high", "motocross-jump", "parkour", "soapbox"]
SINTEL_SCENES = ["alley_2", "ambush_4", "ambush_5", "ambush_6", "cave_2",
                 "cave_4", "market_2", "market_5", "market_6", "shaman_3",
                 "sleeping_1", "sleeping_2", "temple_2", "temple_3"]
TUM_DYNAMICS_SCENES = [
    "rgbd_dataset_freiburg3_sitting_static",
    "rgbd_dataset_freiburg3_sitting_xyz",
    "rgbd_dataset_freiburg3_sitting_halfsphere",
    "rgbd_dataset_freiburg3_sitting_rpy",
    "rgbd_dataset_freiburg3_walking_static",
    "rgbd_dataset_freiburg3_walking_xyz",
    "rgbd_dataset_freiburg3_walking_halfsphere",
    "rgbd_dataset_freiburg3_walking_rpy",
]
