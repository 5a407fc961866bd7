"""TUM trajectory file I/O (the stage-1 <-> stage-2 pose interchange format;
reference reads it with evo's file_interface, dataset_readers.py:112-121, and
writes it in cloud_opt/base_opt.py get_tum_poses/save_tum_poses).

Format: one line per frame: ``timestamp tx ty tz qx qy qz qw``.
"""
from __future__ import annotations

import numpy as np

from das3r_tpu_torch.data.colmap import qvec2rotmat, rotmat2qvec


def read_tum(path: str):
    """Returns (timestamps [F], positions [F,3], quats_wxyz [F,4])."""
    data = np.loadtxt(path, comments="#").reshape(-1, 8)
    ts = data[:, 0]
    xyz = data[:, 1:4]
    qxyzw = data[:, 4:8]
    wxyz = qxyzw[:, [3, 0, 1, 2]]
    return ts, xyz, wxyz


def write_tum(path: str, positions: np.ndarray, quats_wxyz: np.ndarray,
              timestamps=None):
    F = len(positions)
    ts = np.arange(F, dtype=np.float64) if timestamps is None else timestamps
    with open(path, "w") as f:
        for i in range(F):
            x, y, z = positions[i]
            w, qx, qy, qz = quats_wxyz[i]
            f.write(f"{ts[i]} {x} {y} {z} {qx} {qy} {qz} {w}\n")


def tum_to_c2w(positions: np.ndarray, quats_wxyz: np.ndarray) -> np.ndarray:
    """TUM rows -> [F, 4, 4] camera-to-world (``tumpose_to_c2w``,
    dataset_readers.py:82-104: R straight from the normalized quat)."""
    F = len(positions)
    out = np.tile(np.eye(4), (F, 1, 1))
    for i in range(F):
        q = quats_wxyz[i] / np.linalg.norm(quats_wxyz[i])
        out[i, :3, :3] = qvec2rotmat(q)
        out[i, :3, 3] = positions[i]
    return out


def c2w_to_tum(poses_c2w: np.ndarray):
    """[F, 4, 4] c2w -> (positions, quats_wxyz)."""
    pos = poses_c2w[:, :3, 3]
    quats = np.stack([rotmat2qvec(p[:3, :3]) for p in poses_c2w])
    return pos, quats
