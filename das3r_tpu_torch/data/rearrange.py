"""Stage-1 -> stage-2 bridge: re-arrange a flat stage-1 output directory into
the COLMAP-style scene layout stage 2 consumes (reference
utils/rearrange.py:41-130; the davis/sintel variants just loop this over
every sequence under results/<set>/).

Input layout (what the stage-1 runner writes per sequence):
    frame_NNNN.png, frame_NNNN.npy (depth), conf_NNNN.npy,
    dyna_avg_NNNN.npy, dyna_max_NNNN.npy, dynamic_mask_NNNN.png,
    pred_traj.txt, pred_intrinsics.txt
Output:
    images/, depth_maps/, confidence_maps/, dyna_avg/, dyna_max/,
    dynamic_masks/, sparse/0/{cameras.txt, images.txt},
    pred_traj.txt, pred_intrinsics.txt
"""
from __future__ import annotations

import os
import shutil
from pathlib import Path

import numpy as np
from PIL import Image

from das3r_tpu_torch.data import colmap, trajectory


def _glob_sorted(src: Path, pattern: str):
    return sorted(src.glob(pattern),
                  key=lambda x: int(x.stem.split("_")[-1]))


def rearrange_scene(dataset_path: str, output_path: str) -> None:
    src = Path(dataset_path)
    out = Path(output_path)
    colmap_dir = out / "sparse/0"
    colmap_dir.mkdir(parents=True, exist_ok=True)

    subdirs = {
        "images": ("frame_*.png", "{name}"),
        "dynamic_masks": ("dynamic_mask_*.png", "dynamic_mask_{i:04d}.png"),
        "enlarged_dynamic_masks": ("enlarged_dynamic_mask_*.png",
                                   "enlarged_dynamic_mask_{i:04d}.png"),
        "depth_maps": ("frame_*.npy", "frame_{i:04d}.npy"),
        "confidence_maps": ("conf_*.npy", "conf_{i:04d}.npy"),
        "dyna_max": ("dyna_max_*.npy", "dyna_max_{i:04d}.npy"),
        "dyna_avg": ("dyna_avg_*.npy", "dyna_avg_{i:04d}.npy"),
    }
    for sub, (pattern, out_name) in subdirs.items():
        d = out / sub
        d.mkdir(parents=True, exist_ok=True)
        for i, f in enumerate(_glob_sorted(src, pattern)):
            shutil.copy(f, d / out_name.format(name=f.name, i=i))

    for fname in ("pred_traj.txt", "pred_intrinsics.txt"):
        shutil.copy(src / fname, out / fname)

    ts, pos, quat = trajectory.read_tum(str(src / "pred_traj.txt"))
    poses_c2w = trajectory.tum_to_c2w(pos, quat)
    K = np.loadtxt(src / "pred_intrinsics.txt",
                   dtype=np.float32).reshape(-1, 3, 3)

    rgb_files = _glob_sorted(src, "frame_*.png")
    with Image.open(rgb_files[0]) as im:
        size_wh = im.size
    colmap.write_cameras_text(str(colmap_dir / "cameras.txt"), size_wh, K)
    colmap.write_images_text(str(colmap_dir / "images.txt"), poses_c2w,
                             [f.name for f in rgb_files])


def rearrange_results_root(results_root: str, suffix: str = "_rearranged"):
    """Loop over every sequence directory under ``results_root`` (the
    reference's rearrange_davis.py/rearrange_sintel.py behavior)."""
    root = Path(results_root)
    out_root = Path(str(root) + suffix)
    for seq in sorted(p for p in root.iterdir() if p.is_dir()):
        rearrange_scene(str(seq), str(out_root / seq.name))


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--output_dir", required=True,
                    help="stage-1 output dir (single sequence) or results "
                         "root with --all")
    ap.add_argument("--all", action="store_true",
                    help="treat output_dir as a root of sequence dirs")
    args = ap.parse_args()
    if args.all:
        rearrange_results_root(args.output_dir)
    else:
        rearrange_scene(args.output_dir, args.output_dir + "_rearranged")


if __name__ == "__main__":
    main()
