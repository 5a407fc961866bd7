"""Stage-1 runner: video frames -> pairwise predictions -> global alignment
-> stage-1 output directory (port of ``das3r_tpu/predictor/runner.py``;
the reference's ``launch.py --mode=eval_pose_custom`` flow, pose_eval.
pose_estimation_custom :255-330 and base_opt save_* :358-425). It writes
the flat layout that ``das3r_tpu_torch.data.rearrange`` re-arranges into a
COLMAP-style scene directory.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from das3r_tpu_torch.data import trajectory
from das3r_tpu_torch.models.croco.convert import (load_reference_state_dict,
                                                  read_checkpoint)
from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
from das3r_tpu_torch.predictor import alignment, inference, pairs
from das3r_tpu_torch.utils.device import resolve_device

VIDEO_EXTS = {".mp4", ".avi", ".mov"}


def _fit_frame(img: Image.Image, size: int) -> np.ndarray:
    """Resize the long side to ``size``, center-crop to /16 multiples."""
    w, h = img.size
    scale = size / max(w, h)
    nw, nh = round(w * scale), round(h * scale)
    img = img.resize((nw, nh), Image.LANCZOS)
    cw, ch = (nw // 16) * 16, (nh // 16) * 16
    left, top = (nw - cw) // 2, (nh - ch) // 2
    img = img.crop((left, top, left + cw, top + ch))
    return np.asarray(img, np.float32) / 255.0


def _decode_video(path: str, stride: int, max_frames: int | None,
                  fps: float):
    """Sample frames of a video file (reference dust3r/utils/image.py
    :213-252: frame interval round(video_fps / fps) when ``fps > 0``, else
    every ``stride``-th frame; the first ``max_frames``)."""
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    try:
        video_fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if fps > 0 and video_fps > 0:
            interval = max(1, int(round(video_fps / fps)))
        else:
            interval = max(1, stride)
        idxs = list(range(0, total, interval))
        if max_frames is not None:
            idxs = idxs[:max_frames]
        frames, names = [], []
        want = set(idxs)
        last = max(idxs) if idxs else -1
        k = 0
        while k <= last:
            ok, frame = cap.read()
            if not ok:
                break
            if k in want:
                frames.append(Image.fromarray(
                    cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)))
                names.append(f"frame_{k:04d}.png")
            k += 1
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return frames, names


def load_frames(image_dir: str, size: int = 512, stride: int = 1,
                max_frames: int | None = None, fps: float = 0.0):
    """Load, resize (long side -> ``size``) and crop to /16 multiples
    (reference dust3r/utils/image.py:146-275). Returns ([F, 3, H, W] in
    [0, 1], names).

    ``image_dir`` may be a directory of images or a video file
    (.mp4/.avi/.mov, decoded with cv2 as the reference's load_images
    does); for a video, ``fps > 0`` resamples to that frame rate, else
    every ``stride``-th frame is kept."""
    p = Path(image_dir)
    if p.is_file() and p.suffix.lower() in VIDEO_EXTS:
        imgs, names = _decode_video(str(p), stride, max_frames, fps)
        out = [_fit_frame(im, size) for im in imgs]
        return np.stack(out).transpose(0, 3, 1, 2), names
    exts = {".png", ".jpg", ".jpeg"}
    files = sorted(q for q in p.iterdir() if q.suffix.lower() in exts)
    files = files[::stride]
    if max_frames is not None:
        files = files[:max_frames]
    if not files:
        raise ValueError(f"no images under {image_dir}")
    out = []
    for q in files:
        with Image.open(q) as im:
            out.append(_fit_frame(im.convert("RGB"), size))
    return np.stack(out).transpose(0, 3, 1, 2), [q.name for q in files]


def save_stage1_outputs(out_dir: str, images01: np.ndarray,
                        scene: alignment.AlignedScene) -> None:
    """Write the flat stage-1 layout (base_opt.py:358-425)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = images01.shape[0]
    for i in range(n):
        img = (images01[i].transpose(1, 2, 0) * 255).astype(np.uint8)
        Image.fromarray(img).save(out / f"frame_{i:04d}.png")
        np.save(out / f"frame_{i:04d}.npy", scene.depths[i])
        np.save(out / f"conf_{i:04d}.npy", scene.im_conf[i])
        np.save(out / f"dyna_avg_{i:04d}.npy", scene.dyna_avg[i])
        np.save(out / f"dyna_max_{i:04d}.npy", scene.dyna_max[i])
        Image.fromarray(
            (scene.dynamic_masks[i] * 255).astype(np.uint8)).save(
            out / f"dynamic_mask_{i:04d}.png")
    pos, quat = trajectory.c2w_to_tum(scene.poses_c2w.astype(np.float64))
    trajectory.write_tum(str(out / "pred_traj.txt"), pos, quat)
    np.savetxt(out / "pred_intrinsics.txt",
               scene.intrinsics.reshape(n, 9), fmt="%.6f")
    enlarge_seg_masks(str(out))


def dilate_mask(mask: np.ndarray, kernel_size: int = 5) -> np.ndarray:
    """A ``kernel_size`` square dilation of a uint8 [H, W] mask with
    nothing beyond the border: the bytes of ``cv2.dilate`` with a
    ``kernel_size`` square of ones."""
    t = torch.from_numpy(mask.astype(np.float32))[None, None]
    out = F.max_pool2d(t, kernel_size, stride=1, padding=kernel_size // 2)
    return out[0, 0].numpy().astype(np.uint8)


def enlarge_seg_masks(folder: str, kernel_size: int = 5,
                      prefix: str = "dynamic_mask") -> None:
    """5x5 dilation of the binary dynamic masks -> enlarged_dynamic_mask_*
    (reference dust3r/utils/image.py:277-283; read by the stage-2 loader
    as its enlarged_dynamic_masks)."""
    for mask_path in sorted(Path(folder).glob(f"{prefix}_*.png")):
        with Image.open(mask_path) as im:
            mask = np.asarray(im.convert("L"))
        out = mask_path.with_name(
            mask_path.name.replace(prefix, "enlarged_dynamic_mask"))
        Image.fromarray(dilate_mask(mask, kernel_size)).save(out)


@dataclasses.dataclass
class Stage1Result:
    scene: alignment.AlignedScene
    n_frames: int
    out_dir: str


def run_scene(
    image_dir: str,
    out_dir: str,
    model: AsymmetricCroCo3D,
    *,
    scene_graph: str | None = None,
    aligner_cfg: alignment.AlignerConfig = alignment.AlignerConfig(),
    size: int = 512,
    stride: int = 1,
    max_frames: int | None = None,
    flows=None,
    raft_params=None,
    mask_refiner=None,
    verbose=print,
    device=None,
    stats: dict | None = None,
) -> Stage1Result:
    """Stage 1 on ``device`` (default CUDA; a RuntimeError without it; the
    model is moved there).

    ``flows``: precomputed (flow_ij, flow_ji, valid_i, valid_j) for the
    alignment's flow term, as ``alignment.align`` takes them. RAFT flows
    (``raft_params``) and mask refinement (``mask_refiner``) are not
    ported yet and raise. ``stats``, when a dict, receives the seconds of
    each part (``load_s``, ``inference_s``, ``save_s``, ``total_s``) and
    the alignment's under ``align`` (see ``alignment.align``).
    """
    if raft_params is not None:
        raise NotImplementedError(
            "RAFT flows are not ported yet (ROADMAP.md queue 1, item 7); "
            "pass precomputed flows")
    if mask_refiner is not None:
        raise NotImplementedError(
            "mask refinement is not ported yet (ROADMAP.md queue 1, "
            "item 8)")
    dev = resolve_device(device)
    model.to(dev)
    t0 = time.perf_counter()
    images01, _ = load_frames(image_dir, size=size, stride=stride,
                              max_frames=max_frames)
    n = images01.shape[0]
    if n < 2:
        raise ValueError(f"need at least 2 frames, found {n} under "
                         f"{image_dir} (stride={stride})")
    graph = scene_graph or pairs.eval_scene_graph(n)
    edges = pairs.make_pairs(n, graph, symmetrize=True)
    verbose(f"stage1: {n} frames, graph {graph} -> {len(edges)} edges")
    t1 = time.perf_counter()

    preds = inference.run_pairs(model, images01, edges)
    t2 = time.perf_counter()
    verbose("stage1: pairwise inference done; aligning...")

    align_stats: dict = {}
    if n > 2:
        scene = alignment.align(
            edges, preds.pred_i, preds.pred_j, preds.conf_i, preds.conf_j,
            preds.mask_i, aligner_cfg, flows=flows, device=dev,
            stats=align_stats)
    else:
        # exactly one symmetrized pair: the closed-form PairViewer path
        # (reference pose_eval.py:119 / :315)
        scene = alignment.pair_view(
            edges, preds.pred_i, preds.pred_j, preds.conf_i, preds.conf_j,
            preds.mask_i, aligner_cfg)
    t3 = time.perf_counter()
    verbose(f"stage1: alignment loss {scene.final_loss:.5f}")

    save_stage1_outputs(out_dir, images01, scene)
    t4 = time.perf_counter()
    if stats is not None:
        stats.update(load_s=t1 - t0, inference_s=t2 - t1, align_s=t3 - t2,
                     save_s=t4 - t3, total_s=t4 - t0, n_frames=n,
                     n_edges=len(edges), graph=graph, align=align_stats)
    return Stage1Result(scene=scene, n_frames=n, out_dir=out_dir)


def build_model(ckpt: str, bf16: bool = False) -> AsymmetricCroCo3D:
    """The predictor of the reference checkpoint ``ckpt``, at the config
    its weights give (``convert.config_from_state_dict``), the trunk in
    bfloat16 with ``bf16``, on the CPU."""
    state, cfg = read_checkpoint(ckpt)
    if bf16:
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    model = AsymmetricCroCo3D(cfg)
    load_reference_state_dict(model, state)
    return model


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--ckpt", required=True,
                    help="torch .pth checkpoint (e.g. Kai422kx/das3r)")
    ap.add_argument("--scene_graph", default=None)
    ap.add_argument("--n_iter", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--motion_mask_thre", type=float, default=0.35)
    ap.add_argument("--refine_masks", action="store_true",
                    help="video-propagation mask refinement (not ported "
                         "yet: raises)")
    ap.add_argument("--bf16", action="store_true",
                    help="run the ViT trunk in bfloat16 (heads float32)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    model = build_model(args.ckpt, args.bf16)
    cfg = alignment.AlignerConfig(niter=args.n_iter, lr=args.lr,
                                  motion_mask_thre=args.motion_mask_thre)
    run_scene(args.image_dir, args.output_dir, model,
              scene_graph=args.scene_graph, aligner_cfg=cfg,
              stride=args.stride, max_frames=args.max_frames,
              mask_refiner=True if args.refine_masks else None, device=dev)


if __name__ == "__main__":
    main()
