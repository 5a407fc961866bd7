"""Offline rendering tool: load a trained scene (PLY + optimized poses),
re-render every training view with the conf-modulated test renderer and
optionally encode a video at 15 fps. Port of
``das3r_tpu/eval/render_tool.py``.

One difference from the JAX tool: it does not run the
``autosize.auto_entry_cap`` probe render. That probe exists because XLA
needs a static entry-stream capacity; eager PyTorch sizes the stream from
the real per-tile counts (``RasterSettings.max_total_entries=None``), so no
entry is ever dropped and ``entry_overflow`` stays 0.

    python -m das3r_tpu_torch.eval.render_tool -s <scene> -m <model> \\
        --iteration N [--get_video] [--device cpu]
"""
from __future__ import annotations

import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from das3r_tpu_torch.data import ply as ply_io
from das3r_tpu_torch.data import readers
from das3r_tpu_torch.models import render as render_mod
from das3r_tpu_torch.models.gaussians import GaussianMeta, GaussianParams
from das3r_tpu_torch.ops.splat import RasterSettings
from das3r_tpu_torch.utils.device import on_device, resolve_device
from das3r_tpu_torch.utils.quat import w2c_to_pose


def load_gaussians_ply(path: str, max_sh_degree: int = 3, device=None):
    """PLY checkpoint -> (GaussianParams, GaussianMeta, conf_per_gaussian)
    on ``device``. The raw ``opacity_ori`` logit is restored; conf_static is
    applied at render time (render_test of the reference)."""
    dev = resolve_device(device)
    d = ply_io.read_gaussians(path, max_sh_degree)
    n = d["xyz"].shape[0]

    def t(x):
        return on_device(np.asarray(x, np.float32), dev)

    params = GaussianParams(
        xyz=t(d["xyz"]), features_dc=t(d["f_dc"]),
        features_rest=t(d["f_rest"]), scaling=t(d["scaling"]),
        rotation=t(d["rotation"]), opacity=t(d["opacity_logit"]),
        conf_static=torch.zeros(1, 1, 1, device=dev))  # not used in test
    meta = GaussianMeta(
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        pix_id=torch.zeros(n, dtype=torch.int64, device=dev),
        max_radii2d=torch.zeros(n, device=dev),
        xyz_grad_accum=torch.zeros(n, device=dev),
        denom=torch.zeros(n, device=dev))
    return params, meta, t(d["conf_static"])


def images_to_video(image_paths, out_path: str, fps: int = 15) -> str:
    """Encode frames to an mp4 (imageio with its ffmpeg plugin, or a
    system ffmpeg), or to an animated GIF when there is no encoder.
    Returns the path actually written."""
    try:
        import imageio.v2 as imageio
        imageio.mimwrite(out_path, [imageio.imread(p) for p in image_paths],
                         fps=fps)
        return out_path
    except Exception:       # no imageio, or no mp4 plugin: as JAX's tool
        pass
    if shutil.which("ffmpeg"):
        list_file = out_path + ".frames.txt"
        with open(list_file, "w") as f:
            for p in image_paths:
                f.write(f"file '{os.path.abspath(p)}'\n")
        subprocess.run(
            ["ffmpeg", "-y", "-r", str(fps), "-f", "concat", "-safe", "0",
             "-i", list_file, "-pix_fmt", "yuv420p", out_path], check=True)
        os.remove(list_file)
        return out_path
    gif_path = os.path.splitext(out_path)[0] + ".gif"
    imgs = [Image.open(p) for p in image_paths]
    imgs[0].save(gif_path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    print(f"no mp4 encoder available; wrote {gif_path} instead")
    return gif_path


def render_sets(source_path: str, model_path: str, iteration: int,
                *, get_video: bool = False, fps: int = 15,
                mode: str = "test", max_per_tile: int = 1024,
                sh_degree: int = 3, white_background: bool = False,
                device=None, stats: list | None = None):
    """Render all train views at checkpoint ``iteration`` on ``device``
    (default CUDA; a RuntimeError without it). Returns (out_dir, paths).

    ``stats``, when a list, receives one dict per view: the render time in
    ms (CUDA events on the GPU), the stream's entry count and
    ``entry_overflow``, and whether the image is finite."""
    dev = resolve_device(device)
    data = readers.load_scene(source_path, eval_mode=False)
    ply_path = os.path.join(model_path, "point_cloud",
                            f"iteration_{iteration}", "point_cloud.ply")
    params, meta, conf = load_gaussians_ply(ply_path, sh_degree, dev)
    poses_w2c = np.load(os.path.join(model_path, "pose",
                                     f"pose_{iteration}.npy"))
    pose7 = w2c_to_pose(torch.as_tensor(poses_w2c, dtype=torch.float32,
                                        device=dev))

    settings = RasterSettings(
        image_height=data.height, image_width=data.width,
        sh_degree=sh_degree, max_per_tile=max_per_tile,
        max_tiles_per_gaussian=32)
    bg = torch.ones(3, device=dev) if white_background else torch.zeros(
        3, device=dev)

    out_dir = Path(model_path) / f"renders_{iteration}"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for f in range(min(len(pose7), data.n_frames)):
        if stats is not None:
            timer = _Timer(dev)
        out = render_mod.render(
            params, meta, settings, pose7[f], bg, float(data.fovx[f]),
            float(data.fovy[f]), mode=mode, conf_per_gaussian=conf,
            device=dev)
        img = out.image.detach()
        if stats is not None:
            stats.append(dict(
                view=f, ms=timer.stop(),
                entries=int(out.aux.n_contrib_tiles.sum()),
                entry_overflow=int(out.aux.entry_overflow),
                finite=bool(torch.isfinite(img).all())))
        arr = np.clip(img.cpu().numpy().transpose(1, 2, 0), 0, 1)
        p = out_dir / f"{f:05d}.png"
        Image.fromarray((arr * 255).astype(np.uint8)).save(p)
        paths.append(str(p))
    if get_video:
        images_to_video(paths, str(out_dir / "render.mp4"), fps=fps)
    return str(out_dir), paths


class _Timer:
    """Milliseconds from construction to ``stop()``: CUDA events on a GPU,
    the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if not self.cuda:
            return (time.perf_counter() - self.t0) * 1e3
        self.end.record()
        self.end.synchronize()
        return self.start.elapsed_time(self.end)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-s", "--source_path", required=True)
    ap.add_argument("-m", "--model_path", required=True)
    ap.add_argument("--iteration", type=int, required=True)
    ap.add_argument("--get_video", action="store_true")
    ap.add_argument("--fps", type=int, default=15)
    ap.add_argument("--mode", default="test",
                    choices=["test", "no_soft", "confidence"])
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (fails without it)")
    args = ap.parse_args(argv)
    out_dir, paths = render_sets(args.source_path, args.model_path,
                                 args.iteration, get_video=args.get_video,
                                 fps=args.fps, mode=args.mode,
                                 device=args.device)
    print(f"rendered {len(paths)} views -> {out_dir}")


if __name__ == "__main__":
    main()
