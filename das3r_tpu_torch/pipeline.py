"""End to end: video frames -> reconstruction + rendered video (port of
``das3r_tpu/pipeline.py``; the library form of the reference's Gradio
demo, app.py:45-79, which shells out launch.py eval_pose_custom ->
utils/rearrange.py -> train_gui.py --iter 4000 -> render.py --get_video).
Stage 1, the bridge and stage 2 run in one process, on one device. The
frame count is capped at 40 by stride subsampling, as in the demo
(app.py:50-52).
"""
from __future__ import annotations

import dataclasses
import math
import os
from pathlib import Path


@dataclasses.dataclass
class PipelineConfig:
    ckpt: str                       # stage-1 torch checkpoint path
    iterations: int = 4000
    max_frames: int = 40
    align_niter: int = 300
    align_lr: float = 0.01
    sh_degree: int = 3
    conf_thre: float = 1.0
    get_video: bool = True
    size: int = 512                 # the frames' long side for stage 1


def count_frames(image_dir: str) -> int:
    exts = {".png", ".jpg", ".jpeg"}
    return sum(1 for p in Path(image_dir).iterdir()
               if p.suffix.lower() in exts)


def run(image_dir: str, work_dir: str, cfg: PipelineConfig,
        verbose=print, device=None) -> dict:
    """Stage 1 -> ``data.rearrange`` -> ``readers.load_scene`` ->
    ``build_scene`` -> ``train_scene`` -> ``render_sets``, on ``device``
    (default CUDA; a RuntimeError without it)."""
    from das3r_tpu_torch.data import readers, rearrange
    from das3r_tpu_torch.eval import render_tool
    from das3r_tpu_torch.predictor import alignment, runner
    from das3r_tpu_torch.train import scene_setup, trainer
    from das3r_tpu_torch.train.config import OptimizationConfig
    from das3r_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    os.makedirs(work_dir, exist_ok=True)
    n = count_frames(image_dir)
    stride = max(1, math.ceil(n / cfg.max_frames))   # demo cap (app.py:50-52)

    # stage 1
    model = runner.build_model(cfg.ckpt)
    stage1_dir = os.path.join(work_dir, "stage1")
    runner.run_scene(
        image_dir, stage1_dir, model,
        aligner_cfg=alignment.AlignerConfig(niter=cfg.align_niter,
                                            lr=cfg.align_lr),
        size=cfg.size, stride=stride, verbose=verbose, device=dev)
    del model

    # bridge
    scene_dir = stage1_dir + "_rearranged"
    rearrange.rearrange_scene(stage1_dir, scene_dir)

    # stage 2
    data = readers.load_scene(scene_dir, eval_mode=False)
    bundle = scene_setup.build_scene(data, sh_degree=cfg.sh_degree,
                                     conf_thre=cfg.conf_thre, device=dev)
    model_path = os.path.join(work_dir, "model")
    os.makedirs(model_path, exist_ok=True)
    opt_cfg = OptimizationConfig(iterations=cfg.iterations)
    result = trainer.train_scene(
        bundle, opt_cfg, model_path=model_path,
        saving_iterations={cfg.iterations}, progress=verbose, warn=verbose,
        device=dev)

    out = {"scene_dir": scene_dir, "model_path": model_path,
           "final_loss": result.last_loss,
           "iters_per_sec": result.iters_per_sec}
    if cfg.get_video:
        render_dir, _ = render_tool.render_sets(
            scene_dir, model_path, cfg.iterations, get_video=True,
            sh_degree=cfg.sh_degree, device=dev)
        mp4 = os.path.join(render_dir, "render.mp4")
        out["video"] = mp4 if os.path.exists(mp4) else mp4[:-4] + ".gif"
    return out


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--work_dir", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--iter", type=int, default=4000)
    ap.add_argument("--no-video", dest="video", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    out = run(args.image_dir, args.work_dir,
              PipelineConfig(ckpt=args.ckpt, iterations=args.iter,
                             get_video=args.video),
              device=args.device)
    print(out)


if __name__ == "__main__":
    main()
