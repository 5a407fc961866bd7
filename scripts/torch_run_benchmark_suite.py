#!/usr/bin/env python3
"""Batch benchmark driver of the PyTorch port: the port's counterpart of
``scripts/run_benchmark_suite.py`` (the reference's scripts/*.sh as one
tool), with the same modes and arguments, and ``--device``.

Modes (reference counterparts):
  render      rendering_{davis,sintel}.sh: per scene, train 4000 iters on
              ALL frames then render a video (mp4, or a GIF where no
              encoder exists; the file written is printed).
  psnr        testing_psnr_{davis,sintel}.sh + get_testing_psnr_*.py:
              per scene, train with the (i+5)%10 held-out split, then
              scrape test_log.txt into the PSNR table.
  pose        launch.py --mode=eval_pose: stage-1 ATE/RPE per sequence
              (needs --ckpt, a reference .pth of DUST3R_LARGE_CONFIG).
  masks       table_mask protocol: predicted dynamic-mask IoU vs GT.

Scene dirs are expected under <data_root>/<scene> in the rearranged
COLMAP-style layout.

    python3 scripts/torch_run_benchmark_suite.py psnr --dataset davis \\
        --data_root <scenes> --output_root <out> --gt_dynamic_mask <gt>
    python3 scripts/torch_run_benchmark_suite.py ... --device cpu  # small

Each mode prints what the JAX script prints, then one JSON line with the
mode, the card's ``nvidia-smi`` line and the seconds; ``main`` returns
that line's dict with the mode's result under ``result``. Runs on the
card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from das3r_tpu_torch.eval import harness  # noqa: E402
from das3r_tpu_torch.utils.device import card_line  # noqa: E402


def scenes_for(dataset: str, override):
    if override:
        return override
    return (harness.DAVIS_SCENES if dataset == "davis"
            else harness.SINTEL_SCENES)


def device_args(args) -> list:
    return [] if args.device is None else ["--device", args.device]


def video_path(out_dir: str) -> str:
    """The video ``render_sets(get_video=True)`` wrote into ``out_dir``:
    its mp4, or the GIF of the fallback."""
    got = [os.path.join(out_dir, f"render.{ext}") for ext in ("mp4", "gif")]
    got = [p for p in got if os.path.exists(p)]
    if not got:
        raise FileNotFoundError(f"no render.mp4 or render.gif in {out_dir}")
    return max(got, key=os.path.getmtime)


def run_render(args):
    from das3r_tpu_torch.eval import render_tool
    from das3r_tpu_torch.train import trainer
    videos = {}
    for scene in scenes_for(args.dataset, args.scenes):
        src = os.path.join(args.data_root, scene)
        mdl = os.path.join(args.output_root, scene)
        print(f"=== {scene}: training {args.iterations} iters")
        trainer.main(["-s", src, "-m", mdl, "--iter", str(args.iterations),
                      "--save_iterations", str(args.iterations)]
                     + device_args(args))
        out_dir, _ = render_tool.render_sets(src, mdl, args.iterations,
                                             get_video=True,
                                             device=args.device)
        videos[scene] = video_path(out_dir)
        print(f"=== {scene}: wrote {videos[scene]}")
    return videos


def run_psnr(args):
    from das3r_tpu_torch.train import trainer
    for scene in scenes_for(args.dataset, args.scenes):
        src = os.path.join(args.data_root, scene)
        mdl = os.path.join(args.output_root, scene)
        print(f"=== {scene}: PSNR protocol")
        cli = ["-s", src, "-m", mdl, "--iter", str(args.iterations),
               "--eval", "--dataset", args.dataset]
        if args.gt_dynamic_mask:
            cli += ["--gt_dynamic_mask", args.gt_dynamic_mask]
        if args.strict_parity:
            cli += ["--no-optim-test-pose"]
        trainer.main(cli + device_args(args))
    table = harness.psnr_table(args.output_root,
                               scenes_for(args.dataset, args.scenes))
    print(harness.format_psnr_table(table))
    with open(os.path.join(args.output_root,
                           f"psnr_{args.dataset}.json"), "w") as f:
        json.dump(table, f, indent=2)
    return table


def run_pose(args):
    import torch

    from das3r_tpu_torch.eval import pose_eval
    from das3r_tpu_torch.models.croco.convert import (
        load_reference_state_dict, load_torch_checkpoint)
    from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
    from das3r_tpu_torch.predictor import alignment
    from das3r_tpu_torch.utils.device import resolve_device
    dev = resolve_device(args.device)
    with torch.device(dev):       # DUST3R_LARGE's 606M values made there
        model = AsymmetricCroCo3D()
    load_reference_state_dict(model, load_torch_checkpoint(args.ckpt))
    results, summary = pose_eval.eval_pose_estimation(
        args.dataset, args.data_root, args.output_root, model,
        alignment.AlignerConfig(), seq_list=args.scenes, device=dev)
    print(summary)
    return summary


def run_masks(args):
    from das3r_tpu_torch.eval import davis_eval
    table, summary = davis_eval.eval_dataset_masks(
        args.output_root, args.gt_dynamic_mask,
        scenes_for(args.dataset, args.scenes))
    print(json.dumps({"per_scene": {k: v for k, v in table.items()},
                      "summary": summary}, indent=2))
    return {"per_scene": table, "summary": summary}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mode", choices=["render", "psnr", "pose", "masks"])
    ap.add_argument("--dataset", default="davis",
                    choices=["davis", "sintel", "tum"])
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--output_root", required=True)
    ap.add_argument("--iterations", type=int, default=4000)
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--gt_dynamic_mask", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--strict_parity", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the trainer, the renders and "
                         "stage 1; default cuda (fails without it)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    result = {"render": run_render, "psnr": run_psnr, "pose": run_pose,
              "masks": run_masks}[args.mode](args)
    line = {"mode": args.mode, "card": card_line(),
            "seconds": time.perf_counter() - t0}
    print(json.dumps(line), flush=True)
    return {**line, "result": result}


if __name__ == "__main__":
    main()
