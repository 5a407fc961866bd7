#!/usr/bin/env python3
"""Pose-recovery noise sweep of the PyTorch port: the port's counterpart of
``scripts/pose_recovery_sweep.py``, with the same arguments (``--device``
in place of ``--cpu``), arms and records.

Runs ``scripts/torch_quality_e2e.py`` at several pose-noise sigmas, each
with the camera Adam free and frozen (ablation), and records ATE init ->
final + masked test PSNR per arm. All arms run in one process; the card's
cached memory is freed between arms.

The question it answers: does the stage-2 camera Adam RECOVER the true
trajectory (ATE drops substantially), or is the PSNR carried by test-pose
alignment + conf weighting while the train poses barely move? The
--gate0 arm also disables the PSNR>26 camera-step gate
(train_gui.py:581-586) to separate "gate starves the camera optimizer"
from "the loss landscape absorbs pose error into the per-frame geometry".

    python3 scripts/torch_pose_recovery_sweep.py --gate0
    python3 scripts/torch_pose_recovery_sweep.py --sigmas 0.02 --gate0 \\
        --out build/pose_recovery_s0.02.jsonl
    python3 scripts/torch_pose_recovery_sweep.py --frames 6 --height 32 \\
        --width 48 --iters 20 --device cpu      # small, on the CPU

Writes one JSON line per arm (the quality script's record, with its
``card`` and ``seconds``, plus ``wall_s``, ``n_regrow`` and
``n_compile_fallback``) to --out (default build/pose_recovery.jsonl; the
JAX package's record, docs/pose_recovery_r5.jsonl, is never written),
prints a summary, then one JSON line with the arm count, the file, the
card's ``nvidia-smi`` line and the seconds; ``main`` returns the arms'
records.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(SCRIPTS)
sys.path.insert(0, ROOT)
sys.path.insert(0, SCRIPTS)

from das3r_tpu_torch.utils.device import card_line  # noqa: E402


def run_arm(qmain, work, sigma, optim_pose, gate, args):
    argv = ["--work", work,
            "--frames", str(args.frames),
            "--height", str(args.height), "--width", str(args.width),
            "--iters", str(args.iters),
            "--pose_noise", str(sigma),
            "--psnr_threshold", str(gate),
            "--max_points", str(args.max_points)]
    if not optim_pose:
        argv.append("--no-optim-pose")
    if args.device is not None:
        argv += ["--device", args.device]
    buf = io.StringIO()
    t0 = time.time()

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            sys.__stdout__.write(s)
            return len(s)

    with contextlib.redirect_stdout(Tee()):
        qmain(argv)
    wall = time.time() - t0
    out = buf.getvalue()
    rec = None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("{") and "synthetic_e2e" in line:
            rec = json.loads(line)
    assert rec is not None, out[-2000:]
    rec["detail"]["wall_s"] = round(wall, 1)
    rec["detail"]["n_regrow"] = out.count("regrow ")
    # the JAX trainer's compile fallbacks: the port compiles nothing, so
    # this stays 0 and keeps the record's shape
    rec["detail"]["n_compile_fallback"] = out.count("compile failed")
    return rec


def free_card_memory() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--work", default=os.path.join(ROOT, "build",
                                                   "posesweep"))
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--max_points", type=int, default=0)
    ap.add_argument("--sigmas", type=float, nargs="*",
                    default=[0.02, 0.05, 0.1])
    ap.add_argument("--device", default=None,
                    help="torch device of every arm; default cuda (fails "
                         "without it)")
    ap.add_argument("--gate0", action="store_true",
                    help="add a gate-disabled (psnr_threshold 0) arm")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from torch_quality_e2e import main as qmain

    t_all = time.perf_counter()
    arms = []
    for sigma in args.sigmas:
        arms.append((sigma, True, 26.0))
        arms.append((sigma, False, 26.0))
        if args.gate0:
            arms.append((sigma, True, 0.0))

    results = []
    for k, (sigma, optim_pose, gate) in enumerate(arms):
        work = os.path.join(args.work,
                            f"s{sigma}_p{int(optim_pose)}_g{int(gate)}")
        print(f"=== arm {k + 1}/{len(arms)}: sigma={sigma} "
              f"optim_pose={optim_pose} gate={gate}", flush=True)
        rec = run_arm(qmain, work, sigma, optim_pose, gate, args)
        results.append(rec)
        free_card_memory()

    out_path = args.out or os.path.join(ROOT, "build",
                                        "pose_recovery.jsonl")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
    print(f"wrote {len(results)} arms -> {out_path}")
    for r in results:
        d = r["detail"]
        ratio = (d["ate_init"] / d["ate_final"]
                 if d.get("ate_final") else float("nan"))
        print(f"sigma={d.get('pose_noise')} optim={d.get('optim_pose')} "
              f"gate={d.get('psnr_threshold')} psnr={r['value']} "
              f"ate {d.get('ate_init')} -> {d.get('ate_final')} "
              f"({ratio:.2f}x) wall={d.get('wall_s')}s "
              f"regrow={d.get('n_regrow')}")
    print(json.dumps({"arms": len(results), "out": out_path,
                      "card": card_line(),
                      "seconds": time.perf_counter() - t_all}), flush=True)
    return results


if __name__ == "__main__":
    main()
