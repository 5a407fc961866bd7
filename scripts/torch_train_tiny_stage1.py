#!/usr/bin/env python3
"""Train the TINY stage-1 predictor on the synthetic wall world until the
mask heads learn: the PyTorch port's counterpart of
``scripts/train_tiny_stage1.py``, with the same arguments (``--device`` in
place of ``--cpu``), recipe and record.

No published DAS3R/MonST3R checkpoint is in the repository, so this
trains TINY CroCo from the testkit's seeded weights on
``WallTwoViewDataset`` (the ray-traced wall + red-square world of the
quality harness) with the reference criterion ConfLoss(Regr3D_MMask(L21))
and reports the held-out dynamic-mask IoU; with ``--freeze none`` (the
default: no pretrained trunk exists to freeze) the pointmap path trains
too, giving the downstream alignment non-random geometry.

    python3 scripts/torch_train_tiny_stage1.py --epochs 60 --n_train 256 \\
        --resolution 64 48 --lr 1e-3 --freeze none --out build/tiny
    python3 scripts/torch_train_tiny_stage1.py --epochs 1 --n_train 16 \\
        --n_test 8 --device cpu --out build/tiny_cpu

Writes <out>/stage1_tiny.npz (every parameter, in the JAX package's
``save_params_npz`` format that both packages' ``--stage1_ckpt`` read) and
prints one JSON line: the JAX script's record plus the card's
``nvidia-smi`` line and the seconds of each part; ``main`` returns it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from das3r_tpu_torch.utils.device import card_line  # noqa: E402

IOU_BAR = 0.7               # the bar of JAX's record (its vs_baseline)


def mask_iou_eval(model, dataset, batch_size=8, thr=0.5, device=None):
    """The mean IoU of every view's dynamic mask > ``thr`` against its GT
    over ``dataset``, in order."""
    import numpy as np
    import torch

    from das3r_tpu_torch.eval.masks import mask_iou
    from das3r_tpu_torch.predictor.datasets import batch_iterator
    from das3r_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    ious = []
    with torch.no_grad():
        for img1, img2, batch in batch_iterator(dataset, batch_size, seed=0,
                                                shuffle=False,
                                                drop_last=False):
            res1, res2 = model(torch.as_tensor(img1, device=dev),
                               torch.as_tensor(img2, device=dev))
            for res, gt in ((res1, batch.gt_mask_1), (res2, batch.gt_mask_2)):
                pred = (res["dynamic_mask"] > thr).cpu().numpy()
                for b in range(pred.shape[0]):
                    ious.append(mask_iou(pred[b], gt[b] > 0.5))
    return float(np.mean(ious))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "stage1_tiny"))
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--n_train", type=int, default=256)
    ap.add_argument("--n_test", type=int, default=32)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="from-scratch TINY wants a larger lr than the "
                         "reference's 5e-5 fine-tune recipe")
    ap.add_argument("--resolution", type=int, nargs=2, default=[64, 48],
                    help="W H (multiples of 16)")
    ap.add_argument("--freeze", default="none",
                    choices=("none", "encoder_and_3d_predictor"))
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (fails without it)")
    return ap.parse_args(argv)


def seeded_model(device=None):
    """TINY with the testkit's weights of seed 0 (the JAX script's start),
    on ``device``."""
    import numpy as np

    from das3r_tpu_torch.models.croco.convert import load_reference_state_dict
    from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
    from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                      random_torch_state_dict)
    from das3r_tpu_torch.utils.device import resolve_device

    model = AsymmetricCroCo3D(TINY)
    load_reference_state_dict(model, random_torch_state_dict(
        TINY, np.random.default_rng(0)))
    return model.to(resolve_device(device))


def datasets(args):
    """(train, test) sets: ``WallTwoViewDataset`` of seeds 1 and 999."""
    from das3r_tpu_torch.predictor.datasets import WallTwoViewDataset
    res = tuple(args.resolution)
    return (WallTwoViewDataset(n=args.n_train, resolution=res, seed=1),
            WallTwoViewDataset(n=args.n_test, resolution=res, seed=999))


def configs(args):
    """(train config, loop config): the JAX script's arithmetic."""
    from das3r_tpu_torch.predictor import train_loop, training
    steps = max(1, args.n_train // args.batch_size)
    tcfg = training.Stage1TrainConfig(
        lr=args.lr, epochs=args.epochs, steps_per_epoch=steps,
        warmup_epochs=max(1.0, args.epochs * 0.05), freeze=args.freeze)
    lcfg = train_loop.Stage1LoopConfig(
        epochs=args.epochs, batch_size=args.batch_size,
        eval_freq=max(1, args.epochs // 10), out_dir=args.out)
    return tcfg, lcfg


def train(args, train_ds, test_ds, tcfg, lcfg, progress=print):
    """``fit`` the seeded model, its held-out IoU, ``stage1_tiny.npz``:
    (the record, the trained model, the history)."""
    from das3r_tpu_torch.predictor import train_loop

    t0 = time.perf_counter()
    model = seeded_model(args.device)
    seconds = {"model": time.perf_counter() - t0}
    t0 = time.perf_counter()
    model, history = train_loop.fit(model, train_ds, {"wall": test_ds},
                                    tcfg, lcfg, progress=progress,
                                    device=args.device)
    train_s = time.perf_counter() - t0
    seconds["train"] = train_s
    t0 = time.perf_counter()
    iou = mask_iou_eval(model, test_ds, args.batch_size, device=args.device)
    seconds["eval"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt = os.path.join(args.out, "stage1_tiny.npz")
    train_loop.save_params_npz(ckpt, model)
    seconds["save"] = time.perf_counter() - t0
    record = {
        "metric": "tiny_stage1_heldout_mask_iou",
        "value": round(iou, 4),
        "unit": "IoU",
        "vs_baseline": round(iou / IOU_BAR, 3),
        "detail": {"epochs": args.epochs, "n_train": args.n_train,
                   "resolution": list(args.resolution),
                   "freeze": args.freeze, "lr": args.lr,
                   "train_s": round(train_s, 1),
                   "final_train_loss": history[-1]["train_loss"]
                   if history else None,
                   "ckpt": ckpt},
        "card": card_line(),
        "seconds": seconds,
    }
    return record, model, history


def main(argv=None) -> dict:
    args = parse_args(argv)
    t0 = time.perf_counter()
    train_ds, test_ds = datasets(args)
    tcfg, lcfg = configs(args)
    record, _, _ = train(args, train_ds, test_ds, tcfg, lcfg)
    record["seconds"]["total"] = time.perf_counter() - t0
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
