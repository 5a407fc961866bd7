"""Faults planted in the program underneath a run, to show that a cell's
check catches them (``tests/test_bench_faults.py`` on the CPU,
``control.py`` on the card). Each is a context manager that patches one
function of ``das3r_tpu_torch`` and restores it on exit.

* ``state_unchanged``: the optimiser step returns without touching the
  parameters or its moments (a step that leaves its state unchanged);
* ``half_batch``: the loss is taken over the image's top half, its mean
  over those pixels only (half the batch left out);
* ``altered_image``: every rendered image has one 16 x 16 tile zeroed
  where it is produced (an answer altered);
* ``altered_maps``: every decoded pair's pointmaps have one 16 x 16 patch
  zeroed where they are produced;
* ``no_exchange``: the stage-1 step's all-reduce of the mask heads'
  gradients (tag ``stage1_grads``) returns its input, so each rank steps
  on its own rows' gradient (the exchange between chips left out);
* ``local_means``: ``collectives.reduce_sum`` returns its input, so the
  loss's masked means cover the rank's own rows only;
* ``adamw_skipped``: the stage-1 AdamW step returns without touching the
  heads or its moments (a step that leaves its state unchanged);
* ``half_rows``: the stage-1 loss is taken over the first half of each
  rank's rows, its means over those rows only (half the batch left out).
* ``no_weight_decay``: the stage-1 AdamW step runs with weight decay 0
  (a wrong update that every other part of the step survives).

A one-card cell plants a fault around its run in the process that runs
it (``control.py``, ``tests/test_bench_faults.py``); a cell on several
cards gives the fault's name to its driver, which plants it inside every
rank.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name: str, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def state_unchanged():
    from das3r_tpu_torch.train import optim
    return _patched(optim, "adam_step", lambda orig: (lambda *a, **k: None))


def half_batch():
    from das3r_tpu_torch.train import step

    def make(orig):
        def loss(pred, gt, static, lambda_dssim=0.2):
            h = pred.shape[-2] // 2
            return orig(pred[:, :h], gt[:, :h], static[:h], lambda_dssim)
        return loss
    return _patched(step.loss_mod, "photometric_loss", make)


def altered_image():
    from das3r_tpu_torch.models import render

    def make(orig):
        def rendered(*a, **k):
            out = orig(*a, **k)
            img = out.image.clone()
            img[:, :16, :16] = 0.0
            return out._replace(image=img)
        return rendered
    return _patched(render, "render", make)


def altered_maps():
    from das3r_tpu_torch.predictor import inference

    def make(orig):
        def decode(*a, **k):
            r1, r2 = orig(*a, **k)
            for r, key in ((r1, "pts3d"), (r2, "pts3d_in_other_view")):
                r[key] = r[key].clone()
                r[key][:, :16, :16] = 0.0
            return r1, r2
        return decode
    return _patched(inference, "decode_pairs", make)


def no_exchange():
    from das3r_tpu_torch.parallel import collectives

    def make(orig):
        def all_reduce(x, group, *a, tag: str = "", **k):
            if tag == "stage1_grads":
                return x
            return orig(x, group, *a, tag=tag, **k)
        return all_reduce
    return _patched(collectives, "all_reduce", make)


def local_means():
    from das3r_tpu_torch.parallel import collectives
    return _patched(collectives, "reduce_sum",
                    lambda orig: (lambda x, group, tag="": x))


def adamw_skipped():
    from das3r_tpu_torch.predictor import training
    return _patched(training, "adamw_step",
                    lambda orig: (lambda *a, **k: None))


def half_rows():
    from das3r_tpu_torch.predictor import training

    def make(orig):
        def loss(batch, res1, res2, *a, **k):
            h = batch.gt_pts3d_1.shape[0] // 2
            return orig(type(batch)(*(x[:h] for x in batch)),
                        {n: v[:h] for n, v in res1.items()},
                        {n: v[:h] for n, v in res2.items()}, *a, **k)
        return loss
    return _patched(training, "conf_regr3d_mmask_loss", make)


def no_weight_decay():
    import dataclasses

    from das3r_tpu_torch.predictor import training

    def make(orig):
        def step(params, grads, state, lr, cfg):
            return orig(params, grads, state, lr,
                        dataclasses.replace(cfg, weight_decay=0.0))
        return step
    return _patched(training, "adamw_step", make)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "altered_image": altered_image, "altered_maps": altered_maps,
          "no_exchange": no_exchange, "local_means": local_means,
          "adamw_skipped": adamw_skipped, "half_rows": half_rows,
          "no_weight_decay": no_weight_decay}
