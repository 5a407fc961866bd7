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
  zeroed where they are produced.

The cells run on one chip, so no fault leaves an exchange between chips
out.
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


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "altered_image": altered_image, "altered_maps": altered_maps}
