"""Stage-2 photometric loss (port of ``das3r_tpu/train/loss.py``):
static-confidence-weighted L1 + D-SSIM (train_gui.py:565-575) and the frame
PSNR for the camera-step gate."""
from __future__ import annotations

from typing import NamedTuple

import torch

from das3r_tpu_torch.utils import image as image_utils


class PhotometricOut(NamedTuple):
    loss: torch.Tensor        # [] mean loss
    l1_map: torch.Tensor      # [3, H, W]
    psnr_frame: torch.Tensor  # [] PSNR of the weighted images


def photometric_loss(pred: torch.Tensor, gt: torch.Tensor,
                     static: torch.Tensor,
                     lambda_dssim: float = 0.2) -> PhotometricOut:
    """pred/gt: [3, H, W]; static: [H, W] learnable staticness weighting.

    Both images are multiplied by ``static`` before the loss: this is how
    the per-pixel confidence down-weights dynamic pixels and receives its
    gradient (reference train_gui.py:565-575)."""
    p = pred * static
    g = gt * static
    l1 = image_utils.l1_loss(p, g, reduce=False)
    ssim_map = image_utils.ssim(p, g, size_average=False)
    loss = ((1.0 - lambda_dssim) * l1
            + lambda_dssim * (1.0 - ssim_map)).mean()
    psnr_frame = image_utils.psnr(p[None], g[None]).mean()
    return PhotometricOut(loss=loss, l1_map=l1, psnr_frame=psnr_frame)


def masked_test_loss(pred: torch.Tensor, gt: torch.Tensor,
                     gt_dynamic_mask: torch.Tensor):
    """Test-protocol loss and PSNR: both images masked by (1 - GT dynamic
    mask) (train_test_psnr.py:129-136, 265-275). Returns (l1, psnr)."""
    m = 1.0 - gt_dynamic_mask
    p = pred * m
    g = gt * m
    return (image_utils.l1_loss(p, g),
            image_utils.psnr(p[None], g[None]).mean())
