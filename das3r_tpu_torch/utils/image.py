"""Photometric losses and image metrics (port of
``das3r_tpu/utils/image.py``).

SSIM follows the reference (utils/loss_utils.py:26-66): 11x11 Gaussian
window, sigma 1.5, zero ('same') padding, per-channel, C1 = 0.01^2 and
C2 = 0.03^2. The window is rank one, so each of its five convolutions is
two 1-D passes of 11 shifted adds, as in the JAX package. The five are run
as one stack, and the shifted adds keep the result in full float32 whatever
the cuDNN TF32 setting. ``size_average=False`` returns the per-pixel map
that the static-confidence-weighted loss uses.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def l1_loss(pred: torch.Tensor, gt: torch.Tensor,
            reduce: bool = True) -> torch.Tensor:
    d = torch.abs(pred - gt)
    return d.mean() if reduce else d


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-image MSE over flattened pixels, [B, 1]
    (utils/image_utils.py:14-16)."""
    b = pred.shape[0]
    return ((pred - gt) ** 2).reshape(b, -1).mean(1, keepdim=True)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR, 20 log10(1 / sqrt(mse)) (utils/image_utils.py:17-19)."""
    return 20 * torch.log10(1.0 / torch.sqrt(mse(pred, gt)))


@functools.lru_cache(maxsize=8)
def _gaussian_1d(window_size: int, sigma: float) -> tuple[float, ...]:
    x = np.arange(window_size)
    g = np.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma**2))
    return tuple(float(v) for v in (g / g.sum()).astype(np.float32))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """SSIM of (C, H, W) or (N, C, H, W) images."""
    squeeze = img1.dim() == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    h, w = img1.shape[-2:]
    g1 = _gaussian_1d(window_size, 1.5)
    half = window_size // 2

    def conv(x):
        xp = torch.nn.functional.pad(x, (half, half, half, half))
        yh = sum(g1[i] * xp[..., i:i + h, :] for i in range(window_size))
        return sum(g1[j] * yh[..., j:j + w] for j in range(window_size))

    mu1, mu2, e11, e22, e12 = conv(torch.stack(
        [img1, img2, img1 * img1, img2 * img2, img1 * img2]))
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2

    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if squeeze:
        ssim_map = ssim_map[0]
    return ssim_map.mean() if size_average else ssim_map
