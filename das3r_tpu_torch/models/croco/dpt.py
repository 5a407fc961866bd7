"""DPT dense-prediction head (port of ``das3r_tpu/models/croco/dpt.py``;
croco's ``DPTOutputAdapter`` and the reference's dust3r/heads/
dpt_head.py:130-186).

Four decoder layers (hooks [0, 2/3·L, 3/4·L, L]) are projected to pyramid
resolutions (H/4, H/8, H/16, H/32), fused RefineNet-style back up to H/2,
then a task head (regression: 3D points + conf; semseg: dynamic-mask
logits) emits full-resolution maps. Everything runs NCHW, with the
reference's module tree and names (``dpt.act_postprocess.0.1`` is the
``ConvTranspose2d`` that the JAX package writes as a matmul and a pixel
shuffle); the public API returns [B, H, W, C] as the JAX heads do.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def resize_bilinear_ac(x: torch.Tensor, out_h: int,
                       out_w: int) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] with align_corners=True."""
    if x.shape[-2:] == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def conv(cin: int, cout: int, kernel: int, stride: int = 1,
         bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                     bias=bias)


def PixelShuffleUp(cin: int, cout: int, factor: int) -> nn.ConvTranspose2d:
    """The reference's ConvTranspose2d(k = stride = factor), which the JAX
    package computes as a Dense and a pixel shuffle."""
    return nn.ConvTranspose2d(cin, cout, factor, stride=factor)


class UntiedConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d(k = stride) with one bias per output channel and
    kernel tap, ``bias`` [C_out, k, k]: the JAX package's Dense of
    C_out·k·k outputs, whose bias entries train apart (its converter
    repeats the reference's [C_out] bias k·k times)."""

    def forward(self, x):
        y = F.conv_transpose2d(x, self.weight, None, self.stride)
        B, C, H, W = y.shape
        k = self.stride[0]
        y = (y.view(B, C, H // k, k, W // k, k)
             + self.bias[:, None, :, None, :])
        return y.view(B, C, H, W)


def untie_upsample_bias(model: nn.Module) -> None:
    """Replace every ``PixelShuffleUp`` of ``model`` by an
    ``UntiedConvTranspose2d`` holding the same function (its bias copied
    to every tap), in place; the one already untied stay as they are.
    Stage-1 training does this first, so that the port trains JAX's
    parameters (``predictor/training.py``)."""
    for name, m in list(model.named_modules()):
        if type(m) is not nn.ConvTranspose2d:
            continue
        k = m.stride[0]
        new = UntiedConvTranspose2d(m.in_channels, m.out_channels, k,
                                    stride=k, device=m.weight.device,
                                    dtype=m.weight.dtype)
        with torch.no_grad():
            new.weight.copy_(m.weight)
            new.bias = nn.Parameter(
                m.bias.detach()[:, None, None].repeat(1, k, k))
        parent, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent), child, new)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = conv(features, features, 3)
        self.conv2 = conv(features, features, 3)

    def forward(self, x):
        out = self.conv1(F.relu(x))
        return self.conv2(F.relu(out)) + x


class FeatureFusionBlock(nn.Module):
    """croco FeatureFusionBlock_custom (deconv=False, bn=False,
    expand=False, align_corners=True). ``skip=False`` leaves out
    ``resConfUnit1``: refinenet4 takes no skip input, so its unit is dead
    weight in the checkpoint (the JAX converter drops it too)."""

    def __init__(self, features: int, skip: bool = True):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        out = x
        if skip is not None:
            out = out + self.resConfUnit1(skip)
        out = self.resConfUnit2(out)
        H, W = out.shape[-2:]
        return self.out_conv(resize_bilinear_ac(out, 2 * H, 2 * W))


class _Scratch(nn.Module):
    def __init__(self, layer_dims, feature_dim):
        super().__init__()
        self.layer_rn = nn.ModuleList(
            conv(d, feature_dim, 3, bias=False) for d in layer_dims)
        self.refinenet1 = FeatureFusionBlock(feature_dim)
        self.refinenet2 = FeatureFusionBlock(feature_dim)
        self.refinenet3 = FeatureFusionBlock(feature_dim)
        self.refinenet4 = FeatureFusionBlock(feature_dim, skip=False)


class DPTAdapter(nn.Module):
    """The reference's ``dpt`` submodule: act_postprocess, scratch, head."""

    def __init__(self, num_channels: int, head_type: str,
                 hooks: Sequence[int], dims: Sequence[int],
                 layer_dims: Sequence[int] = (96, 192, 384, 768),
                 feature_dim: int = 256, last_dim: int = 128,
                 patch_size: int = 16):
        super().__init__()
        self.hooks = tuple(hooks)
        self.head_type = head_type
        self.patch_size = patch_size
        ld = layer_dims
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(dims[0], ld[0], 1),
                          PixelShuffleUp(ld[0], ld[0], 4)),
            nn.Sequential(nn.Conv2d(dims[1], ld[1], 1),
                          PixelShuffleUp(ld[1], ld[1], 2)),
            nn.Sequential(nn.Conv2d(dims[2], ld[2], 1)),
            nn.Sequential(nn.Conv2d(dims[3], ld[3], 1),
                          conv(ld[3], ld[3], 3, stride=2)),
        ])
        self.scratch = _Scratch(ld, feature_dim)
        # the reference's Sequential indices, so that its keys load; the
        # resizes, activations and placeholders (nn.Identity) are applied
        # in forward
        if head_type == "regression":
            # Conv, Interpolate, Conv, ReLU, Conv
            self.head = nn.Sequential(
                conv(feature_dim, feature_dim // 2, 3), nn.Identity(),
                conv(feature_dim // 2, last_dim, 3), nn.ReLU(),
                nn.Conv2d(last_dim, num_channels, 1))
        elif head_type == "semseg":
            # Conv (no bias), BatchNorm off, ReLU, Dropout (inference:
            # identity), Conv, Interpolate
            self.head = nn.Sequential(
                conv(feature_dim, feature_dim, 3, bias=False), nn.Identity(),
                nn.ReLU(), nn.Identity(),
                nn.Conv2d(feature_dim, num_channels, 1))
        else:
            raise ValueError(head_type)

    def forward(self, token_list, img_h: int, img_w: int) -> torch.Tensor:
        p = self.patch_size
        nh, nw = img_h // p, img_w // p
        layers = []
        for h, act in zip(self.hooks, self.act_postprocess):
            t = token_list[h].to(torch.float32)
            t = t.transpose(1, 2).reshape(t.shape[0], t.shape[-1], nh, nw)
            layers.append(act(t))
        s = self.scratch
        rn = [conv_rn(x) for conv_rn, x in zip(s.layer_rn, layers)]
        path4 = s.refinenet4(rn[3])
        path4 = path4[:, :, : rn[2].shape[2], : rn[2].shape[3]]
        path3 = s.refinenet3(path4, rn[2])
        path2 = s.refinenet2(path3, rn[1])
        path1 = s.refinenet1(path2, rn[0])

        hd = self.head
        if self.head_type == "regression":
            out = resize_bilinear_ac(hd[0](path1), img_h, img_w)
            out = hd[4](F.relu(hd[2](out)))
        else:
            out = hd[4](F.relu(hd[0](path1)))
            out = resize_bilinear_ac(out, img_h, img_w)
        return out.permute(0, 2, 3, 1)                    # [B, H, W, C]


class DPTHead(nn.Module):
    """A DPT head over the 13-entry token list [enc, dec1..dec12]; dims are
    [enc_dim, dec_dim, dec_dim, dec_dim] (dpt_head.py:300-336)."""

    def __init__(self, num_channels: int, head_type: str,
                 hooks: Sequence[int], dims: Sequence[int],
                 patch_size: int = 16):
        super().__init__()
        self.dpt = DPTAdapter(num_channels, head_type, hooks, dims,
                              patch_size=patch_size)

    def forward(self, token_list, img_h: int, img_w: int) -> torch.Tensor:
        return self.dpt(token_list, img_h, img_w)


class LinearHead(nn.Module):
    """LinearPts3d (reference heads/linear_head.py:12-41): one Linear from
    the last decoder token to out_ch * p^2 channels, pixel-shuffled back
    to full resolution; interchangeable with ``DPTHead``."""

    def __init__(self, dim: int, out_ch: int, patch_size: int = 16):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Linear(dim, out_ch * patch_size ** 2)

    def forward(self, token_list, img_h: int, img_w: int) -> torch.Tensor:
        tokens = token_list[-1].to(torch.float32)        # [B, S, D]
        B, S, _ = tokens.shape
        p = self.patch_size
        hp, wp = img_h // p, img_w // p
        if hp * wp != S:
            raise ValueError(f"{S} tokens for a {img_h}x{img_w} image")
        feat = self.proj(tokens).transpose(1, 2).reshape(B, -1, hp, wp)
        return F.pixel_shuffle(feat, p).permute(0, 2, 3, 1)
