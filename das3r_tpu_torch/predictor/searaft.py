"""SEA-RAFT, its "M" configuration (port of ``das3r_tpu/predictor/
searaft.py``; the reference's default flow network for the alignment's
flow term: third_party/RAFT/core/raft.py RAFT2 with extractor.ResNetFPN,
update.BasicUpdateBlock2 and corr.CorrBlock2, loaded from
Tartan-C-T-TSKH-spring540x960-M.pth, cloud_opt/optimizer.py:123).

ResNet34-style 1/8 encoders (initial 64, dims 64/128/256), dim 128, a
correlation pyramid that correlates fmap1 against fmap2 resized to half
its size per level (radius 4, 4 levels), refinement by two ConvNeXt
blocks per iteration, a 6-channel flow head and convex 8x upsampling. The
modules carry the reference's names (``raft.load_reference_weights``
loads its checkpoint). The level resize is the JAX package's:
``jax.image.resize(..., "bilinear")``, which antialiases a downsample (a
triangle kernel widened by the scale, weights renormalised at the
borders), written out as its two weight matrices (``resize_weights``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from das3r_tpu_torch.predictor.raft import (all_pairs_corr, conv,
                                            coords_grid, normalize_images,
                                            pyramid_lookup, upsample_flow,
                                            without_cudnn)


@dataclasses.dataclass(frozen=True)
class SeaRaftConfig:
    dim: int = 128
    initial_dim: int = 64
    block_dims: tuple = (64, 128, 256)
    n_blocks: tuple = (3, 4, 6)          # resnet34
    radius: int = 4
    corr_levels: int = 4
    num_refine: int = 2                   # ConvNeXt blocks per iteration
    iters: int = 4


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(in_planes, planes, 3, stride)
        self.conv2 = conv(planes, planes, 3)
        self.bn1 = nn.BatchNorm2d(planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            # registered twice, as in the reference: bn3 and downsample.1
            self.bn3 = nn.BatchNorm2d(planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.bn3)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class ResNetFPN(nn.Module):
    def __init__(self, cfg: SeaRaftConfig, input_dim: int, output_dim: int):
        super().__init__()
        self.conv1 = conv(input_dim, cfg.initial_dim, 7, 2)
        self.bn1 = nn.BatchNorm2d(cfg.initial_dim)
        in_planes = cfg.initial_dim
        for li, (dim, stride, num) in enumerate(zip(
                cfg.block_dims, (1, 2, 2), cfg.n_blocks)):
            blocks = []
            for bi in range(num):
                blocks.append(BasicBlock(in_planes, dim,
                                         stride if bi == 0 else 1))
                in_planes = dim
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.final_conv = nn.Conv2d(in_planes, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.final_conv(x)


class ConvNextBlock(nn.Module):
    def __init__(self, dim: int, output_dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * output_dim)
        self.pwconv2 = nn.Linear(4 * output_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))
        self.final = nn.Conv2d(dim, output_dim, 1)

    def forward(self, x):
        y = self.dwconv(x).permute(0, 2, 3, 1)
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(y))))
        return self.final(x + (self.gamma * y).permute(0, 3, 1, 2))


class MotionEncoder2(nn.Module):
    def __init__(self, dim: int = 128, corr_channels: int = 4 * 81):
        super().__init__()
        d = dim
        self.convc1 = conv(corr_channels, 2 * d, 1)
        self.convc2 = conv(2 * d, d + d // 2, 3)
        self.convf1 = conv(2, d, 7)
        self.convf2 = conv(d, d // 2, 3)
        self.conv = conv(d + d // 2 + d // 2, d - 2, 3)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], 1)))
        return torch.cat([out, flow], 1)


class UpdateBlock(nn.Module):
    """The reference's update_block: the motion encoder and the ConvNeXt
    refinement (the heads live on the model, as in RAFT2)."""

    def __init__(self, cfg: SeaRaftConfig):
        super().__init__()
        self.encoder = MotionEncoder2(cfg.dim)
        self.refine = nn.ModuleList(
            [ConvNextBlock(3 * cfg.dim, cfg.dim)
             for _ in range(cfg.num_refine)])


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32 weights of ``jax.image.resize``'s bilinear
    (triangle) kernel along one axis, antialiased when it downsamples
    (``jax._src.image.scale.compute_weight_mat`` with translation 0)."""
    scale = np.float32(n_out / n_in)
    inv = np.float32(1.0) / scale
    kscale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]
               ) / kscale
    w = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def half_size(f: torch.Tensor) -> torch.Tensor:
    """[B, D, h, w] -> [B, D, h // 2, w // 2] (``jax.image.resize``,
    bilinear)."""
    h, w = f.shape[2:]
    wh = torch.as_tensor(resize_weights(h, h // 2), device=f.device)
    ww = torch.as_tensor(resize_weights(w, w // 2), device=f.device)
    return torch.einsum("bdhw,hH,wW->bdHW", f, wh, ww)


class SeaRaftCorr:
    """CorrBlock2: level i correlates fmap1 at full size against fmap2
    resized to half its size i times."""

    def __init__(self, fmap1, fmap2, cfg: SeaRaftConfig):
        self.radius = cfg.radius
        self.pyramid = [all_pairs_corr(fmap1, fmap2)]
        f2 = fmap2
        for _ in range(cfg.corr_levels - 1):
            f2 = half_size(f2)
            self.pyramid.append(all_pairs_corr(fmap1, f2))

    def __call__(self, coords):
        return pyramid_lookup(self.pyramid, coords, self.radius)


class SeaRaft(nn.Module):
    def __init__(self, cfg: SeaRaftConfig = SeaRaftConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.cnet = ResNetFPN(cfg, 6, 2 * d)
        self.fnet = ResNetFPN(cfg, 3, 2 * d)
        self.init_conv = conv(2 * d, 2 * d, 3)
        self.update_block = UpdateBlock(cfg)
        self.flow_head = nn.Sequential(conv(d, 2 * d, 3),
                                       nn.ReLU(inplace=True),
                                       conv(2 * d, 6, 3))
        self.upsample_weight = nn.Sequential(conv(d, 2 * d, 3),
                                             nn.ReLU(inplace=True),
                                             nn.Conv2d(2 * d, 64 * 9, 1))
        self.eval()

    def _heads(self, net):
        return self.flow_head(net), 0.25 * self.upsample_weight(net)

    @torch.no_grad()
    def forward(self, image1, image2, iters: int | None = None):
        """images [B, 3, H, W] in [0, 255] -> the final flow [B, 2, H, W]
        (convolutions without cuDNN, as RAFT's)."""
        with without_cudnn():
            return self._flow(image1, image2, iters)

    def _flow(self, image1, image2, iters: int | None):
        cfg = self.cfg
        iters = cfg.iters if iters is None else iters
        B, _, H, W = image1.shape
        x1, x2 = normalize_images(image1), normalize_images(image2)
        cfeat = self.init_conv(self.cnet(torch.cat([x1, x2], 1)))
        net, context = cfeat[:, :cfg.dim], cfeat[:, cfg.dim:]
        flow_info, mask = self._heads(net)
        flow = flow_info[:, :2]
        fmap = self.fnet(torch.cat([x1, x2]))
        corr_fn = SeaRaftCorr(fmap[:B], fmap[B:], cfg)
        grid = coords_grid(B, H // 8, W // 8, image1.device)
        ub = self.update_block
        for _ in range(iters):
            corr = corr_fn(grid + flow.permute(0, 2, 3, 1))
            inp = torch.cat([context, ub.encoder(flow, corr)], 1)
            for blk in ub.refine:
                net = blk(torch.cat([net, inp], 1))
            flow_info, mask = self._heads(net)
            flow = flow + flow_info[:, :2]
        return upsample_flow(flow.permute(0, 2, 3, 1), mask)
