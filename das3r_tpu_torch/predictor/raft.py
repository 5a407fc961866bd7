"""RAFT optical flow, the classic "large" configuration (port of
``das3r_tpu/predictor/raft.py``; the reference vendors it as
dynamic_predictor/third_party/RAFT/core/{raft,extractor,update,corr}.py and
loads it frozen for the alignment's flow term, optimizer.py:117-151, 20
iterations).

The modules carry the reference's names, so ``load_state_dict`` takes the
reference checkpoint's state dict as it is (``load_reference_weights``):
BasicEncoder feature and context nets (instance and batch norm), the
4-level all-pairs correlation pyramid with radius 4, BasicUpdateBlock
(motion encoder, SepConvGRU, flow head) iterated, and convex 8x
upsampling. The net is always frozen: batch norm runs in eval mode.

Layout: images and features are NCHW, as in the reference; the
correlation lookup and the upsampling keep the JAX package's order of
channels (the pretrained weights fix it). The all-pairs correlation is one
batched matrix product (``torch.bmm``), as JAX leaves it to XLA; its
lookup is ``warping.bilinear_sample``, the JAX package's bilinear sampler
with zero padding.

On the card the networks' convolutions run without cuDNN
(``without_cudnn``): in IEEE float32 (TF32 off, as every entry point sets
it) cuDNN's algorithms for them (FFT-tiled ones, in a profile) are slow.
PyTorch's own convolution (im2col and a float32 cuBLAS GEMM) ran RAFT's
20 iterations of 12 pairs at 288x512 in 406 and 409 ms against cuDNN's
4199 and 4340 ms, timed in turns, the flows within 1.5e-5 of each other
(NVIDIA H100 80GB HBM3, 700 W; ``chip_smoke.py`` phase ``stage1``,
``flows.raft.cudnn_turns``).
SEA-RAFT, whose convolutions are of the same kinds, skips cuDNN too; it
is not timed both ways.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from das3r_tpu_torch.predictor.warping import bilinear_sample


def without_cudnn():
    """A context in which convolutions skip cuDNN (module docstring); the
    other cuDNN settings stay as they are."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=False, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic,
                       allow_tf32=cudnn.allow_tf32)


def conv(cin: int, cout: int, k, stride: int = 1, pad=None) -> nn.Conv2d:
    """A biased conv with 'same' padding for odd kernels."""
    k = (k, k) if isinstance(k, int) else k
    pad = tuple(x // 2 for x in k) if pad is None else pad
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad)


def make_norm(norm_fn: str, planes: int) -> nn.Module:
    if norm_fn == "instance":
        return nn.InstanceNorm2d(planes)        # eps 1e-5, no affine
    if norm_fn == "batch":
        return nn.BatchNorm2d(planes)           # eval: running stats
    return nn.Identity()


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = conv(in_planes, planes, 3, stride)
        self.conv2 = conv(planes, planes, 3)
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            # registered twice, as in the reference: norm3 and downsample.1
            self.norm3 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim: int = 256, norm_fn: str = "instance"):
        super().__init__()
        self.norm1 = make_norm(norm_fn, 64)
        self.conv1 = conv(3, 64, 7, 2)
        planes = [64]

        def layer(dim, stride):
            blocks = nn.Sequential(
                ResidualBlock(planes[0], dim, norm_fn, stride),
                ResidualBlock(dim, dim, norm_fn, 1))
            planes[0] = dim
            return blocks

        self.layer1 = layer(64, 1)
        self.layer2 = layer(96, 2)
        self.layer3 = layer(128, 2)
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int = 4 * 9 * 9):
        super().__init__()
        self.convc1 = conv(corr_channels, 256, 1)
        self.convc2 = conv(256, 192, 3)
        self.convf1 = conv(2, 128, 7)
        self.convf2 = conv(128, 64, 3)
        self.conv = conv(64 + 192, 128 - 2, 3)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], 1)))
        return torch.cat([out, flow], 1)                  # 128 channels


class SepConvGRU(nn.Module):
    def __init__(self, hidden: int = 128, input_dim: int = 256):
        super().__init__()
        c = hidden + input_dim
        for i, (k, pad) in enumerate((((1, 5), (0, 2)), ((5, 1), (2, 0))),
                                     1):
            for g in ("z", "r", "q"):
                setattr(self, f"conv{g}{i}", conv(c, hidden, k, pad=pad))

    def forward(self, h, x):
        for i in (1, 2):
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz{i}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{i}")(hx))
            q = torch.tanh(getattr(self, f"convq{i}")(
                torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden: int = 256):
        super().__init__()
        self.conv1 = conv(input_dim, hidden, 3)
        self.conv2 = conv(hidden, 2, 3)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, hidden: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(hidden, 128 + hidden)
        self.flow_head = FlowHead(hidden, 256)
        self.mask = nn.Sequential(conv(128, 256, 3), nn.ReLU(inplace=True),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        m = self.encoder(flow, corr)
        # (inp, motion): the pretrained GRU's channel order (update.py:148)
        net = self.gru(net, torch.cat([inp, m], 1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


def lookup_offsets(radius: int, device) -> torch.Tensor:
    """[d, d, 2] offsets added to (x, y) pixel coordinates: the reference's
    meshgrid(dy, dx) stacked as it is, so the x offset varies along the
    FIRST axis (corr.py:38-44); the pretrained weights fix this channel
    order."""
    r = torch.arange(-radius, radius + 1.0, device=device)
    d1, d2 = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([d1, d2], -1)


def pyramid_lookup(pyramid, coords, radius: int) -> torch.Tensor:
    """coords [B, H, W, 2] (x, y) at level 0 -> [B, L * (2r+1)^2, H, W]:
    each level [B*H*W, 1, h, w] sampled bilinearly (zero outside) on the
    (2r+1)^2 window around coords / 2^level."""
    B, H, W, _ = coords.shape
    d = 2 * radius + 1
    delta = lookup_offsets(radius, coords.device)[None]
    flat = coords.reshape(B * H * W, 1, 1, 2)
    out = [bilinear_sample(corr, flat / (2 ** lvl) + delta)
           .reshape(B, H, W, d * d) for lvl, corr in enumerate(pyramid)]
    return torch.cat(out, -1).permute(0, 3, 1, 2)


def all_pairs_corr(fmap1, fmap2) -> torch.Tensor:
    """[B, D, H, W] x [B, D, h, w] -> [B*H*W, 1, h, w] correlation /
    sqrt(D)."""
    B, D, H, W = fmap1.shape
    h, w = fmap2.shape[2:]
    corr = torch.bmm(fmap1.reshape(B, D, H * W).transpose(1, 2),
                     fmap2.reshape(B, D, h * w)) / math.sqrt(D)
    return corr.reshape(B * H * W, 1, h, w)


class CorrPyramid:
    """All-pairs correlation and its 4-level pyramid (2x2 average pools)
    with the radius-4 lookup (``CorrPyramid`` of the JAX package)."""

    def __init__(self, fmap1, fmap2, num_levels: int = 4, radius: int = 4):
        self.radius = radius
        corr = all_pairs_corr(fmap1, fmap2)
        self.pyramid = [corr]
        for _ in range(num_levels - 1):
            corr = F.avg_pool2d(corr, 2, stride=2)
            self.pyramid.append(corr)

    def __call__(self, coords):
        return pyramid_lookup(self.pyramid, coords, self.radius)


def coords_grid(B: int, h: int, w: int, device) -> torch.Tensor:
    """[B, h, w, 2] pixel coordinates (x, y)."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    return torch.stack([xx, yy], -1).expand(B, h, w, 2)


def upsample_flow(flow, mask) -> torch.Tensor:
    """Convex 8x upsampling (raft.py upsample_flow): each fine pixel is a
    softmax-weighted combination of its coarse 3x3 neighbourhood. flow
    [B, h, w, 2], mask [B, 576, h, w] (channel k * 64 + p * 8 + q, k the
    neighbour, (p, q) the fine pixel) -> [B, 2, 8h, 8w]."""
    B, h, w, _ = flow.shape
    m = torch.softmax(mask.permute(0, 2, 3, 1).reshape(B, h, w, 9, 8, 8), 3)
    pad = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([pad[:, di:di + h, dj:dj + w]
                         for di in range(3) for dj in range(3)], 3)
    up = torch.einsum("bhwkpq,bhwkc->bhwpqc", m, neigh)
    return up.permute(0, 5, 1, 3, 2, 4).reshape(B, 2, 8 * h, 8 * w)


def normalize_images(image) -> torch.Tensor:
    """[0, 255] -> [-1, 1]."""
    return 2.0 * (image / 255.0) - 1.0


@dataclasses.dataclass(frozen=True)
class RaftConfig:
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4


class RAFT(nn.Module):
    def __init__(self, cfg: RaftConfig = RaftConfig()):
        super().__init__()
        self.cfg = cfg
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch")
        self.update_block = BasicUpdateBlock(cfg.hidden_dim)
        self.eval()

    @torch.no_grad()
    def forward(self, image1, image2, iters: int = 20):
        """images [B, 3, H, W] in [0, 255], H and W multiples of 8 ->
        the final flow [B, 2, H, W] (the reference's test_mode output)."""
        with without_cudnn():
            return self._flow(image1, image2, iters)

    def _flow(self, image1, image2, iters: int):
        cfg = self.cfg
        B, _, H, W = image1.shape
        x1, x2 = normalize_images(image1), normalize_images(image2)
        fmap = self.fnet(torch.cat([x1, x2]))
        corr_fn = CorrPyramid(fmap[:B], fmap[B:], cfg.corr_levels,
                              cfg.corr_radius)
        c = self.cnet(x1)
        net = torch.tanh(c[:, :cfg.hidden_dim])
        inp = F.relu(c[:, cfg.hidden_dim:])
        coords0 = coords_grid(B, H // 8, W // 8, image1.device)
        coords1 = coords0
        up_mask = None
        for _ in range(iters):
            corr = corr_fn(coords1)
            flow = (coords1 - coords0).permute(0, 3, 1, 2)
            net, up_mask, delta = self.update_block(net, inp, corr, flow)
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
        return upsample_flow(coords1 - coords0, up_mask)


def load_reference_weights(model: nn.Module, state: dict) -> None:
    """Load a reference checkpoint's state dict (``module.`` prefixes
    dropped): every key of ``model`` must be there with its shape; keys
    the model does not have are ignored."""
    state = {k.replace("module.", ""): torch.as_tensor(np.asarray(v))
             for k, v in state.items()}
    own = model.state_dict()
    missing = [k for k in own if k not in state]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. "
                       f"{missing[:3]}")
    model.load_state_dict({k: state[k] for k in own}, strict=True)


def random_state_dict(model: nn.Module, seed: int) -> dict:
    """Seeded random weights for every key of ``model``'s state dict, as
    numpy (the weights of the tests and of chip_smoke.py, since no
    checkpoint is in the repository): convolution and linear weights
    N(0, 1/fan_in), biases N(0, 0.01), batch-norm scales U(0.8, 1.2),
    shifts and means N(0, 0.1), variances U(0.5, 1.5), the counters 0; a
    module registered under two names gets one value."""
    rng = np.random.default_rng(seed)
    out, seen = {}, {}
    for k, v in model.state_dict().items():
        if v.data_ptr() in seen:        # a module registered twice
            out[k] = out[seen[v.data_ptr()]]
            continue
        seen[v.data_ptr()] = k
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            out[k] = np.zeros(shape, np.int64)
        elif k.endswith("running_var"):
            out[k] = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("running_mean"):
            out[k] = rng.normal(0, 0.1, shape)
        elif v.dim() >= 2:
            fan_in = int(np.prod(shape[1:]))
            out[k] = rng.normal(0, 1 / np.sqrt(fan_in), shape)
        elif k.endswith("gamma"):
            out[k] = rng.uniform(0.5, 1.0, shape)
        elif k.endswith("weight"):
            out[k] = rng.uniform(0.8, 1.2, shape)
        else:
            out[k] = rng.normal(0, 0.1 if "norm" in k or "bn" in k else 0.01,
                                shape)
        out[k] = out[k].astype(np.int64 if k.endswith("num_batches_tracked")
                               else np.float32)
    return out
