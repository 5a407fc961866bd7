"""A frozen copy of the port's stage-1 predictor (das3r_tpu_torch/
models/croco/{rope,blocks,dpt,dust3r}.py as of the benchmark's first
PR), in one file that imports nothing of the program: the plain
reference the benchmark holds the port's pair inference to. Attention
is matmul-softmax-matmul with float32 scores, as in DUSt3R's croco
blocks; every layer keeps the reference checkpoint's module names.

Copied verbatim but for the imports; the program may change its own
files, never these.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn



# --- rope.py -----------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _inv_freq(half_dim: int, base: float) -> np.ndarray:
    """Computed in float64, then cast to float32, as in the JAX package."""
    return np.asarray(
        1.0 / (base ** (np.arange(0, half_dim, 2, dtype=np.float64)
                        / half_dim)), np.float32)


@functools.lru_cache(maxsize=16)
def _inv_freq_on(half_dim: int, base: float,
                 device: torch.device) -> torch.Tensor:
    """``_inv_freq`` on ``device``, copied there once: a copy from host
    memory waits for the device, and every attention layer asks."""
    return torch.as_tensor(_inv_freq(half_dim, base), device=device)


def _rope_1d(tokens: torch.Tensor, pos: torch.Tensor,
             base: float) -> torch.Tensor:
    """tokens [..., N, D], pos [..., N] int -> rotated tokens."""
    D = tokens.shape[-1]
    inv = _inv_freq_on(D, base, tokens.device)
    ang = pos[..., None].to(torch.float32) * inv          # [..., N, D//2]
    ang = torch.cat([ang, ang], -1)                       # [..., N, D]
    x1, x2 = tokens.chunk(2, -1)
    rotated = torch.cat([-x2, x1], -1)
    return tokens * torch.cos(ang) + rotated * torch.sin(ang)


def rope_2d(tokens: torch.Tensor, positions: torch.Tensor,
            base: float = 100.0) -> torch.Tensor:
    """tokens [B, heads, N, D], positions [B, N, 2] (y, x) int. The result
    is float32 (the angles are), as in the JAX package."""
    y_tok, x_tok = tokens.chunk(2, -1)
    return torch.cat([
        _rope_1d(y_tok, positions[:, None, :, 0], base),
        _rope_1d(x_tok, positions[:, None, :, 1], base),
    ], -1)


# --- blocks.py ---------------------------------------------------------

def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    return norm(x.to(torch.float32)).to(dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


def _attend(q, k, v, scale):
    attn = torch.matmul(q.to(torch.float32),
                        k.to(torch.float32).transpose(-1, -2)) * scale
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


class Attention(nn.Module):
    """Self-attention with 2D RoPE on q and k (croco blocks.Attention)."""

    def __init__(self, dim: int, num_heads: int, rope_base: float = 100.0,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.qkv = nn.Linear(dim, 3 * dim, dtype=dtype)
        self.proj = nn.Linear(dim, dim, dtype=dtype)

    def forward(self, x, pos):
        B, N, C = x.shape
        H = self.num_heads
        d = C // H
        qkv = self.qkv(x).reshape(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                  # [B, H, N, d]
        q = rope_2d(q, pos, self.rope_base).to(v.dtype)
        k = rope_2d(k, pos, self.rope_base).to(v.dtype)
        out = _attend(q, k, v, d ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class CrossAttention(nn.Module):
    """Queries from x (xpos), keys and values from y (ypos)."""

    def __init__(self, dim: int, num_heads: int, rope_base: float = 100.0,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.projq = nn.Linear(dim, dim, dtype=dtype)
        self.projk = nn.Linear(dim, dim, dtype=dtype)
        self.projv = nn.Linear(dim, dim, dtype=dtype)
        self.proj = nn.Linear(dim, dim, dtype=dtype)

    def forward(self, x, key, value, xpos, ypos):
        B, Nq, C = x.shape
        H = self.num_heads
        d = C // H

        def split(t):
            return t.reshape(B, t.shape[1], H, d).transpose(1, 2)

        q = split(self.projq(x))
        k = split(self.projk(key))
        v = split(self.projv(value))
        q = rope_2d(q, xpos, self.rope_base).to(v.dtype)
        k = rope_2d(k, ypos, self.rope_base).to(v.dtype)
        out = _attend(q, k, v, d ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(B, Nq, C))


class Block(nn.Module):
    """Pre-norm encoder block (croco blocks.Block)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 rope_base: float = 100.0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, rope_base, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x, pos):
        x = x + self.attn(_layer_norm(self.norm1, x, self.dtype), pos)
        return x + self.mlp(_layer_norm(self.norm2, x, self.dtype))


class DecoderBlock(nn.Module):
    """Self-attention, cross-attention to the other view and MLP (croco
    blocks.DecoderBlock with norm_mem=True: the memory y is LayerNorm-ed
    by ``norm_y`` before it is attended)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 rope_base: float = 100.0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, rope_base, dtype)
        self.cross_attn = CrossAttention(dim, num_heads, rope_base, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.norm_y = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x, y, xpos, ypos):
        dt = self.dtype
        x = x + self.attn(_layer_norm(self.norm1, x, dt), xpos)
        y_ = _layer_norm(self.norm_y, y, dt)
        x = x + self.cross_attn(_layer_norm(self.norm2, x, dt), y_, y_,
                                xpos, ypos)
        x = x + self.mlp(_layer_norm(self.norm3, x, dt))
        return x, y


class PatchEmbed(nn.Module):
    """16x16 patchify, the reference's stride-16 ``Conv2d``.

    Input [B, 3, H, W]; returns tokens [B, N, D] and integer (y, x)
    positions [B, N, 2] in row-major patch order.
    """

    def __init__(self, patch_size: int = 16, embed_dim: int = 1024,
                 dtype=torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size,
                              dtype=dtype)

    def forward(self, img):
        B, _, H, W = img.shape
        p = self.patch_size
        if H % p or W % p:
            raise ValueError(f"image {H}x{W} is not a multiple of {p}")
        nh, nw = H // p, W // p
        x = self.proj(img.to(self.proj.weight.dtype))     # [B, D, nh, nw]
        x = x.flatten(2).transpose(1, 2)
        yy, xx = torch.meshgrid(torch.arange(nh, device=img.device),
                                torch.arange(nw, device=img.device),
                                indexing="ij")
        pos = torch.stack([yy, xx], -1).reshape(1, nh * nw, 2)
        return x, pos.expand(B, nh * nw, 2)


# --- dpt.py ------------------------------------------------------------

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


# --- dust3r.py ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Dust3rConfig:
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: float = 4.0
    rope_base: float = 100.0
    conf_vmin: float = 1.0
    head_type: str = "dpt"         # 'dpt' (DAS3R/MonST3R checkpoints) or
                                   # 'linear' (dust3r 224-linear family)
    dtype: torch.dtype = torch.float32   # encoder/decoder compute type
                                         # (torch.bfloat16: the runner's
                                         # --bf16); heads stay float32


DUST3R_LARGE_CONFIG = Dust3rConfig()


def reg_dense_depth_exp(xyz: torch.Tensor) -> torch.Tensor:
    """'exp' pointmap activation: direction * expm1(|xyz|)
    (reference heads/postprocess.py:31-55)."""
    d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    return xyz / torch.clamp_min(d, 1e-8) * torch.expm1(d)


def reg_dense_conf_exp(x: torch.Tensor, vmin: float = 1.0) -> torch.Tensor:
    """'exp' confidence: vmin + exp(x) (postprocess.py:58-67)."""
    return vmin + torch.exp(x)


def transposed_result(res: dict) -> dict:
    """Swap the two spatial axes of every output map (the reference's
    ``transposed``, misc.py:59-67): portrait predictions back into
    landscape buffers."""
    return {k: v.transpose(1, 2) for k, v in res.items()}


class AsymmetricCroCo3D(nn.Module):
    def __init__(self, cfg: Dust3rConfig = DUST3R_LARGE_CONFIG):
        super().__init__()
        self.cfg = c = cfg
        dt = c.dtype
        self.patch_embed = PatchEmbed(c.patch_size, c.enc_embed_dim, dt)
        self.enc_blocks = nn.ModuleList(
            Block(c.enc_embed_dim, c.enc_num_heads, c.mlp_ratio, c.rope_base,
                  dt) for _ in range(c.enc_depth))
        self.enc_norm = nn.LayerNorm(c.enc_embed_dim, eps=1e-6)
        self.decoder_embed = nn.Linear(c.enc_embed_dim, c.dec_embed_dim)
        self.dec_blocks = nn.ModuleList(
            DecoderBlock(c.dec_embed_dim, c.dec_num_heads, c.mlp_ratio,
                         c.rope_base, dt) for _ in range(c.dec_depth))
        self.dec_blocks2 = nn.ModuleList(
            DecoderBlock(c.dec_embed_dim, c.dec_num_heads, c.mlp_ratio,
                         c.rope_base, dt) for _ in range(c.dec_depth))
        self.dec_norm = nn.LayerNorm(c.dec_embed_dim, eps=1e-6)
        hooks = (0, c.dec_depth * 2 // 4, c.dec_depth * 3 // 4, c.dec_depth)
        dims = (c.enc_embed_dim,) + (c.dec_embed_dim,) * 3
        if c.head_type == "linear":
            def mk(ch, mode):
                return LinearHead(c.dec_embed_dim, ch, c.patch_size)
        elif c.head_type == "dpt":
            def mk(ch, mode):
                return DPTHead(ch, mode, hooks, dims, c.patch_size)
        else:
            raise ValueError(f"unknown head_type {c.head_type!r}; "
                             "expected 'dpt' or 'linear'")
        self.downstream_head1 = mk(4, "regression")
        self.downstream_head2 = mk(4, "regression")
        self.downstream_head_dynamic_mask1 = mk(1, "semseg")
        self.downstream_head_dynamic_mask2 = mk(1, "semseg")

    def encode(self, img: torch.Tensor, portrait: bool = False):
        """[B, 3, H, W] (ImgNorm'ed) -> (tokens [B, N, D_enc] float32,
        pos [B, N, 2]).

        ``portrait``: the buffer holds a portrait image stored TRANSPOSED
        in a landscape [B, 3, H, W] buffer (the reference's ManyAR
        ``true_shape`` handling, patch_embed.py:33-70); it is transposed
        back before patchifying, so the patches and the RoPE positions see
        the true orientation.
        """
        if portrait:
            img = img.transpose(-1, -2)
        x, pos = self.patch_embed(img)
        for blk in self.enc_blocks:
            x = blk(x, pos)
        return self.enc_norm(x.to(torch.float32)), pos

    def _decode(self, f1, pos1, f2, pos2):
        """Two 13-entry lists [enc_out, dec1..dec12], one per view
        (model.py:183-203; entry 0 is the encoder token before the
        projection)."""
        out1, out2 = [f1], [f2]
        f1 = self.decoder_embed(f1)
        f2 = self.decoder_embed(f2)
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            f1, f2 = blk1(f1, f2, pos1, pos2)[0], blk2(f2, f1, pos2, pos1)[0]
            out1.append(f1)
            out2.append(f2)
        out1[-1] = self.dec_norm(out1[-1].to(torch.float32))
        out2[-1] = self.dec_norm(out2[-1].to(torch.float32))
        return out1, out2

    def decode(self, f1, pos1, f2, pos2, img_h: int, img_w: int,
               stop_trunk_grad: bool = True, img_h2: int | None = None,
               img_w2: int | None = None):
        """Pairwise prediction from encoder tokens.

        Returns (res1, res2): res1 = {pts3d, conf, dynamic_mask}, res2 =
        {pts3d_in_other_view, conf, dynamic_mask}, both pointmaps in view
        1's frame (model.py:211-228), maps [B, H, W(, 3)] float32.
        ``img_h, img_w``: view 1's TRUE shape (a portrait view passes
        h > w); ``img_h2, img_w2`` default to it.
        """
        if img_h2 is None:
            img_h2, img_w2 = img_h, img_w
        dec1, dec2 = self._decode(f1, pos1, f2, pos2)
        # heads take float32 tokens (model.py:217-222)
        dec1 = [t.to(torch.float32) for t in dec1]
        dec2 = [t.to(torch.float32) for t in dec2]
        if stop_trunk_grad:
            dec1 = [t.detach() for t in dec1]
            dec2 = [t.detach() for t in dec2]

        c = self.cfg
        out1 = self.downstream_head1(dec1, img_h, img_w)
        out2 = self.downstream_head2(dec2, img_h2, img_w2)
        m1 = self.downstream_head_dynamic_mask1(dec1, img_h, img_w)
        m2 = self.downstream_head_dynamic_mask2(dec2, img_h2, img_w2)
        res1 = dict(
            pts3d=reg_dense_depth_exp(out1[..., :3]),
            conf=reg_dense_conf_exp(out1[..., 3], c.conf_vmin),
            dynamic_mask=torch.sigmoid(m1[..., 0]))
        res2 = dict(
            pts3d_in_other_view=reg_dense_depth_exp(out2[..., :3]),
            conf=reg_dense_conf_exp(out2[..., 3], c.conf_vmin),
            dynamic_mask=torch.sigmoid(m2[..., 0]))
        return res1, res2

    def forward(self, img1, img2, stop_trunk_grad: bool = True,
                portrait1: bool = False, portrait2: bool = False,
                landscape_out: bool = True):
        """The full two-view forward (the reference ``forward``).

        ``portrait1/2``: the view's landscape buffer holds a transposed
        portrait image (ManyAR). Predictions are computed in the TRUE
        orientation and, with ``landscape_out``, transposed back into the
        buffer's layout (transpose_to_landscape, misc.py:76-118).
        """
        H, W = img1.shape[-2:]
        f1, pos1 = self.encode(img1, portrait=portrait1)
        f2, pos2 = self.encode(img2, portrait=portrait2)
        h1, w1 = (W, H) if portrait1 else (H, W)
        H2, W2 = img2.shape[-2:]
        h2, w2 = (W2, H2) if portrait2 else (H2, W2)
        res1, res2 = self.decode(f1, pos1, f2, pos2, h1, w1,
                                 stop_trunk_grad=stop_trunk_grad,
                                 img_h2=h2, img_w2=w2)
        if landscape_out and portrait1:
            res1 = transposed_result(res1)
        if landscape_out and portrait2:
            res2 = transposed_result(res2)
        return res1, res2
