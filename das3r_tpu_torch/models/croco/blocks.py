"""CroCo ViT building blocks (port of ``das3r_tpu/models/croco/blocks.py``).

Module and parameter names follow the reference checkpoint's state dict
(``enc_blocks.0.attn.qkv.weight``, ...), so ``load_state_dict`` takes its
keys as they are.

Attention is written as the JAX package writes it: a matmul, a softmax
and a matmul, the scores in float32 (JAX's ``preferred_element_type``).
``dtype`` is the compute type of a block's matrix products: its Linear
weights are stored in it, while its LayerNorms keep float32 parameters,
compute in float32 and round their output to ``dtype``, as flax's
``LayerNorm(dtype=...)`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from das3r_tpu_torch.models.croco.rope import rope_2d


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
