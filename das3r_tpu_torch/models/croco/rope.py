"""2D rotary position embedding (port of ``das3r_tpu/models/croco/rope.py``;
CroCo v2's ``RoPE2D``, model config ``pos_embed='RoPE100'``).

Per attention head of dim D: the first D/2 channels are rotated by the
token's y position, the last D/2 by its x position; within each half,
standard 1D RoPE with ``rotate_half`` pairing and inv_freq =
base^(-2i/(D/2)). Plain elementwise PyTorch in place of the reference's
``curope`` CUDA kernel, as the JAX package does it in plain XLA.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


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
