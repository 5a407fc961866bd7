"""The DAS3R dynamic predictor (port of ``das3r_tpu/models/croco/
dust3r.py``): a DUSt3R/MonST3R-style asymmetric two-view transformer with
dynamic-mask DPT heads (reference dynamic_predictor/dust3r/model.py:45-228).

  * siamese ViT-L encoder: patch 16, dim 1024, depth 24, heads 16, RoPE100;
  * two cross-attending decoders (dim 768, depth 12, heads 12),
    ``dec_blocks`` for view 1 and ``dec_blocks2`` for view 2;
  * four DPT heads: pts3d + conf per view (regression, exp depth and exp
    conf) and a dynamic mask per view (semseg, sigmoid).

As in the JAX package, the pipeline encodes each unique frame once
(``encode``) and runs the decoder and heads per pair (``decode``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from das3r_tpu_torch.models.croco.blocks import (Block, DecoderBlock,
                                                 PatchEmbed)
from das3r_tpu_torch.models.croco.dpt import DPTHead, LinearHead


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
