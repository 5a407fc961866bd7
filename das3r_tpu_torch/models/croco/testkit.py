"""Tiny-model fixtures for the stage-1 predictor (the port's own copy of
``das3r_tpu/models/croco/testkit.py``).

A reduced ``Dust3rConfig`` that exercises every layer of
AsymmetricCroCo3D at toy size, and a generator that enumerates the
reference checkpoint's state-dict keys with their shapes, so the model can
be driven without real weights. The generator is numpy and draws in the
JAX package's order, so one seed gives both packages the same weights.
"""
import argparse

import numpy as np
import torch

from das3r_tpu_torch.models.croco.dust3r import Dust3rConfig

TINY = Dust3rConfig(enc_embed_dim=64, enc_depth=2, enc_num_heads=4,
                    dec_embed_dim=32, dec_depth=4, dec_num_heads=2)


def random_torch_state_dict(cfg: Dust3rConfig, rng):
    """Enumerate the reference checkpoint's keys with correct shapes."""
    p = {}
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.02  # noqa: E731
    De, Dd = cfg.enc_embed_dim, cfg.dec_embed_dim
    p["patch_embed.proj.weight"] = r(De, 3, 16, 16)
    p["patch_embed.proj.bias"] = r(De)

    def block(prefix, D):
        p[f"{prefix}.norm1.weight"] = r(D)
        p[f"{prefix}.norm1.bias"] = r(D)
        p[f"{prefix}.norm2.weight"] = r(D)
        p[f"{prefix}.norm2.bias"] = r(D)
        p[f"{prefix}.attn.qkv.weight"] = r(3 * D, D)
        p[f"{prefix}.attn.qkv.bias"] = r(3 * D)
        p[f"{prefix}.attn.proj.weight"] = r(D, D)
        p[f"{prefix}.attn.proj.bias"] = r(D)
        p[f"{prefix}.mlp.fc1.weight"] = r(4 * D, D)
        p[f"{prefix}.mlp.fc1.bias"] = r(4 * D)
        p[f"{prefix}.mlp.fc2.weight"] = r(D, 4 * D)
        p[f"{prefix}.mlp.fc2.bias"] = r(D)

    def dec_block(prefix, D):
        block(prefix, D)
        p[f"{prefix}.norm3.weight"] = r(D)
        p[f"{prefix}.norm3.bias"] = r(D)
        p[f"{prefix}.norm_y.weight"] = r(D)
        p[f"{prefix}.norm_y.bias"] = r(D)
        for nm in ("projq", "projk", "projv", "proj"):
            p[f"{prefix}.cross_attn.{nm}.weight"] = r(D, D)
            p[f"{prefix}.cross_attn.{nm}.bias"] = r(D)

    for i in range(cfg.enc_depth):
        block(f"enc_blocks.{i}", De)
    p["enc_norm.weight"] = r(De)
    p["enc_norm.bias"] = r(De)
    p["decoder_embed.weight"] = r(Dd, De)
    p["decoder_embed.bias"] = r(Dd)
    for i in range(cfg.dec_depth):
        dec_block(f"dec_blocks.{i}", Dd)
        dec_block(f"dec_blocks2.{i}", Dd)
    p["dec_norm.weight"] = r(Dd)
    p["dec_norm.bias"] = r(Dd)

    ld = (96, 192, 384, 768)
    dims = (De, Dd, Dd, Dd)

    def dpt(prefix, nch, head_type):
        p[f"{prefix}.dpt.act_postprocess.0.0.weight"] = r(ld[0], dims[0], 1, 1)
        p[f"{prefix}.dpt.act_postprocess.0.0.bias"] = r(ld[0])
        p[f"{prefix}.dpt.act_postprocess.0.1.weight"] = r(ld[0], ld[0], 4, 4)
        p[f"{prefix}.dpt.act_postprocess.0.1.bias"] = r(ld[0])
        p[f"{prefix}.dpt.act_postprocess.1.0.weight"] = r(ld[1], dims[1], 1, 1)
        p[f"{prefix}.dpt.act_postprocess.1.0.bias"] = r(ld[1])
        p[f"{prefix}.dpt.act_postprocess.1.1.weight"] = r(ld[1], ld[1], 2, 2)
        p[f"{prefix}.dpt.act_postprocess.1.1.bias"] = r(ld[1])
        p[f"{prefix}.dpt.act_postprocess.2.0.weight"] = r(ld[2], dims[2], 1, 1)
        p[f"{prefix}.dpt.act_postprocess.2.0.bias"] = r(ld[2])
        p[f"{prefix}.dpt.act_postprocess.3.0.weight"] = r(ld[3], dims[3], 1, 1)
        p[f"{prefix}.dpt.act_postprocess.3.0.bias"] = r(ld[3])
        p[f"{prefix}.dpt.act_postprocess.3.1.weight"] = r(ld[3], ld[3], 3, 3)
        p[f"{prefix}.dpt.act_postprocess.3.1.bias"] = r(ld[3])
        for i in range(4):
            p[f"{prefix}.dpt.scratch.layer_rn.{i}.weight"] = r(256, ld[i], 3, 3)
        for j in range(1, 5):
            rp = f"{prefix}.dpt.scratch.refinenet{j}"
            for unit in ("resConfUnit1", "resConfUnit2"):
                for c in ("conv1", "conv2"):
                    p[f"{rp}.{unit}.{c}.weight"] = r(256, 256, 3, 3)
                    p[f"{rp}.{unit}.{c}.bias"] = r(256)
            p[f"{rp}.out_conv.weight"] = r(256, 256, 1, 1)
            p[f"{rp}.out_conv.bias"] = r(256)
        if head_type == "regression":
            p[f"{prefix}.dpt.head.0.weight"] = r(128, 256, 3, 3)
            p[f"{prefix}.dpt.head.0.bias"] = r(128)
            p[f"{prefix}.dpt.head.2.weight"] = r(128, 128, 3, 3)
            p[f"{prefix}.dpt.head.2.bias"] = r(128)
            p[f"{prefix}.dpt.head.4.weight"] = r(nch, 128, 1, 1)
            p[f"{prefix}.dpt.head.4.bias"] = r(nch)
        else:
            p[f"{prefix}.dpt.head.0.weight"] = r(256, 256, 3, 3)
            p[f"{prefix}.dpt.head.4.weight"] = r(nch, 256, 1, 1)
            p[f"{prefix}.dpt.head.4.bias"] = r(nch)

    dpt("downstream_head1", 4, "regression")
    dpt("downstream_head2", 4, "regression")
    dpt("downstream_head_dynamic_mask1", 1, "semseg")
    dpt("downstream_head_dynamic_mask2", 1, "semseg")
    return p


def save_reference_checkpoint(path, state: dict, cfg: Dust3rConfig) -> None:
    """``state`` (numpy) as a reference-layout ``.pth``: the weights under
    ``model`` and, as the reference's checkpoints keep it, the constructor
    call under ``args.model``, which gives the head counts."""
    call = ", ".join(f"{k}={getattr(cfg, k)}" for k in (
        "enc_embed_dim", "enc_depth", "enc_num_heads", "dec_embed_dim",
        "dec_depth", "dec_num_heads"))
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()},
                "args": argparse.Namespace(
                    model=f"AsymmetricCroCo3DStereo({call})")}, path)
