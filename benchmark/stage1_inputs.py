"""Inputs of the stage-1 cells, made from the seed on the device: the
predictor's weights in the reference checkpoint's layout, video clips,
and the runner's default scene graph over a clip."""
from __future__ import annotations

import math

import torch
from torch import nn

from benchmark.reference import dust3r_model as ref_model

HEADS = "downstream_head"   # modules built after CroCo's init: PyTorch's


def model_config(cfg: dict) -> ref_model.Dust3rConfig:
    keys = ("patch_size", "enc_embed_dim", "enc_depth", "enc_num_heads",
            "dec_embed_dim", "dec_depth", "dec_num_heads", "mlp_ratio")
    return ref_model.Dust3rConfig(**{k: cfg["model"][k] for k in keys})


def init_plan(model: nn.Module) -> dict:
    """Per state-dict tensor, how the model's own init draws it: ``("u",
    bound)`` for U(-bound, bound), ``("c", value)`` for a constant.
    CroCo's ``_init_weights`` for the encoder and decoder: linear weights
    xavier-uniform and their biases 0, LayerNorm gains 1 and biases 0, the
    patch embedding's kernel xavier-uniform over its flattened shape.
    PyTorch's defaults for the DPT heads, which are built after that
    init, and for every other bias: kaiming-uniform with a = sqrt(5), a
    bound of 1 / sqrt(fan_in) for weight and bias alike. Fans are those
    of a weight flattened to [out, rest]: for a linear layer and a
    convolution, the same as PyTorch's."""
    fans = nn.init._calculate_fan_in_and_fan_out
    plan = {}
    for name, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            key = f"{name}.{pname}"
            if isinstance(mod, nn.LayerNorm):
                plan[key] = ("c", 1.0 if pname == "weight" else 0.0)
                continue
            fan_in, fan_out = fans(mod.weight.flatten(1))
            xavier = math.sqrt(6.0 / (fan_in + fan_out))
            if name.startswith(HEADS):
                plan[key] = ("u", 1.0 / math.sqrt(fan_in))
            elif isinstance(mod, nn.Linear):
                plan[key] = ("u", xavier) if pname == "weight" else ("c", 0.0)
            else:   # the patch embedding: its kernel as [out, in * k * k]
                plan[key] = (("u", xavier) if pname == "weight"
                             else ("u", 1.0 / math.sqrt(fan_in)))
    return plan


def weights(cfg: dict, seed: int, device) -> dict:
    """The state dict, drawn as ``init_plan`` says, its tensors views of
    one buffer of U(-1, 1) drawn in one call and scaled in place."""
    with torch.device("meta"):
        model = ref_model.AsymmetricCroCo3D(model_config(cfg))
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    plan = init_plan(model)
    total = sum(s.numel() for s in shapes.values())
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out, o = {}, 0
    for k, s in shapes.items():
        kind, v = plan[k]
        t = flat[o:o + s.numel()]
        t.mul_(v) if kind == "u" else t.fill_(v)
        out[k] = t.view(s)
        o += s.numel()
    return out


def clip(cfg: dict, seed: int, index: int, frames: int, device):
    """[frames, 3, H, W] frames in [0, 1]: smooth random images (a coarse
    grid of colours, bilinearly upsampled), one generator per clip."""
    H, W = cfg["height"], cfg["width"]
    gen = torch.Generator(device).manual_seed(seed * 7919 + index)
    coarse = torch.rand(frames, 3, H // 16, W // 16, generator=gen,
                        device=device)
    return torch.nn.functional.interpolate(coarse, size=(H, W),
                                           mode="bilinear",
                                           align_corners=False)


def scene_graph(n: int, window: int, stride: int) -> list[tuple[int, int]]:
    """``swinstride-<window>-noncyclic``, symmetrised: frame i with
    i + stride * k + 1 for k < window, then every pair reversed (the
    runner's ``pairs.make_pairs(n, eval_scene_graph(n), symmetrize=True)``
    for a 16-frame clip)."""
    pairs = [(i, i + j) for i in range(n)
             for j in range(1, stride * window + 1, stride) if i + j < n]
    return pairs + [(j, i) for i, j in pairs]
