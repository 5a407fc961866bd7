"""Weights into the port's predictor (port of ``das3r_tpu/models/croco/
convert.py``).

The port's modules carry the reference checkpoint's names (dust3r/model.py
and the croco modules; ``Kai422kx/das3r``), so a checkpoint's state dict
loads as it is, bar the three quirks the JAX converter handles
(``load_reference_state_dict``). ``state_dict_from_jax_params`` is the
inverse of the JAX package's ``convert_torch_state_dict``: it takes the
flax ``params`` tree (numpy leaves) to the port's state dict.
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from das3r_tpu_torch.models.croco.dust3r import (DUST3R_LARGE_CONFIG,
                                                 Dust3rConfig)

HEADS = {"downstream_head1": "regression", "downstream_head2": "regression",
         "downstream_head_dynamic_mask1": "semseg",
         "downstream_head_dynamic_mask2": "semseg"}


def _source_key(key: str, state: dict) -> str:
    """The checkpoint key that fills the port's ``key``:

    * ``dec_blocks2.i.*`` from ``dec_blocks.i.*`` when the checkpoint has
      no ``dec_blocks2.i`` (decided on its ``norm1.weight``, as in JAX);
    * ``dpt.scratch.layer_rn.i`` from croco's alias ``layer{i+1}_rn``
      when the ModuleList entry is missing.
    """
    parts = key.split(".")
    if parts[0] == "dec_blocks2" and \
            f"dec_blocks2.{parts[1]}.norm1.weight" not in state:
        return ".".join(["dec_blocks"] + parts[1:])
    if parts[2:4] == ["scratch", "layer_rn"]:
        prefix = ".".join(parts[:5])
        if prefix + ".weight" not in state:
            return ".".join(parts[:3] + [f"layer{int(parts[4]) + 1}_rn"]
                            + parts[5:])
    return key


def load_reference_state_dict(model: nn.Module, state: dict) -> None:
    """Load a reference state dict (numpy arrays or tensors) into ``model``.

    Extra keys are ignored, as the JAX converter ignores them (refinenet4's
    dead ``resConfUnit1`` among them); a key the model needs and the dict
    lacks raises ``KeyError``."""
    want = model.state_dict()
    src = {k: _source_key(k, state) for k in want}
    missing = sorted(s for s in src.values() if s not in state)
    if missing:
        raise KeyError(f"{len(missing)} keys missing from the state dict, "
                       f"e.g. {missing[:8]}")
    model.load_state_dict(
        {k: torch.as_tensor(np.asarray(state[s])) for k, s in src.items()})


def _numpy_state(ckpt) -> dict:
    state = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.numpy() for k, v in state.items() if hasattr(v, "numpy")}


def load_torch_checkpoint(path: str) -> dict:
    """A reference .pth (or HF pytorch_model.bin) as a numpy dict."""
    return _numpy_state(torch.load(path, map_location="cpu",
                                   weights_only=False))


def config_from_state_dict(state: dict, model_args: str | None = None
                           ) -> Dust3rConfig:
    """The predictor config of a reference state dict: widths, depths and
    patch size from its keys and shapes; the head counts, which no shape
    shows, from ``model_args`` (the constructor call that the reference's
    checkpoints keep under ``args.model``, as in ``enc_num_heads=16``),
    else a head width of 64, that of every DPT checkpoint of the family."""
    def depth(prefix):
        return 1 + max(int(k.split(".")[1]) for k in state
                       if k.startswith(prefix + "."))
    enc_dim, _, patch, _ = state["patch_embed.proj.weight"].shape
    dec_dim = state["decoder_embed.weight"].shape[0]
    heads = dict(re.findall(r"\b(enc|dec)_num_heads\s*=\s*(\d+)",
                            model_args or ""))
    return Dust3rConfig(
        patch_size=patch, enc_embed_dim=enc_dim,
        enc_depth=depth("enc_blocks"),
        enc_num_heads=int(heads.get("enc", enc_dim // 64)),
        dec_embed_dim=dec_dim, dec_depth=depth("dec_blocks"),
        dec_num_heads=int(heads.get("dec", dec_dim // 64)),
        head_type="dpt" if "downstream_head1.dpt.head.0.weight" in state
        else "linear")


def read_checkpoint(path: str) -> tuple[dict, Dust3rConfig]:
    """A reference checkpoint's numpy state dict and its predictor config
    (``config_from_state_dict``, with the checkpoint's ``args.model``
    where it has one)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    args = ckpt.get("args") if isinstance(ckpt, dict) else None
    state = _numpy_state(ckpt)
    return state, config_from_state_dict(state, getattr(args, "model", None))


def _linear(out, prefix, p):
    out[prefix + ".weight"] = p["kernel"].T
    out[prefix + ".bias"] = p["bias"]


def _layernorm(out, prefix, p):
    out[prefix + ".weight"] = p["scale"]
    out[prefix + ".bias"] = p["bias"]


def _conv(out, prefix, p):
    out[prefix + ".weight"] = p["kernel"].transpose(3, 2, 0, 1)
    if "bias" in p:
        out[prefix + ".bias"] = p["bias"]


def _convtranspose(out, prefix, p, k):
    kernel = p["proj"]["kernel"]                     # [in, out * k * k]
    out[prefix + ".weight"] = kernel.reshape(kernel.shape[0], -1, k, k)
    out[prefix + ".bias"] = p["proj"]["bias"].reshape(-1, k * k)[:, 0]


def _block(out, prefix, p, decoder: bool):
    norms = ("norm1", "norm2") + (("norm3", "norm_y") if decoder else ())
    for ln in norms:
        _layernorm(out, f"{prefix}.{ln}", p[ln])
    for nm in ("qkv", "proj"):
        _linear(out, f"{prefix}.attn.{nm}", p["attn"][nm])
    for nm in ("fc1", "fc2"):
        _linear(out, f"{prefix}.mlp.{nm}", p["mlp"][nm])
    if decoder:
        for nm in ("projq", "projk", "projv", "proj"):
            _linear(out, f"{prefix}.cross_attn.{nm}", p["cross_attn"][nm])


def _dpt_head(out, prefix, h, head_type):
    d = prefix + ".dpt"
    _conv(out, f"{d}.act_postprocess.0.0", h["act_0_proj"])
    _convtranspose(out, f"{d}.act_postprocess.0.1", h["act_0_up"], 4)
    _conv(out, f"{d}.act_postprocess.1.0", h["act_1_proj"])
    _convtranspose(out, f"{d}.act_postprocess.1.1", h["act_1_up"], 2)
    _conv(out, f"{d}.act_postprocess.2.0", h["act_2_proj"])
    _conv(out, f"{d}.act_postprocess.3.0", h["act_3_proj"])
    _conv(out, f"{d}.act_postprocess.3.1", h["act_3_down"])
    for i in range(4):
        _conv(out, f"{d}.scratch.layer_rn.{i}", h[f"layer_rn_{i}"])
    for j in range(1, 5):
        rf = h[f"refinenet{j}"]
        for unit in ("resConfUnit1", "resConfUnit2"):
            if unit in rf:
                for c in ("conv1", "conv2"):
                    _conv(out, f"{d}.scratch.refinenet{j}.{unit}.{c}",
                          rf[unit][c])
        _conv(out, f"{d}.scratch.refinenet{j}.out_conv", rf["out_conv"])
    convs = ((0, 2, 4) if head_type == "regression" else (0, 4))
    for n, idx in enumerate(convs, 1):
        _conv(out, f"{d}.head.{idx}", h[f"head_conv{n}"])


def state_dict_from_jax_params(params: dict,
                               cfg: Dust3rConfig = DUST3R_LARGE_CONFIG
                               ) -> dict[str, torch.Tensor]:
    """The JAX package's flax ``params`` tree (numpy leaves, a DPT-head
    model) -> the port's state dict; exact, a transpose or reshape of each
    leaf."""
    if cfg.head_type != "dpt":
        raise ValueError("the JAX converter covers DPT heads only")
    p = params
    out: dict = {}
    pe = p["patch_embed"]["proj"]
    out["patch_embed.proj.weight"] = pe["kernel"].T.reshape(
        -1, 3, cfg.patch_size, cfg.patch_size)
    out["patch_embed.proj.bias"] = pe["bias"]
    for i in range(cfg.enc_depth):
        _block(out, f"enc_blocks.{i}", p[f"enc_blocks_{i}"], decoder=False)
    _layernorm(out, "enc_norm", p["enc_norm"])
    _linear(out, "decoder_embed", p["decoder_embed"])
    for i in range(cfg.dec_depth):
        _block(out, f"dec_blocks.{i}", p[f"dec_blocks_{i}"], decoder=True)
        _block(out, f"dec_blocks2.{i}", p[f"dec_blocks2_{i}"], decoder=True)
    _layernorm(out, "dec_norm", p["dec_norm"])
    for name, head_type in HEADS.items():
        _dpt_head(out, name, p[name], head_type)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}
