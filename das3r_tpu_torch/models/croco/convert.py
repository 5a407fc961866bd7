"""Weights into the port's predictor (port of ``das3r_tpu/models/croco/
convert.py``).

The port's modules carry the reference checkpoint's names (dust3r/model.py
and the croco modules; ``Kai422kx/das3r``), so a checkpoint's state dict
loads as it is, bar the three quirks the JAX converter handles
(``load_reference_state_dict``). ``jax_params_from_state_dict`` is the
port's copy of the JAX package's ``convert_torch_state_dict`` (a state
dict to the flax ``params`` tree of numpy leaves) and
``state_dict_from_jax_params`` its inverse; both go leaf by leaf through
``to_jax`` / ``from_jax``, which stage-1 training's checkpoints use to
write JAX's names (``keystr``).
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from das3r_tpu_torch.models.croco.dust3r import (DUST3R_LARGE_CONFIG,
                                                 AsymmetricCroCo3D,
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


# The JAX package's flax tree, leaf by leaf: each key of the port's state
# dict has one leaf there (``jax_path``), which is the tensor transposed
# or reshaped (``to_jax`` / ``from_jax``):
#   Linear            kernel = W.T
#   LayerNorm         scale = weight
#   Conv2d            kernel = W.transpose(2, 3, 1, 0)        (HWIO)
#   patchify Conv2d   kernel = W.reshape(D, -1).T              (a Dense)
#   ConvTranspose2d   kernel = W.reshape(C_in, -1); bias repeated k*k
#                     times ([C_out, k, k] when untied: dpt.py)
_ACT = {("0", "0"): "act_0_proj", ("0", "1"): "act_0_up",
        ("1", "0"): "act_1_proj", ("1", "1"): "act_1_up",
        ("2", "0"): "act_2_proj", ("3", "0"): "act_3_proj",
        ("3", "1"): "act_3_down"}
_UP = {"act_0_up": 4, "act_1_up": 2}
_HEAD_CONV = {"regression": {"0": "head_conv1", "2": "head_conv2",
                             "4": "head_conv3"},
              "semseg": {"0": "head_conv1", "4": "head_conv2"}}


def _leaf(name: str) -> tuple[tuple[str, ...], str]:
    """(JAX path, kind) of the state-dict key ``name``; kind is one of
    linear, norm, conv, patch, up (a ConvTranspose2d's weight), up_bias,
    bias."""
    parts = name.split(".")
    top, leaf = parts[0], parts[-1]
    if top == "patch_embed":
        return (("patch_embed", "proj", "kernel" if leaf == "weight"
                 else "bias"), "patch" if leaf == "weight" else "bias")
    if top in HEADS:
        rest = parts[2:-1]                      # past "<head>.dpt"
        if rest[0] == "act_postprocess":
            mod = _ACT[tuple(rest[1:3])]
            if mod in _UP:
                return ((top, mod, "proj", "kernel" if leaf == "weight"
                         else "bias"), "up" if leaf == "weight"
                        else "up_bias")
            path = (top, mod)
        elif rest[:2] == ["scratch", "layer_rn"]:
            path = (top, f"layer_rn_{rest[2]}")
        elif rest[0] == "scratch":
            path = (top, *rest[1:])
        else:
            path = (top, _HEAD_CONV[HEADS[top]][rest[1]])
        return ((*path, "kernel" if leaf == "weight" else "bias"),
                "conv" if leaf == "weight" else "bias")
    path = ((f"{top}_{parts[1]}", *parts[2:-1])
            if top in ("enc_blocks", "dec_blocks", "dec_blocks2")
            else (top,))
    if path[-1].startswith("norm") or top in ("enc_norm", "dec_norm"):
        return ((*path, "scale" if leaf == "weight" else "bias"),
                "norm" if leaf == "weight" else "bias")
    return ((*path, "kernel" if leaf == "weight" else "bias"),
            "linear" if leaf == "weight" else "bias")


def jax_path(name: str) -> tuple[str, ...]:
    """The path of the state-dict key ``name`` in the JAX params tree."""
    return _leaf(name)[0]


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys:
    ``['params']['enc_norm']['scale']``."""
    return "".join(f"[{p!r}]" for p in path)


def to_jax(name: str, x) -> np.ndarray:
    """The state-dict tensor ``name`` (numpy, or a tensor, laid out on its
    device and then copied to the host) as its JAX leaf."""
    path, kind = _leaf(name)
    if torch.is_tensor(x):
        x = x.detach()
        perm, repeat = x.permute, x.repeat_interleave
    else:
        perm, repeat = x.transpose, lambda n: np.repeat(x, n)
    if kind == "linear":
        y = x.T
    elif kind == "conv":
        y = perm(2, 3, 1, 0)
    elif kind == "patch":
        y = x.reshape(x.shape[0], -1).T
    elif kind == "up":
        y = x.reshape(x.shape[0], -1)
    elif kind == "up_bias":
        y = repeat(_UP[path[1]] ** 2) if x.ndim == 1 else x.reshape(-1)
    else:
        y = x
    if torch.is_tensor(y):
        return y.contiguous().cpu().numpy()
    return np.ascontiguousarray(y)


def from_jax(name: str, y: np.ndarray, shape) -> np.ndarray:
    """The inverse of ``to_jax``: the JAX leaf of ``name`` as a state-dict
    tensor of ``shape`` (a tied ConvTranspose2d bias takes the first of
    each channel's k*k entries, as the JAX package's converter wrote
    them)."""
    path, kind = _leaf(name)
    if kind == "linear":
        x = y.T
    elif kind == "conv":
        x = y.transpose(3, 2, 0, 1)
    elif kind == "patch":
        x = y.T.reshape(shape)
    elif kind == "up_bias" and len(shape) == 1:
        x = y.reshape(shape[0], -1)[:, 0]
    else:
        x = y.reshape(shape)
    return np.ascontiguousarray(x)


def _model_state(cfg: Dust3rConfig) -> dict:
    """The state dict of a ``cfg`` predictor on the meta device: its keys
    and shapes, no storage."""
    with torch.device("meta"):
        return AsymmetricCroCo3D(cfg).state_dict()


def jax_params_from_state_dict(state: dict,
                               cfg: Dust3rConfig = DUST3R_LARGE_CONFIG
                               ) -> dict:
    """A reference state dict (numpy arrays or tensors) -> the JAX
    package's flax ``params`` tree of numpy arrays: the port's copy of its
    ``convert_torch_state_dict``, the reference's quirks included
    (``_source_key``; refinenet4's dead unit dropped). A key the dict
    lacks leaves its leaf out, so the mask heads' tensors alone give the
    trainable tree of stage-1 training."""
    if cfg.head_type != "dpt":
        raise ValueError("the JAX converter covers DPT heads only")
    out: dict = {}
    for k in _model_state(cfg):
        src = _source_key(k, state)
        if src not in state:
            continue
        x = state[src]
        x = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        *parents, leaf = jax_path(k)
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = to_jax(k, x)
    return out


def jax_leaf(params: dict, name: str) -> np.ndarray:
    """The leaf of state-dict key ``name`` in the JAX tree ``params``."""
    node = params
    for p in jax_path(name):
        node = node[p]
    return np.asarray(node)


def state_dict_from_jax_params(params: dict,
                               cfg: Dust3rConfig = DUST3R_LARGE_CONFIG
                               ) -> dict[str, torch.Tensor]:
    """The JAX package's flax ``params`` tree (numpy leaves, a DPT-head
    model) -> the port's state dict; exact, a transpose or reshape of each
    leaf."""
    if cfg.head_type != "dpt":
        raise ValueError("the JAX converter covers DPT heads only")
    return {k: torch.from_numpy(from_jax(k, jax_leaf(params, k), v.shape))
            for k, v in _model_state(cfg).items()}
