"""Checkpoint and artifact I/O for stage-2 training (port of
``das3r_tpu/train/checkpoint.py``).

* ``save_train_state`` / ``load_train_state``: the full training state
  (parameters, poses, both Adam states, the step) and optionally the
  ``GaussianMeta``, in one ``.npz``. The keys are the JAX package's
  (``jax.tree_util.keystr`` paths: ``.params.xyz``, ``.opt.mu.xyz``,
  ``.step``, ``meta:.alive``), so a checkpoint written by either package
  loads in the other.
* ``save_scene_ply``: the live Gaussians in the reference's dual-opacity
  PLY schema.
* ``save_pose_npy``: the [F, 4, 4] w2c pose stack.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from das3r_tpu_torch.data import ply as ply_io
from das3r_tpu_torch.models.gaussians import GaussianMeta, per_gaussian_conf
from das3r_tpu_torch.utils.quat import pose_to_w2c


def _flatten_with_paths(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """{".field.subfield": array} over nested dataclasses; an int leaf
    (the step) becomes an int32 array, as in the JAX state."""
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(_flatten_with_paths(getattr(tree, f.name),
                                           f"{prefix}.{f.name}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    return {prefix: np.asarray(tree, np.int32)}


def save_train_state(path: str, state, meta: GaussianMeta | None = None
                     ) -> None:
    """Full resumable checkpoint; ``meta`` (alive mask and densification
    statistics) is stored under a ``meta:`` prefix when given, which a
    bit-exact resume of a densifying run needs."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = _flatten_with_paths(state)
    if meta is not None:
        payload.update({"meta:" + k: v
                        for k, v in _flatten_with_paths(meta).items()})
    np.savez_compressed(path, **payload)


def _unflatten_from(data, template, prefix: str):
    """A copy of ``template`` with every leaf read from ``data``, on the
    template leaf's device and in its dtype."""
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _unflatten_from(data, getattr(template, f.name),
                                    f"{prefix}.{f.name}")
            for f in dataclasses.fields(template)})
    arr = np.asarray(data[prefix])
    if isinstance(template, torch.Tensor):
        if arr.shape != tuple(template.shape):
            raise ValueError(f"{prefix}: shape {arr.shape} in the file, "
                             f"{tuple(template.shape)} in the state")
        return torch.as_tensor(arr, device=template.device).to(template.dtype)
    return type(template)(arr)


def load_train_state(path: str, template, meta_template=None):
    """The state in ``path``, shaped like ``template`` (a
    ``train.step.TrainState``); with ``meta_template`` also the
    ``GaussianMeta`` (None when the file holds none): (state, meta)."""
    with np.load(path) as data:
        state = _unflatten_from(data, template, "")
        if meta_template is None:
            return state
        has_meta = any(k.startswith("meta:") for k in data.files)
        meta = (_unflatten_from(data, meta_template, "meta:")
                if has_meta else None)
    return state, meta


def save_scene_ply(path: str, params, meta: GaussianMeta) -> None:
    """PLY snapshot of the LIVE Gaussians (capacity padding stripped) in
    the reference dual-opacity schema."""
    with torch.no_grad():
        alive = meta.alive.cpu().numpy()
        conf = per_gaussian_conf(params, meta).cpu().numpy()

        def live(x):
            return x.detach().cpu().numpy()[alive]
        ply_io.write_gaussians(
            path, xyz=live(params.xyz), f_dc=live(params.features_dc),
            f_rest=live(params.features_rest),
            opacity_logit=live(params.opacity),
            conf_per_gaussian=conf[alive], scaling=live(params.scaling),
            rotation=live(params.rotation))


def save_pose_npy(path: str, poses) -> None:
    """[F, 4, 4] w2c stack of ``PoseParams`` or ``TestPoseParams``."""
    with torch.no_grad():
        w2c = pose_to_w2c(torch.cat([poses.Q, poses.T], -1)).cpu().numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, w2c)
