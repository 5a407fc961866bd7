"""Typed training configuration (the port's own copy of
``das3r_tpu/train/config.py``, a plain-Python module): the reference's
three config mechanisms (reflection argparse groups, re-eval'd
``cfg_args`` files and eval()-able model strings) as plain dataclasses
that serialize to JSON.

Field names and defaults mirror the reference's ``OptimizationParams`` /
``ModelParams`` / ``PipelineParams`` (arguments/__init__.py:47-90) so runs
are comparable one-to-one.
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    convert_shs_python: bool = False
    compute_cov3d_python: bool = False
    debug: bool = False


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    iterations: int = 30_000
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 2e-4
    random_background: bool = False
    # DAS3R additions (hardcoded in reference gaussian_model.py:233-255)
    conf_lr_init: float = 3e-3
    conf_lr_final: float = 3e-4
    cam_lr_init: float = 3e-5
    cam_lr_final: float = 3e-6
    cam_lr_max_steps: int = 1000
    fov_lr: float = 1e-4
    psnr_threshold: float = 26.0   # camera-step gate (train_gui.py:734)
    # The reference's create_from_cameras init path LOOKS like it freezes
    # features/scaling/rotation/opacity (requires_grad_(False),
    # gaussian_model.py:651-659) — but wrapping in nn.Parameter resets
    # requires_grad=True (torch Parameter constructor default, verified
    # empirically), and training_setup registers all attrs with normal
    # lrs, so the reference actually TRAINS every attribute. Default False
    # matches that real behavior; True is an opt-in ablation.
    freeze_attrs: bool = False


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)


def from_json(cls, text: str):
    data = json.loads(text)
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in data.items() if k in fields})
