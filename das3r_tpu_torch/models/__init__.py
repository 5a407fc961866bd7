from das3r_tpu_torch.models.gaussians import (
    GaussianParams, PoseParams, GaussianMeta, activated_opacity,
    activated_scaling, per_gaussian_conf, params_from_numpy,
)
from das3r_tpu_torch.models import render
