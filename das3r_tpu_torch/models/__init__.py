from das3r_tpu_torch.models.gaussians import (
    GaussianParams, PoseParams, TestPoseParams, GaussianMeta,
    activated_opacity, activated_scaling, per_gaussian_conf,
    params_from_numpy, poses_from_numpy, test_poses_from_numpy,
    adam_state_from_numpy, init_pose_params, init_test_pose_params,
)
from das3r_tpu_torch.models import render
