"""Scene assembly: SceneData -> training state (port of
``das3r_tpu/train/scene_setup.py``; the reference's ``Scene.__init__``,
``create_from_cameras``, ``init_RT_seq``, ``init_fov`` and
``init_test_RT_seq``, scene/__init__.py:26-93).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from das3r_tpu_torch.data.readers import SceneData
from das3r_tpu_torch.models import autosize
from das3r_tpu_torch.models.gaussians import (
    GaussianMeta, GaussianParams, GaussianScene, PoseParams, TestPoseParams,
    init_from_frames, init_pose_params, init_test_pose_params)
from das3r_tpu_torch.ops.splat import RasterSettings
from das3r_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class SceneBundle:
    params: GaussianParams
    meta: GaussianMeta
    scene: GaussianScene
    poses: PoseParams
    test_poses: TestPoseParams | None
    settings: RasterSettings
    train_data: SceneData       # train-frame subset (uid-indexed)
    test_data: SceneData | None


def nerfpp_radius(poses_w2c: np.ndarray) -> float:
    """Camera-extent radius used as spatial_lr_scale (getNerfppNorm,
    dataset_readers.py:59-80): 1.1 x the largest distance of a camera
    centre from their mean."""
    c2w = np.linalg.inv(poses_w2c)
    centers = c2w[:, :3, 3]
    d = np.linalg.norm(centers - centers.mean(0), axis=1)
    return float(d.max() * 1.1)


def build_scene(
    data: SceneData,
    sh_degree: int = 3,
    conf_thre: float = 1.0,
    capacity: int | None = None,
    max_per_tile: int = 1024,
    max_tiles_per_gaussian: int = 32,
    tile: int = 16,
    max_points: int | None = 1_500_000,
    entry_cap: int | None = None,
    probe_dup_cap: bool = True,
    device=None,
) -> SceneBundle:
    """The training state of ``data``'s train frames on ``device`` (default
    CUDA; a RuntimeError without it): parameters from the stage-1 frames,
    poses, test poses and raster settings.

    ``entry_cap``: ``max_total_entries``. None probes this scene's
    occupancy over sampled train views (``models/autosize.py``) with a
    window-path render, as the JAX package does; so do the three probe
    branches below, unchanged. ``probe_dup_cap`` also tightens
    ``max_tiles_per_gaussian`` to the probed footprint (never above the
    value passed); the trainer regrows it on ``dup_overflow``.

    Where the probe picks a split duplication table
    (``autosize.auto_split_table``, from N x dup cap of 8M slots on: 1.5M
    Gaussians reach it), the settings carry its ``light_dup_width`` and
    ``heavy_rows_cap`` and binning builds it, as in the JAX package; the
    trainer regrows the cap on ``heavy_overflow``.
    """
    dev = resolve_device(device)
    train = data.subset(data.train_idx)
    test = data.subset(data.test_idx) if len(data.test_idx) else None

    spatial_lr_scale = nerfpp_radius(train.poses_w2c_colmap)
    params, meta, scene = init_from_frames(
        images=train.images, depths=train.depth, confs=train.conf,
        dyna_avg=train.dyna_avg, poses_c2w=train.poses_c2w,
        focals=train.intrinsics[:, 0, 0], max_sh_degree=sh_degree,
        conf_thre=conf_thre, capacity=capacity,
        spatial_lr_scale=spatial_lr_scale, max_points=max_points, device=dev)
    poses = init_pose_params(train.poses_w2c_colmap,
                             fovx=float(train.fovx[0]),
                             fovy=float(train.fovy[0]), device=dev)
    test_poses = (init_test_pose_params(test.poses_w2c_colmap, device=dev)
                  if test is not None else None)

    settings = RasterSettings(
        image_height=data.height, image_width=data.width,
        sh_degree=0,  # active degree starts at 0 (bumped every 3000 iters)
        tile=tile, max_per_tile=max_per_tile,
        max_tiles_per_gaussian=max_tiles_per_gaussian,
        # placeholder capacity; replaced below (probe or explicit)
        max_total_entries=8 * params.xyz.shape[0],
        depth_sort_bits=0)
    args = (params, meta, settings, poses.all_poses().detach(),
            float(train.fovx[0]), float(train.fovy[0]))
    if entry_cap is None and probe_dup_cap:
        # one probe pass yields all the capacities
        stats = autosize.probe_capacities(*args)
        entry_cap = -(-max(int(stats.max_total * 1.2), 8 * 1024)
                      // 1024) * 1024
        dup_cap = min(-(-max(int(stats.max_dup * 1.3), 8) // 4) * 4,
                      max_tiles_per_gaussian)
        settings = dataclasses.replace(
            settings, max_tiles_per_gaussian=dup_cap,
            **autosize.auto_split_table(stats, params.xyz.shape[0],
                                        dup_cap))
    elif entry_cap is None:
        # occupancy depends on geometry and opacity only, not the SH degree
        entry_cap = autosize.auto_entry_cap(*args)
    elif probe_dup_cap:
        settings = dataclasses.replace(
            settings, max_tiles_per_gaussian=autosize.auto_dup_cap(*args))
    settings = dataclasses.replace(settings, max_total_entries=entry_cap)

    return SceneBundle(params=params, meta=meta, scene=scene, poses=poses,
                       test_poses=test_poses, settings=settings,
                       train_data=train, test_data=test)
