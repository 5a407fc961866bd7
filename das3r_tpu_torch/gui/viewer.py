"""Headless panel renderer behind the GUI: port of
``das3r_tpu/gui/viewer.py`` (reference train_gui.py GUI class :57-465):
orbit-view RGB, staticness (confidence) maps, GT dynamic-mask blends, and
a top-down trajectory plot, each as a uint8 numpy image ready for
PNG/browser streaming.

The renderer is a function of (scene tensors, orbit camera): each panel
is one ``models/render.render`` on the scene's device under
``torch.no_grad()``, which on the card launches kernels A and B once.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from das3r_tpu_torch.eval.viz import colormap_jet
from das3r_tpu_torch.models import render as render_mod
from das3r_tpu_torch.models.gaussians import GaussianMeta, GaussianParams
from das3r_tpu_torch.ops.splat import RasterSettings
from das3r_tpu_torch.utils.camera_paths import OrbitCamera
from das3r_tpu_torch.utils.device import on_device, resolve_device
from das3r_tpu_torch.utils.quat import pose_to_w2c, w2c_to_pose

PANEL_MODES = ("rgb", "confidence", "no_soft")


@dataclasses.dataclass
class ViewerScene:
    """Render-ready scene state on ``device`` (None means CUDA, and a
    RuntimeError without it; the tests pass ``"cpu"``)."""

    params: GaussianParams
    meta: GaussianMeta
    settings: RasterSettings
    conf: object | None = None   # per-Gaussian conf (PLY-loaded); None ->
                                 # conf_static gather (training-time state)
    bg: object = None            # [3]
    train_poses7: np.ndarray | None = None   # [F, 7] for the trajectory plot
    gt_poses_c2w: np.ndarray | None = None   # optional GT for the plot
    device: object = None

    def __post_init__(self):
        dev = self.device = resolve_device(self.device)
        self.params = GaussianParams(**{
            f.name: getattr(self.params, f.name).to(dev)
            for f in dataclasses.fields(GaussianParams)})
        self.meta = GaussianMeta(**{
            f.name: getattr(self.meta, f.name).to(dev)
            for f in dataclasses.fields(GaussianMeta)})
        self.conf = on_device(self.conf, dev, torch.float32)
        self.bg = (torch.zeros(3, device=dev) if self.bg is None
                   else on_device(self.bg, dev, torch.float32))

    # -- orbit helpers ---------------------------------------------------
    def default_orbit(self, width: int | None = None,
                      height: int | None = None,
                      fovy_deg: float = 60.0) -> OrbitCamera:
        """Orbit around the alive centroid at ~1.5x the scene radius."""
        alive = self.meta.alive.cpu().numpy()
        xyz = self.params.xyz.detach().cpu().numpy()[alive]
        center = xyz.mean(axis=0) if xyz.size else np.zeros(3)
        if xyz.size:
            radius = 1.5 * float(np.percentile(
                np.linalg.norm(xyz - center, axis=1), 90))
        else:
            radius = 2.0
        cam = OrbitCamera(width or self.settings.image_width,
                          height or self.settings.image_height,
                          radius=max(radius, 1e-2), fovy_deg=fovy_deg)
        cam.center = center
        return cam

    # -- panels ----------------------------------------------------------
    def render_image(self, orbit: OrbitCamera, mode: str = "rgb"
                     ) -> torch.Tensor:
        """One orbit view -> the [3, H, W] float image on the scene's
        device, as the renderer gives it (PANEL_MODES)."""
        if mode not in PANEL_MODES:
            raise ValueError(f"mode {mode!r} not in {PANEL_MODES}")
        rmode = {"rgb": "test" if self.conf is not None else "train",
                 "confidence": "confidence", "no_soft": "no_soft"}[mode]
        w2c = np.linalg.inv(orbit.pose).astype(np.float32)
        pose7 = w2c_to_pose(torch.as_tensor(w2c, device=self.device))
        fovx = 2 * np.arctan(np.tan(orbit.fovy / 2) * orbit.W / orbit.H)
        with torch.no_grad():
            return render_mod.render(
                self.params, self.meta, self.settings, pose7, self.bg,
                float(fovx), float(orbit.fovy), mode=rmode,
                conf_per_gaussian=self.conf, device=self.device).image

    def render_panel(self, orbit: OrbitCamera, mode: str = "rgb"
                     ) -> np.ndarray:
        """One orbit view -> [H, W, 3] uint8 (PANEL_MODES)."""
        img = self.render_image(orbit, mode)
        arr = np.clip(img.cpu().numpy().transpose(1, 2, 0), 0.0, 1.0)
        if mode == "confidence":
            return colormap_jet(arr[..., 0])
        return (arr * 255).astype(np.uint8)

    def mask_blend_panel(self, image01_hw3: np.ndarray,
                         mask_hw: np.ndarray,
                         color=(1.0, 0.1, 0.1), alpha: float = 0.5
                         ) -> np.ndarray:
        """GT/pred dynamic-mask overlay (train_gui.py mask blend views):
        image blended toward ``color`` where mask > 0.5."""
        img = np.clip(np.asarray(image01_hw3, np.float64), 0, 1)
        m = (np.asarray(mask_hw) > 0.5)[..., None]
        out = np.where(m, (1 - alpha) * img + alpha * np.asarray(color),
                       img)
        return (out * 255).astype(np.uint8)

    def trajectory_panel(self, size: int = 360) -> np.ndarray:
        """Top-down (x, z) trajectory plot of the train poses (and GT if
        present) — the GUI's ATE plot role, drawn dependency-free."""
        img = np.full((size, size, 3), 24, np.uint8)
        trajs = []
        if self.train_poses7 is not None and len(self.train_poses7):
            c2w = _pose7_to_centers(np.asarray(self.train_poses7))
            trajs.append((c2w, np.asarray([90, 200, 255])))
        if self.gt_poses_c2w is not None and len(self.gt_poses_c2w):
            trajs.append((np.asarray(self.gt_poses_c2w)[:, :3, 3],
                          np.asarray([120, 255, 120])))
        if not trajs:
            return img
        allpts = np.concatenate([t[0] for t in trajs])[:, [0, 2]]
        lo = allpts.min(axis=0)
        span = max(float((allpts.max(axis=0) - lo).max()), 1e-9)
        margin = 0.1 * size
        scale = (size - 2 * margin) / span
        for centers, color in trajs:
            pix = ((centers[:, [0, 2]] - lo) * scale + margin)
            pix = np.clip(pix, 0, size - 1).astype(int)
            for a, b in zip(pix[:-1], pix[1:]):
                _draw_line(img, a, b, color)
            for p in pix:
                img[max(p[1] - 1, 0): p[1] + 2,
                    max(p[0] - 1, 0): p[0] + 2] = color
        return img

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_model_dir(cls, model_path: str, iteration: int,
                       sh_degree: int = 3, max_per_tile: int = 1024,
                       resolution=(480, 320), device=None):
        """Load a trained checkpoint directory (render_tool layout:
        point_cloud/iteration_N/point_cloud.ply + pose/pose_N.npy) onto
        ``device``.

        Unlike the JAX viewer, it renders no probe views to size the entry
        stream: ``max_total_entries=None`` sizes each render's stream from
        its real per-tile counts, as the port's render tool does, so no
        entry is dropped."""
        from das3r_tpu_torch.eval.render_tool import load_gaussians_ply

        dev = resolve_device(device)
        ply_path = os.path.join(model_path, "point_cloud",
                                f"iteration_{iteration}", "point_cloud.ply")
        params, meta, conf = load_gaussians_ply(ply_path, sh_degree, dev)
        pose_path = os.path.join(model_path, "pose",
                                 f"pose_{iteration}.npy")
        train_poses7 = None
        if os.path.exists(pose_path):
            train_poses7 = w2c_to_pose(torch.as_tensor(
                np.load(pose_path), dtype=torch.float32)).numpy()
        w, h = resolution
        settings = RasterSettings(
            image_height=h, image_width=w, sh_degree=sh_degree,
            max_per_tile=max_per_tile, max_tiles_per_gaussian=32)
        return cls(params=params, meta=meta, settings=settings, conf=conf,
                   train_poses7=train_poses7, device=dev)


def _pose7_to_centers(pose7: np.ndarray) -> np.ndarray:
    """[F, 7] w2c (quat, t) -> camera centers in world frame."""
    w2c = pose_to_w2c(on_device(pose7, "cpu", torch.float32)).numpy()
    c2w = np.linalg.inv(w2c)
    return c2w[:, :3, 3]


def _draw_line(img: np.ndarray, a, b, color) -> None:
    n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]), 1))
    xs = np.linspace(a[0], b[0], n + 1).astype(int)
    ys = np.linspace(a[1], b[1], n + 1).astype(int)
    img[ys, xs] = color
