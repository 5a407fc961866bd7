"""Camera-path generation & interpolation for novel-view video rendering.

Port of ``das3r_tpu/utils/camera_paths.py``: the same numpy code, on
the port's ``data/colmap.py`` and ``utils/stepfun.py``.

Covers the reference's path tooling surface: pose interpolation between
training cameras (render.py's ``pose_interpolated`` input / utils/
camera_utils.py:136-229), an orbit camera for interactive viewing
(utils/gui_utils.py:65-151), and an ellipse path fitted to the training
trajectory with constant-speed resampling (utils/pose_utils.py:302-569 +
utils/stepfun.py, simplified to the parts the pipeline can consume).
"""
from __future__ import annotations

import numpy as np

from das3r_tpu_torch.data.colmap import qvec2rotmat, rotmat2qvec


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical interpolation of wxyz quaternions."""
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def interpolate_poses(poses: np.ndarray, factor: int = 4) -> np.ndarray:
    """[F, 4, 4] -> [(F-1)*factor + 1, 4, 4] with slerp rotation + lerp
    translation between consecutive poses."""
    out = []
    for i in range(len(poses) - 1):
        q0 = rotmat2qvec(poses[i, :3, :3])
        q1 = rotmat2qvec(poses[i + 1, :3, :3])
        for k in range(factor):
            t = k / factor
            m = np.eye(4)
            m[:3, :3] = qvec2rotmat(slerp(q0, q1, t))
            m[:3, 3] = (1 - t) * poses[i, :3, 3] + t * poses[i + 1, :3, 3]
            out.append(m)
    out.append(poses[-1].copy())
    return np.stack(out)


def resample_const_speed(positions: np.ndarray, n_out: int) -> np.ndarray:
    """Arc-length (constant-speed) resampling of a polyline [N, d] — the
    role stepfun.sample plays in the ellipse path (pose_utils.py:345)."""
    seg = np.linalg.norm(np.diff(positions, axis=0), axis=1)
    cum = np.concatenate([[0], np.cumsum(seg)])
    total = cum[-1]
    targets = np.linspace(0, total, n_out)
    idx = np.clip(np.searchsorted(cum, targets) - 1, 0, len(seg) - 1)
    t = (targets - cum[idx]) / np.maximum(seg[idx], 1e-12)
    return positions[idx] * (1 - t[:, None]) + positions[idx + 1] * t[:, None]


def look_at(position: np.ndarray, target: np.ndarray,
            up=np.asarray([0.0, -1.0, 0.0])) -> np.ndarray:
    """c2w matrix looking from position toward target (OpenCV convention:
    +z forward)."""
    fwd = target - position
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = down
    m[:3, 2] = fwd
    m[:3, 3] = position
    return m


def ellipse_path(poses: np.ndarray, n_frames: int = 120,
                 z_offset: float = 0.0) -> np.ndarray:
    """Elliptical orbit fitted to the xy-extent of the camera centers,
    looking at their centroid (simplified pose_utils.generate_ellipse_path
    with constant-speed resampling)."""
    centers = poses[:, :3, 3]
    centroid = centers.mean(0)
    radii = (np.percentile(np.abs(centers - centroid), 90, axis=0)
             .clip(1e-3))
    theta = np.linspace(0, 2 * np.pi, 4 * n_frames)
    pts = np.stack([
        centroid[0] + radii[0] * np.cos(theta),
        centroid[1] + radii[1] * np.sin(theta),
        np.full_like(theta, centroid[2] + z_offset)], -1)
    from das3r_tpu_torch.utils import stepfun
    pts = stepfun.resample_const_speed_stepfun(pts, n_frames)
    return np.stack([look_at(p, centroid) for p in pts])


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def _viewmatrix_gl(lookdir, up, position) -> np.ndarray:
    """mip-NeRF lookat frame (pose_utils.viewmatrix :221-227): columns
    (right, up', lookdir) — OpenGL-ish axes (+z away from the target)."""
    vec2 = _normalize(lookdir)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def _cv_to_gl(c2w: np.ndarray) -> np.ndarray:
    g = c2w.copy()
    g[:, :3, 1:3] *= -1
    return g


def _gl_to_cv(g: np.ndarray) -> np.ndarray:
    return _cv_to_gl(g)          # the flip is an involution


def _poses_avg_gl(poses: np.ndarray) -> np.ndarray:
    position = poses[:, :3, 3].mean(0)
    z_axis = poses[:, :3, 2].mean(0)
    up = poses[:, :3, 1].mean(0)
    return _viewmatrix_gl(z_axis, up, position)


def spiral_path(poses: np.ndarray, bounds=(1.0, 100.0), n_frames: int = 180,
                n_rots: int = 2, zrate: float = 0.5) -> np.ndarray:
    """Forward-facing spiral around the average camera
    (pose_utils.generate_spiral_path :369-414, LLFF recipe).

    ``poses``: [F, 4, 4] OpenCV c2w (our convention — the reference takes
    the COLMAP poses_bounds blob; the internal math is identical after the
    axis flip). ``bounds``: scene (near, far) depth bounds, per-frame
    [F, 2] or one pair. Returns [n_frames, 4, 4] OpenCV c2w."""
    g = _cv_to_gl(np.asarray(poses, np.float64))
    b = np.asarray(bounds, np.float64).reshape(-1, 2)

    cam2world = _poses_avg_gl(g)
    up = g[:, :3, 1].mean(0)

    close_depth, inf_depth = b.min() * 0.9, b.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1 - dt) / close_depth + dt / inf_depth)

    # radii from the 90th percentile of positions about the average camera
    positions = g[:, :3, 3] - cam2world[:3, 3]
    radii = np.percentile(np.abs(positions), 90, 0)
    radii = np.concatenate([radii, [1.0]])

    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames,
                             endpoint=False):
        t = radii * [np.cos(theta), -np.sin(theta),
                     -np.sin(theta * zrate), 1.0]
        position = np.concatenate([cam2world[:3, :4] @ t, [1.0]])[:3]
        lookat = cam2world[:3, :4] @ np.asarray([0, 0, -focal, 1.0])
        z_axis = position - lookat
        m = np.eye(4)
        m[:3] = _viewmatrix_gl(z_axis, up, position)
        out.append(m)
    return _gl_to_cv(np.stack(out)).astype(np.float32)


def bspline_path(poses: np.ndarray, n_interp: int = 10,
                 spline_degree: int = 5, smoothness: float = 0.03,
                 rot_weight: float = 0.1, const_speed: bool = False,
                 n_interp_as_total: bool = False) -> np.ndarray:
    """Smooth B-spline through keyframe cameras
    (pose_utils.generate_interpolated_path :419-569, core options).

    Each pose becomes a (position, lookat-point, up-point) triple spaced
    ``rot_weight`` apart, the 9-D point track is fit with a smoothing
    B-spline (scipy splprep, degree ``spline_degree``, smoothing
    ``smoothness``), and poses are rebuilt from the interpolated triples.
    ``poses``: [F, 4, 4] OpenCV c2w. Returns [n_interp * (F - 1), 4, 4]
    (or [n_interp, 4, 4] with ``n_interp_as_total``)."""
    import scipy.interpolate

    g = _cv_to_gl(np.asarray(poses, np.float64))

    def poses_to_points(p, dist):
        pos = p[:, :3, 3]
        lookat = p[:, :3, 3] - dist * p[:, :3, 2]
        up = p[:, :3, 3] + dist * p[:, :3, 1]
        return np.stack([pos, lookat, up], 1)           # [F, 3, 3]

    def points_to_poses(points):
        out = []
        for pos, lookat_point, up_point in points:
            m = np.eye(4)
            m[:3] = _viewmatrix_gl(pos - lookat_point, up_point - pos, pos)
            out.append(m)
        return np.stack(out)

    def interp(points, u, k, s):
        sh = points.shape
        pts = points.reshape(sh[0], -1)
        k = min(k, sh[0] - 1)
        tck, u_keyframes = scipy.interpolate.splprep(pts.T, k=k, s=s)
        new_points = np.array(scipy.interpolate.splev(u, tck))
        return new_points.T.reshape(len(u), sh[1], sh[2]), u_keyframes

    points = poses_to_points(g, dist=rot_weight)
    if n_interp_as_total:
        n_frames = n_interp + 1        # final pose is discarded below
    else:
        n_frames = n_interp * (points.shape[0] - 1)
    u = np.linspace(0, 1, n_frames, endpoint=True)
    new_points, _ = interp(points, u, spline_degree, smoothness)
    out = points_to_poses(new_points)
    if const_speed:
        pos = out[:, :3, 3]
        lengths = np.linalg.norm(np.diff(pos, axis=0), axis=1)
        from das3r_tpu_torch.utils import stepfun
        u = stepfun.sample_np(None, u, np.log(np.maximum(lengths, 1e-12)),
                              n_frames + 1)
        new_points, _ = interp(points, u, spline_degree, smoothness)
        out = points_to_poses(new_points)
    return _gl_to_cv(out[:-1]).astype(np.float32)


class OrbitCamera:
    """Interactive orbit camera (utils/gui_utils.py:65-151): yaw/pitch
    orbit, pan, dolly; exposes the c2w pose and intrinsics."""

    def __init__(self, width: int, height: int, radius: float = 2.0,
                 fovy_deg: float = 60.0):
        self.W = width
        self.H = height
        self.radius = radius
        self.fovy = np.deg2rad(fovy_deg)
        self.center = np.zeros(3)
        self.yaw = 0.0
        self.pitch = 0.0

    def orbit(self, dx: float, dy: float):
        self.yaw += 0.005 * dx
        self.pitch = float(np.clip(self.pitch + 0.005 * dy,
                                   -np.pi / 2 + 1e-3, np.pi / 2 - 1e-3))

    def scale(self, delta: float):
        self.radius = float(np.clip(self.radius * (1.1 ** -delta),
                                    1e-3, 1e6))

    def pan(self, dx: float, dy: float, dz: float = 0.0):
        R = self.pose[:3, :3]
        self.center = self.center + 1e-3 * self.radius * (
            R @ np.asarray([-dx, -dy, dz]))

    @property
    def pose(self) -> np.ndarray:
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        position = self.center + self.radius * np.asarray(
            [cp * sy, -sp, -cp * cy])
        return look_at(position, self.center)

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.H / (2 * np.tan(self.fovy / 2))
        return np.asarray([focal, focal, self.W / 2, self.H / 2])
