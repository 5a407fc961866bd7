"""Stage-1 training datasets: two-view clips with GT pointmaps and dynamic
masks (port of ``das3r_tpu/predictor/datasets.py``; numpy, each sample
and batch bitwise the JAX package's; tensors are made at the step).

Re-implements the reference's dataset layer (dynamic_predictor/dust3r/
datasets/): ``PointOdysseyDataset`` reads the exact on-disk layout
(pointodyssey.py:125-140: rgbs/rgb_%05d.jpg, depths/depth_%05d.png 16-bit *
1000/65535, trajs_3d/, extrinsics/ cams_T_world, intrinsics/), derives the
GT dynamic mask from 3D-trajectory motion splatted onto the pixel grid with
nearest-neighbor lookup (:217, :364-371), and resamples clip strides by the
``linear_1_2`` distribution (utils/misc.py:10-29). ``SyntheticTwoViewDataset``
provides a hermetic in-memory stand-in for tests.

The eval()-able dataset strings of the reference (``"10_000 @ PointOdyssey
(...)"``)) are replaced by explicit constructors + ``RepeatedDataset`` /
``ConcatDataset`` combinators and a seeded batch iterator.
"""
from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from das3r_tpu_torch.predictor.losses import Stage1Batch


def resample_clips_by_stride(clips, strides, dist_type, seed=0):
    """Stride rebalancing shared by every strided-clip dataset.

    Reference formula (tartanair.py:164-174 == pointodyssey.py:164-174 +
    utils/misc.py:10-29 ``get_stride_distribution``): weights
    ``w = linspace(start, end, len(strides))`` normalized by ``max(w)``;
    the base pool size is the clip count of the stride with the LARGEST
    weight; each stride keeps ``min(len(pool), int(w_i * base))`` clips,
    sampled without replacement. Clips are ``(..., stride)`` tuples —
    the stride is the last element."""
    if not clips or len(strides) <= 1 or dist_type is None:
        return clips
    start, end = map(float, dist_type.split("_")[1:])
    dist = np.linspace(start, end, len(strides))
    dist = dist / dist.max()
    rng = np.random.default_rng(seed)
    by_stride = {s: [c for c in clips if c[-1] == s] for s in strides}
    base = len(by_stride[strides[int(np.argmax(dist))]])
    out = []
    for s, frac in zip(strides, dist):
        pool = by_stride[s]
        want = min(len(pool), int(frac * base))
        idx = rng.choice(len(pool), want, replace=False)
        out.extend(pool[i] for i in idx)
    return out


@dataclasses.dataclass
class TwoViewClip:
    """One training sample (numpy, unbatched)."""
    img1: np.ndarray           # [3, H, W] ImgNorm'ed
    img2: np.ndarray
    gt_pts3d_1: np.ndarray     # [H, W, 3] world frame
    gt_pts3d_2: np.ndarray
    camera_pose_1: np.ndarray  # [4, 4] cam-to-world of view 1
    valid_1: np.ndarray        # [H, W] bool
    valid_2: np.ndarray
    gt_mask_1: np.ndarray      # [H, W] {0,1}
    gt_mask_2: np.ndarray


def center_crop_resize(img_hw3, depth, K, resolution):
    """Resize (preserving aspect, covering) + center crop to ``resolution``
    (W, H) with intrinsics update — the deterministic variant of
    base/_crop_resize_if_necessary."""
    import cv2
    W, H = resolution
    h, w = depth.shape
    scale = max(W / w, H / h)
    nw, nh = round(w * scale), round(h * scale)
    img = cv2.resize(img_hw3, (nw, nh), interpolation=cv2.INTER_LINEAR)
    dep = cv2.resize(depth, (nw, nh), interpolation=cv2.INTER_NEAREST)
    K = K.copy()
    K[0] *= scale
    K[1] *= scale
    x0 = (nw - W) // 2
    y0 = (nh - H) // 2
    K[0, 2] -= x0
    K[1, 2] -= y0
    return img[y0:y0 + H, x0:x0 + W], dep[y0:y0 + H, x0:x0 + W], K


def depth_to_world_pts(depth, K, c2w, z_far=80.0):
    h, w = depth.shape
    xx, yy = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    z = depth
    x = z * (xx - K[0, 2]) / K[0, 0]
    y = z * (yy - K[1, 2]) / K[1, 1]
    cam = np.stack([x, y, z], -1)
    world = cam @ c2w[:3, :3].T + c2w[:3, 3]
    valid = (z > 0) & (z < z_far) & np.isfinite(world).all(-1)
    return world.astype(np.float32), valid


def imgnorm(img_hw3_uint8):
    x = img_hw3_uint8.astype(np.float32) / 255.0
    return ((x - 0.5) / 0.5).transpose(2, 0, 1)


class PointOdysseyDataset:
    """Two-frame clips from a PointOdyssey-format tree."""

    def __init__(self, root: str, split: str = "train",
                 strides=(1, 2, 3, 4, 5, 6, 7, 8, 9), clip_step: int = 2,
                 resolution=(512, 288), dist_type: str | None = "linear_1_2",
                 z_far: float = 80.0, seed: int = 0):
        self.resolution = resolution
        self.z_far = z_far
        self.clips: list[tuple[str, int, int, int]] = []  # seq, i, j
        base = os.path.join(root, split)
        for seq in sorted(glob.glob(os.path.join(base, "*/"))):
            rgbs = sorted(glob.glob(os.path.join(seq, "rgbs", "rgb_*.jpg")))
            n = len(rgbs)
            if n == 0 or not os.path.isdir(os.path.join(seq, "trajs_3d")):
                continue
            for stride in strides:
                for ii in range(0, n - 2 * stride + 1, clip_step):
                    self.clips.append((seq, ii, ii + stride, stride))
        self.clips = resample_clips_by_stride(self.clips, strides,
                                              dist_type, seed)

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, index: int) -> TwoViewClip:
        import cv2
        from scipy.interpolate import griddata
        seq, i, j, _ = self.clips[index]

        def load(frame):
            rgb = cv2.cvtColor(
                cv2.imread(os.path.join(seq, "rgbs", f"rgb_{frame:05d}.jpg")),
                cv2.COLOR_BGR2RGB)
            d16 = cv2.imread(os.path.join(seq, "depths",
                                          f"depth_{frame:05d}.png"),
                             cv2.IMREAD_ANYDEPTH)
            depth = d16.astype(np.float32) / 65535.0 * 1000.0
            K = np.load(os.path.join(seq, "intrinsics",
                                     f"intrinsic_{frame:05d}.npy"))
            ext = np.load(os.path.join(seq, "extrinsics",
                                       f"extrinsic_{frame:05d}.npy"))
            R, t = ext[:3, :3], ext[:3, 3]
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3] = R.T
            c2w[:3, 3] = -R.T @ t
            traj = np.load(os.path.join(seq, "trajs_3d",
                                        f"traj_3d_{frame:05d}.npy"))
            return rgb, depth, K.astype(np.float64), c2w, traj

        rgb1, dep1, K1, c2w1, traj1 = load(i)
        rgb2, dep2, K2, c2w2, traj2 = load(j)
        motion_3d = ((traj1 == traj2).sum(axis=1) != 3).astype(np.float32)

        views = []
        for rgb, dep, K, c2w in ((rgb1, dep1, K1, c2w1),
                                 (rgb2, dep2, K2, c2w2)):
            rgb, dep, K = center_crop_resize(rgb, dep, K, self.resolution)
            pts, valid = depth_to_world_pts(dep, K, c2w, self.z_far)
            flat = pts.reshape(-1, 3).copy()
            flat[~valid.reshape(-1)] = 0
            try:
                mm = griddata(traj1, motion_3d, flat, method="nearest",
                              fill_value=0).astype(np.float32)
            except Exception:
                mm = np.zeros(flat.shape[0], np.float32)
            views.append((imgnorm(rgb), pts, valid,
                          np.clip(mm, 0, 1).reshape(valid.shape), c2w))

        (i1, p1, v1, m1, pose1), (i2, p2, v2, m2, _) = views
        return TwoViewClip(img1=i1, img2=i2, gt_pts3d_1=p1, gt_pts3d_2=p2,
                           camera_pose_1=pose1.astype(np.float32),
                           valid_1=v1, valid_2=v2, gt_mask_1=m1,
                           gt_mask_2=m2)


class SyntheticTwoViewDataset:
    """Hermetic random two-view scenes for tests/smoke training."""

    def __init__(self, n: int = 64, resolution=(64, 48), seed: int = 0):
        self.n = n
        self.resolution = resolution
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, index: int) -> TwoViewClip:
        rng = np.random.default_rng(self.seed * 100003 + index)
        W, H = self.resolution
        img = lambda: ((rng.uniform(0, 1, (H, W, 3)) * 255)
                       .astype(np.uint8))
        depth = 3.0 + rng.uniform(0, 2, (H, W)).astype(np.float32)
        K = np.asarray([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2],
                        [0, 0, 1.0]])
        c2w1 = np.eye(4, dtype=np.float32)
        c2w2 = np.eye(4, dtype=np.float32)
        c2w2[:3, 3] = rng.normal(0, 0.1, 3)
        p1, v1 = depth_to_world_pts(depth, K, c2w1)
        p2, v2 = depth_to_world_pts(depth, K, c2w2)
        mask = (rng.uniform(0, 1, (H, W)) > 0.85).astype(np.float32)
        return TwoViewClip(img1=imgnorm(img()), img2=imgnorm(img()),
                           gt_pts3d_1=p1, gt_pts3d_2=p2,
                           camera_pose_1=c2w1, valid_1=v1, valid_2=v2,
                           gt_mask_1=mask, gt_mask_2=mask)


class WallTwoViewDataset:
    """Two-view clips ray-traced from the same wall + red-square world as
    ``data.synthetic.make_synthetic_stage1_dir`` — a LEARNABLE mask-head
    training set: the dynamic mask is the red square,
    predictable from image content, unlike ``SyntheticTwoViewDataset``'s
    pure-noise masks (whose best achievable IoU is chance). Training the
    TINY model here and running quality_e2e --stage1 predictor closes the
    loop with non-meaningless numbers (same image distribution).

    GT pts3d/validity and the camera pose come from the exact ray-traced
    depth, so the Regr3D term is meaningful too; per-view squares sit at
    different positions (the object "moves" between the views)."""

    def __init__(self, n: int = 64, resolution=(64, 48), seed: int = 0):
        self.n = n
        self.resolution = resolution
        self.seed = seed

    def __len__(self):
        return self.n

    def _view(self, rng, W, H, focal, cam_t):
        from das3r_tpu_torch.data.synthetic import render_wall_view
        sz = max(4, int(H * rng.uniform(0.15, 0.3)))
        x0 = int(rng.uniform(0, W - sz))
        y0 = int(rng.uniform(0, H - sz))
        img, depth, dyn = render_wall_view(
            cam_t, H, W, focal, square_xy=(x0, y0), square_size=sz)
        return img, depth, dyn

    def __getitem__(self, index: int) -> TwoViewClip:
        rng = np.random.default_rng(self.seed * 100003 + index)
        W, H = self.resolution
        focal = 0.9 * W
        K = np.asarray([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]])
        t1 = rng.normal(0, 0.15, 3)
        t2 = t1 + rng.normal(0, 0.08, 3)
        c2w1 = np.eye(4, dtype=np.float32)
        c2w1[:3, 3] = t1
        c2w2 = np.eye(4, dtype=np.float32)
        c2w2[:3, 3] = t2
        img1, d1, m1 = self._view(rng, W, H, focal, t1)
        img2, d2, m2 = self._view(rng, W, H, focal, t2)
        p1, v1 = depth_to_world_pts(d1, K, c2w1)
        p2, v2 = depth_to_world_pts(d2, K, c2w2)
        to_u8 = lambda im: (im * 255).astype(np.uint8)  # noqa: E731
        return TwoViewClip(img1=imgnorm(to_u8(img1)),
                           img2=imgnorm(to_u8(img2)),
                           gt_pts3d_1=p1, gt_pts3d_2=p2,
                           camera_pose_1=c2w1, valid_1=v1, valid_2=v2,
                           gt_mask_1=m1.astype(np.float32),
                           gt_mask_2=m2.astype(np.float32))


class RepeatedDataset:
    """``n @ dataset`` combinator: n samples drawn round-robin."""

    def __init__(self, dataset, n: int):
        self.dataset = dataset
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.dataset[i % len(self.dataset)]


class ConcatDataset:
    def __init__(self, *datasets):
        self.datasets = datasets
        self.cum = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, i):
        d = int(np.searchsorted(self.cum, i, side="right"))
        prev = 0 if d == 0 else int(self.cum[d - 1])
        return self.datasets[d][i - prev]


def batch_iterator(dataset, batch_size: int, seed: int = 0,
                   shuffle: bool = True, drop_last: bool = True,
                   rank: int = 0, ranks: int = 1):
    """Yield (img1 [B,3,H,W], img2, Stage1Batch) numpy batches.

    With ``ranks`` > 1 (the data axis of a mesh), each global batch of
    ``batch_size`` is split as JAX's ``P("data")`` splits it: rank ``r``
    gets rows ``[r B/R, (r+1) B/R)`` and renders only those samples. A
    batch whose size the ranks do not divide raises, as JAX's sharding
    does; nothing is padded."""
    order = np.arange(len(dataset))
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(order)
    end = (len(order) // batch_size * batch_size if drop_last
           else len(order))
    for s in range(0, end, batch_size):
        rows = order[s:s + batch_size]
        if len(rows) % ranks:
            raise ValueError(f"a batch of {len(rows)} does not split over "
                             f"{ranks} data ranks")
        n = len(rows) // ranks
        clips = [dataset[int(i)] for i in rows[rank * n:(rank + 1) * n]]
        stack = lambda attr: np.stack([getattr(c, attr) for c in clips])
        yield (stack("img1"), stack("img2"), Stage1Batch(
            gt_pts3d_1=stack("gt_pts3d_1"), gt_pts3d_2=stack("gt_pts3d_2"),
            camera_pose_1=stack("camera_pose_1"),
            valid_1=stack("valid_1"), valid_2=stack("valid_2"),
            gt_mask_1=stack("gt_mask_1"), gt_mask_2=stack("gt_mask_2")))
