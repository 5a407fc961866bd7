"""Stage-1 dataset zoo (port of ``das3r_tpu/predictor/dataset_zoo.py``,
numpy): the full DUSt3R/MonST3R-inherited loader set beyond the DAS3R
training recipe (reference
dynamic_predictor/dust3r/datasets/ — tartanair.py, spring_dataset.py,
waymo.py, scannetpp.py, staticthings3d.py, co3d.py, wildrgbd.py,
arkitscenes.py, blendedmvs.py, megadepth.py, habitat.py,
dynamic_replica.py).  Each dataset yields ``TwoViewClip`` samples exactly
like ``PointOdysseyDataset``; static datasets (no GT dynamic labels in
the reference either) carry all-zero dynamic masks.

Two on-disk conventions exist in the reference zoo and both are kept:

* **strided video clips** (TartanAir tartanair.py:85-102, Spring
  spring_dataset.py:88-110): enumerate ``(seq, i, i+stride)`` windows per
  stride with ``clip_step`` hops, then resample clip counts by the
  ``linear_1_2`` stride distribution (utils/misc.py:10-29).
* **precomputed pair lists** (Waymo waymo.py:29-36 pairs npz, ScanNet++
  scannetpp.py:25-33 all_metadata.npz, StaticThings3D
  staticthings3d.py:27-28 pairs npy).

Everything is host-side numpy (the device never sees file IO); batches
are formed by ``datasets.batch_iterator``.
"""
from __future__ import annotations

import glob
import os

# Must be set before the FIRST cv2 import anywhere in the process: several
# OpenCV builds read (and cache) this at import time.
os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")

import numpy as np

from das3r_tpu_torch.predictor.datasets import (TwoViewClip, center_crop_resize,
                                          depth_to_world_pts, imgnorm,
                                          resample_clips_by_stride)


def _imread_rgb(path):
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _imread_any(path):
    """EXR/16-bit-aware single-channel read (reference imread_cv2 with
    IMREAD_ANYDEPTH for depth maps)."""
    import cv2
    d = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_UNCHANGED)
    if d is None:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        if path.endswith(".exr"):
            raise RuntimeError(
                f"cv2.imread returned None for existing file {path}: this "
                "OpenCV build lacks the OpenEXR codec (or "
                "OPENCV_IO_ENABLE_OPENEXR was set after cv2 import)")
        raise RuntimeError(f"cv2.imread failed to decode {path}")
    if d.ndim == 3:
        d = d[..., 0]
    return d.astype(np.float32)


class _TwoViewZooDataset:
    """Shared view->clip assembly: subclasses provide ``_load_view(ref)``
    returning (rgb u8 HW3, depth HW f32, K 3x3, c2w 4x4)."""

    resolution = (512, 288)
    z_far = 80.0

    def _clip(self, ref1, ref2) -> TwoViewClip:
        views = []
        for ref in (ref1, ref2):
            rgb, dep, K, c2w = self._load_view(ref)
            rgb, dep, K = center_crop_resize(rgb, dep, np.asarray(K, float),
                                             self.resolution)
            pts, valid = depth_to_world_pts(dep, K, c2w, self.z_far)
            views.append((imgnorm(rgb), pts, valid, c2w))
        (i1, p1, v1, pose1), (i2, p2, v2, _) = views
        zero = np.zeros(v1.shape, np.float32)
        return TwoViewClip(img1=i1, img2=i2, gt_pts3d_1=p1, gt_pts3d_2=p2,
                           camera_pose_1=pose1.astype(np.float32),
                           valid_1=v1, valid_2=v2,
                           gt_mask_1=zero, gt_mask_2=zero)


class _StridedClipZooDataset(_TwoViewZooDataset):
    """Strided-video convention: subclasses fill ``self.clips`` with
    ``(seq_payload, i, j, stride)`` tuples via ``_index_sequences``."""

    def __init__(self, root, split, strides, clip_step, resolution,
                 dist_type, z_far, seed):
        self.resolution = resolution
        self.z_far = z_far
        self.clips = []
        self._index_sequences(root, split, strides, clip_step)
        self.clips = resample_clips_by_stride(self.clips, strides,
                                              dist_type, seed)

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, index):
        seq, i, j, _ = self.clips[index]
        return self._clip((seq, i), (seq, j))


class TartanAirDataset(_StridedClipZooDataset):
    """TartanAir (tartanair.py): ``{root}/{env}/{split}/{run}/image_left/
    %06d_left.png`` + ``depth_left/%06d_left_depth.npy`` +
    ``pose_left.txt`` rows ``x y z qx qy qz qw`` in the NED convention —
    the reference permutes (z,x,y) and (qz,qx,qy,qw)
    (tartanair.py:20-32); intrinsics are the fixed 640x480 pinhole
    fx=fy=320, cx=320, cy=240 (:106-115)."""

    def __init__(self, root, split="Hard", strides=(8,), clip_step=2,
                 resolution=(512, 288), dist_type=None, z_far=80.0,
                 seed=0):
        super().__init__(root, split, strides, clip_step, resolution,
                         dist_type, z_far, seed)

    def _index_sequences(self, root, split, strides, clip_step):
        for seq in sorted(glob.glob(os.path.join(root, "*/", split, "*/"))):
            n = len(os.listdir(os.path.join(seq, "image_left")))
            poses = np.loadtxt(os.path.join(seq, "pose_left.txt"))
            for stride in strides:
                for ii in range(0, n - 2 * stride + 1, clip_step):
                    self.clips.append(((seq, poses), ii, ii + stride,
                                       stride))

    @staticmethod
    def _ned_to_c2w(row):
        z, x, y = row[:3]
        qz, qx, qy, qw = row[3:7]
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.array([
            [1 - 2 * qy * qy - 2 * qz * qz, 2 * qx * qy - 2 * qz * qw,
             2 * qx * qz + 2 * qy * qw],
            [2 * qx * qy + 2 * qz * qw, 1 - 2 * qx * qx - 2 * qz * qz,
             2 * qy * qz - 2 * qx * qw],
            [2 * qx * qz - 2 * qy * qw, 2 * qy * qz + 2 * qx * qw,
             1 - 2 * qx * qx - 2 * qy * qy]], np.float32)
        c2w[:3, 3] = (x, y, z)
        return c2w

    def _load_view(self, ref):
        (seq, poses), i = ref
        rgb = _imread_rgb(os.path.join(seq, "image_left",
                                       f"{i:06d}_left.png"))
        dep = np.load(os.path.join(seq, "depth_left",
                                   f"{i:06d}_left_depth.npy"))
        K = np.array([[320.0, 0, 320.0], [0, 320.0, 240.0], [0, 0, 1]])
        return rgb, dep.astype(np.float32), K, self._ned_to_c2w(poses[i])


class SpringDataset(_StridedClipZooDataset):
    """Spring (spring_dataset.py): ``{root}/{split}/{seq}/frame_left/
    frame_left_%04d.png`` (1-indexed) + dsp5 HDF5 disparities
    (``disp1_left_%04d.dsp5``, key 'disparity', subsampled [::2, ::2]),
    depth = fx * 0.065 / disp (:18-29), ``cam_data/extrinsics.txt`` rows =
    flattened 4x4 world-to-cam (inverted to c2w, :163-164),
    ``cam_data/intrinsics.txt`` rows = fx fy cx cy."""

    BASELINE = 0.065

    def __init__(self, root, split="train", strides=(8,), clip_step=2,
                 resolution=(512, 288), dist_type=None, z_far=80.0,
                 seed=0, remove_seqs=()):
        self._remove = set(remove_seqs)
        super().__init__(root, split, strides, clip_step, resolution,
                         dist_type, z_far, seed)

    def _index_sequences(self, root, split, strides, clip_step):
        for seq in sorted(glob.glob(os.path.join(root, split, "*/"))):
            if os.path.basename(seq.rstrip("/")) in self._remove:
                continue
            n = len(os.listdir(os.path.join(seq, "frame_left")))
            extr = np.loadtxt(os.path.join(seq, "cam_data",
                                           "extrinsics.txt"))
            intr = np.loadtxt(os.path.join(seq, "cam_data",
                                           "intrinsics.txt"))
            for stride in strides:
                for ii in range(1, n - 2 * stride + 2, clip_step):
                    self.clips.append(((seq, extr, intr), ii, ii + stride,
                                       stride))

    def _load_view(self, ref):
        import h5py
        (seq, extr, intr), i = ref
        rgb = _imread_rgb(os.path.join(seq, "frame_left",
                                       f"frame_left_{i:04d}.png"))
        with h5py.File(os.path.join(seq, "disp1_left",
                                    f"disp1_left_{i:04d}.dsp5"), "r") as f:
            disp = np.asarray(f["disparity"], np.float32)
        fx, fy, cx, cy = intr[i - 1]
        with np.errstate(divide="ignore", invalid="ignore"):
            dep = (fx * self.BASELINE / disp)[::2, ::2]
        dep = np.where(np.isfinite(dep), dep, -1.0).astype(np.float32)
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        c2w = np.linalg.inv(extr[i - 1].reshape(4, 4)).astype(np.float32)
        return rgb, dep, K, c2w


class WaymoDataset(_TwoViewZooDataset):
    """Preprocessed Waymo (waymo.py): ``{root}/{pairs_npz}`` holding
    scenes / frames / pairs (scene_id, img1_id, img2_id); per frame
    ``{scene}/{frame}.jpg`` + ``.exr`` depth + ``.npz`` with 'intrinsics'
    and 'cam2world' (:44-60)."""

    def __init__(self, root, pairs_npz="waymo_pairs_video.npz",
                 resolution=(512, 288), z_far=80.0):
        self.root = root
        self.resolution = resolution
        self.z_far = z_far
        with np.load(os.path.join(root, pairs_npz)) as data:
            self.scenes = [str(s) for s in data["scenes"]]
            self.frames = [str(f) for f in data["frames"]]
            self.pairs = data["pairs"].astype(int)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, index):
        scene, a, b = self.pairs[index]
        seq = os.path.join(self.root, self.scenes[scene])
        return self._clip((seq, self.frames[a]), (seq, self.frames[b]))

    def _load_view(self, ref):
        seq, frame = ref
        base = os.path.join(seq, frame)
        rgb = _imread_rgb(base + ".jpg")
        dep = _imread_any(base + ".exr")
        cam = np.load(base + ".npz")
        return rgb, dep, np.float32(cam["intrinsics"]), \
            np.float32(cam["cam2world"])


class ScanNetppDataset(_TwoViewZooDataset):
    """Preprocessed ScanNet++ (scannetpp.py): ``all_metadata.npz`` with
    scenes / sceneids / images / intrinsics / trajectories / pairs; RGB at
    ``{scene}/images/{name}.jpg``, depth ``{scene}/depth/{name}.png`` in
    millimeters (:54-56)."""

    def __init__(self, root, resolution=(512, 288), z_far=80.0):
        self.root = root
        self.resolution = resolution
        self.z_far = z_far
        with np.load(os.path.join(root, "all_metadata.npz")) as data:
            self.scenes = [str(s) for s in data["scenes"]]
            self.sceneids = data["sceneids"]
            self.images = [str(s) for s in data["images"]]
            self.intrinsics = data["intrinsics"].astype(np.float32)
            self.trajectories = data["trajectories"].astype(np.float32)
            self.pairs = data["pairs"][:, :2].astype(int)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, index):
        a, b = self.pairs[index]
        return self._clip(a, b)

    def _load_view(self, view_idx):
        scene = os.path.join(self.root, self.scenes[self.sceneids[view_idx]])
        name = self.images[view_idx]
        rgb = _imread_rgb(os.path.join(scene, "images", name + ".jpg"))
        dep = _imread_any(os.path.join(scene, "depth", name + ".png"))
        dep = np.where(np.isfinite(dep), dep / 1000.0, 0.0)
        return rgb, dep.astype(np.float32), self.intrinsics[view_idx], \
            self.trajectories[view_idx]


class Co3dDataset(_TwoViewZooDataset):
    """Preprocessed CO3D-v2 (co3d.py): ``selected_seqs_{split}.json`` maps
    category -> {instance: [view pool]}; pairs are frame-index combinations
    (i, j) over the 100-frame orbit with 0 < |i-j| <= 30 and |i-j| % 5 == 0
    (:44-47). Per view: ``{obj}/{instance}/images/frame%06d.{jpg,npz}``
    (npz: camera_pose, camera_intrinsics, maximum_depth), depth
    ``depths/frame%06d.jpg.geometric.png`` u16/65535 * maximum_depth
    (:66-69), foreground mask ``masks/frame%06d.png`` multiplied into the
    depth when ``mask_bg`` (:113-120). The reference adds a +/-4 frame rng
    jitter and an invalid-image retry walk; this loader is deterministic
    (no jitter — the pool index pair is used as-is)."""

    def __init__(self, root, split="train", resolution=(512, 288),
                 z_far=80.0, mask_bg=True):
        import json
        self.root = root
        self.resolution = resolution
        self.z_far = z_far
        self.mask_bg = mask_bg
        with open(os.path.join(root, f"selected_seqs_{split}.json")) as f:
            scenes = json.load(f)
        self.scenes = {(k, k2): v2 for k, v in scenes.items()
                       for k2, v2 in v.items() if v2}
        self.scene_list = sorted(self.scenes.keys())
        self.combinations = [(i, j)
                             for i in range(100) for j in range(i + 1, 100)
                             if 0 < abs(i - j) <= 30 and abs(i - j) % 5 == 0]

    def __len__(self):
        return len(self.scene_list) * len(self.combinations)

    # path scheme hooks (overridden by WildRGBDDataset, wildrgbd.py:23-34)
    def _impath(self, obj, instance, idx):
        return os.path.join(self.root, obj, instance, "images",
                            f"frame{idx:06d}.jpg")

    def _metapath(self, obj, instance, idx):
        return os.path.join(self.root, obj, instance, "images",
                            f"frame{idx:06d}.npz")

    def _depthpath(self, obj, instance, idx):
        return os.path.join(self.root, obj, instance, "depths",
                            f"frame{idx:06d}.jpg.geometric.png")

    def _maskpath(self, obj, instance, idx):
        return os.path.join(self.root, obj, instance, "masks",
                            f"frame{idx:06d}.png")

    def _read_depth(self, path, meta):
        d = _imread_any(path)
        return d / 65535.0 * np.nan_to_num(float(meta["maximum_depth"]))

    def __getitem__(self, index):
        obj, instance = self.scene_list[index // len(self.combinations)]
        pool = self.scenes[obj, instance]
        i, j = self.combinations[index % len(self.combinations)]
        last = len(pool) - 1
        return self._clip((obj, instance, pool[min(i, last)]),
                          (obj, instance, pool[min(j, last)]))

    def _load_view(self, ref):
        obj, instance, idx = ref
        meta = np.load(self._metapath(obj, instance, idx))
        rgb = _imread_rgb(self._impath(obj, instance, idx))
        dep = self._read_depth(self._depthpath(obj, instance, idx), meta)
        if self.mask_bg:
            mask = _imread_any(self._maskpath(obj, instance, idx))
            dep = dep * ((mask / 255.0) > 0.1)
        return rgb, dep.astype(np.float32), \
            np.float32(meta["camera_intrinsics"]), \
            np.float32(meta["camera_pose"])


class WildRGBDDataset(Co3dDataset):
    """Preprocessed WildRGB-D (wildrgbd.py): CO3D layout with ``rgb/``,
    ``depth/`` (millimeters / 1000), ``masks/``, ``metadata/`` subdirs and
    %05d names."""

    def _impath(self, obj, instance, idx):
        return os.path.join(self.root, obj, instance, "rgb",
                            f"{idx:05d}.jpg")

    def _metapath(self, obj, instance, idx):
        return os.path.join(self.root, obj, instance, "metadata",
                            f"{idx:05d}.npz")

    def _depthpath(self, obj, instance, idx):
        return os.path.join(self.root, obj, instance, "depth",
                            f"{idx:05d}.png")

    def _maskpath(self, obj, instance, idx):
        return os.path.join(self.root, obj, instance, "masks",
                            f"{idx:05d}.png")

    def _read_depth(self, path, meta):
        return _imread_any(path) / 1000.0


class ARKitScenesDataset(_TwoViewZooDataset):
    """Preprocessed ARKitScenes (arkitscenes.py): ScanNet++-style
    ``{split}/all_metadata.npz`` (split dirs ``Training``/``Test``,
    :23-28); RGB at ``{scene}/vga_wide/{name .png->.jpg}``, depth
    ``{scene}/lowres_depth/{name}.png`` in millimeters (:57-62)."""

    SPLITS = {"train": "Training", "test": "Test"}

    def __init__(self, root, split="train", resolution=(512, 288),
                 z_far=80.0):
        self.root = root
        self.split = self.SPLITS[split]
        self.resolution = resolution
        self.z_far = z_far
        with np.load(os.path.join(root, self.split,
                                  "all_metadata.npz")) as data:
            self.scenes = [str(s) for s in data["scenes"]]
            self.sceneids = data["sceneids"]
            self.images = [str(s) for s in data["images"]]
            self.intrinsics = data["intrinsics"].astype(np.float32)
            self.trajectories = data["trajectories"].astype(np.float32)
            self.pairs = data["pairs"][:, :2].astype(int)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, index):
        a, b = self.pairs[index]
        return self._clip(a, b)

    def _load_view(self, view_idx):
        scene = os.path.join(self.root, self.split,
                             self.scenes[self.sceneids[view_idx]])
        name = self.images[view_idx]
        rgb = _imread_rgb(os.path.join(
            scene, "vga_wide", name.replace(".png", ".jpg")))
        dep = _imread_any(os.path.join(scene, "lowres_depth", name))
        dep = np.where(np.isfinite(dep), dep / 1000.0, 0.0)
        return rgb, dep.astype(np.float32), self.intrinsics[view_idx], \
            self.trajectories[view_idx]


class BlendedMVSDataset(_TwoViewZooDataset):
    """Preprocessed BlendedMVS (blendedmvs.py): ``blendedmvs_pairs.npy``
    structured rows (seq_high, seq_low, img1, img2, score); train keeps
    ``seq_low % 10 > 0``, val the rest (:28-35); scene dir name is
    ``f"{seqh:08x}{seql:016x}"`` (:49), files ``{idx:08d}.jpg`` + .exr +
    .npz with intrinsics / R_cam2world / t_cam2world (:55-64)."""

    def __init__(self, root, split=None, resolution=(512, 288), z_far=80.0):
        self.root = root
        self.resolution = resolution
        self.z_far = z_far
        pairs = np.load(os.path.join(root, "blendedmvs_pairs.npy"))
        if split == "train":
            pairs = pairs[pairs["seq_low"] % 10 > 0]
        elif split == "val":
            pairs = pairs[pairs["seq_low"] % 10 == 0]
        self.pairs = pairs

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, index):
        seqh, seql, img1, img2, _ = self.pairs[index]
        seq = os.path.join(self.root, f"{seqh:08x}{seql:016x}")
        return self._clip((seq, int(img1)), (seq, int(img2)))

    def _load_view(self, ref):
        seq, idx = ref
        base = os.path.join(seq, f"{idx:08d}")
        rgb = _imread_rgb(base + ".jpg")
        dep = _imread_any(base + ".exr")
        cam = np.load(base + ".npz")
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = cam["R_cam2world"]
        c2w[:3, 3] = cam["t_cam2world"]
        return rgb, dep, np.float32(cam["intrinsics"]), c2w


class MegaDepthDataset(_TwoViewZooDataset):
    """Preprocessed MegaDepth (megadepth.py): ``all_metadata.npz`` with
    scenes ("scene subscene" strings), images, pairs (scene_id, im1_id,
    im2_id, score); per view ``{scene}/{subscene}/{img}.{jpg,exr,npz}``
    (:65-84). train excludes scenes 0015/0022, val keeps them
    (:24-29)."""

    def __init__(self, root, split=None, resolution=(512, 288), z_far=80.0):
        self.root = root
        self.resolution = resolution
        self.z_far = z_far
        with np.load(os.path.join(root, "all_metadata.npz")) as data:
            self.all_scenes = [str(s) for s in data["scenes"]]
            self.all_images = [str(s) for s in data["images"]]
            self.pairs = data["pairs"]
        if split in ("train", "val"):
            val_ids = [i for i, s in enumerate(self.all_scenes)
                       if s.startswith(("0015", "0022"))]
            valid = np.isin(self.pairs["scene_id"], val_ids)
            self.pairs = self.pairs[valid if split == "val" else ~valid]

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, index):
        scene_id, im1, im2, _ = self.pairs[index]
        scene, subscene = self.all_scenes[scene_id].split()
        seq = os.path.join(self.root, scene, subscene)
        return self._clip((seq, self.all_images[im1]),
                          (seq, self.all_images[im2]))

    def _load_view(self, ref):
        seq, img = ref
        base = os.path.join(seq, img)
        rgb = _imread_rgb(base + ".jpg")
        dep = _imread_any(base + ".exr")
        cam = np.load(base + ".npz")
        return rgb, dep, np.float32(cam["intrinsics"]), \
            np.float32(cam["cam2world"])


class HabitatDataset(_TwoViewZooDataset):
    """Preprocessed Habitat renders (habitat.py): scene list from
    ``Habitat_{size}_scenes_{split}.txt``; each scene key has 5 views
    ``{key}_{i}.jpeg`` + ``{key}_{i}_depth.exr`` +
    ``{key}_{i}_camera_params.json`` (R_cam2world / t_cam2world /
    camera_intrinsics), 1-indexed (:61-77). View 0 is connected to views
    1-4 (:44); the reference picks the partner at random — here the pair
    index selects it deterministically (scene * 4 + k)."""

    def __init__(self, root, size, split="train", resolution=(512, 288),
                 z_far=80.0):
        self.root = root
        self.resolution = resolution
        self.z_far = z_far
        with open(os.path.join(root,
                               f"Habitat_{size}_scenes_{split}.txt")) as f:
            self.scenes = [s for s in f.read().splitlines() if s]

    def __len__(self):
        return len(self.scenes) * 4

    def __getitem__(self, index):
        scene = self.scenes[index // 4]
        partner = index % 4 + 1                       # views 1..4
        data_path, key = os.path.split(os.path.join(self.root, scene))
        return self._clip((data_path, key, 0), (data_path, key, partner))

    def _load_view(self, ref):
        import json
        data_path, key, i = ref
        base = os.path.join(data_path, f"{key}_{i + 1}")  # files 1-indexed
        rgb = _imread_rgb(base + ".jpeg")
        dep = _imread_any(base + "_depth.exr")
        with open(base + "_camera_params.json") as f:
            cam = json.load(f)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.float32(cam["R_cam2world"])
        c2w[:3, 3] = np.float32(cam["t_cam2world"])
        return rgb, dep, np.float32(cam["camera_intrinsics"]), c2w


def _load_f16_png_depth(path):
    """Dynamic Replica depth: 16-bit PNG whose u16 payload reinterprets as
    float16 (dynamic_replica.py:65-74)."""
    from PIL import Image
    with Image.open(path) as im:
        arr = np.array(im, dtype=np.uint16)
    return arr.view(np.float16).astype(np.float32).reshape(arr.shape)


def ndc_to_pixel_intrinsics(focal_ndc, pp_ndc, width, height,
                            intrinsics_format="ndc_isotropic"):
    """NDC -> pixel intrinsics (dynamic_replica.py:29-63)."""
    half = np.array([width, height]) / 2.0
    if intrinsics_format.lower() == "ndc_norm_image_bounds":
        rescale = half
    elif intrinsics_format.lower() == "ndc_isotropic":
        rescale = np.min(half)
    else:
        raise ValueError(f"Unknown intrinsics format: {intrinsics_format}")
    f = np.asarray(focal_ndc, float) * rescale
    pp = half - np.asarray(pp_ndc, float) * rescale
    return np.array([[f[0], 0, pp[0]], [0, f[1], pp[1]], [0, 0, 1]],
                    np.float32)


class DynamicReplicaDataset(_StridedClipZooDataset):
    """Dynamic Replica (dynamic_replica.py): clips indexed from
    ``frame_annotations_train.json`` grouped by sequence_name; per frame
    the annotation carries image/depth paths, NDC camera intrinsics and a
    world-to-cam R/T (pose inverted at :218-222); depth is the f16-in-u16
    PNG. Strided clips + the shared linear stride resampler."""

    def __init__(self, root, strides=(1, 2, 3, 4, 5, 6, 7, 8, 9),
                 clip_step=2, resolution=(512, 288), dist_type=None,
                 z_far=80.0, seed=0):
        self.root = root
        super().__init__(root, None, strides, clip_step, resolution,
                         dist_type, z_far, seed)

    def _index_sequences(self, root, split, strides, clip_step):
        import json
        with open(os.path.join(root,
                               "frame_annotations_train.json")) as f:
            anno = json.load(f)
        by_seq = {}
        for a in anno:
            by_seq.setdefault(a["sequence_name"], []).append(a)
        for seq in sorted(by_seq):
            frames = by_seq[seq]
            n = len(frames)
            for stride in strides:
                for ii in range(0, n - 2 * stride + 1, clip_step):
                    self.clips.append((frames, ii, ii + stride, stride))

    def _load_view(self, ref):
        frames, i = ref
        a = frames[i]
        rgb = _imread_rgb(os.path.join(self.root, a["image"]["path"]))
        dep = _load_f16_png_depth(os.path.join(self.root,
                                               a["depth"]["path"]))
        vp = a["viewpoint"]
        K = ndc_to_pixel_intrinsics(
            vp["focal_length"], vp["principal_point"],
            rgb.shape[1], rgb.shape[0],
            vp.get("intrinsics_format", "ndc_isotropic"))
        R = np.float32(vp["R"])
        t = np.float32(vp["T"])
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ t
        return rgb, dep, K, c2w


class StaticThings3DDataset(_TwoViewZooDataset):
    """StaticThings3D (staticthings3d.py): ``staticthings_pairs.npy``
    rows (scene, seq, cam1, im1, cam2, im2); frames under
    ``TRAIN/{scene}/{seq:04d}/{left|right}/{num:04d}_clean.jpg`` + .exr +
    .npz. ``mask_bg`` zeroes depths > 200 (:46-47) — deterministic here
    (True/False, no rng coin)."""

    def __init__(self, root, resolution=(512, 288), z_far=200.0,
                 mask_bg=True, variant="clean"):
        self.root = root
        self.resolution = resolution
        self.z_far = z_far
        self.mask_bg = mask_bg
        self.variant = variant
        self.pairs = np.load(os.path.join(root, "staticthings_pairs.npy"),
                             allow_pickle=True)

    def __len__(self):
        return len(self.pairs)

    @staticmethod
    def _cam_name(c):
        c = c.decode("ascii") if isinstance(c, bytes) else str(c)
        return {"l": "left", "r": "right"}.get(c, c)

    def __getitem__(self, index):
        scene, seq, cam1, im1, cam2, im2 = self.pairs[index]
        scene = scene.decode("ascii") if isinstance(scene, bytes) \
            else str(scene)
        seq_path = os.path.join(self.root, "TRAIN", scene, f"{int(seq):04d}")
        return self._clip((seq_path, self._cam_name(cam1), int(im1)),
                          (seq_path, self._cam_name(cam2), int(im2)))

    def _load_view(self, ref):
        seq_path, cam, idx = ref
        base = os.path.join(seq_path, cam, f"{idx:04d}")
        rgb = _imread_rgb(f"{base}_{self.variant}.jpg")
        dep = _imread_any(base + ".exr")
        if self.mask_bg:
            dep = np.where(dep > 200.0, 0.0, dep)
        cam_np = np.load(base + ".npz")
        return rgb, dep, np.float32(cam_np["intrinsics"]), \
            np.float32(cam_np["cam2world"])
