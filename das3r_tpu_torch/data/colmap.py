"""COLMAP text-format I/O (cameras.txt / images.txt / points3D.txt).

Covers what the DAS3R pipeline actually uses: the rearrange bridge WRITES
per-frame PINHOLE cameras + poses (reference utils/dust3r_utils.py:210-232,
utils/rearrange.py:94-100) and the stage-2 reader PARSES them back
(scene/colmap_loader.py: read_intrinsics_text / read_extrinsics_text).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # PINHOLE: fx fy cx cy; SIMPLE_PINHOLE: f cx cy

    @property
    def focal_xy(self) -> tuple[float, float]:
        if self.model == "SIMPLE_PINHOLE":
            return float(self.params[0]), float(self.params[0])
        return float(self.params[0]), float(self.params[1])


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray   # wxyz, world-to-camera
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion (COLMAP convention)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1],
         R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    if q[0] < 0:
        q = -q
    return q


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam = ColmapCamera(
                id=int(parts[0]), model=parts[1], width=int(parts[2]),
                height=int(parts[3]),
                params=np.asarray([float(p) for p in parts[4:]]))
            cams[cam.id] = cam
    return cams


def read_images_text(path: str) -> dict[int, ColmapImage]:
    """images.txt has two lines per image; the second (2D points) may be
    empty and is ignored."""
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.strip().startswith("#")]
    i = 0
    while i < len(lines):
        parts = lines[i].split()
        img = ColmapImage(
            id=int(parts[0]),
            qvec=np.asarray([float(p) for p in parts[1:5]]),
            tvec=np.asarray([float(p) for p in parts[5:8]]),
            camera_id=int(parts[8]),
            name=parts[9])
        images[img.id] = img
        # the next line is the (possibly empty) POINTS2D line; we detect it
        # by it NOT looking like an image header (10 fields with a filename)
        if i + 1 < len(lines):
            nxt = lines[i + 1].split()
            looks_like_header = (len(nxt) == 10
                                 and not nxt[-1].replace(".", "").isdigit())
            i += 1 if looks_like_header else 2
        else:
            i += 1
    return images


def write_cameras_text(path: str, sizes_wh, intrinsics: np.ndarray):
    """One PINHOLE camera per frame from [F, 3, 3] K (rearrange bridge)."""
    w, h = sizes_wh
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for i, K in enumerate(intrinsics):
            f.write(f"{i + 1} PINHOLE {w} {h} "
                    f"{K[0, 0]} {K[1, 1]} {K[0, 2]} {K[1, 2]}\n")


def write_images_text(path: str, poses_c2w: np.ndarray, names):
    """Write world-to-camera extrinsics from c2w poses + image names."""
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for i, (c2w, name) in enumerate(zip(poses_c2w, names)):
            w2c = np.linalg.inv(c2w)
            q = rotmat2qvec(w2c[:3, :3])
            t = w2c[:3, 3]
            f.write(f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]} {i + 1} {os.path.basename(name)}\n")
            f.write("\n")


def read_points3d_binary(path: str):
    """sparse/0/points3D.bin -> (xyz [N,3], rgb [N,3] uint8, err [N])
    (scene/colmap_loader.py read_points3D_binary)."""
    import struct
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        for i in range(n):
            data = struct.unpack("<QdddBBBd", f.read(43))
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            track_len = struct.unpack("<Q", f.read(8))[0]
            f.read(8 * track_len)
    return xyz, rgb, err


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            xyz.append([float(x) for x in p[1:4]])
            rgb.append([int(x) for x in p[4:7]])
            err.append(float(p[7]))
    return (np.asarray(xyz), np.asarray(rgb, np.uint8), np.asarray(err))


def read_extrinsics_binary(path: str) -> dict[int, "ColmapImage"]:
    """sparse/0/images.bin (scene/colmap_loader.py read_extrinsics_binary)."""
    import struct
    images = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            d = struct.unpack("<idddddddi", f.read(64))
            image_id, qw, qx, qy, qz, tx, ty, tz, cam_id = d
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            n2d = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * n2d)
            images[image_id] = ColmapImage(
                id=image_id, qvec=np.asarray([qw, qx, qy, qz]),
                tvec=np.asarray([tx, ty, tz]), camera_id=cam_id,
                name=name.decode("utf-8"))
    return images


def read_cameras_binary(path: str) -> dict[int, "ColmapCamera"]:
    """sparse/0/cameras.bin (scene/colmap_loader.py)."""
    import struct
    model_info = {0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4),
                  2: ("SIMPLE_RADIAL", 4), 3: ("RADIAL", 5),
                  4: ("OPENCV", 8)}
    cams = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n_params = model_info[model_id]
            params = struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            cams[cam_id] = ColmapCamera(id=cam_id, model=name, width=w,
                                        height=h,
                                        params=np.asarray(params))
    return cams
