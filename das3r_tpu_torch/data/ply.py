"""Minimal binary-little-endian PLY I/O (replaces the ``plyfile`` dependency).

Two schemas:
  * generic xyz/normal/rgb point clouds (points3D.ply,
    reference dataset_readers.py:283-306);
  * the DAS3R Gaussian checkpoint schema with BOTH ``opacity_ori`` (raw
    logit) and ``opacity`` (logit of conf-modulated opacity) plus
    ``conf_static`` per Gaussian (reference gaussian_model.py:326-364,
    load_ply :371-418).
"""
from __future__ import annotations

import io
import os

import numpy as np


def _write_ply(path: str, names: list[str], columns: np.ndarray,
               dtypes: list[str] | None = None):
    n = columns.shape[0]
    dtypes = dtypes or ["f4"] * len(names)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _ply_map = {"f4": "float", "u1": "uchar"}
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}"]
        header += [f"property {_ply_map[d]} {nm}"
                   for nm, d in zip(names, dtypes)]
        header += ["end_header", ""]
        f.write("\n".join(header).encode("ascii"))
        rec = np.rec.fromarrays(
            [columns[:, i].astype(d) for i, d in enumerate(dtypes)],
            names=names)
        f.write(rec.tobytes())


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read a binary_little_endian or ascii PLY vertex element into a dict
    of per-property arrays."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header") + len(b"end_header")
    header = data[:end].decode("ascii").splitlines()
    body = data[end:].lstrip(b"\n")
    n = 0
    props: list[tuple[str, str]] = []
    fmt = "binary_little_endian"
    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4"}
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element" and parts[1] == "vertex":
            n = int(parts[2])
        elif parts[0] == "property" and parts[1] != "list":
            props.append((parts[2], type_map[parts[1]]))
    dtype = np.dtype([(nm, tp) for nm, tp in props])
    if fmt == "ascii":
        arr = np.loadtxt(io.StringIO(body.decode("ascii")), max_rows=n)
        arr = arr.reshape(n, len(props))
        return {nm: arr[:, i] for i, (nm, _) in enumerate(props)}
    rec = np.frombuffer(body, dtype=dtype, count=n)
    return {nm: np.asarray(rec[nm]) for nm, _ in props}


def write_point_cloud(path: str, xyz: np.ndarray, rgb_uint8: np.ndarray):
    """points3D.ply-style cloud (normals written as zeros)."""
    normals = np.zeros_like(xyz)
    cols = np.concatenate([xyz, normals, rgb_uint8], 1)
    _write_ply(path, ["x", "y", "z", "nx", "ny", "nz",
                      "red", "green", "blue"], cols,
               ["f4"] * 6 + ["u1"] * 3)


def read_point_cloud(path: str):
    d = read_ply(path)
    xyz = np.stack([d["x"], d["y"], d["z"]], -1)
    rgb = np.stack([d["red"], d["green"], d["blue"]], -1) / 255.0
    normals = (np.stack([d["nx"], d["ny"], d["nz"]], -1)
               if "nx" in d else np.zeros_like(xyz))
    return xyz, rgb, normals


def gaussian_attribute_names(n_rest: int) -> list[str]:
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * n_rest)]
    names += ["opacity_ori", "opacity", "conf_static"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def write_gaussians(path: str, *, xyz, f_dc, f_rest, opacity_logit,
                    conf_per_gaussian, scaling, rotation):
    """DAS3R dual-opacity schema (gaussian_model.save_ply :342-364).

    f_dc: [N, 1, 3]; f_rest: [N, R, 3] — flattened channel-major like the
    reference's transpose(1, 2).flatten(1).
    """
    n = xyz.shape[0]
    sig = 1.0 / (1.0 + np.exp(-opacity_logit.reshape(n)))
    mod = np.clip(sig * conf_per_gaussian.reshape(n), 1e-7, 1 - 1e-7)
    opacity_mod_logit = np.log(mod / (1 - mod))
    cols = np.concatenate([
        xyz, np.zeros_like(xyz),
        f_dc.transpose(0, 2, 1).reshape(n, -1),
        f_rest.transpose(0, 2, 1).reshape(n, -1),
        opacity_logit.reshape(n, 1),
        opacity_mod_logit.reshape(n, 1),
        conf_per_gaussian.reshape(n, 1),
        scaling, rotation], 1).astype(np.float32)
    _write_ply(path, gaussian_attribute_names(f_rest.shape[1]), cols)


def read_gaussians(path: str, max_sh_degree: int = 3):
    """Load the checkpoint back. Matches load_ply's behavior of restoring
    ``opacity_ori`` into the opacity parameter (reference :377-380) and
    returning ``conf_static`` separately for render_test."""
    d = read_ply(path)
    n = d["x"].shape[0]
    xyz = np.stack([d["x"], d["y"], d["z"]], -1)
    f_dc = np.stack([d["f_dc_0"], d["f_dc_1"], d["f_dc_2"]],
                    -1).reshape(n, 1, 3)
    n_rest = (max_sh_degree + 1) ** 2 - 1
    rest_names = sorted([k for k in d if k.startswith("f_rest_")],
                        key=lambda x: int(x.split("_")[-1]))
    if len(rest_names) != 3 * n_rest:
        raise ValueError(f"{path}: {len(rest_names)} f_rest columns, "
                         f"SH degree {max_sh_degree} needs {3 * n_rest}")
    f_rest = np.stack([d[k] for k in rest_names],
                      -1).reshape(n, 3, n_rest).transpose(0, 2, 1)
    scaling = np.stack([d[f"scale_{i}"] for i in range(3)], -1)
    rotation = np.stack([d[f"rot_{i}"] for i in range(4)], -1)
    return dict(
        xyz=xyz, f_dc=f_dc, f_rest=f_rest,
        opacity_logit=d["opacity_ori"].reshape(n, 1),
        opacity_modulated_logit=d["opacity"].reshape(n, 1),
        conf_static=d["conf_static"].reshape(n),
        scaling=scaling, rotation=rotation)
