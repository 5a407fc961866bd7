"""PyTorch port: maths utilities against the JAX package, the port's
import hygiene, and its no-silent-CPU device rule."""
import ast
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.utils import quat as jquat
from das3r_tpu.utils import sh as jsh
from das3r_tpu.utils import transforms as jtf
from das3r_tpu_torch.utils import quat as tquat
from das3r_tpu_torch.utils import sh as tsh
from das3r_tpu_torch.utils import transforms as ttf
from das3r_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)
ATOL = 1e-6
ROOT = Path(__file__).resolve().parents[1]


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    n = 257
    coeffs = rng.normal(size=(n, 3, 25)).astype(np.float32)
    dirs = _unit(rng, n)
    want = np.asarray(jsh.eval_sh(degree, jnp.asarray(coeffs),
                                  jnp.asarray(dirs)))
    got = tsh.eval_sh(degree, torch.as_tensor(coeffs),
                      torch.as_tensor(dirs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_eval_sh_rejects_degree_5():
    with pytest.raises(ValueError):
        tsh.eval_sh(5, torch.zeros(1, 3, 36), torch.zeros(1, 3))


def test_quaternion_maths_matches_jax():
    rng = np.random.default_rng(1)
    q1 = rng.normal(size=(64, 4)).astype(np.float32)
    q2 = rng.normal(size=(64, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tquat.quat_mul(torch.as_tensor(q1), torch.as_tensor(q2)).numpy(),
        np.asarray(jquat.quat_mul(jnp.asarray(q1), jnp.asarray(q2))),
        atol=ATOL)
    np.testing.assert_allclose(
        tquat.quat_to_rotmat(torch.as_tensor(q1)).numpy(),
        np.asarray(jquat.quat_to_rotmat(jnp.asarray(q1))), atol=ATOL)
    m = np.array(jquat.quat_to_rotmat(jnp.asarray(q2)))
    np.testing.assert_allclose(
        tquat.rotmat_to_quat(torch.as_tensor(m)).numpy(),
        np.asarray(jquat.rotmat_to_quat(jnp.asarray(m))), atol=ATOL)


def test_pose_roundtrip_matches_jax():
    rng = np.random.default_rng(2)
    pose = np.concatenate([rng.normal(size=(16, 4)),
                           rng.normal(size=(16, 3))], -1).astype(np.float32)
    w2c_t = tquat.pose_to_w2c(torch.as_tensor(pose))
    w2c_j = jquat.pose_to_w2c(jnp.asarray(pose))
    np.testing.assert_allclose(w2c_t.numpy(), np.asarray(w2c_j), atol=ATOL)
    np.testing.assert_allclose(
        tquat.w2c_to_pose(w2c_t).numpy(),
        np.asarray(jquat.w2c_to_pose(w2c_j)), atol=ATOL)


def test_safe_sqrt_has_finite_gradient_at_zero():
    x = torch.zeros(4, requires_grad=True)
    tquat._sqrt_positive_part(x).sum().backward()
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("fov", [(1.1, 1.1), (1.0144, 0.6056)])
def test_projection_matches_jax(fov):
    fovx, fovy = fov
    got = ttf.projection_matrix_dyn(0.01, 100.0, fovx, fovy).numpy()
    want = np.asarray(jtf.projection_matrix_dyn(0.01, 100.0, fovx, fovy))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert ttf.focal2fov(460.8, 512) == jtf.focal2fov(460.8, 512)
    assert ttf.fov2focal(fovx, 512) == jtf.fov2focal(fovx, 512)
    t = ttf.focal2fov(torch.tensor(460.8, dtype=torch.float64), 512)
    assert math.isclose(float(t), jtf.focal2fov(460.8, 512), rel_tol=1e-12)


def _imports(path: Path):
    """Every module name an ``import`` / ``from`` statement names, at any
    depth of the file (imports inside functions included)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "das3r_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "das3r_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path):
    from das3r_tpu_torch.data import synthetic
    from das3r_tpu_torch.eval import render_tool
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.ops.splat import RasterSettings, rasterize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        render_tool.render_sets(str(tmp_path), str(tmp_path), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_tool.main(["-s", str(tmp_path), "-m", str(tmp_path),
                          "--iteration", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.random_gaussian_scene(10)
    params, meta, poses = synthetic.random_gaussian_scene(10, device="cpu")
    s = RasterSettings(image_height=32, image_width=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_mod.render(params, meta, s, poses.pose(0), torch.zeros(3),
                          1.0, 1.0, mode="no_soft")
    with pytest.raises(RuntimeError, match="CUDA"):
        rasterize(params.xyz, torch.ones(10), s, viewmatrix=torch.eye(4),
                  projmatrix=torch.eye(4), campos=torch.zeros(3),
                  bg=torch.zeros(3), tan_fovx=0.5, tan_fovy=0.5,
                  colors_precomp=torch.ones(10, 3),
                  scales=torch.ones(10, 3), rotations=params.rotation)


def test_kernel_wrappers_reject_bad_input():
    """The CUDA route checks device, dtype, rank and contiguity before it
    hands a pointer to a kernel."""
    from das3r_tpu_torch.ops.splat import kernels
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="must be on"):
        kernels.check(x, "keys", torch.int64, 1)
