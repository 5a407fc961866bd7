"""PyTorch port: stage 1 around the model and the alignment, against the
JAX package: scene graphs, geometry, the flow-loss warps, the scale fit,
pairwise inference, the runner end to end, and the pipeline from frames
to a trained scene on the CPU (the port's copy of
``tests/test_full_pipeline.py``).

The model is the testkit's TINY config on seeded random weights in the
reference layout; frames are the synthetic stage-1 scene's. Inputs are
numpy from a seed; TF32 is off.
"""
import ast
import dataclasses
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from das3r_tpu.data.synthetic import make_synthetic_stage1_dir
from das3r_tpu.models.croco.convert import convert_torch_state_dict
from das3r_tpu.models.croco.dust3r import AsymmetricCroCo3D as JModel
from das3r_tpu.models.croco.testkit import TINY as JTINY
from das3r_tpu.predictor import alignment as JA
from das3r_tpu.predictor import inference as jinf
from das3r_tpu.predictor import pairs as jpairs
from das3r_tpu.predictor import runner as jrunner
from das3r_tpu.predictor import warping as jwarp
from das3r_tpu.utils import geometry as jgeo
from das3r_tpu_torch import pipeline
from das3r_tpu_torch.models.croco import convert
from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                  random_torch_state_dict,
                                                  save_reference_checkpoint)
from das3r_tpu_torch.predictor import alignment as TA
from das3r_tpu_torch.predictor import inference as tinf
from das3r_tpu_torch.predictor import pairs as tpairs
from das3r_tpu_torch.predictor import runner as trunner
from das3r_tpu_torch.predictor import warping as twarp
from das3r_tpu_torch.utils import geometry as tgeo

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ROOT = Path(__file__).resolve().parents[1]
REL = 1e-4        # x max|ref| per map: the model outputs
# x max|ref|: depths, poses and focals of the runner end to end (measured:
# 1.2e-5, PERF.md §6). The two alignments start from predictions that
# differ by ~1e-6 of their largest value; Adam's normalized step carries
# that into depth pixels whose gradient is near zero (random weights put
# depths from 1e-8 to 5e-4 in one frame).
E2E_REL = 1e-4
ATOL = 1e-6


def _t(x):
    return torch.as_tensor(np.array(x))


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def weights():
    sd = random_torch_state_dict(TINY, np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, convert_torch_state_dict(sd, JTINY))
    model = AsymmetricCroCo3D(TINY)
    convert.load_reference_state_dict(model, sd)
    return sd, params, model


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """6 synthetic frames at 48x64 (the stage-1 fixture's images)."""
    root = tmp_path_factory.mktemp("video")
    make_synthetic_stage1_dir(str(root / "gen"), n_frames=6, height=48,
                              width=64)
    out = root / "frames"
    out.mkdir()
    for p in sorted((root / "gen").glob("frame_*.png")):
        shutil.copy(p, out)
    return str(out)


# ---------------------------------------------------------------------------
# graphs, geometry, warps, scale fit


GRAPHS = ["complete", "swin-3", "swin-3-noncyclic", "swinstride-5-noncyclic",
          "swin2stride-2", "swinskip_start-2", "swin-1", "logwin-3",
          "logwin-3-noncyclic", "oneref-2", "oneref"]


@pytest.mark.parametrize("graph", GRAPHS)
def test_make_pairs_matches_jax(graph):
    for n in (2, 5, 16):
        for sym in (True, False):
            for pre in (None, "seq2", "cyc3"):
                assert (tpairs.make_pairs(n, graph, sym, pre)
                        == jpairs.make_pairs(n, graph, sym, pre))
    for n in (16, 96, 120):
        assert tpairs.eval_scene_graph(n) == jpairs.eval_scene_graph(n)
    assert len(tpairs.make_pairs(16, tpairs.eval_scene_graph(16))) == 110
    with pytest.raises(ValueError):
        tpairs.make_pairs(4, "nope")


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    depth = rng.uniform(1, 5, (2, 6, 8)).astype(np.float32)
    K = np.stack([np.asarray(jgeo.intrinsics_matrix(f, [4.0, 3.0]))
                  for f in (7.0, 9.0)])
    c2w = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    c2w[:, :3, 3] = rng.normal(size=(2, 3))
    np.testing.assert_allclose(
        tgeo.depthmap_to_pts3d(_t(depth), _t(K), _t(c2w)).numpy(),
        np.asarray(jgeo.depthmap_to_pts3d(jnp.asarray(depth), jnp.asarray(K),
                                          jnp.asarray(c2w))), atol=ATOL)
    pts = rng.normal(size=(2, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.project_points(_t(pts), _t(K[:, None])).numpy(),
        np.asarray(jgeo.project_points(jnp.asarray(pts),
                                       jnp.asarray(K[:, None]))), rtol=1e-6)
    np.testing.assert_array_equal(
        tgeo.intrinsics_matrix(_t([7.0, 9.0]), _t([[4.0, 3.0]] * 2)).numpy(),
        K)
    np.testing.assert_array_equal(tgeo.xy_grid(4, 3).numpy(),
                                  np.asarray(jgeo.xy_grid(4, 3)))
    valid = rng.uniform(size=(2, 5)) > 0.3
    got = tgeo.normalize_pointcloud_avg_dis(_t(pts), _t(valid))
    want = jgeo.normalize_pointcloud_avg_dis(jnp.asarray(pts),
                                             jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_warping_matches_jax():
    rng = np.random.default_rng(1)
    B, H, W = 3, 10, 14

    def rot(n):
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        x, y, z, w = q.T * 0.2
        w = np.sqrt(1 - x * x - y * y - z * z)
        return np.asarray(JA.quat_xyzw_to_rotmat(
            jnp.asarray(np.stack([x, y, z, w], -1), jnp.float32)))
    R1, R2 = rot(B), rot(B)
    t1 = rng.normal(0, 0.2, (B, 3, 1)).astype(np.float32)
    t2 = rng.normal(0, 0.2, (B, 3, 1)).astype(np.float32)
    disp = rng.uniform(0.2, 1.0, (B, 1, H, W)).astype(np.float32)
    K = np.tile(np.asarray([[12.0, 0, 7], [0, 12.0, 5], [0, 0, 1]],
                           np.float32), (B, 1, 1))
    iK = np.linalg.inv(K)
    args = (R1, t1, R2, t2, disp, K, iK)
    want = jwarp.ego_flow_from_disp(*(jnp.asarray(a) for a in args))
    got = twarp.ego_flow_from_disp(*(_t(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)

    f12 = rng.normal(0, 2, (B, 2, H, W)).astype(np.float32)
    f21 = rng.normal(0, 2, (B, 2, H, W)).astype(np.float32)
    coords = rng.uniform(-2, 16, (B, H, W, 2)).astype(np.float32)
    np.testing.assert_allclose(
        twarp.bilinear_sample(_t(f21), _t(coords)).numpy(),
        np.asarray(jwarp.bilinear_sample(jnp.asarray(f21),
                                         jnp.asarray(coords))), atol=ATOL)
    np.testing.assert_array_equal(
        twarp.occlusion_valid_mask(_t(f12), _t(f21)).numpy(),
        np.asarray(jwarp.occlusion_valid_mask(jnp.asarray(f12),
                                              jnp.asarray(f21))))
    mask = rng.uniform(size=(B, 1, H, W)) > 0.3
    for thre in (50.0, 2.0, 0.0):
        np.testing.assert_allclose(
            float(twarp.smooth_l1_flow_loss(_t(f12 * 5), _t(f21), _t(mask),
                                            per_pixel_thre=thre)),
            float(jwarp.smooth_l1_flow_loss(jnp.asarray(f12 * 5),
                                            jnp.asarray(f21),
                                            jnp.asarray(mask),
                                            per_pixel_thre=thre)),
            rtol=1e-6)
    d1 = rng.uniform(1, 4, (B, 1, H, W)).astype(np.float32)
    d2 = rng.uniform(1, 4, (B, 1, H, W)).astype(np.float32)
    for w in (None, mask.astype(np.float32)):
        np.testing.assert_allclose(
            float(twarp.depth_regularization_si_weighted(
                _t(d1), _t(d2), None if w is None else _t(w))),
            float(jwarp.depth_regularization_si_weighted(
                jnp.asarray(d1), jnp.asarray(d2),
                None if w is None else jnp.asarray(w))), rtol=1e-6)


@pytest.mark.parametrize("fit_mode", ["avg", "median", "weiszfeld",
                                      "avg_stop_grad", "median_stop_grad",
                                      "weiszfeld_stop_grad"])
def test_find_opt_scaling_matches_jax(fit_mode):
    rng = np.random.default_rng(2)
    gt1, gt2, pr1, pr2 = (rng.normal(size=(3, 4, 5, 3)).astype(np.float32)
                          for _ in range(4))
    v1, v2 = (rng.uniform(size=(3, 4, 5)) > 0.3 for _ in range(2))
    for args in ((gt1, gt2, pr1 * 1.7, pr2 * 1.7, v1, v2),
                 (gt1, None, pr1, None, None, None)):
        want = jinf.find_opt_scaling(
            *(None if a is None else jnp.asarray(a) for a in args[:4]),
            fit_mode=fit_mode,
            valid1=None if args[4] is None else jnp.asarray(args[4]),
            valid2=None if args[5] is None else jnp.asarray(args[5]))
        got = tinf.find_opt_scaling(
            *(None if a is None else _t(a) for a in args[:4]),
            fit_mode=fit_mode,
            valid1=None if args[4] is None else _t(args[4]),
            valid2=None if args[5] is None else _t(args[5]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6)
    with pytest.raises(ValueError):
        tinf.find_opt_scaling(_t(gt1), None, _t(pr1), fit_mode="bad")


# ---------------------------------------------------------------------------
# inference, the runner, the pipeline


def test_run_pairs_matches_jax(weights, frames_dir):
    """6 frames at 48x64, batches of 4 (the last one short)."""
    _, params, model = weights
    images01, _ = trunner.load_frames(frames_dir, size=64)
    edges = tpairs.make_pairs(6, "swin-2-noncyclic")
    want = jinf.run_pairs(JModel(JTINY), params, images01, edges,
                          encode_batch=4, decode_batch=4)
    got = tinf.run_pairs(model, images01, edges, encode_batch=4,
                         decode_batch=4)
    for k in ("pred_i", "pred_j", "conf_i", "conf_j", "mask_i", "mask_j"):
        w = getattr(want, k)
        assert getattr(got, k).shape == w.shape == (len(edges),) + (
            (48, 64, 3) if k.startswith("pred") else (48, 64)), k
        assert _rel(getattr(got, k), w) <= REL, k


def test_load_frames_and_masks_match_jax(frames_dir, tmp_path):
    got, names = trunner.load_frames(frames_dir, size=56, stride=2)
    want, wnames = jrunner.load_frames(frames_dir, size=56, stride=2)
    assert names == wnames and got.shape == (3, 3, 32, 48)
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(3)
    for k in range(2):
        mask = (rng.uniform(size=(20, 31)) > 0.97).astype(np.uint8) * 255
        mask[0, k * 30] = 255     # a pixel on the border
        Image.fromarray(mask).save(tmp_path / f"dynamic_mask_{k:04d}.png")
    j_dir = tmp_path / "j"
    shutil.copytree(tmp_path, j_dir, ignore=shutil.ignore_patterns("j"))
    trunner.enlarge_seg_masks(str(tmp_path))
    jrunner.enlarge_seg_masks(str(j_dir))
    for k in range(2):
        name = f"enlarged_dynamic_mask_{k:04d}.png"
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / name)),
                                      np.asarray(Image.open(j_dir / name)))


def test_run_scene_matches_jax(weights, frames_dir, tmp_path):
    """The same 6 frames and weights through both runners: the same
    files, frames and masks bitwise, depths and poses within E2E_REL."""
    _, params, model = weights
    kw = dict(scene_graph="swin-2-noncyclic", size=64,
              verbose=lambda *_: None)
    want = jrunner.run_scene(
        frames_dir, str(tmp_path / "jax"), JModel(JTINY), params,
        aligner_cfg=JA.AlignerConfig(niter=12, flow_loss_weight=0.0), **kw)
    stats = {}
    got = trunner.run_scene(
        frames_dir, str(tmp_path / "port"), model,
        aligner_cfg=TA.AlignerConfig(niter=12, flow_loss_weight=0.0),
        device="cpu", stats=stats, **kw)
    assert got.n_frames == want.n_frames == 6
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(b)),
                                          np.asarray(Image.open(a)), name)
        elif name.startswith(("conf_", "dyna_")):
            assert _rel(np.load(b), np.load(a)) <= REL, name
        elif name.endswith(".npy"):
            assert _rel(np.load(b), np.load(a)) <= E2E_REL, name
        else:
            x, y = np.loadtxt(a), np.loadtxt(b)
            assert np.abs(x - y).max() <= E2E_REL * np.abs(x).max(), name
    for k in ("depths", "poses_c2w", "focals"):
        assert _rel(getattr(got.scene, k), getattr(want.scene, k)) \
            <= E2E_REL, k
    assert stats["n_edges"] == 18 and stats["align"]["first_loss"] > 0


def test_runner_raises_on_what_is_not_ported(weights, frames_dir, tmp_path,
                                             monkeypatch):
    _, _, model = weights
    with pytest.raises(NotImplementedError, match="item 7"):
        trunner.run_scene(frames_dir, str(tmp_path), model, raft_params={},
                          device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        trunner.run_scene(frames_dir, str(tmp_path), model,
                          mask_refiner=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.run_scene(frames_dir, str(tmp_path), model)
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.main(["--image_dir", frames_dir, "--output_dir",
                      str(tmp_path), "--ckpt", "missing.pth"])
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.main(["--image_dir", frames_dir, "--work_dir",
                       str(tmp_path), "--ckpt", "missing.pth"])


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_build_model_takes_its_config_from_the_checkpoint(weights, tmp_path,
                                                          bf16):
    """runner.build_model reads TINY off a TINY checkpoint (head counts
    from its args.model) and loads its weights as they are."""
    sd, _, model = weights
    save_reference_checkpoint(tmp_path / "tiny.pth", sd, TINY)
    got = trunner.build_model(str(tmp_path / "tiny.pth"), bf16=bf16)
    want = TINY if not bf16 else dataclasses.replace(TINY,
                                                     dtype=torch.bfloat16)
    assert got.cfg == want
    for k, v in model.state_dict().items():
        assert torch.equal(got.state_dict()[k], v.to(got.state_dict()[k]))


def test_pipeline_frames_to_trained_scene(frames_dir, tmp_path):
    """pipeline.run on the CPU: a TINY checkpoint written with torch.save,
    stage 1, the bridge, 6 stage-2 iterations and the renders."""
    sd = random_torch_state_dict(TINY, np.random.default_rng(0))
    ckpt = tmp_path / "tiny.pth"
    save_reference_checkpoint(ckpt, sd, TINY)
    cfg = pipeline.PipelineConfig(
        ckpt=str(ckpt), iterations=6, align_niter=12, sh_degree=0, size=64)
    out = pipeline.run(frames_dir, str(tmp_path / "work"), cfg,
                       verbose=lambda *_: None, device="cpu")
    assert np.isfinite(out["final_loss"])
    stage1 = tmp_path / "work" / "stage1"
    for f in ("frame_0000.png", "frame_0000.npy", "conf_0000.npy",
              "dyna_avg_0000.npy", "dyna_max_0000.npy",
              "dynamic_mask_0000.png", "enlarged_dynamic_mask_0000.png",
              "pred_traj.txt", "pred_intrinsics.txt"):
        assert (stage1 / f).exists(), f
    renders = Path(out["model_path"]) / "renders_6"
    assert len(list(renders.glob("*.png"))) == 6
    assert Path(out["video"]).exists()


def test_stage1_modules_exist_and_import_no_jax():
    """The stage-1 files of the port exist and are walked by
    tests/test_torch_utils.py's import-hygiene test, which covers every
    file under das3r_tpu_torch/."""
    files = ["models/croco/" + f for f in ("rope.py", "blocks.py", "dpt.py",
                                           "dust3r.py", "testkit.py",
                                           "convert.py")]
    files += ["predictor/" + f for f in ("pairs.py", "inference.py",
                                         "warping.py", "alignment.py",
                                         "runner.py")]
    files += ["utils/geometry.py", "pipeline.py"]
    for f in files:
        path = ROOT / "das3r_tpu_torch" / f
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "flax", "das3r_tpu"), \
                    (f, n)
