"""PyTorch port: the multi-device path (``das3r_tpu_torch/parallel``) on
gloo process groups of ranks spawned on the CPU (``torch_parallel_workers.
py``), against the port's unsharded step and against the JAX package's
sharded step on the virtual 8-device CPU mesh of tests/conftest.py.

The scene is that of tests/test_parallel.py (120 Gaussians in a capacity
of 128, 32x32, 4 frames, ``max_total_entries`` 8192), with its ground
truth rendered by JAX and its features and positions perturbed."""
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.models import render as jrender
from das3r_tpu.parallel import make_mesh as jax_make_mesh
from das3r_tpu.parallel import multihost as jax_multihost
from das3r_tpu.parallel import sharded as jsharded
from das3r_tpu.train import step as jstep
from das3r_tpu.train.config import OptimizationConfig as JaxConfig
from das3r_tpu_torch.parallel import make_mesh, multihost, sharded
from das3r_tpu_torch.train import optim
from das3r_tpu_torch.train.config import OptimizationConfig

import torch_parallel_workers as workers
from test_torch_blend_backward import assert_grads_close
from test_train import build_synthetic_scene

torch.set_num_threads(2)
SPAWN_TIMEOUT = 120        # s, each group of ranks, start-up included
CFG = dict(psnr_threshold=5.0)


def spawn(task: str, world: int, work) -> list[dict]:
    """Run ``task`` on ``world`` spawned ranks; every rank's result. A
    rank's exception fails the test with its traceback; ranks still
    running after ``SPAWN_TIMEOUT`` are killed and the test fails."""
    ctx = torch.multiprocessing.start_processes(
        workers.run, args=(world, str(work), task), nprocs=world,
        join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=5):        # raises on a rank's failure
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(10)
            pytest.fail(f"{task}: {world} ranks still running after "
                        f"{SPAWN_TIMEOUT} s")
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(work / f"{task}.{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The JAX scene, its ground truth, and the same written for the
    ranks (``scene.npz``, ``scene.json``)."""
    params, meta, poses, js = build_synthetic_scene(n=120, cap=128, f=4,
                                                    hw=32, seed=2)
    js = dataclasses.replace(js, max_total_entries=8192)
    fovs = jnp.ones(4)
    gts = jnp.stack([jrender.render(params, meta, js, poses.pose(u),
                                    jnp.zeros(3), fovs[u], fovs[u],
                                    mode="train").image for u in range(4)])
    rng = np.random.default_rng(3)
    params = params._replace(
        features_dc=params.features_dc + rng.normal(
            0, 0.1, params.features_dc.shape).astype(np.float32),
        xyz=params.xyz + rng.normal(0, 0.01, params.xyz.shape).astype(
            np.float32))
    work = tmp_path_factory.mktemp("parallel")
    arrays = {f"{g}.{k}": np.asarray(v) for g, nt in
              (("params", params), ("meta", meta), ("poses", poses))
              for k, v in nt._asdict().items()}
    np.savez(work / "scene.npz", gts=np.asarray(gts), fovs=np.asarray(fovs),
             bg=np.zeros(3, np.float32), **arrays)
    (work / "scene.json").write_text(json.dumps(
        dict(settings=dataclasses.asdict(js), cfg=CFG)))
    return params, meta, poses, js, gts, fovs, work


@pytest.fixture(scope="module")
def reference(scene):
    """The port's unsharded batched step (world size 1) on frames 0, 1."""
    return workers.run_step(scene[-1], make_mesh(world_size=1))


@pytest.fixture(scope="module")
def four_ranks(scene):
    return spawn("render_and_steps", 4, scene[-1])


@pytest.mark.parametrize("kw,want", [
    (dict(data=2, tile=4), (2, 1, 4)),
    (dict(), (1, 1, 8)),
    (dict(data=2, gauss=2, tile=2), (2, 2, 2)),
    (dict(gauss=4, tile=2), (1, 4, 2)),
])
def test_mesh_shapes_match_jax(kw, want):
    """``make_mesh`` for the four calls of test_parallel.py's
    test_mesh_construction, and ``global_mesh`` of one host, against JAX's
    meshes of the 8 virtual devices."""
    got = make_mesh(**kw, world_size=8).shape
    jmesh = jax_make_mesh(**kw)
    assert tuple(got.values()) == want == tuple(
        jmesh.shape[a] for a in ("data", "gauss", "tile"))
    jg = jax_multihost.global_mesh(**kw)
    tg = multihost.global_mesh(**kw, world_size=8, local_world_size=8)
    assert tuple(tg.shape.values()) == tuple(
        jg.shape[a] for a in ("data", "gauss", "tile"))
    assert multihost.choose_backend("cpu", 2) == "gloo"


def test_tile_sharded_render_is_bitwise(scene, four_ranks):
    """Four tile ranges on four ranks: every rank holds the whole image,
    bitwise the port's unsharded render."""
    tp, tm, tq, _, fovs, bg, ts, _ = workers.load_scene(scene[-1])
    with torch.no_grad():
        want = sharded.make_sharded_render(make_mesh(world_size=1), ts,
                                           "cpu")(tp, tm, tq.pose(0), bg,
                                                  fovs[0], fovs[0])
    assert float(want.max()) > 0.1
    for r in four_ranks:
        assert np.array_equal(r["image"], want.numpy())


def assert_step_close(got: dict, want: dict, rows=slice(None)):
    """The bars of a sharded step against the unsharded one: the loss
    within rel 1e-5, each parameter group's gradient within 2e-5 x
    max|g|, the post-step parameters and poses within 2 lr (Adam's first
    step moves a noise-level element by about +-lr)."""
    cfg = OptimizationConfig(**CFG)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["cam_stepped"] == want["cam_stepped"]
    assert got["entry_overflow"] == want["entry_overflow"] == 0
    for group in ("g_params", "g_poses"):
        for k, w in want[group].items():
            w = w[rows] if k in sharded.GAUSSIAN_FIELDS else w
            assert_grads_close(got[group][k], w)
    lrs = optim.gaussian_lrs(1, cfg, 1.0)
    for k, w in want["params"].items():
        w = w[rows] if k in sharded.GAUSSIAN_FIELDS else w
        bound = 2 * float(getattr(lrs, k)) + 1e-7
        assert np.abs(got["params"][k] - w).max() <= bound, k
    cam = optim.camera_lrs(1, cfg)
    for k, w in want["poses"].items():
        bound = 2 * float(getattr(cam, k)) + 1e-7
        assert np.abs(got["poses"][k] - w).max() <= bound, k


def test_step_data_tile_matches_unsharded(four_ranks, reference):
    """(data=2, tile=2): one frame per data rank, two tile ranges each."""
    assert np.abs(reference["g_params"]["xyz"]).max() > 0
    for r in four_ranks:
        assert_step_close(r["data_tile"], reference)


def test_step_gauss_tile_matches_unsharded(four_ranks, reference):
    """(data=1, gauss=2, tile=2), Gaussian-sharded: each rank holds only
    its 64 of the 128 rows of the parameters and moments."""
    for r in four_ranks:
        got = r["gauss_tile"]
        j = got["coords"]["gauss"]
        assert got["params"]["xyz"].shape == (64, 3)
        assert got["moments"]["xyz"] == (64, 3)
        assert got["moments"]["features_rest"][0] == 64
        assert got["moments"]["conf_static"] == (4, 32, 32)
        assert_step_close(got, reference, slice(64 * j, 64 * (j + 1)))


def test_window_path_tile_step_matches_unsharded(scene):
    """(tile=2) on the [T, K] window path (``entry_stream=False``): each
    rank blends its range of window rows, the rows are gathered and the
    depth-rank table's gradient summed; against the unsharded window
    step at the same bars."""
    want = workers.run_step(scene[-1], make_mesh(world_size=1),
                            entry_stream=False)
    assert np.abs(want["g_params"]["xyz"]).max() > 0
    for r in spawn("window_tile", 2, scene[-1]):
        assert_step_close(r, want)


def test_comm_stats_count_the_table_reduction(scene):
    """(data=1, tile=2): the table-gradient all-reduce moves (N + 1) x 9 x
    4 bytes, once a step; every family is in hlo_stats' form."""
    ranks = spawn("comm", 2, scene[-1])
    n = scene[0].xyz.shape[0]
    for r in ranks:
        table = [b for fam, tag, b in r["calls"] if tag == "table_grad"]
        assert table == [(n + 1) * 9 * 4] * 2
        assert {"all-reduce", "all-gather"} <= set(r["families"])
        assert r["families"]["all-reduce"]["count"] == 2
        tiles = [b for _, tag, b in r["calls"] if tag == "tiles"]
        assert tiles == [2 * 2 * 4 * 256 * 4] * 2   # 2 ranges x 2 tiles


def test_gauss_sharded_step_matches_jax(scene):
    """Eight ranks at (data=2, gauss=2, tile=2) against JAX's
    ``make_sharded_train_step(gauss_axis="gauss", backend="pallas")`` on
    the same mesh of 8 virtual devices: the loss within 1e-4, the
    parameters within 2 lr."""
    params, meta, poses, js, gts, fovs, work = scene
    ranks = spawn("jax_mesh", 8, work)
    cfg = JaxConfig(**CFG)
    mesh = jax_make_mesh(data=2, gauss=2, tile=2)
    # the arguments are made outside the mesh: JAX commits an array made
    # inside it to a replicated sharding, which the step's in_shardings
    # then refuse
    args = (jstep.init_train_state(params, poses), meta, jnp.arange(2),
            gts[:2], fovs[:2], fovs[:2], jnp.zeros(3))
    with jax.sharding.set_mesh(mesh):
        step = jsharded.make_sharded_train_step(
            mesh, js, cfg, gauss_axis="gauss", backend="pallas")
        state, metrics = step(*args)
    want = dict(loss=float(metrics.loss),
                cam_stepped=bool(metrics.cam_stepped), entry_overflow=0,
                params={k: np.asarray(v)
                        for k, v in state.params._asdict().items()},
                poses={k: np.asarray(v)
                       for k, v in state.poses._asdict().items()})
    lrs = optim.gaussian_lrs(1, OptimizationConfig(**CFG), 1.0)
    for r in ranks:
        assert r["loss"] == pytest.approx(want["loss"], rel=1e-4)
        assert r["cam_stepped"] == want["cam_stepped"]
        j = r["coords"]["gauss"]
        for k, w in want["params"].items():
            if k in sharded.GAUSSIAN_FIELDS:
                w = w[64 * j:64 * (j + 1)]
            bound = 2 * float(getattr(lrs, k)) + 1e-7
            assert np.abs(r["params"][k] - w).max() <= bound, k
