"""The ranks of ``tests/test_torch_parallel.py`` (and the stage-1 step of
``tests/test_torch_stage1_training.py`` and the stage-1 ``fit`` of
``tests/test_torch_stage1_fit_parallel.py``). Each runs in a process of
its own, spawned by the test, on the CPU, joined to a gloo group through a
``file://`` store; it reads the scene that the test wrote (``scene.npz``,
``scene.json``) and writes its results beside it. The module imports
neither JAX nor the JAX package, so a rank starts with PyTorch alone; the
test also runs ``run_step`` itself, with the unsharded mesh, as the
reference."""
import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from das3r_tpu_torch.models import gaussians
from das3r_tpu_torch.models.croco import convert
from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                  random_torch_state_dict)
from das3r_tpu_torch.ops.splat import RasterSettings
from das3r_tpu_torch.parallel import comm_stats, multihost, sharded
from das3r_tpu_torch.parallel.mesh import make_mesh
from das3r_tpu_torch.predictor import datasets, train_loop, training
from das3r_tpu_torch.predictor.losses import Stage1Batch
from das3r_tpu_torch.train import step as step_mod
from das3r_tpu_torch.train.config import OptimizationConfig
from chip_smoke import Stage1FitProbe


def load_scene(work: Path):
    """(params, meta, poses, gts, fovs, bg, settings, cfg) on the CPU."""
    z = np.load(work / "scene.npz")

    def group(prefix):
        return {k.split(".", 1)[1]: z[k] for k in z.files
                if k.startswith(prefix + ".")}

    params, meta = gaussians.params_from_numpy(group("params"),
                                               group("meta"), "cpu")
    poses = gaussians.poses_from_numpy(group("poses"), "cpu")
    cfg = json.loads((work / "scene.json").read_text())
    return (params, meta, poses, torch.as_tensor(z["gts"]),
            torch.as_tensor(z["fovs"]), torch.as_tensor(z["bg"]),
            RasterSettings(**cfg["settings"]),
            OptimizationConfig(**cfg["cfg"]))


def numpy_group(g) -> dict:
    return {f.name: getattr(g, f.name).detach().numpy().copy()
            for f in dataclasses.fields(g)}


def run_step(work: Path, mesh, gauss_axis=None, uids=(0, 1),
             **settings_kw) -> dict:
    """One sharded step on the scene from a fresh state: this rank's
    gradients, loss and post-step state, as numpy. ``settings_kw``
    replace fields of the scene's raster settings."""
    params, meta, poses, gts, fovs, bg, settings, cfg = load_scene(work)
    settings = dataclasses.replace(settings, **settings_kw)
    state = step_mod.init_train_state(params, poses)
    if gauss_axis:
        state = sharded.shard_state(state, mesh)
        meta = sharded.shard_meta(meta, mesh)
    step = sharded.make_sharded_train_step(mesh, settings, cfg,
                                           gauss_axis=gauss_axis,
                                           device="cpu")
    uids = list(uids)
    g_params, g_poses, stats = step.loss_and_grads(
        state, meta, uids, gts[uids], fovs[uids], fovs[uids], bg)
    metrics = step.update(state, g_params, g_poses, stats)
    return dict(
        loss=float(metrics.loss), psnr=float(metrics.psnr),
        cam_stepped=bool(metrics.cam_stepped),
        entry_overflow=int(metrics.entry_overflow),
        g_params=numpy_group(g_params), g_poses=numpy_group(g_poses),
        params=numpy_group(state.params), poses=numpy_group(state.poses),
        moments={k: v.shape for k, v in numpy_group(state.opt.mu).items()},
        coords=dict(mesh.coords))


def task_render_and_steps(work: Path) -> dict:
    """The tile-sharded render over every rank, then the step at (data=2,
    tile=2) and at (data=1, gauss=2, tile=2): four ranks."""
    params, meta, poses, _, fovs, bg, settings, _ = load_scene(work)
    render = sharded.make_sharded_render(make_mesh(tile=4), settings, "cpu")
    with torch.no_grad():
        image = render(params, meta, poses.pose(0), bg, fovs[0], fovs[0])
    return dict(
        image=image.numpy(),
        data_tile=run_step(work, make_mesh(data=2, tile=2)),
        gauss_tile=run_step(work, make_mesh(data=1, gauss=2, tile=2),
                            gauss_axis="gauss"))


def task_comm(work: Path) -> dict:
    """Two steps of one frame each at (data=1, tile=2) under ``CommStats``:
    two ranks."""
    with comm_stats.CommStats() as stats:
        for uid in (0, 1):
            run_step(work, make_mesh(data=1, tile=2), uids=(uid,))
    return dict(calls=stats.calls, families=stats.families())


def task_jax_mesh(work: Path) -> dict:
    """The step at (data=2, gauss=2, tile=2), Gaussian-sharded: eight
    ranks, JAX's mesh of tests/test_parallel.py."""
    return run_step(work, make_mesh(data=2, gauss=2, tile=2),
                    gauss_axis="gauss")


def task_window_tile(work: Path) -> dict:
    """The step at (tile=2) on the [T, K] window path
    (``entry_stream=False``): two ranks."""
    return run_step(work, make_mesh(tile=2), entry_stream=False)


def task_stage1_step(work: Path) -> dict:
    """One stage-1 step at (data=2) on the batch of ``stage1.npz``, each
    rank on its half, from the TINY model of its seed: two ranks (for
    ``tests/test_torch_stage1_training.py``)."""
    z = np.load(work / "stage1.npz")
    mesh = make_mesh(data=2)
    model = AsymmetricCroCo3D(TINY)
    convert.load_reference_state_dict(model, random_torch_state_dict(
        TINY, np.random.default_rng(int(z["seed"]))))
    train, _ = training.split_params(model)
    cfg = training.Stage1TrainConfig(**json.loads(str(z["cfg"])))
    n = z["img1"].shape[0] // mesh.shape["data"]
    rows = slice(mesh.coords["data"] * n, (mesh.coords["data"] + 1) * n)
    batch = Stage1Batch(*(z[f][rows] for f in Stage1Batch._fields))
    step = training.make_train_step(model, cfg, group=mesh.group("data"))
    out = step(train, training.adamw_init(train),
               torch.as_tensor(z["img1"][rows]),
               torch.as_tensor(z["img2"][rows]), batch.to("cpu"), 0)
    return dict(loss=[float(x) for x in out],
                params={k: convert.to_jax(k, p.detach().numpy())
                        for k, p in train.items()})


@functools.lru_cache(maxsize=1)
def tiny_weights(seed: int) -> dict:
    return random_torch_state_dict(TINY, np.random.default_rng(seed))


def stage1_fit_args(spec: dict, seed: int):
    """The TINY model of ``seed`` and ``fit``'s other arguments, from the
    test's ``stage1_fit.json``."""
    model = AsymmetricCroCo3D(TINY)
    convert.load_reference_state_dict(model, tiny_weights(seed))
    train = datasets.SyntheticTwoViewDataset(**spec["train"])
    test = datasets.SyntheticTwoViewDataset(**spec["test"])
    return model, train, {"syn": test}, training.Stage1TrainConfig(
        **spec["cfg"])


def task_stage1_fit(work: Path) -> dict:
    """``train_loop.fit`` at (data=2), from the spec that the test wrote
    (``stage1_fit.json``): a fresh run into ``two/`` and one that resumes
    the one-rank run's checkpoint in ``resume/``, then a batch the ranks
    do not divide. Returns each run's history, a hash of its parameters
    and AdamW state, and the files each rank wrote; two ranks."""
    spec = json.loads((work / "stage1_fit.json").read_text())
    mesh = make_mesh(data=2)
    out = dict(files={})
    for run in ("two", "resume"):
        model, train, tests, cfg = stage1_fit_args(spec, spec["seed"])
        with Stage1FitProbe() as probe:
            _, hist = train_loop.fit(
                model, train, tests, cfg, train_loop.Stage1LoopConfig(
                    out_dir=str(work / run), **spec["loop"]),
                mesh=mesh, progress=lambda *_: None, device="cpu")
        out[run] = dict(history=hist, digest=probe.digest())
        out["files"][run] = dict(probe.wrote)
    try:
        train_loop.fit(model, train, tests, cfg, train_loop.Stage1LoopConfig(
            out_dir=str(work / "odd"), **{**spec["loop"], "batch_size": 3}),
            mesh=mesh, device="cpu")
    except ValueError as e:
        out["odd_batch"] = str(e)
    return out


TASKS = {"render_and_steps": task_render_and_steps, "comm": task_comm,
         "jax_mesh": task_jax_mesh, "window_tile": task_window_tile,
         "stage1_step": task_stage1_step, "stage1_fit": task_stage1_fit}


def run(rank: int, world: int, work: str, task: str) -> None:
    """A rank's whole life: join the group, run ``task``, write its
    result to ``<task>.<rank>.pt``, leave the group."""
    torch.set_num_threads(1)
    work = Path(work)
    multihost.initialize_distributed(f"file://{work / task}.store", world,
                                     rank, device="cpu")
    try:
        torch.save(TASKS[task](work), work / f"{task}.{rank}.pt")
    finally:
        dist.destroy_process_group()
