"""PyTorch port: data-parallel stage-1 fine-tuning, ``train_loop.fit(...,
mesh=)`` over two gloo ranks, against JAX's ``fit(mesh=make_mesh(data=2))``
on two of the CPU's forced host devices (``tests/conftest.py``).

Both packages start from the same TINY weights (the reference layout,
converted by JAX's converter) and train the mask heads (the recipe's
freeze set) on the same synthetic sets for 2 epochs of 2 steps of a
global batch of 2 pairs: one row a rank. The ranks' code is
``tests/torch_parallel_workers.py::task_stage1_fit`` (no JAX import).

Bars, as for the one-device steps (``tests/test_torch_stage1_training.py``):
the history's losses within 1e-4 relative; the trainable parameters within
1e-4 x max|ref| per tensor at Adam eps 1e-2, where Adam's update is a
smooth function of the gradient. Between the ranks of one run: bitwise.

TINY's mask heads hold 36.2M parameters, so a checkpoint (parameters and
both moments) is ~434 MB: the runs write few (a test pass at epoch 2
only, no ``checkpoint-last`` except the one-rank run's, which the two
ranks resume), and JAX's writer is given ``np.savez`` for
``np.savez_compressed`` (zlib takes ~30 s a file; ``np.load`` reads
either, and the keys are JAX's own). The ranks run beside JAX's fit.
"""
import json
import shutil
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.models.croco.convert import convert_torch_state_dict
from das3r_tpu.models.croco.dust3r import AsymmetricCroCo3D as JModel
from das3r_tpu.models.croco.testkit import TINY as JTINY
from das3r_tpu.parallel.mesh import make_mesh as jax_mesh
from das3r_tpu.predictor import datasets as jds
from das3r_tpu.predictor import train_loop as jloop
from das3r_tpu.predictor import training as jtraining
from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                  random_torch_state_dict)
from das3r_tpu_torch.predictor import datasets as tds
from das3r_tpu_torch.predictor import train_loop

import torch_parallel_workers as workers

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
SEED = 5
LOSS_REL = 1e-4
PARAM_REL = 1e-4
SPAWN_TIMEOUT = 180        # s, both ranks, start-up included
SPEC = dict(
    seed=SEED,
    train=dict(n=4, resolution=[48, 32], seed=0),
    test=dict(n=2, resolution=[48, 32], seed=9),
    cfg=dict(lr=1e-3, warmup_epochs=0.0, steps_per_epoch=2, epochs=4,
             eps=1e-2),
    loop=dict(epochs=2, batch_size=2, eval_freq=2, save_freq=3))
HIST_LOSSES = ("train_loss", "test_syn_loss", "test_syn_loss_med")


def start(task: str, world: int, work: Path):
    """Start ``task`` of ``torch_parallel_workers`` on ``world`` spawned
    gloo ranks; ``join`` waits for them."""
    return torch.multiprocessing.start_processes(
        workers.run, args=(world, str(work), task), nprocs=world,
        join=False, start_method="spawn")


def join(ctx, task: str, world: int, work: Path) -> list[dict]:
    """Every rank's result, once all have ended."""
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=5):        # raises on a rank's failure
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{task}: ranks still running after "
                        f"{SPAWN_TIMEOUT} s")
    return [torch.load(work / f"{task}.{r}.pt", weights_only=False)
            for r in range(world)]


def jax_fit(params, out_dir: Path, mesh):
    """JAX's ``fit`` on the spec, ``np.savez`` for its compressed writer."""
    loop = jloop.Stage1LoopConfig(out_dir=str(out_dir), **SPEC["loop"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(np, "savez_compressed", np.savez)
        return jloop.fit(
            JModel(JTINY), params,
            jds.SyntheticTwoViewDataset(**SPEC["train"]),
            {"syn": jds.SyntheticTwoViewDataset(**SPEC["test"])},
            jtraining.Stage1TrainConfig(**SPEC["cfg"]), loop, mesh=mesh,
            progress=lambda *_: None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run, once: the port's one-rank fit, whose epoch-1
    ``checkpoint-last`` is kept for the two-rank resume; the two ranks (a
    fresh fit, the resume, an uneven batch) while JAX's (data=2) fit runs
    here; then JAX's fit resuming the ranks' final checkpoint. The files
    are deleted after."""
    work = tmp_path_factory.mktemp("stage1_fit")
    (work / "resume").mkdir()

    def keep_epoch1(msg):
        if msg.startswith("epoch 0:"):
            shutil.move(work / "one" / "checkpoint-last.npz",
                        work / "resume" / "checkpoint-last.npz")
    t0 = time.perf_counter()
    model, train, tests, cfg = workers.stage1_fit_args(SPEC, SEED)
    one_model, one_hist = train_loop.fit(
        model, train, tests, cfg, train_loop.Stage1LoopConfig(
            out_dir=str(work / "one"), **{**SPEC["loop"], "save_freq": 1}),
        progress=keep_epoch1, device="cpu")
    t_one = time.perf_counter() - t0

    (work / "stage1_fit.json").write_text(json.dumps(SPEC))
    ctx = start("stage1_fit", 2, work)
    sd = random_torch_state_dict(TINY, np.random.default_rng(SEED))
    params = jax.tree.map(jnp.asarray, convert_torch_state_dict(sd, JTINY))
    mesh = jax_mesh(data=2, devices=jax.devices()[:2])
    _, jhist = jax_fit(params, work / "jax", mesh)
    t_jax = time.perf_counter() - t0 - t_one
    ranks = join(ctx, "stage1_fit", 2, work)
    t_ranks = time.perf_counter() - t0 - t_one

    # JAX resumes the ranks' final checkpoint (epoch 2 of 2: no step)
    (work / "jax_resume").mkdir()
    shutil.copy(work / "two" / "checkpoint-final.npz",
                work / "jax_resume" / "checkpoint-last.npz")
    jresumed, jresumed_hist = jax_fit(params, work / "jax_resume", mesh)
    print(f"one rank {t_one:.1f} s, then JAX's fit {t_jax:.1f} s beside "
          f"the two ranks {t_ranks:.1f} s")
    files = {name: dict(np.load(work / name / "checkpoint-final.npz"))
             for name in ("jax", "one", "two", "resume")}
    listing = {name: sorted(p.name for p in (work / name).iterdir())
               for name in ("two", "resume")}
    yield dict(jhist=jhist, one_hist=one_hist, one_model=one_model,
               ranks=ranks, files=files, jresumed=jresumed,
               jresumed_hist=jresumed_hist, listing=listing, tests=tests)
    shutil.rmtree(work, ignore_errors=True)


def assert_history_close(got: list, want: list):
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want]
    for g, w in zip(got, want):
        assert set(g) == set(w), (set(g), set(w))
        for k in HIST_LOSSES:
            if k in w:
                assert g[k] == pytest.approx(w[k], rel=LOSS_REL), k
        assert g["train_lr"] == pytest.approx(w["train_lr"], rel=1e-6)


def assert_params_close(got: dict, want: dict):
    """Every ``['params']`` tensor of two checkpoint files within
    PARAM_REL x max|ref|, and the epoch counts equal."""
    keys = [k for k in want if k.startswith("['params']")]
    assert keys and sorted(keys) == sorted(
        k for k in got if k.startswith("['params']"))
    for k in keys:
        assert got[k].shape == want[k].shape, k
        assert np.abs(got[k] - want[k]).max() <= PARAM_REL * np.abs(
            want[k]).max(), k
    assert int(got["__epoch"]) == int(want["__epoch"])
    assert int(got["__count"]) == int(want["__count"])


def test_two_rank_fit_matches_jax_fit_mesh(runs):
    for r in runs["ranks"]:
        assert_history_close(r["two"]["history"], runs["jhist"])
    assert_params_close(runs["files"]["two"], runs["files"]["jax"])
    assert float(runs["files"]["two"]["__best"]) == pytest.approx(
        float(runs["files"]["jax"]["__best"]), rel=LOSS_REL)


def test_two_rank_fit_matches_one_rank_fit(runs):
    assert_history_close(runs["ranks"][0]["two"]["history"],
                         runs["one_hist"])
    assert_params_close(runs["files"]["two"], runs["files"]["one"])
    assert_history_close(runs["one_hist"], runs["jhist"])


@pytest.mark.parametrize("run", ["two", "resume"])
def test_ranks_agree_bitwise_and_rank0_alone_writes(runs, run):
    """Parameters and AdamW state bitwise equal on both ranks, the same
    history (rank 0's clock), and every file written by rank 0 alone."""
    r0, r1 = runs["ranks"]
    assert r0[run]["digest"] == r1[run]["digest"]
    assert r0[run]["history"] == r1[run]["history"]
    assert r1["files"][run] == {}
    want = {"checkpoint-best.npz": 1, "checkpoint-final.npz": 1,
            "log.txt": 2 if run == "two" else 1}
    assert r0["files"][run] == want
    # resume/ also holds the one-rank run's checkpoint-last
    assert set(runs["listing"][run]) == set(want) | (
        {"checkpoint-last.npz"} if run == "resume" else set())


def test_one_rank_checkpoint_resumes_two_rank_fit(runs):
    """The two ranks resume the one-rank run's epoch-1 checkpoint-last and
    run epoch 2 only: its history line and the final parameters are those
    of JAX's and of the one-rank run."""
    for r in runs["ranks"]:
        assert_history_close(r["resume"]["history"], runs["jhist"][1:])
    assert_params_close(runs["files"]["resume"], runs["files"]["jax"])
    assert_params_close(runs["files"]["resume"], runs["files"]["one"])


def test_two_rank_checkpoint_resumes_jax_fit(runs):
    """JAX's ``fit`` resumes the ranks' checkpoint (their final one, as
    its checkpoint-last) at epoch 2 of 2 and returns its parameters
    bitwise."""
    assert runs["jresumed_hist"] == []
    last = runs["files"]["two"]
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jtraining.split_params(runs["jresumed"])[0])
    assert len(flat) == sum(k.startswith("['params']") for k in last)
    for path, v in flat:
        np.testing.assert_array_equal(
            np.asarray(v), last["['params']" + jax.tree_util.keystr(path)])


def test_uneven_batch_raises(runs):
    for r in runs["ranks"]:
        assert "does not split over 2 data ranks" in r["odd_batch"]
    with pytest.raises(ValueError, match="does not split"):
        next(tds.batch_iterator(tds.SyntheticTwoViewDataset(n=4), 3,
                                rank=0, ranks=2))


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_batch_rows_split_jax_batches(ranks):
    """Each rank renders its rows of every global batch; the ranks' rows,
    stacked, are JAX's batch bitwise."""
    kw = dict(n=9, resolution=(16, 16), seed=3)
    want = list(jds.batch_iterator(jds.SyntheticTwoViewDataset(**kw), 4,
                                   seed=11))
    parts = [list(tds.batch_iterator(tds.SyntheticTwoViewDataset(**kw), 4,
                                     seed=11, rank=r, ranks=ranks))
             for r in range(ranks)]
    assert len(want) == 2 and all(len(p) == 2 for p in parts)
    for b, (img1, img2, batch) in enumerate(want):
        rows = [p[b] for p in parts]
        assert all(len(r[0]) == 4 // ranks for r in rows)
        np.testing.assert_array_equal(
            np.concatenate([r[0] for r in rows]), img1)
        np.testing.assert_array_equal(
            np.concatenate([r[1] for r in rows]), img2)
        for f, w in zip(batch._fields, batch):
            np.testing.assert_array_equal(
                np.concatenate([getattr(r[2], f) for r in rows]), w)


def test_evaluate_is_the_test_pass_loss(runs):
    """``evaluate`` (JAX's wrapper of ``evaluate_stats``) on the one-rank
    run's final model: the epoch-2 test pass's loss, JAX's within the
    bar."""
    got = train_loop.evaluate(runs["one_model"], runs["tests"]["syn"], 2,
                              max_batches=8, device="cpu")
    assert got == runs["one_hist"][-1]["test_syn_loss"]
    assert got == pytest.approx(runs["jhist"][-1]["test_syn_loss"],
                                rel=LOSS_REL)
