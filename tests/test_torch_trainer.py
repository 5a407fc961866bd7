"""PyTorch port: the stage-2 trainer against the JAX package on the
synthetic 12-frame 48x64 scene of ``tests/test_trainer_e2e.py``:
``build_scene``, checkpoints written by one package and read by the other,
a ``train_scene`` run on the [T, K] window path against the JAX trainer
(whose CPU path is its window path), and the port's capacity regrows."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.data import readers as jreaders
from das3r_tpu.data import rearrange
from das3r_tpu.data.synthetic import make_synthetic_stage1_dir
from das3r_tpu.train import checkpoint as jckpt
from das3r_tpu.train import scene_setup as jsetup
from das3r_tpu.train import step as jstep
from das3r_tpu.train import trainer as jtrainer
from das3r_tpu.train.config import OptimizationConfig as JaxConfig
from das3r_tpu_torch.data import readers
from das3r_tpu_torch.models import render as render_mod
from das3r_tpu_torch.train import checkpoint as ckpt
from das3r_tpu_torch.train import scene_setup, trainer
from das3r_tpu_torch.train import step as step_mod
from das3r_tpu_torch.train.config import OptimizationConfig

from test_torch_init import assert_params_close

torch.set_num_threads(2)
# the small build of the e2e tests: ~270 entries in the busiest tile
BUILD = dict(sh_degree=0, max_per_tile=512, max_tiles_per_gaussian=16,
             max_points=2048)
# Loss, port against JAX, over 24 iterations: measured 7.9e-6 relative at
# the last (the window blends and the k-NN round in another order, and
# Adam carries the difference on); the bar leaves 12x.
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("trainer") / "seq")
    make_synthetic_stage1_dir(src, n_frames=12, height=48, width=64)
    rearrange.rearrange_scene(src, src + "_rearranged")
    return src + "_rearranged"


def both_bundles(scene_dir, eval_mode, **kw):
    jdata = jreaders.load_scene(scene_dir, eval_mode=eval_mode)
    tdata = readers.load_scene(scene_dir, eval_mode=eval_mode)
    return (jsetup.build_scene(jdata, **kw),
            scene_setup.build_scene(tdata, device="cpu", **kw))


def test_build_scene_matches_jax(scene_dir):
    jb, tb = both_bundles(scene_dir, True, **BUILD)
    assert dataclasses.asdict(tb.settings) == dataclasses.asdict(jb.settings)
    assert dataclasses.asdict(tb.scene) == dataclasses.asdict(jb.scene)
    assert_params_close(tb.params, jb.params)
    for group, jgroup in ((tb.meta, jb.meta), (tb.poses, jb.poses),
                          (tb.test_poses, jb.test_poses)):
        for f in dataclasses.fields(group):
            np.testing.assert_allclose(
                getattr(group, f.name).numpy(),
                np.asarray(getattr(jgroup, f.name)), rtol=0, atol=1e-6,
                err_msg=f.name)
    assert len(tb.train_data.images) == 11 and len(tb.test_data.images) == 1
    assert tb.settings.max_total_entries >= 8 * 1024
    assert tb.settings.max_tiles_per_gaussian < 16       # the probed cap


def test_checkpoints_cross_load(scene_dir, tmp_path):
    """A checkpoint the JAX package wrote loads in the port, and the
    reverse, equal field by field (meta included)."""
    jb, tb = both_bundles(scene_dir, False, **BUILD)
    jstate = jstep.init_train_state(jb.params, jb.poses)
    jstate = jstate._replace(step=jnp.asarray(17, jnp.int32))
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_train_state(jpath, jstate, meta=jb.meta)
    tstate = step_mod.init_train_state(tb.params, tb.poses)
    got, meta = ckpt.load_train_state(jpath, tstate, meta_template=tb.meta)
    want = jckpt._flatten_with_paths(jstate)
    flat = ckpt._flatten_with_paths(got)
    assert flat.keys() == want.keys() and got.step == 17
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    for k, v in ckpt._flatten_with_paths(meta).items():
        np.testing.assert_array_equal(
            v, np.asarray(jckpt._flatten_with_paths(jb.meta)[k]))

    tpath = str(tmp_path / "torch.npz")
    ckpt.save_train_state(tpath, got, meta=meta)
    back, jmeta = jckpt.load_train_state(tpath, jstate,
                                         meta_template=jb.meta)
    for k, v in jckpt._flatten_with_paths(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert int(back.step) == 17 and jmeta is not None


def test_train_scene_window_path_matches_jax(scene_dir, tmp_path):
    """24 iterations with log_every=1 (a progress line at each chunk end)
    on the port's window path against the JAX trainer: the same logged
    iterations, each loss within LOSS_RTOL; the saved artifacts."""
    jb, tb = both_bundles(scene_dir, False, **BUILD)
    tb = dataclasses.replace(tb, settings=dataclasses.replace(
        tb.settings, entry_stream=False))
    kw = dict(iterations=24, psnr_threshold=15.0)
    jlines, tlines = [], []
    jres = jtrainer.train_scene(jb, JaxConfig(**kw), log_every=1,
                                progress=jlines.append,
                                warn=lambda *_: None)
    model = str(tmp_path / "model")
    res = trainer.train_scene(tb, OptimizationConfig(**kw), log_every=1,
                              model_path=model, saving_iterations={24},
                              checkpoint_iterations={24},
                              progress=tlines.append, device="cpu")

    def parse(lines):
        return {int(ln.split("]")[0][6:]):
                float(ln.split("loss ")[1].split()[0])
                for ln in lines if " loss " in ln}
    want, got = parse(jlines), parse(tlines)
    assert got.keys() == want.keys() == {12, 24}
    for it in want:
        np.testing.assert_allclose(got[it], want[it], rtol=LOSS_RTOL,
                                   err_msg=f"iteration {it}")
    np.testing.assert_allclose(res.losses[-1], jres.last_loss,
                               rtol=LOSS_RTOL)
    assert len(res.losses) == 24 and res.losses[-1] < res.losses[0]
    assert int(res.final_settings.max_per_tile) == 512
    for path in ("point_cloud/iteration_24/point_cloud.ply",
                 "pose/pose_24.npy", "chkpnt24.npz"):
        assert os.path.exists(os.path.join(model, path)), path


@pytest.mark.parametrize("what", ["tile", "dup", "entry"])
def test_capacity_regrow(scene_dir, what):
    """A starved capacity regrows at the first log point with the JAX
    package's rule and warning; the grown dup and entry capacities render
    as a generous one does."""
    kw = dict(BUILD)
    if what == "tile":
        kw.update(max_per_tile=128)
    elif what == "dup":
        kw.update(max_tiles_per_gaussian=2, entry_cap=512 * 1024,
                  probe_dup_cap=False)
    else:
        kw.update(entry_cap=2048)
    data = readers.load_scene(scene_dir, eval_mode=False)
    bundle = scene_setup.build_scene(data, device="cpu", **kw)
    if what == "tile":     # the regrow that exists for the window path
        bundle = dataclasses.replace(bundle, settings=dataclasses.replace(
            bundle.settings, entry_stream=False))
    msgs = []
    res = trainer.train_scene(bundle, OptimizationConfig(
        iterations=4, psnr_threshold=15.0), log_every=1,
        progress=lambda *_: None, warn=msgs.append, device="cpu")
    final = res.final_settings
    field = {"tile": "max_per_tile", "dup": "max_tiles_per_gaussian",
             "entry": "max_total_entries"}[what]
    assert any(f"regrow {field}" in m for m in msgs), msgs
    assert getattr(final, field) > getattr(bundle.settings, field)
    if what == "tile":
        assert final.max_per_tile % 128 == 0
        return
    big = dataclasses.replace(final, max_tiles_per_gaussian=64,
                              max_total_entries=None)
    pose = res.state.poses.pose(0).detach()
    imgs = [render_mod.render(res.state.params, res.meta, st, pose,
                              torch.zeros(3), float(data.fovx[0]),
                              float(data.fovy[0]), device="cpu")
            for st in (final, big)]
    if int(imgs[0].aux.dup_overflow) == 0:
        torch.testing.assert_close(imgs[0].image, imgs[1].image, rtol=0,
                                   atol=1e-6)
    assert int(imgs[0].aux.entry_overflow) == 0 or what == "dup"
