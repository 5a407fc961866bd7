"""PyTorch port: the end-to-end quality path (``scripts/torch_quality_e2e.py``)
against the JAX package's ``scripts/quality_e2e.py``, both run in-process on
the CPU at a small size, and the stage-2 trainer's long-run schedule: the
4000-iteration chunk plan and the SH-degree bump at iteration 3000, crossed
by both trainers from one checkpoint."""
import dataclasses
import filecmp
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from das3r_tpu.train import trainer as jtrainer
from das3r_tpu.train.config import OptimizationConfig as JaxConfig
from das3r_tpu_torch.train import checkpoint as ckpt
from das3r_tpu_torch.train import scene_setup
from das3r_tpu_torch.train import step as step_mod
from das3r_tpu_torch.train import trainer
from das3r_tpu_torch.train.config import OptimizationConfig

from test_torch_trainer import LOSS_RTOL, both_bundles, scene_dir  # noqa

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
PSNR_DB = 1e-3      # dB: the trainer test's 7.9e-6 relative loss carried on
ATE_ABS = 1e-4
SMALL = ["--frames", "6", "--height", "48", "--width", "64"]


def script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_record(argv, capsys) -> dict:
    """JAX's ``quality_e2e.main`` (its record is printed, not returned)."""
    capsys.readouterr()
    script("quality_e2e").main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def window_path(build):
    """``build_scene`` on the [T, K] window path, JAX's CPU path (its
    probed K truncates this scene's densest tiles in both packages)."""
    def build_window(*a, **k):
        bundle = build(*a, **k)
        return dataclasses.replace(bundle, settings=dataclasses.replace(
            bundle.settings, entry_stream=False))
    return build_window


def test_gt_branch_matches_jax(tmp_path, capsys, monkeypatch):
    """``--stage1 gt`` with pose noise 0.02 (seed 11), 16 iterations, the
    port's trainer on JAX's CPU path (``window_path``): the rearranged
    scenes and the noisy trajectories bitwise equal, the initial ATE
    equal, the masked test PSNR within 1e-3 dB and the final ATE within
    1e-4."""
    monkeypatch.setattr(scene_setup, "build_scene",
                        window_path(scene_setup.build_scene))
    argv = SMALL + ["--iters", "16", "--pose_noise", "0.02"]
    want = jax_record(["--work", str(tmp_path / "jax")] + argv, capsys)
    got = script("torch_quality_e2e").main(
        ["--work", str(tmp_path / "port"), "--device", "cpu"] + argv)
    for sub in ("scene", "gt_masks/scene"):
        a, b = tmp_path / "jax" / sub, tmp_path / "port" / sub
        files = sorted(str(p.relative_to(a)) for p in a.rglob("*")
                       if p.is_file())
        assert files == sorted(str(p.relative_to(b)) for p in b.rglob("*")
                               if p.is_file())
        match, mismatch, errors = filecmp.cmpfiles(a, b, files,
                                                   shallow=False)
        assert not mismatch and not errors, (sub, mismatch, errors)
    assert ((tmp_path / "jax/stage1/pred_traj.txt").read_bytes()
            == (tmp_path / "port/stage1/pred_traj.txt").read_bytes())
    np.testing.assert_array_equal(
        np.load(tmp_path / "port/model/pose/pose_org.npy"),
        np.load(tmp_path / "jax/model/pose/pose_org.npy"))
    w, g = want["detail"], got["detail"]
    assert g["ate_init"] == w["ate_init"]

    def psnr(work):
        return script("torch_quality_e2e").final_test_psnr(
            str(work / "model" / "test_log.txt"), 16)
    d_psnr = abs(psnr(tmp_path / "port") - psnr(tmp_path / "jax"))
    print(f"PSNR {psnr(tmp_path / 'port')} against {psnr(tmp_path / 'jax')}"
          f" dB; ATE {g['ate_final']} against {w['ate_final']}")
    assert d_psnr <= PSNR_DB
    assert abs(g["ate_final"] - w["ate_final"]) <= ATE_ABS
    assert {k: v for k, v in got.items() if k not in ("card", "seconds")
            }.keys() == want.keys()
    assert g.keys() == w.keys()


def stub_trainer(argv):
    """A trainer ``main`` that trains nothing: the test log line the
    scripts read, for their stage-1 part alone."""
    model = argv[argv.index("-m") + 1]
    iters = argv[argv.index("--iter") + 1]
    os.makedirs(model, exist_ok=True)
    with open(os.path.join(model, "test_log.txt"), "w") as f:
        f.write(f"[ITER {iters}] Evaluating test: L1 0.0 PSNR 0.0\n")


def trained_like_npz(path: str) -> str:
    """TINY's seed-0 weights with every upsampling bias untied and its
    k*k taps drawn apart (as stage-1 training leaves them), written in the
    JAX package's npz format."""
    from das3r_tpu_torch.models.croco.dpt import untie_upsample_bias
    from das3r_tpu_torch.predictor import train_loop
    model = tiny_model()
    untie_upsample_bias(model)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 3 and name.endswith("bias"):      # [C, k, k] taps
                p.add_(torch.as_tensor(rng.normal(0, 0.05, p.shape),
                                       dtype=p.dtype))
    train_loop.save_params_npz(path, model)
    return path


def tiny_model():
    from das3r_tpu_torch.models.croco.convert import load_reference_state_dict
    from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
    from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                      random_torch_state_dict)
    model = AsymmetricCroCo3D(TINY)
    load_reference_state_dict(model, random_torch_state_dict(
        TINY, np.random.default_rng(0)))
    return model


@pytest.mark.parametrize("ckpt", [False, True], ids=["seeded", "npz"])
def test_predictor_branch_matches_jax(tmp_path, capsys, monkeypatch, ckpt):
    """``--stage1 predictor`` on TINY's seeded random weights (``npz``:
    ``--stage1_ckpt`` of weights whose upsampling biases' taps differ,
    ``trained_like_npz``), 6 frames at the generator's 64x96, the
    script's 50 alignment iterations: the stage-1 mask IoU equal, the
    stage-1 ATE within 1e-4 (the trainer stubbed in both:
    ``test_gt_branch_matches_jax`` holds it)."""
    monkeypatch.setattr(jtrainer, "main", stub_trainer)
    monkeypatch.setattr(trainer, "main", stub_trainer)
    argv = ["--stage1", "predictor", "--frames", "6", "--height", "64",
            "--width", "96", "--iters", "1"]
    if ckpt:
        argv += ["--stage1_ckpt", trained_like_npz(str(tmp_path / "w.npz"))]
    want = jax_record(["--work", str(tmp_path / "jax")] + argv, capsys)
    got = script("torch_quality_e2e").main(
        ["--work", str(tmp_path / "port"), "--device", "cpu"] + argv)
    w, g = want["detail"], got["detail"]
    print(f"IoU {g['stage1_mask_iou']} against {w['stage1_mask_iou']}; "
          f"ATE {g['stage1_ate']} against {w['stage1_ate']}")
    assert g["stage1_mask_iou"] == w["stage1_mask_iou"]
    assert abs(g["stage1_ate"] - w["stage1_ate"]) <= ATE_ABS
    assert g.keys() == w.keys()


@pytest.mark.parametrize("densify, white", [(False, False), (True, False),
                                            (True, True)])
def test_4000_iteration_schedule_matches_jax(densify, white):
    """The chunk plan of a 4000-iteration run over 14 training frames
    (QUALITY_r05.json's 16 frames less the held-out two), with densify and
    opacity-reset events at the trainer's defaults, and the SH degree of
    each chunk, equal to JAX's; the plan cuts at iteration 3000."""
    cfg, jcfg = OptimizationConfig(iterations=4000), JaxConfig(
        iterations=4000)
    events = trainer._densify_schedule(cfg, densify, white)
    assert events == jtrainer._densify_schedule(jcfg, densify, white)
    extra = events[0] | events[1]
    got = trainer._plan_chunks(4000, 14, 0, extra_boundaries=extra)
    want = jtrainer._plan_chunks(4000, 14, 0, extra_boundaries=extra)
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert 3000 in [s for s, _ in got]
    assert sum(len(u) for _, u in got) == 4000
    assert [min(s // 3000, 3) for s, _ in got].count(1) > 0


def test_sh_bump_matches_jax(scene_dir, tmp_path):   # noqa: F811
    """Both trainers resumed from one checkpoint at iteration 2988, an
    epoch boundary (the port writes it, JAX reads it), and run to 3008
    across the SH-degree bump at 3000 (degree 0 to 1, on the window path,
    JAX's CPU path): the logged losses and the last loss within
    LOSS_RTOL, and both trainers' settings at degree 1 at the end."""
    build = dict(sh_degree=1, max_per_tile=512, max_tiles_per_gaussian=16,
                 max_points=2048)
    jb, tb = both_bundles(scene_dir, False, **build)
    tb = dataclasses.replace(tb, settings=dataclasses.replace(
        tb.settings, entry_stream=False))
    start = 2988                      # the epoch boundary of 12 frames
    assert start % tb.scene.n_frames == 0
    state = step_mod.init_train_state(tb.params, tb.poses)
    path = str(tmp_path / "chkpnt.npz")
    ckpt.save_train_state(path, dataclasses.replace(state, step=start),
                          meta=tb.meta)
    kw = dict(iterations=3008, psnr_threshold=15.0)
    jlines, tlines = [], []
    jres = jtrainer.train_scene(jb, JaxConfig(**kw), log_every=1,
                                start_checkpoint=path,
                                progress=jlines.append,
                                warn=lambda *_: None)
    res = trainer.train_scene(tb, OptimizationConfig(**kw), log_every=1,
                              start_checkpoint=path, progress=tlines.append,
                              warn=lambda *_: None, device="cpu")

    def parse(lines):
        return {int(ln.split("]")[0][6:]):
                float(ln.split("loss ")[1].split()[0])
                for ln in lines if " loss " in ln}
    want, got = parse(jlines), parse(tlines)
    print(f"losses {got} against {want}; last {res.losses[-1]} against "
          f"{jres.last_loss}")
    assert got.keys() == want.keys() and 3000 in got
    for it in want:
        np.testing.assert_allclose(got[it], want[it], rtol=LOSS_RTOL,
                                   err_msg=f"iteration {it}")
    np.testing.assert_allclose(res.losses[-1], jres.last_loss,
                               rtol=LOSS_RTOL)
    assert res.final_settings.sh_degree == jres.final_settings.sh_degree == 1
