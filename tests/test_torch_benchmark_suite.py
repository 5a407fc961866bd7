"""PyTorch port: the batch benchmark driver (``scripts/torch_run_benchmark_
suite.py``) against the JAX package's ``scripts/run_benchmark_suite.py``,
both ``main``s in-process on the CPU.

- ``masks``: JAX's own fixture (tests/test_misc_components.py) and two
  scenes that overlap in part: the printed tables equal.
- ``psnr``: one 10-frame synthetic scene at 32x48 (the (i+5)%10 split
  holds out frame 5), 27 iterations (3 epochs), GT dynamic masks and
  ``--strict_parity``; the port's trainer on the [T, K] window path, JAX's
  CPU path: ``psnr_davis.json`` within 1e-3 dB.
- the arguments: for every mode and flag, both drivers hand their
  trainer's ``main`` and ``render_sets`` the same arguments (each replaced
  by a recorder), the port's with ``--device`` / ``device=`` besides.
- ``render``: one real run of the port that writes the video or its GIF
  fallback, one frame a view.
- ``pose``: both drivers on a TINY ``.pth`` (``torch.save`` of the seeded
  reference state dict) over a synthetic ``tum`` sequence, each package's
  model class and converter pointed at TINY and its aligner at 2
  iterations: the mean ATE within 1e-4 relative (tests/test_torch_eval.py's
  bar for ``eval_pose_estimation``).
"""
import ast
import dataclasses
import functools
import importlib.util
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from das3r_tpu.eval import render_tool as jrender_tool
from das3r_tpu.models.croco import convert as jconvert
from das3r_tpu.models.croco import dust3r as jdust3r
from das3r_tpu.models.croco.testkit import TINY as JTINY
from das3r_tpu.predictor import alignment as jalign
from das3r_tpu.predictor import runner as jrunner
from das3r_tpu.train import trainer as jtrainer
from das3r_tpu_torch.data import rearrange
from das3r_tpu_torch.data.synthetic import make_synthetic_stage1_dir
from das3r_tpu_torch.eval import harness
from das3r_tpu_torch.eval import render_tool
from das3r_tpu_torch.models.croco import dust3r
from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                  random_torch_state_dict)
from das3r_tpu_torch.predictor import alignment as talign
from das3r_tpu_torch.predictor import runner as trunner
from das3r_tpu_torch.train import scene_setup
from das3r_tpu_torch.train import trainer

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
PSNR_DB = 1e-3
ATE_REL = 1e-4


def script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def both(argv, capsys) -> tuple[str, str, dict]:
    """JAX's ``main`` and the port's (on the CPU) on ``argv``: what each
    printed, the port's last line (its mode, card and seconds) apart, and
    what the port's returned."""
    capsys.readouterr()
    script("run_benchmark_suite").main(argv)
    want = capsys.readouterr().out
    got = script("torch_run_benchmark_suite").main(argv + ["--device",
                                                           "cpu"])
    out = capsys.readouterr().out.rstrip("\n").split("\n")
    last = json.loads(out[-1])
    assert last["mode"] == argv[0] and last["seconds"] > 0
    assert last.keys() == {"mode", "card", "seconds"}
    return want, "\n".join(out[:-1]) + "\n", got


def write_mask(path: Path, box) -> None:
    m = np.zeros((16, 16), np.uint8)
    m[box] = 255
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(m).save(path)


@pytest.mark.parametrize("case", ["jax_fixture", "partial_overlap"])
def test_masks_mode_matches_jax(tmp_path, capsys, case):
    scenes = ["blackswan"] if case == "jax_fixture" else ["camel", "dog"]
    pred_box = (slice(4, 10), slice(4, 10))
    for k, scene in enumerate(scenes):
        for i in range(2 if case == "jax_fixture" else 3):
            gt_box = (pred_box if case == "jax_fixture"
                      else (slice(4 + i + k, 12), slice(2, 9 + k)))
            write_mask(tmp_path / "out" / scene / f"dynamic_mask_{i:04d}.png",
                       pred_box)
            write_mask(tmp_path / "gt" / scene / f"{i:05d}.png", gt_box)
    argv = ["masks", "--dataset", "davis", "--data_root", str(tmp_path),
            "--output_root", str(tmp_path / "out"), "--gt_dynamic_mask",
            str(tmp_path / "gt"), "--scenes", *scenes]
    want, got, ret = both(argv, capsys)
    assert got == want
    mean_j = ret["result"]["summary"]["mean_J"]
    if case == "jax_fixture":
        assert '"mean_J": 1.0' in got
    else:
        assert 0 < mean_j < 1


def synthetic_scene(root: Path, gt_root: Path, scene: str, frames: int,
                    height: int, width: int, seed: int = 0) -> None:
    """A synthetic stage-1 scene rearranged into ``root/scene`` and its GT
    dynamic masks in the DAVIS layout (``gt_root/scene/00000.png``)."""
    stage1 = root / f"{scene}_stage1"
    make_synthetic_stage1_dir(str(stage1), n_frames=frames, height=height,
                              width=width, seed=seed)
    rearrange.rearrange_scene(str(stage1), str(root / scene))
    (gt_root / scene).mkdir(parents=True)
    for p in sorted(stage1.glob("dynamic_mask_*.png")):
        shutil.copy(p, gt_root / scene / f"{int(p.stem.split('_')[-1]):05d}"
                    ".png")
    shutil.rmtree(stage1)


def window_path(build):
    """``build_scene`` on the [T, K] window path, JAX's CPU path."""
    def build_window(*a, **k):
        bundle = build(*a, **k)
        return dataclasses.replace(bundle, settings=dataclasses.replace(
            bundle.settings, entry_stream=False))
    return build_window


def test_psnr_mode_matches_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(scene_setup, "build_scene",
                        window_path(scene_setup.build_scene))
    data, gt = tmp_path / "data", tmp_path / "gt"
    synthetic_scene(data, gt, "blackswan", 10, 32, 48)
    tables = {}
    for name, extra in (("run_benchmark_suite", []),
                        ("torch_run_benchmark_suite", ["--device", "cpu"])):
        out = tmp_path / name
        script(name).main(
            ["psnr", "--dataset", "davis", "--data_root", str(data),
             "--output_root", str(out), "--iterations", "27",
             "--scenes", "blackswan", "--gt_dynamic_mask", str(gt),
             "--strict_parity"] + extra)
        tables[name] = json.loads((out / "psnr_davis.json").read_text())
    capsys.readouterr()
    want, got = tables.values()
    print(f"PSNR {got} against {want}")
    assert got.keys() == want.keys() == {"blackswan", "average"}
    assert np.isfinite(got["blackswan"])
    assert abs(got["blackswan"] - want["blackswan"]) <= PSNR_DB
    assert got["average"] == got["blackswan"] == harness.last_psnr(
        str(tmp_path / "torch_run_benchmark_suite" / "blackswan"
            / "test_log.txt"))


def recording_trainer(calls: list):
    def main(argv):
        calls.append(("trainer", list(argv)))
        model = argv[argv.index("-m") + 1]
        os.makedirs(model, exist_ok=True)
        with open(os.path.join(model, "test_log.txt"), "w") as f:
            f.write("[ITER 7] Evaluating test: L1 0.1 PSNR 20.5\n")
    return main


def recording_render_sets(calls: list):
    def render_sets(src, mdl, iteration, **kw):
        calls.append(("render_sets", [src, mdl, iteration], kw))
        out_dir = os.path.join(mdl, f"renders_{iteration}")
        os.makedirs(out_dir, exist_ok=True)
        Image.new("RGB", (4, 4)).save(os.path.join(out_dir, "render.gif"))
        return out_dir, []
    return render_sets


MODE_FLAGS = [
    ("render", "davis", []), ("render", "sintel", ["--iterations", "7"]),
    ("psnr", "davis", []), ("psnr", "sintel", ["--iterations", "7"]),
    ("psnr", "davis", ["--gt_dynamic_mask", "GT"]),
    ("psnr", "davis", ["--strict_parity"]),
    ("psnr", "sintel", ["--gt_dynamic_mask", "GT", "--strict_parity",
                        "--scenes", "alley_2", "cave_2"]),
]


@pytest.mark.parametrize("mode, dataset, flags", MODE_FLAGS)
def test_arguments_match_jax(tmp_path, capsys, monkeypatch, mode, dataset,
                             flags):
    calls = {"jax": [], "port": []}
    for side, tr, rt in (("jax", jtrainer, jrender_tool),
                         ("port", trainer, render_tool)):
        monkeypatch.setattr(tr, "main", recording_trainer(calls[side]))
        monkeypatch.setattr(rt, "render_sets",
                            recording_render_sets(calls[side]))
    argv = [mode, "--dataset", dataset, "--data_root", "DATA",
            "--output_root", str(tmp_path / "out")] + flags
    want, got, ret = both(argv, capsys)
    # the port prints the video it wrote after each render
    assert "".join(ln for ln in got.splitlines(True)
                   if ": wrote " not in ln) == want
    n = (len(harness.DAVIS_SCENES) if dataset == "davis" and "--scenes"
         not in flags else len(harness.SINTEL_SCENES) if "--scenes"
         not in flags else 2)
    assert len([c for c in calls["jax"] if c[0] == "trainer"]) == n
    port = []
    for c in calls["port"]:
        if c[0] == "trainer":
            assert c[1][-2:] == ["--device", "cpu"]
            port.append(("trainer", c[1][:-2]))
        else:
            assert c[2].pop("device") == "cpu"
            port.append(c)
    assert port == calls["jax"]
    if mode == "psnr":
        assert ret["result"] == json.loads(
            (tmp_path / "out" / f"psnr_{dataset}.json").read_text())
        assert harness.format_psnr_table(ret["result"]) in got
    else:
        assert all(v.endswith("render.gif") for v in ret["result"].values())


def test_render_mode_writes_the_video(tmp_path, capsys):
    """``render`` for real on one 6-frame scene, 12 iterations on every
    frame: the renders and the video (an mp4, or the GIF fallback) of one
    frame a view, the file written printed."""
    data = tmp_path / "data"
    synthetic_scene(data, tmp_path / "gt", "camel", 6, 32, 48)
    ret = script("torch_run_benchmark_suite").main(
        ["render", "--data_root", str(data), "--output_root",
         str(tmp_path / "out"), "--iterations", "12", "--scenes", "camel",
         "--device", "cpu"])
    video = ret["result"]["camel"]
    assert f"wrote {video}" in capsys.readouterr().out
    assert Path(video).parent == tmp_path / "out" / "camel" / "renders_12"
    assert len(list(Path(video).parent.glob("*.png"))) == 6
    if video.endswith(".gif"):
        assert Image.open(video).n_frames == 6
    else:
        assert video.endswith(".mp4") and os.path.getsize(video) > 0


def tum_layout(root: Path, seq: str, n_frames: int = 4) -> None:
    """``root/tum/seq/rgb_50`` frames and ``groundtruth_50.txt``."""
    gen = root / "gen"
    make_synthetic_stage1_dir(str(gen), n_frames=n_frames, height=48,
                              width=64, seed=2)
    seq_dir = root / "tum" / seq
    (seq_dir / "rgb_50").mkdir(parents=True)
    for p in sorted(gen.glob("frame_*.png")):
        shutil.copy(p, seq_dir / "rgb_50")
    shutil.copy(gen / "pred_traj.txt", seq_dir / "groundtruth_50.txt")
    shutil.rmtree(gen)


def test_pose_mode_matches_jax(tmp_path, capsys, monkeypatch):
    seq = "rgbd_synthetic"
    tum_layout(tmp_path, seq)
    sd = random_torch_state_dict(TINY, np.random.default_rng(0))
    pth = tmp_path / "tiny.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               pth)
    # TINY in place of DUST3R_LARGE_CONFIG, 2 aligner iterations without
    # the smoothing and flow terms, frames at a long side of 64
    monkeypatch.setattr(jdust3r, "AsymmetricCroCo3D", functools.partial(
        jdust3r.AsymmetricCroCo3D, JTINY))
    monkeypatch.setattr(jconvert, "convert_torch_state_dict",
                        functools.partial(jconvert.convert_torch_state_dict,
                                          cfg=JTINY))
    monkeypatch.setattr(dust3r, "AsymmetricCroCo3D", functools.partial(
        dust3r.AsymmetricCroCo3D, TINY))
    cfg = dict(niter=2, flow_loss_weight=0.0, temporal_smoothing_weight=0.0)
    for mod in (jalign, talign):
        monkeypatch.setattr(mod, "AlignerConfig", functools.partial(
            mod.AlignerConfig, **cfg))
    for mod in (jrunner, trunner):
        orig = mod.load_frames
        monkeypatch.setattr(mod, "load_frames",
                            lambda d, size=512, _f=orig, **kw: _f(d, size=64,
                                                                  **kw))
    sums = {}
    for name, extra in (("run_benchmark_suite", []),
                        ("torch_run_benchmark_suite", ["--device", "cpu"])):
        capsys.readouterr()
        script(name).main(["pose", "--dataset", "tum", "--data_root",
                           str(tmp_path), "--output_root",
                           str(tmp_path / name), "--ckpt", str(pth),
                           "--scenes", seq] + extra)
        lines = capsys.readouterr().out.strip().splitlines()
        summary = [ln for ln in lines if ln.startswith("{'n_sequences'")]
        sums[name] = ast.literal_eval(summary[-1])
    want, got = sums.values()
    print(f"summary {got} against {want}")
    assert got.keys() == want.keys()
    assert got["n_ok"] == got["n_sequences"] == want["n_ok"] == 1
    for k in ("mean_ate", "mean_rpe_trans", "mean_rpe_rot"):
        assert np.isfinite(got[k])
    assert abs(got["mean_ate"] - want["mean_ate"]) <= ATE_REL * abs(
        want["mean_ate"])
    assert (tmp_path / "torch_run_benchmark_suite" / "tum_summary.txt"
            ).exists()


def test_pose_mode_needs_every_key(tmp_path, monkeypatch):
    """A ``.pth`` that lacks a key of the model (TINY's here) raises,
    naming it, before any sequence runs."""
    monkeypatch.setattr(dust3r, "AsymmetricCroCo3D", functools.partial(
        dust3r.AsymmetricCroCo3D, TINY))
    sd = random_torch_state_dict(TINY, np.random.default_rng(0))
    sd.pop("enc_norm.weight")
    pth = tmp_path / "bad.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               pth)
    with pytest.raises(KeyError, match="enc_norm.weight"):
        script("torch_run_benchmark_suite").main(
            ["pose", "--dataset", "tum", "--data_root", str(tmp_path),
             "--output_root", str(tmp_path / "out"), "--ckpt", str(pth),
             "--device", "cpu"])
    assert not (tmp_path / "out").exists()
