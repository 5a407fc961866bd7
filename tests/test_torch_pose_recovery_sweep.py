"""PyTorch port: the pose-recovery sweep (``scripts/torch_pose_recovery_
sweep.py``) against the JAX package's ``scripts/pose_recovery_sweep.py``.

With each sweep's quality ``main`` replaced by a recorder (the module each
imports stubbed in ``sys.modules``), the two run the same arms in the same
order with the same arguments (``--cpu`` for ``--device cpu``) and write
JSONL records with the same keys. Then one real frozen arm of the port on
the CPU at 6 frames, 32x48, 20 iterations: the camera Adam off leaves the
trajectory where the noise put it, ``ate_final == ate_init``.
"""
import importlib.util
import json
import math
import sys
import types
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recorder(calls: list):
    """A quality ``main`` that trains nothing: it keeps its argv and
    prints a record of the quality script's shape, with a regrow warning
    and the port's extra keys."""
    def main(argv):
        calls.append(list(argv))
        sigma = float(argv[argv.index("--pose_noise") + 1])
        print("[ITER 10] entry overflow 3: regrow max_total_entries")
        print(json.dumps({
            "metric": "synthetic_e2e_masked_test_psnr_20it", "value": 30.0,
            "unit": "dB", "vs_baseline": 1.0,
            "detail": {"pose_noise": sigma,
                       "optim_pose": "--no-optim-pose" not in argv,
                       "psnr_threshold": float(
                           argv[argv.index("--psnr_threshold") + 1]),
                       "ate_init": 0.5, "ate_final": 0.25}}))
    return main


@pytest.mark.parametrize("gate0", [False, True], ids=["two_arms",
                                                      "gate0"])
def test_arm_plans_and_records_match_jax(tmp_path, monkeypatch, capsys,
                                         gate0):
    argv = ["--frames", "6", "--height", "32", "--width", "48", "--iters",
            "20", "--sigmas", "0.02", "0.1"] + (["--gate0"] if gate0 else [])
    runs = {}
    for name, module, extra in (
            ("pose_recovery_sweep", "quality_e2e", ["--cpu"]),
            ("torch_pose_recovery_sweep", "torch_quality_e2e",
             ["--device", "cpu"])):
        calls = []
        monkeypatch.setitem(sys.modules, module, types.SimpleNamespace(
            main=recorder(calls)))
        out = tmp_path / f"{name}.jsonl"
        script(name).main(argv + extra + [
            "--work", str(tmp_path / name), "--out", str(out)])
        runs[name] = calls, [json.loads(line) for line in
                             out.read_text().splitlines()]
    capsys.readouterr()
    (jcalls, jrecs), (tcalls, trecs) = runs.values()
    assert len(jcalls) == (6 if gate0 else 4)

    def plan(calls, name):
        """each arm's argv, its work directory relative to --work"""
        out = []
        for c in calls:
            c = list(c)
            c[1] = str(Path(c[1]).relative_to(tmp_path / name))
            out.append(c)
        return out
    want = [c[:-1] + ["--device", "cpu"] if c[-1] == "--cpu" else c
            for c in plan(jcalls, "pose_recovery_sweep")]
    assert plan(tcalls, "torch_pose_recovery_sweep") == want
    assert len(trecs) == len(jrecs)
    for t, j in zip(trecs, jrecs):
        assert t.keys() == j.keys() and t["detail"].keys() == j[
            "detail"].keys()
        assert t["detail"]["n_regrow"] == j["detail"]["n_regrow"] == 1
        assert t["detail"]["n_compile_fallback"] == 0
        assert ({k: v for k, v in t["detail"].items() if k != "wall_s"}
                == {k: v for k, v in j["detail"].items() if k != "wall_s"})


def test_default_out_is_not_jax_record(tmp_path, monkeypatch, capsys):
    """Without ``--out`` the port's sweep writes build/pose_recovery.jsonl
    of its checkout (here one at ``tmp_path``), never docs/ (the JAX
    package's record)."""
    calls = []
    monkeypatch.setitem(sys.modules, "torch_quality_e2e",
                        types.SimpleNamespace(main=recorder(calls)))
    record = ROOT / "docs" / "pose_recovery_r5.jsonl"
    before = record.read_bytes()
    mod = script("torch_pose_recovery_sweep")
    monkeypatch.setattr(mod, "ROOT", str(tmp_path))
    mod.main(["--sigmas", "0.05", "--device", "cpu"])
    default = tmp_path / "build" / "pose_recovery.jsonl"
    assert len(default.read_text().splitlines()) == 2
    assert all(Path(c[1]).parent == tmp_path / "build" / "posesweep"
               for c in calls)
    assert record.read_bytes() == before
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "out"] == str(default)


def test_frozen_arm_keeps_its_trajectory(tmp_path, capsys):
    """One real frozen arm (``--no-optim-pose``) of the port's sweep on
    the CPU: a finite PSNR, ``ate_final == ate_init`` and the JAX record's
    keys."""
    mod = script("torch_pose_recovery_sweep")
    args = types.SimpleNamespace(frames=6, height=32, width=48, iters=20,
                                 max_points=0, device="cpu")
    qmain = script("torch_quality_e2e").main
    rec = mod.run_arm(qmain, str(tmp_path / "arm"), 0.05, False, 26.0, args)
    capsys.readouterr()
    d = rec["detail"]
    print(d)
    assert d["optim_pose"] is False and d["pose_noise"] == 0.05
    assert d["ate_final"] == d["ate_init"] > 0
    assert math.isfinite(rec["value"])
    jax_keys = json.loads((ROOT / "docs" / "pose_recovery_r5.jsonl")
                          .read_text().splitlines()[0])["detail"].keys()
    assert set(jax_keys) <= set(d)
