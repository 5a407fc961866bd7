"""PyTorch port: the TINY stage-1 trainer (``scripts/torch_train_tiny_stage1
.py``) against the JAX package's ``scripts/train_tiny_stage1.py``, both
``main``s in-process on the CPU at 1 epoch of 16 pairs (2 steps) and 8
held-out pairs: every loss of the epoch within 1e-4 relative (the bar of
tests/test_torch_stage1_training.py for TINY steps), the held-out mask
IoU within 1e-3, the records' keys
equal; and each package's ``stage1_tiny.npz`` loaded into the other's
model with ``load_params_npz``, the predictions there within 1e-4 x
max|ref| of the writer's own.
"""
import importlib.util
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.models.croco.convert import convert_torch_state_dict
from das3r_tpu.models.croco.dust3r import AsymmetricCroCo3D as JModel
from das3r_tpu.models.croco.testkit import TINY as JTINY
from das3r_tpu.predictor import train_loop as jloop
from das3r_tpu_torch.models.croco.dpt import untie_upsample_bias
from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                  random_torch_state_dict)
from das3r_tpu_torch.predictor import train_loop
from das3r_tpu_torch.predictor.datasets import (WallTwoViewDataset,
                                                batch_iterator)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
IOU_ABS = 1e-3
PRED_BAR = 1e-4     # x max|ref| per output map
ARGV = ["--epochs", "1", "--n_train", "16", "--n_test", "8"]


def script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def epoch_losses(out: Path) -> dict:
    """Every loss of ``log.txt``'s epoch lines, by epoch and key."""
    got = {}
    for line in (out / "log.txt").read_text().splitlines():
        entry = json.loads(line)
        got.update({(entry["epoch"], k): v for k, v in entry.items()
                    if "loss" in k})
    return got


def kept_checkpoints(written: list):
    """``fit``'s checkpoint writer replaced by a record of the files it
    is asked to write: each is TINY's parameters and AdamW moments,
    ~870 MB, and their format is held across the packages by
    tests/test_torch_stage1_data.py."""
    def save(path, *args, **kw):
        written.append(Path(path).name)
    return save


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ``main``s at 1 epoch; JAX's writers given ``np.savez`` for
    ``savez_compressed`` (zlib takes tens of seconds on TINY's 72M
    values; ``np.load`` reads both); ``fit``'s checkpoints recorded, not
    written (``kept_checkpoints``)."""
    work = tmp_path_factory.mktemp("tiny")
    written = {"jax": [], "port": []}
    mp = pytest.MonkeyPatch()
    mp.setattr(np, "savez_compressed", np.savez)
    mp.setattr(jloop, "_save_ckpt", kept_checkpoints(written["jax"]))
    mp.setattr(train_loop, "_save_ckpt", kept_checkpoints(written["port"]))
    try:
        buf = io.StringIO()
        with redirect_stdout(buf):
            script("train_tiny_stage1").main(
                ARGV + ["--out", str(work / "jax")])
        want = json.loads(buf.getvalue().strip().splitlines()[-1])
        got = script("torch_train_tiny_stage1").main(
            ARGV + ["--out", str(work / "port"), "--device", "cpu"])
    finally:
        mp.undo()
    assert written["port"] == written["jax"] and written["jax"]
    return work, want, got


def test_tiny_trainer_matches_jax(runs):
    work, want, got = runs
    jl, tl = epoch_losses(work / "jax"), epoch_losses(work / "port")
    print(f"IoU {got['value']} against {want['value']}; losses {tl} "
          f"against {jl}")
    assert tl.keys() == jl.keys() and jl
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(got["detail"]["final_train_loss"],
                               want["detail"]["final_train_loss"],
                               rtol=LOSS_RTOL)
    assert abs(got["value"] - want["value"]) <= IOU_ABS
    assert {k: v for k, v in got.items() if k not in ("card", "seconds")
            }.keys() == want.keys()
    assert got["detail"].keys() == want["detail"].keys()
    assert ({k: v for k, v in got["detail"].items()
             if k not in ("train_s", "final_train_loss", "ckpt")}
            == {k: v for k, v in want["detail"].items()
                if k not in ("train_s", "final_train_loss", "ckpt")})
    assert Path(got["detail"]["ckpt"]) == work / "port" / "stage1_tiny.npz"


def test_checkpoints_cross_load(runs):
    """JAX's npz into the port's TINY (upsampling biases untied first, as
    the quality script loads it) against JAX's model on its own params,
    and the port's npz into JAX's params tree against the port's model on
    its own file, on 4 held-out pairs: every output map within 1e-4 x
    max|ref|."""
    work, _, _ = runs
    mod = script("torch_train_tiny_stage1")
    img1, img2, _ = next(batch_iterator(
        WallTwoViewDataset(n=4, resolution=(64, 48), seed=999), 4, seed=0,
        shuffle=False))
    jmodel = JModel(JTINY)
    template = jax.tree.map(jnp.asarray, convert_torch_state_dict(
        random_torch_state_dict(TINY, np.random.default_rng(0)), JTINY))

    def jax_preds(path):
        params = jloop.load_params_npz(str(path), template)
        return jmodel.apply({"params": params}, jnp.asarray(img1),
                            jnp.asarray(img2), deterministic=True)

    def port_preds(path):
        model = mod.seeded_model("cpu")
        untie_upsample_bias(model)
        train_loop.load_params_npz(str(path), model)
        with torch.no_grad():
            return model(torch.as_tensor(img1), torch.as_tensor(img2))

    for writer in ("jax", "port"):
        npz = work / writer / "stage1_tiny.npz"
        j, t = jax_preds(npz), port_preds(npz)
        for view in (0, 1):
            for k, ref in j[view].items():
                ref = np.asarray(ref)
                got = t[view][k].numpy()
                err = np.abs(got - ref).max() / np.abs(ref).max()
                assert err <= PRED_BAR, (writer, view, k, err)


def test_mask_iou_eval_matches_jax(runs):
    """Both scripts' ``mask_iou_eval`` on JAX's trained weights (the port's
    model loading JAX's npz) over the 8 held-out pairs, at a threshold of
    the predictions' mean, where the masks are not empty (at 0.5 after
    one epoch they are): the IoUs within 1e-3."""
    work, _, _ = runs
    mod = script("torch_train_tiny_stage1")
    jmod = script("train_tiny_stage1")
    test_ds = WallTwoViewDataset(n=8, resolution=(64, 48), seed=999)
    npz = str(work / "jax" / "stage1_tiny.npz")
    params = jloop.load_params_npz(npz, jax.tree.map(
        jnp.asarray, convert_torch_state_dict(
            random_torch_state_dict(TINY, np.random.default_rng(0)), JTINY)))
    model = mod.seeded_model("cpu")
    untie_upsample_bias(model)
    train_loop.load_params_npz(npz, model)
    img1, img2, _ = next(batch_iterator(test_ds, 8, seed=0, shuffle=False))
    with torch.no_grad():
        r1, r2 = model(torch.as_tensor(img1), torch.as_tensor(img2))
    thr = float(torch.cat([r1["dynamic_mask"], r2["dynamic_mask"]]).mean())
    want = jmod.mask_iou_eval(JModel(JTINY), params, test_ds, thr=thr)
    got = mod.mask_iou_eval(model, test_ds, thr=thr, device="cpu")
    print(f"IoU at {thr}: {got} against {want}")
    assert 0 < want < 1 and abs(got - want) <= IOU_ABS
