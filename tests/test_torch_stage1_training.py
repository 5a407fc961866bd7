"""PyTorch port: stage-1 training (``predictor/{losses,training}.py``)
against the JAX package on the same weights and batches.

The model is the testkit's TINY config at 32x48 on seeded random weights
in the reference layout (the JAX package converts them); batches are
numpy from a seed, as ``tests/test_stage1_training.py::make_batch`` makes
them but with ``valid`` masks that are not all ones. TF32 is off.

Bars:
  * the losses: 1e-5 x |ref| for one evaluation; 1e-4 x |ref| after
    three steps (the stage-1 bar of PERF.md section 2);
  * the first step's gradient: 2e-5 x max|g| per tensor (the JAX
    gradient bar);
  * the parameters after three steps: 1e-4 x max|ref| per tensor where
    Adam's update is a smooth function of the gradient (eps 1e-2). At the
    recipe's eps 1e-8 the first update is lr x sign(g), so an element
    whose gradient is within float32 rounding of zero steps +-lr in
    either package: there every element is held within 2 x lr x steps
    and at most 1% of them beyond 1e-4 x max|ref| (measured: 1 of 36.2M
    on this batch, 0.18% on one whose rows share their valid fractions).
"""
import json
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
from das3r_tpu.predictor import losses as jlosses
from das3r_tpu.predictor import training as jtraining
from das3r_tpu_torch.models.croco import convert
from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                  random_torch_state_dict)
from das3r_tpu_torch.predictor import losses, training

import torch_parallel_workers as workers

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
H, W = 32, 48
SEED = 3
LOSS_REL = 1e-5
STEP_LOSS_REL = 1e-4
GRAD_REL = 2e-5
PARAM_REL = 1e-4
SIGN_NOISE_SHARE = 0.01
LR = 1e-3
STEPS = 3
SPAWN_TIMEOUT = 120        # s, both ranks, start-up included


def make_batch(rng, b=2, h=H, w=W, valid_share=((0.9, 0.8), (0.3, 0.2))):
    """(img1, img2, the Stage1Batch fields as numpy): JAX's ``make_batch``
    with ``valid`` masks of the given shares per row (views 1 and 2)."""
    pts1 = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32) + [0, 0, 4]
    pts2 = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32) + [0, 0, 4]
    pose1 = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose1[:, :3, 3] = rng.normal(0, 0.1, (b, 3))
    mask1 = (rng.uniform(0, 1, (b, h, w)) > 0.8).astype(np.float32)
    mask2 = (rng.uniform(0, 1, (b, h, w)) > 0.8).astype(np.float32)
    share = np.asarray(valid_share, np.float64)[:, :, None, None]
    valid1 = rng.uniform(0, 1, (b, h, w)) < share[:, 0]
    valid2 = rng.uniform(0, 1, (b, h, w)) < share[:, 1]
    img1 = rng.standard_normal((b, 3, h, w)).astype(np.float32)
    img2 = rng.standard_normal((b, 3, h, w)).astype(np.float32)
    return img1, img2, (pts1.astype(np.float32), pts2.astype(np.float32),
                        pose1, valid1, valid2, mask1, mask2)


def jbatch(fields):
    return jlosses.Stage1Batch(*map(jnp.asarray, fields))


def tbatch(fields):
    return losses.Stage1Batch(*fields).to("cpu")


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.fixture(scope="module")
def weights():
    sd = random_torch_state_dict(TINY, np.random.default_rng(SEED))
    params = jax.tree.map(jnp.asarray, convert_torch_state_dict(sd, JTINY))
    return sd, params


def port_model(sd):
    model = AsymmetricCroCo3D(TINY)
    convert.load_reference_state_dict(model, sd)
    return model


@pytest.fixture(scope="module")
def batch():
    return make_batch(np.random.default_rng(SEED + 1))


@pytest.fixture(scope="module")
def outputs(weights, batch):
    """The TINY model's outputs on the batch (numpy; the port's, which
    tests/test_torch_croco.py holds against JAX's): the losses' input."""
    img1, img2, _ = batch
    with torch.no_grad():
        res = port_model(weights[0])(torch.as_tensor(img1),
                                     torch.as_tensor(img2))
    return [{k: v.numpy() for k, v in r.items()} for r in res]


# ---------------------------------------------------------------------------
# the losses (ports of TestLossSemantics, then against JAX)


def test_normalize_pair_joint():
    rng = np.random.default_rng(0)
    p1 = torch.as_tensor(rng.uniform(1, 2, (2, 4, 4, 3)), dtype=torch.float32)
    p2 = torch.as_tensor(rng.uniform(1, 2, (2, 4, 4, 3)), dtype=torch.float32)
    v = torch.ones((2, 4, 4), dtype=torch.bool)
    n1, n2 = losses.normalize_pointcloud_pair(p1, p2, v, v)
    d = torch.cat([torch.linalg.norm(n1, dim=-1).reshape(2, -1),
                   torch.linalg.norm(n2, dim=-1).reshape(2, -1)], 1)
    np.testing.assert_allclose(d.mean(1).numpy(), 1.0, rtol=1e-5)
    j1, j2 = jlosses.normalize_pointcloud_pair(
        jnp.asarray(p1.numpy()), jnp.asarray(p2.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(v.numpy()))
    assert rel(n1, j1) <= LOSS_REL and rel(n2, j2) <= LOSS_REL


def test_bce_is_jax_clip_formula():
    """JAX's clip + log/log1p; torch's own BCE agrees inside the clip and
    clamps its log at -100 outside, where the port keeps JAX's value."""
    rng = np.random.default_rng(1)
    p = rng.uniform(0.01, 0.99, (64,)).astype(np.float32)
    t = (rng.uniform(0, 1, 64) > 0.5).astype(np.float32)
    ours = losses.bce(torch.as_tensor(p), torch.as_tensor(t)).numpy()
    theirs = torch.nn.functional.binary_cross_entropy(
        torch.as_tensor(p), torch.as_tensor(t), reduction="none").numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-6)
    edge = np.asarray([0.0, 1.0, 1e-9, 1 - 1e-9], np.float32)
    te = np.asarray([1.0, 0.0, 1.0, 0.0], np.float32)
    np.testing.assert_allclose(
        losses.bce(torch.as_tensor(edge), torch.as_tensor(te)).numpy(),
        np.asarray(jlosses.bce(jnp.asarray(edge), jnp.asarray(te))),
        rtol=1e-6)


def test_conf_weighting_direction():
    """Higher confidence must amplify the pixel loss term."""
    _, _, f = make_batch(np.random.default_rng(2),
                         valid_share=((1, 1), (1, 1)))
    batch = tbatch(f)
    b, h, w = batch.gt_mask_1.shape
    res_lo = {"pts3d": batch.gt_pts3d_1 + 1.0,
              "conf": torch.full((b, h, w), 1.5),
              "dynamic_mask": torch.full((b, h, w), 0.5)}
    res2 = {"pts3d_in_other_view": batch.gt_pts3d_2,
            "conf": torch.full((b, h, w), 1.5),
            "dynamic_mask": torch.full((b, h, w), 0.5)}
    lo = losses.conf_regr3d_mmask_loss(batch, res_lo, res2)
    hi = losses.conf_regr3d_mmask_loss(
        batch, dict(res_lo, conf=torch.full((b, h, w), 5.0)), res2)
    assert float(hi.total) > float(lo.total)


@pytest.mark.parametrize("count", ["odd", "even"])
def test_losses_match_jax(batch, outputs, count):
    """Both criteria on the TINY model's outputs, ``valid`` not all ones.
    "even": view 2 shares view 1's mask, so every joint median is over an
    even count and must average its two middle values (JAX's nanmedian;
    ``torch.nanmedian`` takes the lower)."""
    fields = [np.array(x) for x in batch[2]]
    if count == "even":
        fields[4] = fields[3].copy()
    for i in range(2):
        if (fields[3][i].sum() + fields[4][i].sum()) % 2 != (count == "odd"):
            fields[4][i, 0, 0] = ~fields[4][i, 0, 0]
        assert (fields[3][i].sum() + fields[4][i].sum()) % 2 == (
            count == "odd")
    r1, r2 = outputs
    j = [{k: jnp.asarray(v) for k, v in r.items()} for r in (r1, r2)]
    t = [{k: torch.as_tensor(v) for k, v in r.items()} for r in (r1, r2)]
    for jfn, tfn in ((jlosses.conf_regr3d_mmask_loss,
                      losses.conf_regr3d_mmask_loss),
                     (jlosses.regr3d_scale_shift_inv_loss,
                      losses.regr3d_scale_shift_inv_loss)):
        want = jfn(jbatch(fields), *j)
        got = tfn(tbatch(fields), *t)
        for name, a, b in zip(want._fields, got, want):
            assert abs(float(a) - float(b)) <= LOSS_REL * max(
                abs(float(b)), 1e-30), (jfn.__name__, name, a, b)
    # the medians themselves
    z1 = torch.as_tensor(r1["pts3d"][..., 2])
    z2 = torch.as_tensor(r2["pts3d_in_other_view"][..., 2])
    v1, v2 = torch.as_tensor(fields[3]), torch.as_tensor(fields[4])
    np.testing.assert_allclose(
        losses.joint_median_depth(z1, z2, v1, v2).numpy(),
        np.asarray(jlosses.joint_median_depth(
            jnp.asarray(z1.numpy()), jnp.asarray(z2.numpy()),
            jnp.asarray(fields[3]), jnp.asarray(fields[4]))), rtol=1e-6)


# ---------------------------------------------------------------------------
# the step


def test_first_step_gradient_matches_jax(weights, batch):
    """The mask heads' gradient of the DAS3R criterion, per tensor, against
    ``jax.grad`` (JAX's untied upsampling biases included)."""
    sd, params = weights
    img1, img2, fields = batch
    train_j, frozen_j = jtraining.split_params(params)
    jmodel = JModel(JTINY)

    def loss_fn(tp):
        r1, r2 = jmodel.apply({"params": {**frozen_j, **tp}},
                              jnp.asarray(img1), jnp.asarray(img2),
                              stop_trunk_grad=True, deterministic=True)
        return jlosses.conf_regr3d_mmask_loss(jbatch(fields), r1, r2).total
    want = jax.jit(jax.grad(loss_fn))(train_j)

    model = port_model(sd)
    train, _ = training.split_params(model)
    r1, r2 = model(torch.as_tensor(img1), torch.as_tensor(img2))
    total = losses.conf_regr3d_mmask_loss(tbatch(fields), r1, r2).total
    grads = torch.autograd.grad(total, list(train.values()))
    assert len(grads) == len(jax.tree.leaves(want))
    worst = 0.0
    for name, g in zip(train, grads):
        ref = convert.jax_leaf(want, name)
        got = convert.to_jax(name, g.numpy())
        assert got.shape == ref.shape, name
        e = rel(got, ref)
        worst = max(worst, e)
        assert e <= GRAD_REL, (name, e)
    print(f"gradient: worst {worst:.3g} x max|g|")


def run_jax_steps(params, batch, cfg):
    """JAX's ``make_train_step`` for ``STEPS`` steps: (its trainable
    params after step 1 and after the last, the losses of each step)."""
    img1, img2, fields = batch
    tp, fp = jtraining.split_params(params, cfg.freeze)
    step = jtraining.make_train_step(JModel(JTINY), cfg)
    opt = jtraining.adamw_init(tp)
    outs, after = [], []
    for i in range(STEPS):
        tp, opt, out = step(tp, fp, opt, jnp.asarray(img1),
                            jnp.asarray(img2), jbatch(fields),
                            jnp.asarray(i))
        outs.append([float(x) for x in out])
        after.append(tp)
    return after[0], tp, np.asarray(outs)


def step_cfg(eps):
    return dict(lr=LR, warmup_epochs=0.0, steps_per_epoch=10, epochs=10,
                eps=eps)


@pytest.fixture(scope="module")
def jax_runs(weights, batch):
    return {eps: run_jax_steps(weights[1], batch,
                               jtraining.Stage1TrainConfig(**step_cfg(eps)))
            for eps in (1e-8, 1e-2)}


def run_port_steps(sd, batch, cfg, steps=STEPS):
    img1, img2, fields = batch
    model = port_model(sd)
    train, _ = training.split_params(model, cfg.freeze)
    step = training.make_train_step(model, cfg)
    opt = training.adamw_init(train)
    outs = [[float(x) for x in step(train, opt, torch.as_tensor(img1),
                                    torch.as_tensor(img2), tbatch(fields),
                                    i)]
            for i in range(steps)]
    return train, np.asarray(outs)


@pytest.mark.parametrize("eps", [1e-8, 1e-2], ids=["recipe_eps", "smooth"])
def test_three_steps_match_jax_make_train_step(weights, batch, jax_runs,
                                              eps):
    _, want_p, want_l = jax_runs[eps]
    got_p, got_l = run_port_steps(weights[0], batch,
                                  training.Stage1TrainConfig(**step_cfg(eps)))
    np.testing.assert_allclose(got_l, want_l, rtol=STEP_LOSS_REL)
    over = total = 0
    for name, p in got_p.items():
        ref = convert.jax_leaf(want_p, name)
        got = convert.to_jax(name, p.detach().numpy())
        d = np.abs(got - ref)
        if eps > 1e-4:
            assert d.max() <= PARAM_REL * np.abs(ref).max(), name
        else:
            assert d.max() <= 2 * LR * STEPS, name
            over += int((d > PARAM_REL * np.abs(ref).max()).sum())
            total += d.size
    assert over <= SIGN_NOISE_SHARE * max(total, 1), (over, total)


@pytest.mark.parametrize("freeze", ["encoder_and_3d_predictor", "none"])
def test_freeze_sets(weights, batch, freeze):
    """The recipe: the trunk and pointmap heads bitwise untouched, with no
    gradient ever computed for them, and every mask-head tensor moved.
    ``none``: every tensor moves."""
    sd, _ = weights
    img1, img2, fields = batch
    model = port_model(sd)
    train, frozen = training.split_params(model, freeze)
    if freeze == "none":
        assert not frozen and len(train) == len(list(model.parameters()))
    else:
        assert {k.split(".")[0] for k in train} == set(
            training.TRAINABLE_KEYS)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    cfg = training.Stage1TrainConfig(lr=LR, warmup_epochs=0.0,
                                     steps_per_epoch=10, freeze=freeze)
    step = training.make_train_step(model, cfg)
    opt = training.adamw_init(train)
    for i in range(2):
        step(train, opt, torch.as_tensor(img1), torch.as_tensor(img2),
             tbatch(fields), i)
    for k, p in frozen.items():
        assert not p.requires_grad and p.grad is None, k
        assert torch.equal(p, before[k]), k
    for k, p in train.items():
        assert not torch.equal(p, before[k]), k
    assert int(opt.count) == 2


@pytest.mark.parametrize("step", [0, 3, 7, 25, 60, 500])
def test_lr_at_matches_jax(step):
    """Warmup (steps 0-7 of 10 a warmup epoch... ), mid-cosine and past
    the end, in float32."""
    cfg = dict(lr=5e-5, min_lr=1e-8, warmup_epochs=1.0, epochs=5,
               steps_per_epoch=8)
    want = float(jtraining.lr_at(jnp.asarray(float(step), jnp.float32),
                                 jtraining.Stage1TrainConfig(**cfg)))
    got = training.lr_at(step, training.Stage1TrainConfig(**cfg))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# the sharded step


def spawn(task: str, world: int, work: Path) -> list[dict]:
    """Run ``task`` of ``torch_parallel_workers`` on ``world`` spawned
    gloo ranks; every rank's result."""
    ctx = torch.multiprocessing.start_processes(
        workers.run, args=(world, str(work), task), nprocs=world,
        join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=5):        # raises on a rank's failure
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{task}: ranks still running after "
                        f"{SPAWN_TIMEOUT} s")
    return [torch.load(work / f"{task}.{r}.pt", weights_only=False)
            for r in range(world)]


def test_sharded_step_matches_jax_single_device(weights, batch, jax_runs,
                                                tmp_path):
    """One step at (data=2) on two gloo ranks, one row each, against JAX's
    unsharded step on the whole batch, whose rows have different
    ``valid`` shares: the loss is the global batch's masked mean, which
    the average of the two rows' own losses is not."""
    img1, img2, fields = batch
    np.savez(tmp_path / "stage1.npz", img1=img1, img2=img2, seed=SEED,
             cfg=json.dumps(step_cfg(1e-2)),
             **dict(zip(losses.Stage1Batch._fields, fields)))
    ranks = spawn("stage1_step", 2, tmp_path)
    want_p, _, want_l = jax_runs[1e-2]
    # each row's own loss (the port's, single device): their mean is off
    # by far more than the bar
    model = port_model(weights[0])
    with torch.no_grad():
        own = [float(losses.conf_regr3d_mmask_loss(
            tbatch(f[i:i + 1] for f in fields),
            *model(torch.as_tensor(img1[i:i + 1]),
                   torch.as_tensor(img2[i:i + 1]))).total) for i in (0, 1)]
    assert abs(np.mean(own) - want_l[0, 0]) > 10 * STEP_LOSS_REL * abs(
        want_l[0, 0])
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want_l[0], rtol=STEP_LOSS_REL)
        for name, got in r["params"].items():
            ref = convert.jax_leaf(want_p, name)
            assert np.abs(got - ref).max() <= PARAM_REL * np.abs(
                ref).max(), name
    for name in ranks[0]["params"]:
        np.testing.assert_array_equal(ranks[0]["params"][name],
                                      ranks[1]["params"][name])
