"""PyTorch port: the training modules (image metrics, loss, schedules,
Adam, ``train_step``, ``test_pose_step``) against the JAX package on the
same numpy inputs, and the gradients of one training render against JAX's
entry-stream Pallas path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.data.synthetic import random_gaussian_scene
from das3r_tpu.models.gaussians import PoseParams as JaxPoses
from das3r_tpu.models import render as jrender
from das3r_tpu.train import loss as jloss
from das3r_tpu.train import optim as joptim
from das3r_tpu.train import step as jstep
from das3r_tpu.train.config import OptimizationConfig as JaxConfig
from das3r_tpu.utils import image as jimage
from das3r_tpu.utils import schedules as jsched
from das3r_tpu_torch.models import gaussians, render as trender
from das3r_tpu_torch.train import loss as tloss
from das3r_tpu_torch.train import optim as toptim
from das3r_tpu_torch.train import step as tstep
from das3r_tpu_torch.train.config import OptimizationConfig
from das3r_tpu_torch.utils import image as timage
from das3r_tpu_torch.utils import schedules as tsched

from test_torch_blend_backward import assert_grads_close
from test_torch_preprocess import settings_pair

torch.set_num_threads(2)
H, W = 48, 64


def numpy_fields(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def images(seed, shape=(3, 40, 56)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


def test_ssim_and_psnr_match_jax():
    a, b = images(0)
    for avg in (False, True):
        np.testing.assert_allclose(
            timage.ssim(torch.as_tensor(a), torch.as_tensor(b),
                        size_average=avg).numpy(),
            np.asarray(jimage.ssim(jnp.asarray(a), jnp.asarray(b),
                                   size_average=avg)), atol=2e-6, rtol=0)
    np.testing.assert_allclose(
        timage.psnr(torch.as_tensor(a)[None], torch.as_tensor(b)[None]),
        np.asarray(jimage.psnr(jnp.asarray(a)[None], jnp.asarray(b)[None])),
        rtol=1e-6)


def test_photometric_loss_and_its_gradients_match_jax():
    a, b = images(1)
    static = np.random.default_rng(2).uniform(0.2, 1, a.shape[1:]).astype(
        np.float32)
    want = jloss.photometric_loss(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(static), 0.2)
    pred = torch.tensor(a, requires_grad=True)
    st = torch.tensor(static, requires_grad=True)
    got = tloss.photometric_loss(pred, torch.as_tensor(b), st, 0.2)
    for k in ("loss", "l1_map", "psnr_frame"):
        np.testing.assert_allclose(getattr(got, k).detach().numpy(),
                                   np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    g_want = jax.jit(jax.grad(lambda p, s: jloss.photometric_loss(
        p, jnp.asarray(b), s, 0.2).loss, argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(static))
    g_got = torch.autograd.grad(got.loss, (pred, st))
    for g, w in zip(g_got, g_want):
        assert_grads_close(g.numpy(), w)


@pytest.mark.parametrize("step", [-1, 0, 1, 7, 500, 1000, 40_000])
def test_schedules_match_jax(step):
    for kw in (dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_mult=0.01,
                    max_steps=30_000),
               dict(lr_init=3e-5, lr_final=3e-6, lr_delay_steps=100,
                    lr_delay_mult=0.01, max_steps=1000),
               dict(lr_init=0.0, lr_final=0.0)):
        np.testing.assert_allclose(float(tsched.expon_lr(step, **kw)),
                                   float(jsched.expon_lr(step, **kw)),
                                   rtol=1e-6, err_msg=str(kw))
    t = min(max(step, 0), 1000) / 1000
    for name in ("cosine_lr", "linear_lr", "cycled_lr"):
        np.testing.assert_allclose(
            float(getattr(tsched, name)(t, 0.01, 1e-4)),
            float(getattr(jsched, name)(t, 0.01, 1e-4)), rtol=1e-6,
            err_msg=name)


def test_adam_step_matches_jax_on_identical_gradients():
    """Six gated steps with scheduled lrs on a pose group: parameters,
    moments and the count agree with JAX."""
    rng = np.random.default_rng(3)
    p0 = dict(Q=rng.normal(size=(3, 4)), T=rng.normal(size=(3, 3)),
              fovx=np.float32(1.1), fovy=np.float32(0.8))
    p0 = {k: np.asarray(v, np.float32) for k, v in p0.items()}
    cfg = OptimizationConfig(cam_lr_init=1e-2, cam_lr_final=1e-3,
                             cam_lr_max_steps=6, fov_lr=1e-3)
    jp = JaxPoses(**{k: jnp.asarray(v) for k, v in p0.items()})
    js = joptim.adam_init(jp)
    tp = gaussians.poses_from_numpy(p0, "cpu")
    ts = toptim.adam_init(tp)
    for i, gate in enumerate([True, False, True, True, False, True]):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p0.items()}
        jp, js = joptim.adam_step(
            jp, JaxPoses(**{k: jnp.asarray(v) for k, v in g.items()}), js,
            joptim.camera_lrs(i + 1, JaxConfig(**dataclasses.asdict(cfg))),
            gate=jnp.asarray(gate))
        toptim.adam_step(tp, gaussians.poses_from_numpy(g, "cpu"), ts,
                         toptim.camera_lrs(i + 1, cfg),
                         gate=torch.tensor(gate))
    assert int(ts.count) == int(js.count) == 4
    for k in p0:
        for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(want, k)),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def jax_scene(seed=0, n=600, cap=640):
    """A JAX scene with every SH band and the learnable conf in use, and
    dead capacity slots, at H x W with 2 frames."""
    params, meta, poses = random_gaussian_scene(n, cap=cap, n_frames=2,
                                                height=H, width=W, seed=seed)
    rng = np.random.default_rng(seed + 1)
    params = params._replace(
        features_rest=jnp.asarray(rng.normal(
            0, 0.1, params.features_rest.shape).astype(np.float32)),
        conf_static=jnp.asarray(rng.uniform(
            0.3, 1.0, params.conf_static.shape).astype(np.float32)))
    gts = rng.uniform(0, 1, (2, 3, H, W)).astype(np.float32)
    return params, meta, poses, gts


def port_scene(params, meta, poses):
    tp, tm = gaussians.params_from_numpy(numpy_fields(params),
                                         numpy_fields(meta), "cpu")
    return tp, tm, gaussians.poses_from_numpy(numpy_fields(poses), "cpu")


def test_training_render_gradients_match_jax():
    """d(photometric loss of one mode='train' render) by every
    GaussianParams field and every PoseParams field (the FoV rendered from
    the learnable one) against jax.grad through the Pallas backward."""
    jparams, jmeta, jposes, gts = jax_scene(seed=4)
    js, ts = settings_pair(image_height=H, image_width=W, sh_degree=3,
                           max_tiles_per_gaussian=32,
                           max_total_entries=32_768)
    bg = np.array([0.1, 0.0, 0.3], np.float32)

    def jfn(params, poses):
        out = jrender.render(params, jmeta, js, poses.pose(1),
                             jnp.asarray(bg), poses.fovx, poses.fovy,
                             mode="train", backend="pallas")
        return jloss.photometric_loss(out.image, jnp.asarray(gts[1]),
                                      params.conf_static[1], 0.2).loss

    jl, (jgp, jgq) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
        jparams, jposes)

    tp, tm, tq = port_scene(jparams, jmeta, jposes)
    tstep._require_grad(tp, tq)
    out = trender.render(tp, tm, ts, tq.pose(1), bg, tq.fovx, tq.fovy,
                         mode="train", device="cpu")
    tl = tloss.photometric_loss(out.image, torch.as_tensor(gts[1]),
                                tp.conf_static[1], 0.2).loss
    (tgp, tgq), _ = tstep._grads(tl, (tp, tq))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for got, want in ((tgp, jgp), (tgq, jgq)):
        for k, w in want._asdict().items():
            g = getattr(got, k)
            assert g is not None, k
            assert float(np.abs(np.asarray(w)).max()) > 0, k
            assert_grads_close(g.numpy(), w)


def test_train_step_trajectory_matches_jax():
    """One TrainState, carried across after a JAX step, then 5 steps of
    both packages over frames 1, 0, 1, 0, 1 with the stats tracked. JAX's
    train_step takes its XLA blend on the CPU (held equal to the entry
    stream by its own tests). Loss and PSNR agree per step to 1e-4; each
    parameter group to 2 k lr after k steps, because Adam's first steps
    move each element by about lr * sign(g) however small g is, so an
    element whose gradient is at noise level may step either way."""
    jparams, jmeta, jposes, gts = jax_scene(seed=5)
    js, ts = settings_pair(image_height=H, image_width=W, sh_degree=3,
                           max_tiles_per_gaussian=32,
                           max_total_entries=32_768)
    cfg = OptimizationConfig(psnr_threshold=0.0)   # the camera steps too
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    bg = np.zeros(3, np.float32)
    fov = (0.9, 0.7)

    def jax_step(state, meta, uid):
        return jstep.train_step(state, meta, jnp.asarray(uid),
                                jnp.asarray(gts[uid]), *map(jnp.asarray, fov),
                                jnp.asarray(bg), js, jcfg, track_stats=True)

    jstate = jstep.init_train_state(jparams, jposes)
    jstate, jmeta, _ = jax_step(jstate, jmeta, 0)
    assert int(jstate.opt.count) == 1

    tp, tmeta, tq = port_scene(jstate.params, jmeta, jstate.poses)
    tstate = tstep.TrainState(
        params=tp, poses=tq,
        opt=gaussians.adam_state_from_numpy(
            jstate.opt.count, numpy_fields(jstate.opt.mu),
            numpy_fields(jstate.opt.nu), gaussians.GaussianParams, "cpu"),
        opt_cam=gaussians.adam_state_from_numpy(
            jstate.opt_cam.count, numpy_fields(jstate.opt_cam.mu),
            numpy_fields(jstate.opt_cam.nu), gaussians.PoseParams, "cpu"),
        step=int(jstate.step))
    start = {k: np.asarray(v).copy()
             for k, v in jstate.params._asdict().items()}
    for k, uid in enumerate([1, 0, 1, 0, 1], start=1):
        jstate, jmeta, jm = jax_step(jstate, jmeta, uid)
        tstate, tmeta, tmet = tstep.train_step(
            tstate, tmeta, uid, torch.as_tensor(gts[uid]), *fov,
            torch.as_tensor(bg), ts, cfg, track_stats=True)
        assert int(jm.tile_overflow) == 0 and int(tmet.entry_overflow) == 0
        np.testing.assert_allclose(float(tmet.loss), float(jm.loss),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tmet.psnr), float(jm.psnr),
                                   rtol=1e-4)
        assert bool(tmet.cam_stepped) and bool(jm.cam_stepped)
        lrs = toptim.gaussian_lrs(tstate.step, cfg, 1.0)
        for name, want in jstate.params._asdict().items():
            got = getattr(tstate.params, name).detach().numpy()
            bound = 2 * k * float(getattr(lrs, name)) + 1e-6
            assert np.abs(got - np.asarray(want)).max() <= bound, name
            assert np.abs(got - start[name]).max() > 0, name
        for name in ("Q", "T"):
            bound = 2 * k * float(toptim.camera_lrs(tstate.step, cfg).Q)
            assert (np.abs(getattr(tstate.poses, name).detach().numpy()
                           - np.asarray(getattr(jstate.poses, name))).max()
                    <= bound + 1e-7), name
    assert tstate.step == int(jstate.step) == 6
    assert int(tstate.opt.count) == int(jstate.opt.count) == 6
    assert int(tstate.opt_cam.count) == int(jstate.opt_cam.count) == 6
    np.testing.assert_array_equal(tmeta.denom.numpy(),
                                  np.asarray(jmeta.denom))
    np.testing.assert_array_equal(tmeta.max_radii2d.numpy(),
                                  np.asarray(jmeta.max_radii2d))
    acc = np.asarray(jmeta.xyz_grad_accum)
    np.testing.assert_allclose(tmeta.xyz_grad_accum.numpy(), acc,
                               atol=1e-4 * acc.max())


def small_port_scene(seed):
    """A port scene on the CPU and one GT view rendered from it."""
    from das3r_tpu_torch.data import synthetic
    params, meta, poses = synthetic.random_gaussian_scene(
        300, n_frames=1, height=32, width=32, seed=seed, sh_degree=0,
        device="cpu")
    _, ts = settings_pair(image_height=32, image_width=32, sh_degree=0,
                          max_tiles_per_gaussian=16)
    bg = torch.zeros(3)
    with torch.no_grad():
        gt = trender.render(params, meta, ts, poses.pose(0), bg, 1.0, 1.0,
                            mode="train", device="cpu").image
    return params, meta, poses, ts, bg, gt


def test_psnr_gate_blocks_camera():
    """Port of tests/test_train.py:183-199: a threshold no frame can clear
    leaves the camera group frozen; the main group always steps."""
    params, meta, poses, ts, bg, gt = small_port_scene(5)
    cfg = OptimizationConfig(psnr_threshold=1e6)
    state = tstep.init_train_state(params, poses)
    q_before = poses.Q.detach().clone()
    xyz_before = params.xyz.detach().clone()
    state, _, m = tstep.train_step(state, meta, 0, gt + 0.05, 1.0, 1.0, bg,
                                   ts, cfg)
    assert not bool(m.cam_stepped)
    assert torch.equal(state.poses.Q.detach(), q_before)
    assert int(state.opt_cam.count) == 0
    assert int(state.opt.count) == 1 and state.step == 1
    assert not torch.equal(state.params.xyz.detach(), xyz_before)


def test_test_pose_step_lowers_the_loss():
    params, meta, poses, ts, bg, gt = small_port_scene(7)
    rng = np.random.default_rng(11)
    tq = gaussians.test_poses_from_numpy(
        dict(Q=poses.Q[:1].numpy() + rng.normal(0, 0.01, (1, 4)),
             T=poses.T[:1].numpy() + rng.normal(0, 0.01, (1, 3))), "cpu")
    cfg = OptimizationConfig(cam_lr_init=3e-3, cam_lr_final=3e-4)
    st = tstep.TestPoseState(poses=tq, opt=toptim.adam_init(tq))
    losses = []
    for it in range(8):
        st, lossv, psnr_v = tstep.test_pose_step(
            st, params, meta, 0, gt, torch.zeros_like(gt), 1.0, 1.0, bg,
            it + 1, ts, cfg)
        losses.append(float(lossv))
        assert np.isfinite(float(psnr_v))
    assert losses[-1] < losses[0]
    assert int(st.opt.count) == 8


def test_chunks_are_loops_of_the_steps():
    """``train_chunk`` and ``test_pose_chunk`` (one ``lax.scan`` each in
    the JAX package) give what their steps give one by one."""
    runs = []
    for chunked in (False, True):
        params, meta, poses, ts, bg, gt = small_port_scene(9)
        gts = torch.stack([gt, gt.flip(2)])
        fov = torch.tensor([1.0, 1.0])
        cfg = OptimizationConfig(psnr_threshold=0.0)
        params.conf_static = torch.cat([params.conf_static] * 2)
        poses.Q = torch.cat([poses.Q, poses.Q])    # a second frame
        poses.T = torch.cat([poses.T, poses.T + 0.01])
        state = tstep.init_train_state(params, poses)
        tq = gaussians.test_poses_from_numpy(
            dict(Q=poses.Q.detach().numpy(), T=poses.T.detach().numpy()),
            "cpu")
        tp = tstep.TestPoseState(poses=tq, opt=toptim.adam_init(tq))
        masks = torch.zeros_like(gts)
        if chunked:
            state, meta, m = tstep.train_chunk(
                state, meta, [0, 1, 0], gts, fov, fov, bg, ts, cfg,
                track_stats=True)
            tp, (tl, _) = tstep.test_pose_chunk(
                tp, state.params, meta, [1, 0], gts, masks, fov, fov, bg, 4,
                ts, cfg)
            losses = m.loss.tolist() + tl.tolist()
        else:
            losses = []
            for uid in (0, 1, 0):
                state, meta, m = tstep.train_step(
                    state, meta, uid, gts[uid], fov[uid], fov[uid], bg, ts,
                    cfg, track_stats=True)
                losses.append(float(m.loss))
            for uid in (1, 0):
                tp, lv, _ = tstep.test_pose_step(
                    tp, state.params, meta, uid, gts[uid], masks[uid],
                    fov[uid], fov[uid], bg, 4, ts, cfg)
                losses.append(float(lv))
        runs.append((losses, state.params.xyz.detach().clone(),
                     meta.denom.clone(), tp.poses.T.detach().clone()))
    (l0, x0, d0, t0), (l1, x1, d1, t1) = runs
    assert l0 == l1 and len(l0) == 5
    assert torch.equal(x0, x1) and torch.equal(d0, d1)
    assert torch.equal(t0, t1)
    assert int(d1.max()) == 3
