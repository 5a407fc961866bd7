"""PyTorch port: global alignment (``das3r_tpu_torch/predictor/
alignment.py``) against the JAX package on the same numpy predictions.

The scene is ``tests/test_alignment.py``'s (known depths and poses, exact
pairwise pointmaps plus noise) on a symmetrized sliding-window graph, so
the MST leaves frames without a pose and RANSAC-PnP runs, as it does on a
video. Confidences and dynamic masks are drawn from a seed. The host
initialization is copied numpy and must agree bitwise; the loop runs in
float32 autograd on the CPU here, against JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.predictor import alignment as JA
from das3r_tpu.predictor import pairs as jpairs
from das3r_tpu_torch.predictor import alignment as TA
from test_alignment import make_multiview_scene

torch.set_num_threads(2)
# x max|ref| for depths, poses and focals after 12 iterations (measured:
# at most 2.0e-6, PERF.md §6)
ALIGN_REL = 1e-5
LOSS_REL = 1e-6
GRAD_TOL = 2e-5   # x max|g| per parameter: the JAX gradient bar
N_FRAMES = 6


@pytest.fixture(scope="module")
def scene():
    edges, pred_i, pred_j, conf, _, *_ = make_multiview_scene(
        f=N_FRAMES, noise=0.02, seed=3)
    sub = jpairs.make_pairs(N_FRAMES, "swin-2-noncyclic", symmetrize=True)
    idx = [edges.index(e) for e in sub]
    rng = np.random.default_rng(0)
    c = conf[idx]
    conf_i = (c * rng.uniform(0.5, 1.5, c.shape)).astype(np.float32)
    conf_j = (c * rng.uniform(0.5, 1.5, c.shape)).astype(np.float32)
    mask_i = rng.uniform(0, 0.6, c.shape).astype(np.float32)
    E, H, W = c.shape
    flows = (rng.normal(0, 2, (E, 2, H, W)).astype(np.float32),
             rng.normal(0, 2, (E, 2, H, W)).astype(np.float32),
             np.ones((E, 1, H, W), bool), np.ones((E, 1, H, W), bool))
    return dict(edges=sub, pred_i=pred_i[idx], pred_j=pred_j[idx],
                conf_i=conf_i, conf_j=conf_j, mask_i=mask_i, flows=flows)


def _args(s):
    return (s["edges"], s["pred_i"], s["pred_j"], s["conf_i"], s["conf_j"],
            s["mask_i"])


def test_host_initialization_is_bitwise(scene, monkeypatch):
    s = scene
    edges = s["edges"]
    jm = JA.aggregate_frame_maps(edges, s["conf_i"], s["conf_j"],
                                 s["mask_i"], N_FRAMES)
    tm = TA.aggregate_frame_maps(edges, s["conf_i"], s["conf_j"],
                                 s["mask_i"], N_FRAMES)
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(a, b)

    pnp = []
    orig = TA._pnp_c2w

    def counted(*a, **k):
        pnp.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(TA, "_pnp_c2w", counted)
    jinit = JA.mst_init(edges, s["pred_i"], s["pred_j"], s["conf_i"],
                        s["conf_j"], jm[0], JA.AlignerConfig())
    tinit = TA.mst_init(edges, s["pred_i"], s["pred_j"], s["conf_i"],
                        s["conf_j"], tm[0], TA.AlignerConfig())
    assert pnp, "the MST set every pose: RANSAC-PnP did not run"
    for a, b in zip(jinit, tinit):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    for shared in (True, False):
        jp = JA.build_init_params(
            edges, s["pred_i"], s["conf_i"], *jinit,
            JA.AlignerConfig(shared_focal=shared))
        tp = TA.build_init_params(
            edges, s["pred_i"], s["conf_i"], *tinit,
            TA.AlignerConfig(shared_focal=shared))
        for k in JA.AlignParams._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jp, k)), tp[k],
                                          err_msg=k)


def _loss_and_grads(scene, dtype):
    """(JAX's, the port's) loss and gradients at iteration 0 in ``dtype``,
    all four terms live: pairwise, temporal smoothing, the flow term (its
    start ratio 0) and the depth prior against a perturbed depth."""
    s = scene
    edges = s["edges"]
    F = N_FRAMES
    E, H, W = s["conf_i"].shape
    kw = dict(flow_loss_start_ratio=0.0, depth_regularize_weight=0.5)
    jcfg, tcfg = JA.AlignerConfig(**kw), TA.AlignerConfig(**kw)
    im_conf, dyna_avg, _ = TA.aggregate_frame_maps(
        edges, s["conf_i"], s["conf_j"], s["mask_i"], F)
    dyn = dyna_avg > tcfg.motion_mask_thre
    assert dyn.any() and not dyn.all()
    init = TA.build_init_params(
        edges, s["pred_i"], s["conf_i"],
        *TA.mst_init(edges, s["pred_i"], s["pred_j"], s["conf_i"],
                     s["conf_j"], im_conf, tcfg), tcfg)
    rng = np.random.default_rng(1)
    init_depth = np.exp(init["depth_log"]) * rng.uniform(0.8, 1.2, (F, H, W))
    ei = [i for i, _ in edges]
    ej = [j for _, j in edges]
    arrays = dict(pred_i=s["pred_i"], pred_j=s["pred_j"], conf_i=s["conf_i"],
                  conf_j=s["conf_j"], mask_i=s["mask_i"],
                  init_depth=init_depth, **init)
    arrays = {k: np.asarray(v, dtype) for k, v in arrays.items()}
    flows = [np.asarray(f, dtype) if f.dtype != bool else f
             for f in s["flows"]]
    fields = JA.AlignParams._fields

    with jax.enable_x64(dtype == np.float64):
        a = {k: jnp.asarray(v) for k, v in arrays.items()}
        jloss = JA.make_align_loss(
            JA.EdgeData(ei=jnp.asarray(ei, jnp.int32),
                        ej=jnp.asarray(ej, jnp.int32),
                        **{k: a[k] for k in TA.EdgeData._fields[2:]}),
            jnp.asarray(dyn), tuple(jnp.asarray(f) for f in flows), jcfg,
            F, H, W, init_depth=a["init_depth"])
        want, wgrad = jax.jit(jax.value_and_grad(jloss))(
            JA.AlignParams(**{k: a[k] for k in fields}), 0)
        want = float(want)
        wgrad = {k: np.asarray(getattr(wgrad, k)) for k in fields}

    t = {k: torch.as_tensor(v) for k, v in arrays.items()}
    params = TA.AlignParams(**{k: t[k].requires_grad_() for k in fields})
    tloss = TA.make_align_loss(
        TA.EdgeData(ei=torch.as_tensor(ei), ej=torch.as_tensor(ej),
                    **{k: t[k] for k in TA.EdgeData._fields[2:]}),
        torch.as_tensor(dyn), tuple(torch.as_tensor(f) for f in flows),
        tcfg, F, H, W, init_depth=t["init_depth"])
    got = tloss(params, 0)
    grads = torch.autograd.grad(got, [getattr(params, k) for k in fields])
    return (want, wgrad), (float(got.detach()),
                           {k: g.numpy() for k, g in zip(fields, grads)})


def test_loss_and_gradients_match_jax_at_iteration_0(scene):
    """In float64 the two packages' loss and gradients agree within the
    JAX bars (1e-6 relative, 2e-5 x max|g|). In float32 the loss does
    too; its gradients do not need to: the pairwise term's unit residuals
    r/|r| lose digits where |r| << |p| (noise 0.02 on points at depth
    ~4), so JAX's own float32 gradient is up to 1.4e-4 x max|g| off the
    float64 value (depth_log). There the port is held to no further from
    the float64 gradient than JAX's float32 gradient plus 2e-5 x max|g|.
    """
    (w64, wg64), (t64, tg64) = _loss_and_grads(scene, np.float64)
    (w32, wg32), (t32, tg32) = _loss_and_grads(scene, np.float32)
    assert abs(t64 - w64) <= LOSS_REL * abs(w64)
    assert abs(t32 - w32) <= LOSS_REL * abs(w32)
    for k in wg64:
        scale = np.abs(wg64[k]).max()
        assert scale > 0, k
        assert np.abs(tg64[k] - wg64[k]).max() <= GRAD_TOL * scale, k
        jax_err = np.abs(wg32[k] - wg64[k]).max()
        port_err = np.abs(tg32[k] - wg64[k]).max()
        assert port_err <= jax_err + GRAD_TOL * scale, (k, port_err, jax_err)


@pytest.mark.parametrize("kw,with_flows", [
    ({}, False),
    (dict(flow_loss_start_ratio=0.0), True),
    (dict(depth_regularize_weight=0.5), False),
    (dict(schedule="cosine"), False),
    (dict(schedule="cycle2", optimize_pp=True), False),
    (dict(preset_focals=(30.0,), temporal_smoothing_weight=0.0), False),
])
def test_align_matches_jax(scene, kw, with_flows):
    s = scene
    flows = s["flows"] if with_flows else None
    want = JA.align(*_args(s), JA.AlignerConfig(niter=12, **kw),
                    flows=None if flows is None
                    else tuple(jnp.asarray(f) for f in flows))
    stats = {}
    got = TA.align(*_args(s), TA.AlignerConfig(niter=12, **kw), flows=flows,
                   device="cpu", stats=stats)
    for k in ("depths", "poses_c2w", "focals", "intrinsics"):
        w = np.asarray(getattr(want, k))
        err = np.abs(getattr(got, k) - w).max()
        assert err <= ALIGN_REL * np.abs(w).max(), (k, err)
    for k in ("im_conf", "dyna_avg", "dyna_max", "dynamic_masks"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.final_loss == pytest.approx(want.final_loss, rel=ALIGN_REL)
    assert stats["last_loss"] == got.final_loss
    assert stats["first_loss"] > 0 and stats["loop_s"] > 0
    if "preset_focals" in kw:
        np.testing.assert_allclose(got.focals, 30.0, rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(dist="l2"), dict(conf_mode="sqrt"), dict(conf_mode="m1"),
    dict(conf_mode="none"), dict(shared_focal=False, optimize_pp=True)])
def test_loss_variants_match_jax(scene, kw):
    """The loss's other branches at the MST initialization (float32, 1e-6
    relative). Twelve Adam steps do not compare here: where a pixel's
    gradient is float32 noise (the L2 distance near a fit), Adam's
    normalized step turns the noise into +-lr."""
    s = scene
    edges = s["edges"]
    E, H, W = s["conf_i"].shape
    jcfg, tcfg = JA.AlignerConfig(**kw), TA.AlignerConfig(**kw)
    im_conf, dyna_avg, _ = TA.aggregate_frame_maps(
        edges, s["conf_i"], s["conf_j"], s["mask_i"], N_FRAMES)
    init = TA.build_init_params(
        edges, s["pred_i"], s["conf_i"],
        *TA.mst_init(edges, s["pred_i"], s["pred_j"], s["conf_i"],
                     s["conf_j"], im_conf, tcfg), tcfg)
    init["pp_off"] = np.random.default_rng(2).normal(
        0, 0.1, init["pp_off"].shape).astype(np.float32)
    dyn = dyna_avg > tcfg.motion_mask_thre
    ei = [i for i, _ in edges]
    ej = [j for _, j in edges]
    arrays = {k: s[k] for k in TA.EdgeData._fields[2:]}
    want = JA.make_align_loss(
        JA.EdgeData(ei=jnp.asarray(ei, jnp.int32),
                    ej=jnp.asarray(ej, jnp.int32),
                    **{k: jnp.asarray(v) for k, v in arrays.items()}),
        jnp.asarray(dyn), None, jcfg, N_FRAMES, H, W)(
        JA.AlignParams(**{k: jnp.asarray(v) for k, v in init.items()}), 0)
    got = TA.make_align_loss(
        TA.EdgeData(ei=torch.as_tensor(ei), ej=torch.as_tensor(ej),
                    **{k: torch.as_tensor(v) for k, v in arrays.items()}),
        torch.as_tensor(dyn), None, tcfg, N_FRAMES, H, W)(
        TA.AlignParams(**{k: torch.as_tensor(v) for k, v in init.items()}),
        0)
    assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want))


@pytest.mark.parametrize("schedule", ["linear", "cosine", "cycle2"])
def test_schedule_matches_jax(schedule):
    from das3r_tpu.utils import schedules as jsched
    cfg = TA.AlignerConfig(niter=300, schedule=schedule)
    fn = {"linear": jsched.linear_lr, "cosine": jsched.cosine_lr,
          "cycle2": jsched.cycled_lr}[schedule]
    for it in (0, 1, 77, 150, 299):
        want = np.float32(fn(it / cfg.niter, cfg.lr, cfg.lr_min))
        assert np.float32(TA.schedule_lr(it, cfg)) == want, it


def test_align_needs_a_device(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.align(*_args(scene), TA.AlignerConfig(niter=1))


def _two_view_scene():
    """tests/test_alignment.py::test_pair_view_recovers_pose_and_focal's
    scene: exact pointmaps of two views, edge (0, 1) more confident."""
    H, W, f = 48, 64, 60.0
    pp = np.asarray([W / 2, H / 2], np.float32)
    rng = np.random.default_rng(7)
    xx, yy = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")

    def unproject(z):
        return np.stack([(xx - pp[0]) / f * z, (yy - pp[1]) / f * z, z], -1)
    z = rng.uniform(2.0, 6.0, (H, W)).astype(np.float32)
    pts1 = unproject(z)
    th = 0.1
    R = np.asarray([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                    [-np.sin(th), 0, np.cos(th)]], np.float32)
    t = np.asarray([0.3, -0.1, 0.2], np.float32)
    w2c2 = np.eye(4, dtype=np.float32)
    w2c2[:3, :3], w2c2[:3, 3] = R.T, -R.T @ t
    pts_in2 = (pts1.reshape(-1, 3) @ w2c2[:3, :3].T
               + w2c2[:3, 3]).reshape(H, W, 3)
    c2w2 = np.linalg.inv(w2c2)
    cam2pts = unproject(rng.uniform(2.0, 6.0, (H, W)).astype(np.float32))
    p2_in0 = (cam2pts.reshape(-1, 3) @ c2w2[:3, :3].T
              + c2w2[:3, 3]).reshape(H, W, 3)
    hi, lo = np.full((H, W), 9.0, np.float32), np.full((H, W), 4.0,
                                                      np.float32)
    return ([(0, 1), (1, 0)], np.stack([pts1, cam2pts]).astype(np.float32),
            np.stack([p2_in0, pts_in2]).astype(np.float32),
            np.stack([hi, lo]), np.stack([hi, lo]),
            np.zeros((2, H, W), np.float32))


@pytest.mark.parametrize("swap", [False, True])
def test_pair_view_matches_jax(swap):
    """The closed-form two-frame path; ``swap`` makes edge (1, 0) the more
    confident one (the world at camera 2)."""
    edges, pred_i, pred_j, conf_i, conf_j, mask_i = _two_view_scene()
    if swap:
        conf_i, conf_j = conf_i[::-1].copy(), conf_j[::-1].copy()
    want = JA.pair_view(edges, pred_i, pred_j, conf_i, conf_j, mask_i)
    got = TA.pair_view(edges, pred_i, pred_j, conf_i, conf_j, mask_i)
    for k in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    with pytest.raises(ValueError, match="one symmetrized pair"):
        TA.pair_view([(0, 1)], pred_i, pred_j, conf_i, conf_j, mask_i)


def test_clean_pointcloud_matches_jax():
    rng = np.random.default_rng(9)
    F, H, W = 3, 12, 16
    K = np.asarray([[14.0, 0, 8], [0, 14.0, 6], [0, 0, 1]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    poses[:, :3, 3] = rng.uniform(-0.1, 0.1, (F, 3))
    depths = rng.uniform(2, 5, (F, H, W)).astype(np.float32)
    confs = rng.uniform(1, 5, (F, H, W)).astype(np.float32)
    intr = np.stack([K] * F)
    want = JA.clean_pointcloud(confs, intr, poses, depths)
    got = TA.clean_pointcloud(confs, intr, poses, depths)
    assert (want == 0).any()
    np.testing.assert_array_equal(got, want)


def test_pose_helpers_match_jax():
    rng = np.random.default_rng(10)
    p = rng.normal(size=(5, 7)).astype(np.float32)
    np.testing.assert_allclose(
        TA.pose7_to_mat(torch.as_tensor(p)).numpy(),
        np.asarray(JA.pose7_to_mat(jnp.asarray(p))), atol=1e-6)
    R = np.asarray(JA.quat_xyzw_to_rotmat(jnp.asarray(p[:, :4])))
    for r in R:
        np.testing.assert_array_equal(TA.rotmat_to_quat_xyzw(r),
                                      JA.rotmat_to_quat_xyzw(r))
    x = torch.zeros(4, 3, requires_grad=True)
    TA._safe_norm(x).sum().backward()
    assert torch.equal(x.grad, torch.zeros(4, 3))
