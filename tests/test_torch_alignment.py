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


# The default alignment on a moving camera: the synthetic generator's wall
# scene (its camera translates 0.022 a frame), pairwise predictions from
# its true depths and poses with 1% noise, every AlignerConfig setting at
# its default but niter (the smoothing term at 0.01, L1, the flow term from
# iteration 15 of 100).
MOVING_FRAMES, MOVING_H, MOVING_W = 6, 48, 64
MOVING_ITERS = 100
MOVING_AT = (1, 12, 50, 100)
MOVING_REL = 1e-4   # x max|ref|: PR 8's bar for the runner end to end


def moving_camera_inputs(work: str) -> dict:
    """Pairwise predictions of the generator's scene on the symmetrized
    ``swin-2-noncyclic`` graph, each array built once with numpy: each
    edge's two pointmaps in frame i's camera from the true depths and
    poses, plus seeded noise of 1% of depth per coordinate (no L1 residual
    at zero); confidences 1 plus uniform noise in [1, 5]; flows from the
    true geometry (the red square's by its pixel shift), plus 0.1 px of
    noise, valid where they land in the image; the generator's dynamic
    masks as each edge's ``mask_i``."""
    from PIL import Image

    from das3r_tpu_torch.data import synthetic, trajectory
    from das3r_tpu_torch.predictor import pairs as tpairs

    F, H, W = MOVING_FRAMES, MOVING_H, MOVING_W
    synthetic.make_synthetic_stage1_dir(work, n_frames=F, height=H, width=W)
    K = np.loadtxt(f"{work}/pred_intrinsics.txt").reshape(F, 3, 3)
    c2w = trajectory.tum_to_c2w(*trajectory.read_tum(
        f"{work}/pred_traj.txt")[1:])
    depth = np.stack([np.load(f"{work}/frame_{f:04d}.npy")
                      for f in range(F)]).astype(np.float64)
    dyn = np.stack([np.asarray(Image.open(f"{work}/dynamic_mask_{f:04d}"
                                          ".png")) > 127 for f in range(F)])
    # the square's left edge in each frame (synthetic.py's x0)
    sq_x = [int(W * 0.1 + f * W * 0.08) for f in range(F)]
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64), indexing="xy")

    def in_camera(i, f):
        """frame f's true points in frame i's camera"""
        d = depth[f]
        pts = np.stack([d * (gx - K[f, 0, 2]) / K[f, 0, 0],
                        d * (gy - K[f, 1, 2]) / K[f, 1, 1], d], -1)
        rel = np.linalg.inv(c2w[i]) @ c2w[f]
        return pts @ rel[:3, :3].T + rel[:3, 3]

    def true_flow(i, j):
        p = in_camera(j, i)
        u = K[j, 0, 0] * p[..., 0] / p[..., 2] + K[j, 0, 2]
        v = K[j, 1, 1] * p[..., 1] / p[..., 2] + K[j, 1, 2]
        return np.stack([np.where(dyn[i], sq_x[j] - sq_x[i], u - gx),
                         np.where(dyn[i], 0.0, v - gy)])

    rng = np.random.default_rng(0)
    edges = tpairs.make_pairs(F, "swin-2-noncyclic", symmetrize=True)
    pred_i, pred_j, flow_ij, flow_ji = [], [], [], []
    for i, j in edges:
        for out, f in ((pred_i, i), (pred_j, j)):
            p = in_camera(i, f)
            noise = rng.normal(0, 1, p.shape) * 0.01 * depth[f][..., None]
            out.append(p + noise)
        flow_ij.append(true_flow(i, j) + rng.normal(0, 0.1, (2, H, W)))
        flow_ji.append(true_flow(j, i) + rng.normal(0, 0.1, (2, H, W)))
    E = len(edges)

    def valid(flow):
        x, y = gx + flow[:, 0], gy + flow[:, 1]
        return ((x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1))[:, None]

    flow_ij, flow_ji = np.asarray(flow_ij), np.asarray(flow_ji)
    f32 = np.float32
    return dict(
        edges=edges, pred_i=np.asarray(pred_i, f32),
        pred_j=np.asarray(pred_j, f32),
        conf_i=(1 + rng.uniform(1, 5, (E, H, W))).astype(f32),
        conf_j=(1 + rng.uniform(1, 5, (E, H, W))).astype(f32),
        mask_i=np.asarray([dyn[i] for i, _ in edges], f32),
        flows=(flow_ij.astype(f32), flow_ji.astype(f32), valid(flow_ij),
               valid(flow_ji)),
        dyn=dyn)


@pytest.fixture(scope="module")
def moving_camera(tmp_path_factory):
    return moving_camera_inputs(str(tmp_path_factory.mktemp("moving")))


def _recorded(make_loss, rec, jax_side):
    """``make_loss`` whose loss records (loss, parameters) under ``it``:
    the parameters after ``it`` Adam steps."""
    def make(*a, **k):
        fn = make_loss(*a, **k)

        def loss(params, it):
            value = fn(params, it)
            if jax_side:
                jax.debug.callback(
                    lambda i, v, *ps: rec.__setitem__(
                        int(i), (float(v), [np.asarray(p) for p in ps])),
                    it, value, *params, ordered=True)
            else:
                rec[it] = (float(value.detach()),
                           [getattr(params, k).detach().numpy().copy()
                            for k in JA.AlignParams._fields])
            return value
        return loss
    return make


def moving_camera_trajectories(s, dtype, **kw):
    """Both packages' ``optimize`` from the one host initialization, in
    ``dtype``, at ``AlignerConfig(niter=MOVING_ITERS, **kw)``: ({it:
    (loss, [parameters])} for JAX, the same for the port), with the
    parameters after the last step under ``MOVING_ITERS``, and the port's
    loss function (for the flow term's switch)."""
    F, H, W = MOVING_FRAMES, MOVING_H, MOVING_W
    edges = s["edges"]
    jcfg = JA.AlignerConfig(niter=MOVING_ITERS, **kw)
    tcfg = TA.AlignerConfig(niter=MOVING_ITERS, **kw)
    args = _args(s)[1:]
    jm = JA.aggregate_frame_maps(edges, *args[2:], F)
    tm = TA.aggregate_frame_maps(edges, *args[2:], F)
    jinit = JA.build_init_params(
        edges, args[0], args[2], *JA.mst_init(edges, *args[:4], jm[0], jcfg),
        jcfg)
    init = TA.build_init_params(
        edges, args[0], args[2], *TA.mst_init(edges, *args[:4], tm[0], tcfg),
        tcfg)
    for k in JA.AlignParams._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jinit, k)), init[k])
    dyn = tm[1] > tcfg.motion_mask_thre
    np.testing.assert_array_equal(dyn, s["dyn"])
    ei = [i for i, _ in edges]
    ej = [j for _, j in edges]
    arrays = {k: np.asarray(s[k], dtype) for k in TA.EdgeData._fields[2:]}
    flows = [f if f.dtype == bool else np.asarray(f, dtype)
             for f in s["flows"]]
    init = {k: np.asarray(v, dtype) for k, v in init.items()}
    fields = JA.AlignParams._fields
    rec_j, rec_t = {}, {}

    # the recording callback runs on another thread: x64 must be global
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == np.float64)
    make_j = JA.make_align_loss
    JA.make_align_loss = _recorded(make_j, rec_j, True)
    try:
        params, loss = JA.optimize(
            JA.AlignParams(**{k: jnp.asarray(v) for k, v in init.items()}),
            JA.EdgeData(ei=jnp.asarray(ei, jnp.int32),
                        ej=jnp.asarray(ej, jnp.int32),
                        **{k: jnp.asarray(v) for k, v in arrays.items()}),
            jnp.asarray(dyn), jcfg, F, H, W,
            flows=tuple(jnp.asarray(f) for f in flows))
        rec_j[MOVING_ITERS] = (loss, [np.asarray(getattr(params, k))
                                      for k in fields])
    finally:
        JA.make_align_loss = make_j
        jax.config.update("jax_enable_x64", x64)

    make_t = TA.make_align_loss
    TA.make_align_loss = _recorded(make_t, rec_t, False)
    edge = TA.EdgeData(ei=torch.as_tensor(ei), ej=torch.as_tensor(ej),
                       **{k: torch.as_tensor(v) for k, v in arrays.items()})
    tflows = tuple(torch.as_tensor(f) for f in flows)
    try:
        params, loss = TA.optimize(
            TA.AlignParams(**{k: torch.as_tensor(v)
                              for k, v in init.items()}),
            edge, torch.as_tensor(dyn), tcfg, F, H, W, flows=tflows)
    finally:
        TA.make_align_loss = make_t
    rec_t[MOVING_ITERS] = (loss, [getattr(params, k).numpy()
                                  for k in fields])
    return rec_j, rec_t, make_t(edge, torch.as_tensor(dyn), tflows, tcfg,
                                F, H, W)


def moving_camera_state(ps) -> dict:
    """depths, poses (camera to world) and focals of recorded parameters"""
    f64 = [np.array(p, np.float64) for p in ps]
    params = TA.AlignParams(*f64)
    return dict(
        depths=np.exp(params.depth_log),
        poses=TA.pose7_to_mat(torch.as_tensor(params.im_poses)).numpy(),
        focals=np.exp(params.focal_log / TA.AlignerConfig().focal_break))


def test_default_alignment_on_a_moving_camera_matches_jax(moving_camera):
    """``AlignerConfig()``'s settings (niter 100) on a moving camera
    (``moving_camera_inputs``), both packages' ``optimize`` from the same
    host initialization (bitwise in both): the depths, poses and focals
    after 1, 12, 50 and 100 iterations within 1e-4 x max|ref| of JAX's,
    and the loss of every iteration within 1e-4 relative; the flow term
    switches on at iteration 15 and adds to the loss.

    In float64 (measured: at most 1.1e-10 x max|ref|, losses 3.0e-11
    relative).
    In float32 the comparison does not hold, and JAX does not hold it
    against itself either: JAX's float32 run is 1.33e-3 x max|ref| from
    JAX's float64 run in depths after 1 iteration. Where the pairwise L1
    gradients of a depth pixel cancel to below Adam's eps (1e-8; |g| up to
    5.8e-4 here), each package's float32 rounding of the terms (~3e-10)
    moves that pixel's step by a share of lr. ROADMAP.md section 3 has the
    float32 drift by iteration; ``PYTHONPATH=. python
    tests/test_torch_alignment.py`` prints it."""
    rec_j, rec_t, loss_fn = moving_camera_trajectories(moving_camera,
                                                       np.float64)
    assert sorted(rec_j) == sorted(rec_t) == list(range(MOVING_ITERS + 1))
    for it in MOVING_AT:
        want = moving_camera_state(rec_j[it][1])
        got = moving_camera_state(rec_t[it][1])
        for k in want:
            err = np.abs(got[k] - want[k]).max()
            assert err <= MOVING_REL * np.abs(want[k]).max(), (it, k, err)
    for it in range(MOVING_ITERS):
        assert rec_t[it][0] == pytest.approx(rec_j[it][0], rel=MOVING_REL), it
    # the flow term: off at iteration 14, on from 15, below its threshold
    start = int(MOVING_ITERS * TA.AlignerConfig().flow_loss_start_ratio)
    params = TA.AlignParams(*map(torch.as_tensor, rec_t[start][1]))
    on, off = float(loss_fn(params, start)), float(loss_fn(params, start - 1))
    assert on == rec_t[start][0] and on > off


def drift_on_a_moving_camera():
    """The float32 drift of ``test_default_alignment_on_a_moving_camera_
    matches_jax``'s case by iteration (x max|ref|): the port against JAX
    in float32 and in float64, and each package's float32 run against
    JAX's float64 run; with the smoothing term at its default and without
    it. Prints one line an iteration."""
    import tempfile
    s = moving_camera_inputs(tempfile.mkdtemp())

    def rel(got, want):
        return " ".join(
            f"{k} {np.abs(got[k] - want[k]).max() / np.abs(want[k]).max():.2e}"
            for k in want)
    for smoothing in (0.01, 0.0):
        kw = dict(temporal_smoothing_weight=smoothing)
        j64, t64, _ = moving_camera_trajectories(s, np.float64, **kw)
        j32, t32, _ = moving_camera_trajectories(s, np.float32, **kw)
        losses = {n: np.asarray([r[i][0] for i in range(MOVING_ITERS)])
                  for n, r in (("j64", j64), ("t64", t64), ("j32", j32),
                               ("t32", t32))}
        rel64, rel32 = (np.max(np.abs(losses[f"t{b}"] / losses[f"j{b}"] - 1))
                        for b in (64, 32))
        print(f"smoothing {smoothing}: losses, port against JAX, relative: "
              f"float64 {rel64:.2e}, float32 {rel32:.2e}")
        for it in MOVING_AT:
            st = {n: moving_camera_state(r[it][1]) for n, r in
                  (("j64", j64), ("t64", t64), ("j32", j32), ("t32", t32))}
            print(f"  {it} iterations: port-JAX float32 "
                  f"[{rel(st['t32'], st['j32'])}]; float64 "
                  f"[{rel(st['t64'], st['j64'])}]; JAX float32-float64 "
                  f"[{rel(st['j32'], st['j64'])}]; port float32-JAX float64 "
                  f"[{rel(st['t32'], st['j64'])}]", flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    drift_on_a_moving_camera()
