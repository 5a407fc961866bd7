"""PyTorch port: stage 1's flows, motion masks and mask refinement
(``predictor/{raft,searaft,flow,motion_mask,mask_refine}.py`` and the
runner's ``raft_params`` and ``mask_refiner``) against the JAX package.

No RAFT or SEA-RAFT checkpoint is in the repository: the networks run on
seeded random weights (``raft.random_state_dict``), the port's state dict
passed through JAX's converters, on one 64x96 pair."""
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from das3r_tpu.models.croco.convert import convert_torch_state_dict
from das3r_tpu.models.croco.dust3r import AsymmetricCroCo3D as JModel
from das3r_tpu.models.croco.testkit import TINY as JTINY
from das3r_tpu.predictor import alignment as JA
from das3r_tpu.predictor import flow as jflow
from das3r_tpu.predictor import mask_refine as jrefine
from das3r_tpu.predictor import motion_mask as jmm
from das3r_tpu.predictor import runner as jrunner
from das3r_tpu.predictor.raft import RAFT as JRaft
from das3r_tpu.predictor.raft import convert_raft_state_dict
from das3r_tpu.predictor.searaft import SeaRaft as JSeaRaft
from das3r_tpu.predictor.searaft import convert_searaft_state_dict
from das3r_tpu_torch.models.croco import convert
from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                  random_torch_state_dict)
from das3r_tpu_torch.predictor import alignment as TA
from das3r_tpu_torch.predictor import flow as tflow
from das3r_tpu_torch.predictor import mask_refine as trefine
from das3r_tpu_torch.predictor import motion_mask as tmm
from das3r_tpu_torch.predictor import raft, runner as trunner, searaft

from test_mask_refine import _square
from test_motion_mask import _synthetic_pair
from test_torch_stage1 import E2E_REL, REL, _rel, frames_dir, weights  # noqa

torch.set_num_threads(2)
BAR = 1e-4          # x max|ref|: PR 8's bar for the predictor's outputs
# SEA-RAFT on random weights amplifies the two packages' difference at each
# refinement (its flows reach hundreds of pixels on a 96-px image, looked
# up far outside the correlation volume): the initial flow and one
# iteration are held at BAR, two and three at SEA_BAR_2_3, ten times it;
# ``test_searaft_matches_jax`` prints the error of each (pytest -s).
SEA_BAR_2_3 = 1e-3


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    img1 = rng.uniform(0, 255, (1, 3, 64, 96)).astype(np.float32)
    img2 = (np.roll(img1, 3, axis=3) * 0.9
            + rng.uniform(0, 25, img1.shape)).astype(np.float32)
    return img1, img2


def seeded(cls, seed):
    """A port network on seeded weights and the same as JAX params."""
    model = cls()
    state = raft.random_state_dict(model, seed)
    raft.load_reference_weights(model, state)
    convert = (convert_searaft_state_dict if cls is searaft.SeaRaft
               else convert_raft_state_dict)
    return model, state, jax.tree.map(jnp.asarray, convert(state))


def flows_of(cls, jcls, pair, iters):
    model, _, params = seeded(cls, 1)
    img1, img2 = pair
    want = jax.jit(lambda p, a, b: jcls().apply({"params": p}, a, b,
                                                iters=iters))(params, img1,
                                                              img2)
    got = model(torch.as_tensor(img1), torch.as_tensor(img2), iters=iters)
    assert got.shape == (1, 2, 64, 96)
    return got.numpy(), np.asarray(want)


def test_raft_matches_jax(pair):
    """Classic RAFT, 3 iterations: within 1e-4 x max|ref| (the error is
    printed, pytest -s)."""
    got, want = flows_of(raft.RAFT, JRaft, pair, 3)
    print(f"RAFT, 3 iterations: {_rel(got, want):.2e} x max|ref|")
    assert np.abs(want).max() > 1
    assert _rel(got, want) <= BAR


@pytest.mark.parametrize("iters,bar", [(0, BAR), (1, BAR),
                                       (2, SEA_BAR_2_3), (3, SEA_BAR_2_3)])
def test_searaft_matches_jax(pair, iters, bar):
    """SEA-RAFT "M" (``SEA_BAR_2_3`` for the bar past one iteration)."""
    got, want = flows_of(searaft.SeaRaft, JSeaRaft, pair, iters)
    rel = _rel(got, want)
    print(f"SEA-RAFT, {iters} iterations: {rel:.2e} x max|ref| "
          f"({np.abs(want).max():.1f} px)")
    assert np.abs(want).max() > 1
    assert rel <= bar


@pytest.mark.parametrize("name,cls", [("raft-things.pth", raft.RAFT),
                                      ("Tartan-M.pth", searaft.SeaRaft)])
def test_load_flow_model_picks_the_network(tmp_path, name, cls):
    """'M' in the file name picks SEA-RAFT, as in the reference; the
    weights load under the reference's names (a ``module.`` prefix
    dropped)."""
    _, state, _ = seeded(cls, 3)
    path = tmp_path / name
    torch.save({f"module.{k}": torch.as_tensor(v) for k, v in state.items()},
               path)
    model = tflow.load_flow_model(str(path))
    assert type(model) is cls and not model.training
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)


def test_compute_edge_flows_matches_jax():
    """Three frames, 4 edges in chunks of 3, 2 iterations: the flows
    within 1e-4 x max|ref|, the consistency masks equal."""
    rng = np.random.default_rng(5)
    base = rng.uniform(0, 1, (3, 64, 96)).astype(np.float32)
    imgs = np.stack([np.roll(base, 2 * f, axis=2) for f in range(3)])
    edges = [(0, 1), (1, 2), (1, 0), (2, 0)]
    model, _, params = seeded(raft.RAFT, 2)
    want = jflow.compute_edge_flows(params, imgs, edges, iters=2, chunk=3)
    got = tflow.compute_edge_flows(model, imgs, edges, iters=2, chunk=3,
                                   device="cpu")
    for k in (0, 1):
        assert got[k].shape == (4, 2, 64, 96)
        assert _rel(got[k].numpy(), want[k]) <= BAR
    for k in (2, 3):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert 0 < int(got[2].sum()) < got[2].numel()


def test_motion_mask_matches_jax():
    """test_motion_mask.py's pair with a moving patch: the mask equal,
    the normalised error within 1e-5; the driver's list."""
    pts_n, pts_m_in_n, K, R, T = _synthetic_pair()
    H, W = pts_n.shape[:2]
    conf = np.full((H, W), 10.0, np.float32)
    flow = np.zeros((2, H, W), np.float32)
    flow[:, 10:20, 15:30] += 5.0
    want_m, want_e = jmm.pair_motion_mask(pts_n, pts_m_in_n, conf, flow)
    got_m, got_e = tmm.pair_motion_mask(pts_n, pts_m_in_n, conf, flow,
                                        device="cpu")
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_allclose(got_e, want_e, atol=1e-5, rtol=0)
    assert got_m.any() and not got_m.all()
    masks = tmm.motion_masks_from_pairs(
        np.stack([pts_n] * 2), np.stack([pts_m_in_n] * 2),
        np.stack([conf] * 2), np.stack([flow] * 2), device="cpu")
    assert len(masks) == 2 and masks[0].dtype == bool
    np.testing.assert_array_equal(masks[1], want_m)


def refine_cases():
    """test_mask_refine.py's inputs: (masks, propagator kwargs)."""
    hw = (16, 24)
    prior = np.zeros((5,) + hw, np.float32)
    prior[:, :, :12] = 1.0
    gap = np.stack([_square(f, 6 + f) for f in range(5)])
    gap[2] = False
    return {
        "moving": (np.stack([_square(f, 4 + 2 * f) for f in range(6)]), {}),
        "gap": (gap, {}),
        "dilate1": (gap, dict(dilate_per_step=1)),
        "prior": (gap, dict(dilate_per_step=3, prior=prior)),
    }


@pytest.mark.parametrize("case", sorted(refine_cases()))
def test_mask_refine_is_bitwise_jax(case):
    masks, kw = refine_cases()[case]
    want = jrefine.refine_motion_masks(
        masks, propagator=jrefine.NeighborPropagator(**kw))
    got = trefine.refine_motion_masks(
        masks, propagator=trefine.NeighborPropagator(**kw))
    np.testing.assert_array_equal(got, want)
    assert got.sum() > masks.sum()
    with pytest.raises(ImportError, match="sam2"):
        trefine.Sam2Propagator("ckpt.pt", "cfg.yaml")


def test_run_scene_with_flows_and_refinement_matches_jax(
        weights, frames_dir, tmp_path, monkeypatch):
    """The runner with a flow network (RAFT on seeded weights, its flow
    head scaled by 0.01 so the flows are ~0.1 px and pass the flow term's
    gates; 2 iterations in both packages) and the NeighborPropagator,
    against JAX's runner: the same files, masks bitwise, depths and poses
    within PR 8's bars.

    At 64x96 frames (RAFT's 4-level pyramid needs 1/8-size maps of 8
    rows; PR 8's runner test runs 48x64) the alignment amplifies the
    packages' ~1e-7 differences past PR 8's bar: within 2 iterations with
    the temporal smoothing term (its safe norm of near-identity relative
    poses makes the direction of its gradient noise, which Adam's
    normalised step follows), and from the third without it
    (``PYTHONPATH=. python tests/test_torch_flow.py`` prints the drift of
    both by iteration; ROADMAP.md section 3). So: no smoothing term, the flow
    term's gate off (``flow_loss_thre=0``), no dynamic pixel
    (``motion_mask_thre=0.5`` > every dyna_avg of the random predictor, so
    the flow term covers every pixel), 2 iterations: the flow term is
    active from the second (``flow_loss_start_ratio``)."""
    _, params, model = weights
    flow_net = raft.RAFT()
    state = raft.random_state_dict(flow_net, 4)
    for k in ("weight", "bias"):
        state[f"update_block.flow_head.conv2.{k}"] *= 0.01
    raft.load_reference_weights(flow_net, state)
    flow_params = jax.tree.map(jnp.asarray, convert_raft_state_dict(state))
    monkeypatch.setattr(jflow, "compute_edge_flows", functools.partial(
        jflow.compute_edge_flows, iters=2))
    monkeypatch.setattr(tflow, "compute_edge_flows", functools.partial(
        tflow.compute_edge_flows, iters=2))
    cfg = dict(niter=2, temporal_smoothing_weight=0.0, flow_loss_thre=0.0,
               motion_mask_thre=0.5)
    kw = dict(scene_graph="swin-2-noncyclic", size=96,
              verbose=lambda *_: None)
    want = jrunner.run_scene(
        frames_dir, str(tmp_path / "jax"), JModel(JTINY), params,
        aligner_cfg=JA.AlignerConfig(**cfg), raft_params=flow_params,
        mask_refiner=jrefine.NeighborPropagator(), **kw)
    stats = {}
    got = trunner.run_scene(
        frames_dir, str(tmp_path / "port"), model,
        aligner_cfg=TA.AlignerConfig(**cfg), raft_params=flow_net,
        mask_refiner=trefine.NeighborPropagator(), device="cpu",
        stats=stats, **kw)
    assert TA.AlignerConfig().flow_loss_weight == 0.01
    assert stats["flow_s"] > 0 and stats["refine_s"] >= 0
    no_flow = trunner.run_scene(
        frames_dir, str(tmp_path / "plain"), model,
        aligner_cfg=TA.AlignerConfig(**cfg), device="cpu", **kw)
    assert got.scene.final_loss > 1.5 * no_flow.scene.final_loss
    assert got.scene.depths.shape[1:] == (64, 96)
    for k in ("depths", "poses_c2w", "focals"):
        assert _rel(getattr(got.scene, k), getattr(want.scene, k)) \
            <= E2E_REL, k
    np.testing.assert_array_equal(got.scene.dynamic_masks,
                                  want.scene.dynamic_masks)
    for i in range(6):
        for name in (f"dynamic_mask_{i:04d}.png",
                     f"enlarged_dynamic_mask_{i:04d}.png"):
            np.testing.assert_array_equal(
                np.asarray(Image.open(tmp_path / "port" / name)),
                np.asarray(Image.open(tmp_path / "jax" / name)), name)
        assert _rel(np.load(tmp_path / "port" / f"dyna_avg_{i:04d}.npy"),
                    np.load(tmp_path / "jax" / f"dyna_avg_{i:04d}.npy")) \
            <= REL
    shutil.rmtree(tmp_path)


# A start whose dynamic mask is neither all-dynamic nor all-static. On the
# testkit's random weights every pixel's dyna_avg lies in [0.4941, 0.4960],
# above the 0.35 threshold: the mask heads' last convolution is scaled by
# MASK_SCALE so the logits spread over the image, and its bias shifted by
# MASK_SHIFT, which puts the threshold in the widest gap between the middle
# pixels' values (the median logit alone leaves pixels within 1e-7 of it,
# which the packages' ~1e-7 differences flip). 58.9% of the pixels are
# static, each at least MASK_MARGIN from the threshold.
MASK_SCALE = 1000.0
MASK_SHIFT = 21.87857
MASK_MARGIN = 1e-5


def learnt_mask_weights(sd: dict) -> dict:
    """``sd`` with both mask heads' last convolution scaled and shifted."""
    out = dict(sd)
    for h in (1, 2):
        k = f"downstream_head_dynamic_mask{h}.dpt.head.4"
        out[f"{k}.weight"] = sd[f"{k}.weight"] * np.float32(MASK_SCALE)
        out[f"{k}.bias"] = (sd[f"{k}.bias"] * np.float32(MASK_SCALE)
                            + np.float32(MASK_SHIFT))
    return out


def flow_net_and_params():
    """RAFT on seeded weights, its flow head scaled by 0.01 (flows of
    ~0.1 px), and the same as JAX params."""
    flow_net = raft.RAFT()
    state = raft.random_state_dict(flow_net, 4)
    for k in ("weight", "bias"):
        state[f"update_block.flow_head.conv2.{k}"] *= 0.01
    raft.load_reference_weights(flow_net, state)
    return flow_net, jax.tree.map(jnp.asarray,
                                  convert_raft_state_dict(state))


@pytest.mark.parametrize("niter, smoothing", [(1, 0.01), (12, 0.0)],
                         ids=["smoothing_default", "flow_term_12_iters"])
def test_run_scene_with_flows_on_learnt_masks_matches_jax(
        weights, frames_dir, tmp_path, monkeypatch, niter, smoothing):
    """The runner with RAFT flows on a start whose static mask is neither
    empty nor whole (``learnt_mask_weights``), every other alignment
    setting at its default (the flow term from iteration 0.15 niter, its
    gates on), against JAX's runner at the runner's end-to-end bar
    (``E2E_REL``): masks bitwise, depths, poses and focals within
    1e-4 x max|ref|.

    ``flow_term_12_iters``: without the temporal smoothing term, 12
    iterations, 10 of them with the flow term on the 58.9% static pixels.
    ``smoothing_default``: the smoothing term at its default (0.01) holds
    the bar for 1 iteration only (poses 3.9e-5 x max|ref|; 5.1e-4 after 2,
    2.7e-2 after 12), and that iteration runs no flow term: its start
    ratio puts it at iteration 0.15, and at iteration 0 it cannot be
    compared (the start's depths clipped at 1e-8 turn the initial poses'
    ~1e-7 rounding differences into ego flows of tenths of a pixel).
    ROADMAP.md section 3 has the numbers; ``PYTHONPATH=. python
    tests/test_torch_flow.py [--conditioning]`` prints them."""
    sd = learnt_mask_weights(weights[0])
    params = jax.tree.map(jnp.asarray, convert_torch_state_dict(sd, JTINY))
    model = AsymmetricCroCo3D(TINY)
    convert.load_reference_state_dict(model, sd)
    flow_net, flow_params = flow_net_and_params()
    monkeypatch.setattr(jflow, "compute_edge_flows", functools.partial(
        jflow.compute_edge_flows, iters=2))
    monkeypatch.setattr(tflow, "compute_edge_flows", functools.partial(
        tflow.compute_edge_flows, iters=2))
    cfg = dict(niter=niter, temporal_smoothing_weight=smoothing)
    kw = dict(scene_graph="swin-2-noncyclic", size=96,
              verbose=lambda *_: None)
    want = jrunner.run_scene(
        frames_dir, str(tmp_path / "jax"), JModel(JTINY), params,
        aligner_cfg=JA.AlignerConfig(**cfg), raft_params=flow_params, **kw)
    got = trunner.run_scene(
        frames_dir, str(tmp_path / "port"), model,
        aligner_cfg=TA.AlignerConfig(**cfg), raft_params=flow_net,
        device="cpu", **kw)
    static = float((~want.scene.dynamic_masks).mean())
    print(f"static share {static:.4f}")
    assert 0.4 < static < 0.8
    thre = TA.AlignerConfig().motion_mask_thre
    assert np.abs(want.scene.dyna_avg - thre).min() > MASK_MARGIN
    np.testing.assert_array_equal(got.scene.dynamic_masks,
                                  want.scene.dynamic_masks)
    for k in ("depths", "poses_c2w", "focals"):
        assert _rel(getattr(got.scene, k), getattr(want.scene, k)) \
            <= E2E_REL, k
    shutil.rmtree(tmp_path)


def _probe_inputs(work):
    """The runner tests' 6 frames under ``work``/frames, the seed-0 TINY
    state dict, RAFT and the runner's keywords, for the probes below."""
    from das3r_tpu.data.synthetic import make_synthetic_stage1_dir
    make_synthetic_stage1_dir(f"{work}/gen", n_frames=6, height=48,
                              width=64)
    os.makedirs(f"{work}/frames")
    for name in sorted(os.listdir(f"{work}/gen")):
        if name.startswith("frame_") and name.endswith(".png"):
            shutil.copy(f"{work}/gen/{name}", f"{work}/frames")
    return (random_torch_state_dict(TINY, np.random.default_rng(0)),
            flow_net_and_params(),
            dict(scene_graph="swin-2-noncyclic", size=96,
                 verbose=lambda *_: None))


def _both_runners(work, sd, flows, cfg, kw):
    """JAX's and the port's ``run_scene`` on the frames of ``work`` from
    the reference state dict ``sd``: (JAX's result, the port's)."""
    model = AsymmetricCroCo3D(TINY)
    convert.load_reference_state_dict(model, sd)
    want = jrunner.run_scene(
        f"{work}/frames", f"{work}/jax", JModel(JTINY),
        jax.tree.map(jnp.asarray, convert_torch_state_dict(sd, JTINY)),
        aligner_cfg=JA.AlignerConfig(**cfg), raft_params=flows[1], **kw)
    got = trunner.run_scene(
        f"{work}/frames", f"{work}/port", model,
        aligner_cfg=TA.AlignerConfig(**cfg), raft_params=flows[0],
        device="cpu", **kw)
    return want, got


def drift_by_iteration(work, niters=(1, 2, 3, 5, 8, 12)):
    """The runner tests' configurations, varied: the poses' and depths'
    error against JAX's runner (x max|ref|) by alignment iterations, with
    the temporal smoothing term at its default and without it, on the
    random weights (every pixel dynamic, the flow term's gate off, as in
    ``test_run_scene_with_flows_and_refinement_matches_jax``) and on the
    learnt-mask start (every other setting at its default, as in
    ``test_run_scene_with_flows_on_learnt_masks_matches_jax``). Prints one
    line a run."""
    import tempfile
    work = tempfile.mkdtemp(dir=work)
    random_sd, flows, kw = _probe_inputs(work)
    starts = {"random": (random_sd, dict(flow_loss_thre=0.0,
                                         motion_mask_thre=0.5)),
              "learnt_masks": (learnt_mask_weights(random_sd), {})}
    for start, (sd, start_cfg) in starts.items():
        for smoothing in (0.01, 0.0):
            for niter in niters:
                cfg = dict(niter=niter, temporal_smoothing_weight=smoothing,
                           **start_cfg)
                want, got = _both_runners(work, sd, flows, cfg, kw)
                g, w = got.scene, want.scene
                print(f"{start}, smoothing {smoothing}, {niter} iterations: "
                      f"static {float((~w.dynamic_masks).mean()):.3f}, "
                      f"poses {_rel(g.poses_c2w, w.poses_c2w):.2e}, "
                      f"depths {_rel(g.depths, w.depths):.2e} x max|ref|",
                      flush=True)
    shutil.rmtree(work)


def flow_term_conditioning(work):
    """Where the learnt-mask start's comparison loses its conditioning
    (ROADMAP.md section 3). Without the smoothing term, for the 3- and
    12-iteration runs: each iteration's ``im_poses`` and ``depth_log``
    error against JAX's (x max|ref|) after its Adam step, frame 0's
    quaternion-w gradient at iteration 0 in both packages, and (3
    iterations) the ``im_poses`` gradient in float64 at JAX's parameters
    against float64 at the port's, and each package's float32 gradient
    against float64 at its own (x max|g64|). Then the flow term at
    iteration 0 (``flow_loss_start_ratio=0``): its value at each
    package's initial parameters in float32 and float64, the parameters'
    differences, and 1 iteration with the smoothing term run that way."""
    import dataclasses
    import tempfile

    work = tempfile.mkdtemp(dir=work)
    random_sd, flows, kw = _probe_inputs(work)
    sd = learnt_mask_weights(random_sd)
    names = [f.name for f in dataclasses.fields(TA.AlignParams)]
    rec = {}

    def jax_step(params, grads, state, lrs, **k):
        out = j_adam(params, grads, state, lrs, **k)
        jax.debug.callback(
            lambda g, *ps: rec["jax"].append(
                (np.asarray(g), [np.asarray(p) for p in ps])),
            grads.im_poses, *params, *out[0], ordered=True)
        return out

    def port_step(params, grads, state, lrs, **k):
        before = [getattr(params, n).detach().clone() for n in names]
        out = t_adam(params, grads, state, lrs, **k)
        rec["port"].append((grads.im_poses.detach().numpy().copy(),
                            [p.numpy() for p in before]
                            + [getattr(params, n).detach().numpy().copy()
                               for n in names]))
        return out

    def port_loss(*a, **k):
        rec["loss_args"] = (a, k)
        return t_make_loss(*a, **k)

    def f64(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.double()
        if isinstance(x, tuple):
            return type(x)(*map(f64, x)) if hasattr(x, "_fields") \
                else tuple(map(f64, x))
        return x

    def loss_at(ps, it, dtype, **cfg_changes):
        """The port's loss, rebuilt from the captured arguments in
        ``dtype``, and its gradient in ``im_poses`` at ``ps``."""
        a, k = rec["loss_args"]
        a = list(a)
        a[3] = dataclasses.replace(a[3], **cfg_changes)
        conv = f64 if dtype == torch.float64 else (lambda v: v)
        fn = t_make_loss(*map(conv, a), **{n: conv(v) for n, v in k.items()})
        q = TA.AlignParams(*[torch.tensor(p, dtype=dtype,
                                          requires_grad=True) for p in ps])
        loss = fn(q, it)
        grad = torch.autograd.grad(loss, q.im_poses)[0]
        return float(loss.detach()), grad.numpy()

    j_adam, t_adam, t_make_loss = (JA.optim_mod.adam_step, TA.adam_step,
                                   TA.make_align_loss)
    JA.optim_mod.adam_step, TA.adam_step = jax_step, port_step
    TA.make_align_loss = port_loss
    try:
        for niter in (3, 12):
            rec.update(jax=[], port=[])
            _both_runners(work, sd, flows, dict(
                niter=niter, temporal_smoothing_weight=0.0), kw)
            steps = list(zip(rec["jax"], rec["port"]))
            (gj, _), (gp, _) = steps[0]
            print(f"{niter} iterations: frame 0's quaternion-w gradient at "
                  f"iteration 0: JAX {gj[0, 3]:.3e}, port {gp[0, 3]:.3e}")
            for field, k in (("im_poses", 1), ("depth_log", 2)):
                errs = [_rel(p[5 + k], j[5 + k])
                        for (_, j), (_, p) in steps]
                print(f"  {field} after each step (x max|ref|): "
                      + ", ".join(f"{e:.1e}" for e in errs))
            for it, ((gj, pj), (gp, pp)) in enumerate(steps):
                if niter != 3:
                    break
                _, g64j = loss_at(pj[:5], it, torch.float64)
                _, g64p = loss_at(pp[:5], it, torch.float64)
                m = np.abs(g64p).max()
                print(f"  iteration {it}: float64 gradient at JAX's "
                      f"against the port's parameters "
                      f"{np.abs(g64j - g64p).max() / m:.2e}; JAX's float32 "
                      f"against it {np.abs(gj - g64j).max() / m:.2e}, the "
                      f"port's {np.abs(gp - g64p).max() / m:.2e} x max|g64|")
        # the flow term at iteration 0, at each package's start
        (_, pj), (_, pp) = steps[0]
        print("initial parameters, JAX against the port (max abs): "
              + ", ".join(f"{n} {np.abs(a - b).max():.2e}"
                          for n, a, b in zip(names, pj[:5], pp[:5])))
        for who, ps in (("JAX's", pj[:5]), ("the port's", pp[:5])):
            for dtype in (torch.float32, torch.float64):
                on, _ = loss_at(ps, 0, dtype, flow_loss_start_ratio=0.0,
                                flow_loss_weight=1.0)
                off, _ = loss_at(ps, 0, dtype, flow_loss_weight=0.0)
                print(f"  flow term at {who} start, {dtype}: {on - off:.6e}")
        want, got = _both_runners(work, sd, flows, dict(
            niter=1, flow_loss_start_ratio=0.0), kw)
        print("1 iteration, smoothing term, the flow term from iteration 0:"
              f" poses {_rel(got.scene.poses_c2w, want.scene.poses_c2w):.2e}"
              " x max|ref|", flush=True)
    finally:
        JA.optim_mod.adam_step, TA.adam_step = j_adam, t_adam
        TA.make_align_loss = t_make_loss
    shutil.rmtree(work)


if __name__ == "__main__":
    import sys
    import tempfile
    jax.config.update("jax_platforms", "cpu")
    jflow.compute_edge_flows = functools.partial(jflow.compute_edge_flows,
                                                 iters=2)
    tflow.compute_edge_flows = functools.partial(tflow.compute_edge_flows,
                                                 iters=2)
    probe = (flow_term_conditioning if "--conditioning" in sys.argv
             else drift_by_iteration)
    args = [a for a in sys.argv[1:] if a != "--conditioning"]
    probe(args[0] if args else tempfile.gettempdir())
