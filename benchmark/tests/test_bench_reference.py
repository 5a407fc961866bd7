"""Each plain reference against the port at a tiny size on the CPU,
where the port runs its plain versions: the splat render and training
step, the stage-1 predictor, and the scene graph."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import scene as scene_mod
from benchmark import splat_program
from benchmark import stage1_inputs as inputs
from benchmark.reference import dust3r_model as ref_model
from benchmark.reference import splat as ref
from benchmark.tests.conftest import TINY_MODEL, tiny_cell


def _scene(tiny_bench, seed=11):
    cfg = json.loads((tiny_bench / "configs"
                      / "davis50_288x512_1p5m.json").read_text())
    return cfg, scene_mod.make_scene(cfg, seed, "cpu")


def test_reference_render_matches_the_port(tiny_bench, spec):
    from das3r_tpu_torch.models import render as render_mod
    from benchmark.drivers import splat_orbit
    cfg, sc = _scene(tiny_bench)
    tr = tiny_cell(spec, "davis50_1p5m.orbit_render", tiny_bench).traffic
    params, meta, _ = splat_program.program_state(sc, "cpu")
    conf = sc.params["conf_static"].reshape(-1)[sc.pix_id]
    settings = splat_orbit.settings_of(cfg, tr, sc)
    poses = scene_mod.orbit(sc, 4, 2.0)
    bg = torch.zeros(3)
    opacity = torch.sigmoid(sc.params["opacity"][:, 0]) * conf
    for v in range(4):
        with torch.no_grad():
            got = render_mod.render(params, meta, settings, poses[v], bg,
                                    sc.fovx, sc.fovy, mode="test",
                                    conf_per_gaussian=conf,
                                    device="cpu").image
        want = ref.render(sc.params, opacity, poses[v], sc.fovx, sc.fovy,
                          sc.height, sc.width, cfg["sh_degree"], bg,
                          grad=False).image
        assert float(want.norm()) > 1.0
        assert float((got - want).norm() / want.norm()) < 1e-5


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_reference_training_step_matches_the_port(tiny_bench, sh_degree):
    from das3r_tpu_torch.train import step as step_mod
    from das3r_tpu_torch.train.config import OptimizationConfig
    from benchmark.drivers import splat_train
    cfg, sc = _scene(tiny_bench)
    params, meta, poses = splat_program.program_state(sc, "cpu")
    settings = splat_train.probed_settings(params, meta, poses, sc,
                                           sh_degree)
    state = step_mod.init_train_state(params, poses)
    F = sc.gt.shape[0]
    fov = (torch.full((F,), sc.fovx), torch.full((F,), sc.fovy))
    _, _, m = step_mod.train_step(
        state, meta, 2, sc.gt[2], fov[0][2], fov[1][2], torch.zeros(3),
        settings, OptimizationConfig(**cfg["optimization"]),
        spatial_lr_scale=sc.spatial_lr_scale, track_stats=True)
    rp = {k: v.clone() for k, v in sc.params.items()}
    rp.update(Q=sc.poses[:, :4].clone(), T=sc.poses[:, 4:].clone(),
              fovx=torch.tensor(sc.fovx), fovy=torch.tensor(sc.fovy))
    o = ref.train_step(rp, ref.new_state(rp, ref.GAUSS_KEYS),
                       ref.new_state(rp, ref.CAM_KEYS), 1, 2, sc.gt[2],
                       sc.fovx, sc.fovy, sc.pix_id, sc.height, sc.width,
                       sh_degree, torch.zeros(3),
                       cfg["optimization"], sc.spatial_lr_scale)
    assert abs(float(m.loss) - o.loss) < 1e-5 * o.loss
    assert bool(m.cam_stepped) == o.cam_stepped
    for k in ref.GAUSS_KEYS:
        g = getattr(state.opt.mu, k) / 0.1
        want = o.grads[k]
        assert float((g - want).norm()) <= 1e-4 * float(want.norm()) + 1e-12
        # Adam's first update is lr x sign(g): compare each leaf's change
        # by its norm, as the cell's check does
        d_p = float((getattr(state.params, k) - sc.params[k]).norm())
        d_r = float((rp[k] - sc.params[k]).norm())
        assert abs(d_p - d_r) <= 1e-3 * d_r + 1e-12, k


def test_reference_predictor_matches_the_port():
    from das3r_tpu_torch.models.croco import dust3r
    cfg = {"model": dict(patch_size=16, mlp_ratio=4.0, **TINY_MODEL)}
    sd = inputs.weights(cfg, 3, "cpu")
    prog = dust3r.AsymmetricCroCo3D(dust3r.Dust3rConfig(**TINY_MODEL))
    prog.load_state_dict(sd)
    refm = ref_model.AsymmetricCroCo3D(inputs.model_config(cfg))
    refm.load_state_dict(sd)
    img = (inputs.clip({"height": 32, "width": 64}, 3, 0, 2, "cpu") - .5) / .5
    with torch.no_grad():
        a = prog.decode(*prog.encode(img[:1]), *prog.encode(img[1:]), 32, 64)
        b = refm.decode(*refm.encode(img[:1]), *refm.encode(img[1:]), 32, 64)
    for ra, rb in zip(a, b):
        for k in ra:
            x, y = ra[k].numpy(), rb[k].numpy()
            assert np.linalg.norm(x - y) <= 1e-6 * np.linalg.norm(y), k


def test_scene_graph_is_the_runners():
    from das3r_tpu_torch.predictor import pairs
    for n in (4, 16):
        assert inputs.scene_graph(n, 5, 2) == pairs.make_pairs(
            n, pairs.eval_scene_graph(n), symmetrize=True)


def test_scene_is_the_same_from_one_seed_and_keeps_its_sizes(tiny_bench):
    cfg, a = _scene(tiny_bench, 3000000123)
    _, b = _scene(tiny_bench, 3000000123)
    _, c = _scene(tiny_bench, 17)
    assert torch.equal(a.params["xyz"], b.params["xyz"])
    assert torch.equal(a.gt, b.gt)
    assert a.params["xyz"].shape == c.params["xyz"].shape
    assert not torch.equal(a.params["xyz"], c.params["xyz"])
