"""PyTorch port: the trainer's one-time and per-event state surgery
against the JAX package on the same numpy inputs: the k-NN scale init,
``init_from_frames``, densify (clone, split, prune), the opacity reset,
capacity growth and the capacity probe with its ``auto_*`` rules."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.models import autosize as jauto
from das3r_tpu.models import densify as jdens
from das3r_tpu.models import gaussians as jgs
from das3r_tpu.ops.knn import knn_mean_sq_dist as jknn
from das3r_tpu.ops.splat import RasterSettings as JaxSettings
from das3r_tpu.train import optim as joptim
from das3r_tpu_torch.models import autosize as tauto
from das3r_tpu_torch.models import densify as tdens
from das3r_tpu_torch.models import gaussians as tgs
from das3r_tpu_torch.ops.knn import knn_mean_sq_dist as tknn
from das3r_tpu_torch.ops.splat import RasterSettings

torch.set_num_threads(2)
FIELDS = [f.name for f in dataclasses.fields(tgs.GaussianParams)]


def test_knn_matches_jax_and_ignores_the_block():
    """The expansion |q|^2 - 2 q.p + |p|^2 cancels for near neighbours, so
    both packages are held to the float64 exact result within its rounding
    bound, 1e-6 x max|p|^2 (about 8 float32 ulps of the largest term; both
    measured within 3e-7), and to each other within the same; the port's
    result is the same, bit for bit, at every block."""
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(700, 3)) * 0.05 + 1.5).astype(np.float32)
    pts[5] = pts[4]                                   # a zero distance
    p64 = pts.astype(np.float64)
    d = ((p64[:, None] - p64[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    exact = np.sort(d, 1)[:, :3].mean(1)
    bound = 1e-6 * (p64 ** 2).sum(1).max()
    want = np.asarray(jknn(jnp.asarray(pts), k=3, block=256))
    got = tknn(torch.as_tensor(pts))
    for x in (got.numpy(), want):
        np.testing.assert_allclose(x, exact, rtol=0, atol=bound)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bound)
    for block in (1, 64, 699, 700):
        assert torch.equal(tknn(torch.as_tensor(pts), block=block), got)
    tiny = tknn(torch.zeros(2, 3))
    assert torch.isinf(tiny).all()                    # fewer than 3 others


def stage1_frames(rng, f=3, h=12, w=16):
    images = rng.uniform(0, 1, (f, 3, h, w)).astype(np.float32)
    depths = rng.uniform(1.0, 3.0, (f, h, w)).astype(np.float32)
    confs = rng.uniform(-1.0, 2.0, (f, h, w)).astype(np.float32)
    confs[0, :2] = 1.5                                # ties at the cap
    dyna = rng.uniform(0, 1, (f, h, w)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    poses[:, :3, 3] = rng.normal(0, 0.1, (f, 3))
    focals = np.full(f, 14.0, np.float32)
    return images, depths, confs, dyna, poses, focals


def assert_params_close(tp, jp):
    """Every field within 1e-6 but the log-scales, whose k-NN mean squared
    distances exp(2 s) are held within the k-NN bound of
    ``test_knn_matches_jax_and_ignores_the_block``, 1e-6 x max|xyz|^2."""
    for name in FIELDS:
        got, want = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        atol = 1e-6
        if name == "scaling":
            got, want = np.exp(2 * got), np.exp(2 * want)
            atol = 1e-6 * float((tp.xyz.numpy() ** 2).sum(1).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("max_points", [None, 200])
def test_init_from_frames_matches_jax(max_points):
    args = stage1_frames(np.random.default_rng(1))
    jp, jm, jscene = jgs.init_from_frames(*args, max_sh_degree=2,
                                          max_points=max_points)
    tp, tm, tscene = tgs.init_from_frames(*args, max_sh_degree=2,
                                          max_points=max_points,
                                          device="cpu")
    assert dataclasses.asdict(tscene) == dataclasses.asdict(jscene)
    assert_params_close(tp, jp)
    for name in ("alive", "pix_id", "max_radii2d", "xyz_grad_accum",
                 "denom"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    n = int(tm.alive.sum())
    assert n == (max_points or n) and tp.xyz.shape[0] == 4096
    assert (tp.opacity[n:] == -1e4).all()
    assert (tp.rotation[n:] == torch.tensor([1.0, 0, 0, 0])).all()

    pts = np.random.default_rng(2).normal(size=(300, 3)).astype(np.float32)
    cols = np.random.default_rng(3).uniform(size=(300, 3)).astype(np.float32)
    jp, jm, _ = jgs.init_from_point_cloud(pts, cols, max_sh_degree=1)
    tp, tm, _ = tgs.init_from_point_cloud(pts, cols, max_sh_degree=1,
                                          device="cpu")
    assert_params_close(tp, jp)
    np.testing.assert_array_equal(tm.alive.numpy(), np.asarray(jm.alive))


def densify_state(seed=0, nc=160, n_alive=70):
    """Both packages' (params, meta, Adam state) of one random state:
    clone candidates (hot, small), split candidates (hot, large), prune
    candidates (faint or, with max_screen_size, large on screen)."""
    rng = np.random.default_rng(seed)
    p = dict(
        xyz=rng.normal(size=(nc, 3)), features_dc=rng.normal(size=(nc, 1, 3)),
        features_rest=rng.normal(size=(nc, 3, 3)),
        # even rows small (clone), odd rows large (split)
        scaling=np.log(np.where(np.arange(nc)[:, None] % 2 == 0,
                                rng.uniform(0.001, 0.04, (nc, 3)),
                                rng.uniform(0.06, 0.2, (nc, 3)))),
        rotation=rng.normal(size=(nc, 4)),
        opacity=rng.normal(0, 3, (nc, 1)),
        conf_static=rng.uniform(size=(2, 4, 4)))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    alive = np.arange(nc) < n_alive
    m = dict(alive=alive, pix_id=rng.integers(0, 32, nc).astype(np.int32),
             max_radii2d=rng.uniform(0, 40, nc).astype(np.float32),
             xyz_grad_accum=rng.uniform(0, 6e-4, nc).astype(np.float32),
             denom=rng.integers(0, 3, nc).astype(np.float32))
    mu = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    nu = {k: rng.uniform(size=v.shape).astype(np.float32)
          for k, v in p.items()}
    jstate = (jgs.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()}),
              jgs.GaussianMeta(**{k: jnp.asarray(v) for k, v in m.items()}),
              joptim.AdamState(count=jnp.asarray(7, jnp.int32),
                               mu=jgs.GaussianParams(**mu),
                               nu=jgs.GaussianParams(**nu)))
    tp, tm = tgs.params_from_numpy(p, m, "cpu")
    topt = tgs.adam_state_from_numpy(7, mu, nu, tgs.GaussianParams, "cpu")
    return jstate, (tp, tm, topt)


def assert_group_equal(tgroup, jgroup, skip=()):
    for f in dataclasses.fields(tgroup):
        if f.name not in skip:
            np.testing.assert_array_equal(
                getattr(tgroup, f.name).numpy(),
                np.asarray(getattr(jgroup, f.name)), err_msg=f.name)


@pytest.mark.parametrize("cfg", [
    dict(enable_clone=True),
    dict(enable_clone=True, max_screen_size=20.0, extent=0.5),
    dict(enable_clone=True, enable_split=True, split_n=2),
], ids=["clone_prune", "size_prune", "clone_split"])
def test_densify_matches_jax(cfg):
    """Clone and prune exactly. Split: the same rows split into the same
    slots, with the source's features and scale / (0.8 N); only the
    positions' noise differs (jax.random against a torch.Generator)."""
    (jp, jm, jo), (tp, tm, to) = densify_state()
    jcfg = jdens.DensifyConfig(grad_threshold=2e-4, percent_dense=0.05,
                               **cfg)
    tcfg = tdens.DensifyConfig(**dataclasses.asdict(jcfg))
    jp2, jm2, jo2, jrep = jdens.densify_and_prune(
        jp, jm, jo, jax.random.PRNGKey(0), jcfg)
    tp2, tm2, to2, trep = tdens.densify_and_prune(
        tp, tm, to, torch.Generator().manual_seed(0), tcfg)
    for f in ("n_cloned", "n_split", "n_pruned", "n_overflow"):
        assert int(getattr(trep, f)) == int(getattr(jrep, f)), f
    assert int(trep.n_cloned) > 0 and int(trep.n_pruned) > 0
    assert_group_equal(tm2, jm2)
    if cfg.get("enable_split"):
        assert int(trep.n_split) > 0
        # only the split rows' positions differ: their noise
        moved = np.abs(tp2.xyz.numpy() - np.asarray(jp2.xyz)).max(1) > 0
        assert moved.sum() == int(trep.n_split)
        np.testing.assert_array_equal(tp2.xyz.numpy()[~moved],
                                      np.asarray(jp2.xyz)[~moved])
        assert_group_equal(tp2, jp2, skip=("xyz",))
    else:
        assert_group_equal(tp2, jp2)
    for grp in ("mu", "nu"):
        assert_group_equal(getattr(to2, grp), getattr(jo2, grp))


def test_reset_opacity_and_grow_capacity_match_jax():
    (jp, jm, jo), (tp, tm, to) = densify_state(seed=3)
    jp2, jo2 = jdens.reset_opacity(jp, jo)
    tp2, to2 = tdens.reset_opacity(tp, to)
    assert_group_equal(tp2, jp2)
    for grp in ("mu", "nu"):
        assert_group_equal(getattr(to2, grp), getattr(jo2, grp))
    jp3, jm3, jo3 = jdens.grow_capacity(jp2, jm, jo2, 40)
    tp3, tm3, to3 = tdens.grow_capacity(tp2, tm, to2, 40)
    assert tp3.xyz.shape[0] == 200
    assert_group_equal(tp3, jp3)
    assert_group_equal(tm3, jm3)
    for grp in ("mu", "nu"):
        assert_group_equal(getattr(to3, grp), getattr(jo3, grp))


def probe_scene():
    """A small frame-initialised scene in both packages (the port's from
    the JAX arrays) and its poses, at 40x56."""
    rng = np.random.default_rng(5)
    images, depths, confs, dyna, _, focals = stage1_frames(rng, 4, 40, 56)
    poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    poses[:, :3, 3] = [[0, 0, 0], [0.05, 0, 0], [0, 0.05, 0], [0.05, 0.05, 0]]
    focals[:] = 40.0
    jp, jm, _ = jgs.init_from_frames(images, depths, confs, dyna, poses,
                                     focals, max_sh_degree=0)
    jposes = jgs.init_pose_params(np.linalg.inv(poses), 1.2, 0.9)
    np_ = lambda g: {k: np.asarray(v) for k, v in g._asdict().items()}
    tp, tm = tgs.params_from_numpy(np_(jp), np_(jm), "cpu")
    tposes = tgs.poses_from_numpy(np_(jposes), "cpu")
    return (jp, jm, jposes), (tp, tm, tposes)


def test_probe_and_auto_caps_match_jax():
    (jp, jm, jposes), (tp, tm, tposes) = probe_scene()
    kw = dict(image_height=40, image_width=56, sh_degree=0,
              max_tiles_per_gaussian=32, max_total_entries=8 * 4096)
    js, ts = JaxSettings(**kw), RasterSettings(**kw)
    jargs = (jp, jm, js, jposes.all_poses(), 1.2, 0.9)
    targs = (tp, tm, ts, tposes.all_poses(), 1.2, 0.9)
    jst = jauto.probe_capacities(*jargs)
    tst = tauto.probe_capacities(*targs)
    assert tst == jst and tst.max_tile > 128        # truncation is free
    assert tauto.auto_entry_cap(*targs) == jauto.auto_entry_cap(*jargs)
    assert tauto.auto_dup_cap(*targs) == jauto.auto_dup_cap(*jargs)
    for f in (5, 8, 9, 50, 151):
        np.testing.assert_array_equal(
            tauto.probe_views(f), np.asarray(jnp.linspace(0, f - 1, min(
                f, 8)).astype(jnp.int32)) if f > 8 else np.arange(f))

    hist = (900_000, 500_000, 200_000, 60_000, 9000, 10, 0, 0, 0, 0)
    for n, dup, heavy in ((1_500_000, 16, 70_000), (100_000, 32, 500),
                          (1_500_000, 4, 0), (3_000_000, 32, 2_000_000)):
        st = jauto.ProbeStats(1, 1, dup, heavy, hist)
        assert tauto.auto_split_table(tauto.ProbeStats(*st), n, dup) == \
            jauto.auto_split_table(st, n, dup)
        assert tauto.auto_heavy_cap(heavy, n, dup) == \
            jauto.auto_heavy_cap(heavy, n, dup)
        assert tauto.auto_heavy_cap(heavy) == jauto.auto_heavy_cap(heavy)
    assert tauto.SPLIT_TABLE_MIN_SLOTS == jauto.SPLIT_TABLE_MIN_SLOTS
