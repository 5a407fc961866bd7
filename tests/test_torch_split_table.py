"""PyTorch port: the split-width duplication table (``heavy_rows_cap`` set,
``0 < light_dup_width < max_tiles_per_gaussian``) against the JAX
package's, on the fixture of ``tests/test_binning_split.py``.

Both binners get the same preprocess outputs (the JAX ones, converted), so
binning is compared bitwise:

* with an ample cap the port's split stream is JAX's split stream and the
  port's own full-width stream (its live keys, ``rank``, ``chunk_tile``,
  ``count``, ``astart``), with ``heavy_overflow`` 0;
* with a starved cap it is JAX's, ``heavy_overflow`` and
  ``entry_overflow`` included (the JAX count of rect cells, an upper
  bound on the entries dropped under tight binning);
* the window path's ``TileBins`` in both cases;
* a ``max_total_entries`` below the live total drops nothing from the
  split table's keys and is reported, as JAX does on that branch.

Then ``rasterize`` with a starved cap on both raster branches against JAX
(the image within 2e-4, the gradients within 2e-5 x max|g|), and the
trainer's heavy-row regrow.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das3r_tpu.models import autosize as jautosize
from das3r_tpu.ops.splat import binning as jbin
from das3r_tpu.ops.splat import rasterize as jax_rasterize
from das3r_tpu_torch.data import readers
from das3r_tpu_torch.models import render as render_mod
from das3r_tpu_torch.ops.splat import binning as tbin
from das3r_tpu_torch.ops.splat import rasterize
from das3r_tpu_torch.train import scene_setup, trainer
from das3r_tpu_torch.train.config import OptimizationConfig

from test_splat import make_scene
from test_torch_binning import assert_streams_equal, jax_prep_pair
from test_torch_blend_backward import assert_grads_close
from test_torch_preprocess import raster_kwargs, settings_pair, to_jax
from test_torch_trainer import BUILD, scene_dir  # noqa: F401 (fixture)

torch.set_num_threads(2)
ATOL = 2e-4     # the image bar of the JAX tests against the oracle
RTOL = 2e-5     # x max|g|: the JAX gradient bar
N, SEED = 6000, 7
# tests/test_binning_split.py::_base_settings
BASE = dict(image_height=96, image_width=128, sh_degree=0, max_per_tile=512,
            max_tiles_per_gaussian=16, max_total_entries=96 * 1024,
            light_dup_width=4)


@functools.lru_cache(maxsize=2)
def prep_pair(tight: bool):
    """(JAX settings, port settings, JAX Preprocessed, the same as torch,
    heavy rows) of the fixture scene; the port's stream is sized from the
    counts."""
    js, ts, jprep, tprep = jax_prep_pair(N, SEED, **BASE,
                                         tight_binning=tight)
    ntt = np.minimum(np.asarray(jprep.n_tiles_touched),
                     BASE["max_tiles_per_gaussian"])
    heavy = int(((ntt > BASE["light_dup_width"])
                 & np.asarray(jprep.binnable)).sum())
    assert heavy > 8, "the fixture must exercise the heavy table"
    return js, ts, jprep, tprep, heavy


def caps(heavy: int) -> dict:
    """An ample cap (2x the heavy rows) and a starved one (a third)."""
    return {"ample": -(-heavy * 2 // 128) * 128,
            "starved": max(128, (heavy // 3) // 128 * 128)}


def with_cap(js, ts, cap, **kw):
    return (dataclasses.replace(js, heavy_rows_cap=cap, **kw),
            dataclasses.replace(ts, heavy_rows_cap=cap, **kw))


def jax_live_keys(js, jprep):
    """The JAX sorted key stream's live keys (below the sentinel tile) as
    int64, and its overflow counters."""
    ks = jax.jit(lambda p: jbin._sorted_key_stream(p, js))(jprep)
    keys = np.asarray(ks.sorted_packed).astype(np.int64)
    live = keys[keys < (js.n_tiles << ks.nbits)]
    return live, int(ks.entry_overflow), int(ks.heavy_overflow)


@pytest.mark.parametrize("cap", ["ample", "starved"])
@pytest.mark.parametrize("tight", [True, False])
def test_entry_stream_matches_jax_split(tight, cap):
    js, ts, jprep, tprep, heavy = prep_pair(tight)
    js1, ts1 = with_cap(js, ts, caps(heavy)[cap])
    ks = tbin._sorted_key_stream(tprep, ts1)
    live, j_entry, j_heavy = jax_live_keys(js1, jprep)
    np.testing.assert_array_equal(ks.sorted_packed.numpy(), live)
    assert int(ks.heavy_overflow) == j_heavy
    assert int(ks.entry_overflow) == j_entry == 0

    jes = jax.jit(lambda p: jbin.bin_entry_stream(p, js1))(jprep)
    tes = tbin.bin_entry_stream(tprep, ts1)
    assert_streams_equal(jes, tes, N, ts.n_tiles)
    assert int(tes.heavy_overflow) == int(jes.heavy_overflow) == j_heavy
    full = tbin.bin_entry_stream(tprep, ts)
    if cap == "ample":
        # the same keys as the full-width table, so the same stream
        assert j_heavy == 0
        full_keys = tbin._sorted_key_stream(tprep, ts).sorted_packed
        assert torch.equal(ks.sorted_packed, full_keys)
        for f in ("rank", "chunk_tile", "count", "astart", "order"):
            assert torch.equal(getattr(tes, f), getattr(full, f)), f
        return
    # the starved cap drops the over-cap heavy rows' cells past L: at most
    # the rect cells JAX counts, exactly those without the per-pair cull
    dropped = int(full.count.sum()) - int(tes.count.sum())
    assert dropped > 0
    assert (j_heavy == dropped) if not tight else (j_heavy >= dropped)


@pytest.mark.parametrize("cap", ["ample", "starved"])
@pytest.mark.parametrize("tight", [True, False])
def test_one_buffer_allowance_emits_the_split_tables_keys(tight, cap):
    """The rule the ``dup_count`` / ``dup_emit`` kernels are given: each
    depth-ranked row emits ``row_allowance`` cells (the split table's L /
    heavy-cap rule as one count per row) into one buffer. Through the plain
    cull it emits exactly the key set of the two-table plain path, with its
    ``heavy_overflow``, row-major in depth order; with an ample cap, the
    full-width table's keys in their order."""
    js, ts, jprep, tprep, heavy = prep_pair(tight)
    _, ts1 = with_cap(js, ts, caps(heavy)[cap])
    ks = tbin._sorted_key_stream(tprep, ts1)          # the two tables
    d_cap = ts1.max_tiles_per_gaussian
    o = ks.order
    ntt = tbin.allowed_cells(tprep, d_cap)[o]
    h_pos, heavy_overflow = tbin.heavy_rows(ntt, ts1)
    allow = tbin.row_allowance(ntt, h_pos, ts1)
    width = torch.clamp_min(tprep.rect_max[:, 0] - tprep.rect_min[:, 0], 1)
    keys = tbin._emit_keys(width[o], tprep.rect_min[o], allow,
                           tprep.mean2d[o], tprep.conic[o], tprep.q_cap[o],
                           torch.arange(N), 0, d_cap, ks.nbits, ts1)
    assert torch.equal(torch.sort(keys).values, ks.sorted_packed)
    assert int(heavy_overflow) == int(ks.heavy_overflow)
    rank = keys & ((1 << ks.nbits) - 1)
    assert bool((rank[1:] >= rank[:-1]).all())
    cut = int((allow < ntt).sum())
    if cap == "ample":
        assert cut == 0 and int(heavy_overflow) == 0
        full, _ = tbin.dup_keys_plain(tprep, o, ks.nbits, ts)
        assert torch.equal(keys, full)
    else:
        assert cut > 0 and int(heavy_overflow) > 0
    assert tbin.row_allowance(ntt, None, ts1) is ntt


@pytest.mark.parametrize("cap", ["ample", "starved"])
def test_window_bins_match_jax_split(cap):
    js, ts, jprep, tprep, heavy = prep_pair(True)
    js1, ts1 = with_cap(js, ts, caps(heavy)[cap], max_total_entries=None)
    jb = jax.jit(lambda p: jbin.bin_gaussians(p, js1))(jprep)
    tb = tbin.bin_gaussians(tprep, ts1)
    full = tbin.bin_gaussians(tprep, ts)
    for f in ("delta", "count", "full_count"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    jrank = np.asarray(jb.rank)
    live = (np.arange(jrank.shape[1])[None, :]
            < np.asarray(jb.count)[:, None])
    np.testing.assert_array_equal(tb.rank.numpy()[live], jrank[live])
    assert int(tb.heavy_overflow) == int(jb.heavy_overflow)
    if cap == "ample":
        assert int(tb.heavy_overflow) == 0
        assert torch.equal(tb.full_count, full.full_count)
        assert torch.equal(tb.rank[torch.as_tensor(live)],
                           full.rank[torch.as_tensor(live)])
    else:
        assert int(tb.heavy_overflow) > 0
        assert int(tb.full_count.sum()) < int(full.full_count.sum())


@pytest.mark.parametrize("full_sort_below", [64_000_000, 0])
def test_entry_cap_reports_without_dropping(full_sort_below):
    """``max_total_entries`` below the live total on the split branch: the
    sorted keys keep every entry (the full-width table's compaction would
    drop the farthest; this branch's keys are not in depth order), the
    overflow is JAX's, and the stream's capacity then cuts tile tails as
    JAX's does."""
    js, ts, jprep, tprep, heavy = prep_pair(True)
    uncapped = tbin._sorted_key_stream(
        tprep, dataclasses.replace(ts, heavy_rows_cap=caps(heavy)["ample"]))
    cap = uncapped.sorted_packed.numel() // 2
    js1, ts1 = with_cap(js, ts, caps(heavy)["ample"], max_total_entries=cap,
                        full_sort_below=full_sort_below)
    ks = tbin._sorted_key_stream(tprep, ts1)
    assert torch.equal(ks.sorted_packed, uncapped.sorted_packed)
    live, j_entry, _ = jax_live_keys(js1, jprep)
    np.testing.assert_array_equal(ks.sorted_packed.numpy(), live)
    assert int(ks.entry_overflow) == j_entry == live.size - cap > 0
    jes = jax.jit(lambda p: jbin.bin_entry_stream(p, js1))(jprep)
    tes = tbin.bin_entry_stream(tprep, ts1)
    assert tes.rank.numel() == np.asarray(jes.rank).size
    assert_streams_equal(jes, tes, N, ts.n_tiles)


@pytest.mark.parametrize("entry_stream", [True, False])
def test_rasterize_with_starved_cap_matches_jax(entry_stream):
    """The image and the gradients by means, opacities and colours with a
    starved heavy cap, against JAX's ``backend="pallas"`` on the same
    branch (its kernels in interpret mode); the counters equal."""
    rng = np.random.default_rng(11)
    js, ts = settings_pair(
        image_height=64, image_width=96, sh_degree=0, max_per_tile=512,
        max_tiles_per_gaussian=16, light_dup_width=2, heavy_rows_cap=128,
        entry_stream=entry_stream,
        max_total_entries=48_000 if entry_stream else None)
    means, scales, rots, ops, colors = make_scene(800, rng)
    kw = raster_kwargs(js, scales, rots, bg=np.array([0.2, 0.3, 0.1],
                                                     np.float32))
    h, w = ts.image_height, ts.image_width
    weight = np.cos(np.arange(3 * h * w).reshape(3, h, w) * 0.01).astype(
        np.float32)

    def jloss(m, o, c):
        img, _, aux = jax_rasterize(m, o, js, backend="pallas",
                                    **to_jax(dict(kw, colors_precomp=c)))
        return jnp.sum(img * weight), (img, aux)

    (_, (jimg, jaux)), jgrad = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(means, ops, colors)
    leaves = [torch.tensor(x, requires_grad=True) for x in (means, ops,
                                                             colors)]
    img, _, aux = rasterize(leaves[0], leaves[1], ts, device="cpu",
                            **dict(kw, colors_precomp=leaves[2]))
    assert int(aux.heavy_overflow) == int(jaux.heavy_overflow) > 0
    assert int(aux.heavy_rows) == int(jaux.heavy_rows)
    assert int(aux.entry_overflow) == int(jaux.entry_overflow) == 0
    np.testing.assert_array_equal(aux.n_contrib_tiles.numpy(),
                                  np.asarray(jaux.n_contrib_tiles))
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg),
                               atol=ATOL, rtol=0)
    got = torch.autograd.grad((img * torch.as_tensor(weight)).sum(), leaves)
    for name, g, wv in zip(("means", "opacities", "colors"), got, jgrad):
        assert float(np.abs(np.asarray(wv)).max()) > 0, name
        assert_grads_close(g.numpy(), np.asarray(wv), rtol=RTOL)


def test_trainer_regrows_a_starved_heavy_cap(scene_dir):  # noqa: F811
    """A heavy cap below the scene's heavy rows: the first log point sees
    ``heavy_overflow`` and regrows the cap with the JAX package's rule and
    warning; the next iterations bin through the regrown table."""
    data = readers.load_scene(scene_dir, eval_mode=False)
    bundle = scene_setup.build_scene(data, device="cpu", **BUILD)
    old = 16
    settings = dataclasses.replace(bundle.settings, light_dup_width=1,
                                   heavy_rows_cap=old)
    bundle = dataclasses.replace(bundle, settings=settings)
    # the live heavy rows of each train view at the start
    heavy_rows = []
    for f in range(len(data.images)):
        with torch.no_grad():
            out = render_mod.render(
                bundle.params, bundle.meta, settings, bundle.poses.pose(f),
                torch.zeros(3), float(data.fovx[f]), float(data.fovy[f]),
                device="cpu")
        heavy_rows.append(int(out.aux.heavy_rows))
    assert min(heavy_rows) > old
    msgs = []
    res = trainer.train_scene(bundle, OptimizationConfig(
        iterations=2, psnr_threshold=15.0), log_every=1,
        progress=lambda *_: None, warn=msgs.append, device="cpu")
    grown = [m for m in msgs if "regrow heavy_rows_cap" in m]
    assert grown and "heavy-row overflow" in grown[0], msgs
    new = res.final_settings.heavy_rows_cap
    assert f"heavy_rows_cap {old} -> {new} " in grown[0]
    # the JAX rule (das3r_tpu/train/trainer.py), from the chunk's peak
    # heavy-row count: the same cap for every count this scene can give
    want = {max(jautosize.auto_heavy_cap(hr), -(-int(old * 1.5) // 1024)
                * 1024) for hr in heavy_rows + [max(heavy_rows) * 2]}
    assert want == {new}
    assert len(grown) == 1      # the regrown table no longer overflows
