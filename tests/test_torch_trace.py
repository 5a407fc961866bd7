"""The port's tracing (``das3r_tpu_torch/utils/trace.py``): spans and their
nesting, sync sites and counters, the clock against the profiler's own
records, and the exact sync counts of one training step, one served view
and one stage-1 decode batch.

On the CPU the counts are the sites passed. The tests marked ``cuda``
(skipped without a card) hold the same counts against every
synchronizing operation that ``torch.cuda.set_sync_debug_mode`` reports,
and the spans against the profiler's raw records of their ranges. The
file imports neither JAX nor the JAX package; on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py -q
"""
import statistics
import threading

import numpy as np
import pytest
import torch

from das3r_tpu_torch.utils import trace

# the host's waits of one step, one view and one decode batch, by site
TRAIN_SYNCS = {"sync/identity_quat_to_device": 1,
               "sync/pose_row_to_device": 1,
               "sync/tile_grid_to_device": 1,
               "sync/emit_keys": 2,             # the split table's two
               "sync/entry_cap_to_device": 1,
               "sync/stream_total": 1}
VIEW_SYNCS = {"sync/identity_quat_to_device": 1,
              "sync/pose_row_to_device": 1,
              "sync/fov_to_device": 2,
              "sync/tile_grid_to_device": 1,
              "sync/emit_keys": 1,
              "sync/stream_total": 1}
PAIRS_SYNCS = {"sync/frames_to_device": 1, "sync/edges_to_device": 2,
               "sync/to_host": 6}


def test_spans_nest_with_parent_root_and_attrs():
    with trace.session() as rec:
        with trace.span("das3r::a", step=3):
            with trace.span("das3r::b"):
                with trace.span("das3r::c", uid=7):
                    pass
            with trace.span("das3r::d"):
                pass
        with trace.span("das3r::e"):
            pass
    names = [s.name for s in rec.spans]
    assert names == ["das3r::a", "das3r::b", "das3r::c", "das3r::d",
                     "das3r::e"]
    a, b, c, d, e = rec.spans
    assert (a.parent, a.root) == (-1, 0)
    assert (b.parent, b.root) == (0, 0)
    assert (c.parent, c.root) == (1, 0)
    assert (d.parent, d.root) == (0, 0)
    assert (e.parent, e.root) == (-1, 4)
    assert a.attrs == {"step": 3} and c.attrs == {"uid": 7}
    assert b.attrs == {}
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns
    assert b.end_ns <= d.start_ns <= d.end_ns <= a.end_ns <= e.start_ns


def test_nothing_is_recorded_outside_a_session_but_counters_count():
    before = trace.counters("sync/")
    with trace.span("das3r::outside"):
        with trace.sync("test_outside", 3):
            pass
    trace.count("test/outside")
    assert trace.counters("sync/")["sync/test_outside"] == (
        before.get("sync/test_outside", 0) + 3)
    assert trace.counters()["test/outside"] >= 1
    with trace.session() as rec:
        pass
    assert rec.spans == [] and rec.counts() == {}
    # outside a session a span is the profiler's range itself
    assert isinstance(trace.span("das3r::x"),
                      torch.profiler.record_function)


def test_sync_records_its_span_and_the_session_counts_its_change():
    with trace.session() as rec:
        with trace.span("das3r::step"):
            with trace.sync("test_site"):
                pass
            with trace.sync("test_site", 6):
                pass
        trace.count("test/thing", 2)
    assert [s.name for s in rec.spans] == [
        "das3r::step", "das3r::sync/test_site", "das3r::sync/test_site"]
    assert all(s.root == 0 and s.parent == 0 for s in rec.spans[1:])
    assert rec.counts("sync/") == {"sync/test_site": 7}
    assert rec.counts() == {"sync/test_site": 7, "test/thing": 2}
    trace.count("test/thing")          # after the session: not its own
    assert rec.counts("test/") == {"test/thing": 2}


def test_a_session_is_one_threads_and_does_not_nest():
    seen = []

    def other():
        with trace.span("das3r::other_thread"):
            with trace.sync("test_other_thread"):
                seen.append(True)

    with trace.session() as rec:
        with pytest.raises(RuntimeError, match="already open"):
            with trace.session():
                pass
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert seen == [True] and rec.spans == []
    assert rec.counts() == {"sync/test_other_thread": 1}


def test_an_exception_closes_its_spans_and_the_session():
    with pytest.raises(ValueError):
        with trace.session() as rec:
            with trace.span("das3r::outer"):
                with trace.span("das3r::inner"):
                    raise ValueError("boom")
    assert [s.name for s in rec.spans] == ["das3r::outer", "das3r::inner"]
    assert all(s.end_ns >= s.start_ns for s in rec.spans)
    with trace.session():              # the next session opens
        pass


def test_spans_are_on_the_profilers_clock():
    """Each span's start against the raw kineto start of its own range:
    the median offset over 50 spans under 2 ms."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.session() as rec:
            for i in range(50):
                with trace.span(f"das3r::clock_{i}"):
                    x = x * 1.0001
    raw = {e.name(): e.start_ns()
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("das3r::clock_")}
    assert len(raw) == 50 == len(rec.spans)
    offsets = [abs(s.start_ns - raw[s.name]) for s in rec.spans]
    assert statistics.median(offsets) < 2e6, offsets


def tiny_scene():
    from das3r_tpu_torch.data.synthetic import random_gaussian_scene
    params, meta, poses = random_gaussian_scene(
        1500, n_frames=2, height=32, width=48, seed=0, sh_degree=0,
        device="cpu")
    return params, meta, poses


def test_one_train_step_counts_its_syncs_and_spans():
    from das3r_tpu_torch.ops.splat import RasterSettings
    from das3r_tpu_torch.train import step as step_mod
    from das3r_tpu_torch.train.config import OptimizationConfig
    params, meta, poses = tiny_scene()
    # the train cell's form: a probed entry cap and the split table
    s = RasterSettings(image_height=32, image_width=48, sh_degree=0,
                       max_per_tile=256, max_tiles_per_gaussian=8,
                       max_total_entries=1 << 16, light_dup_width=2,
                       heavy_rows_cap=1024)
    state = step_mod.init_train_state(params, poses)
    gt = torch.rand(2, 3, 32, 48, generator=torch.Generator().manual_seed(0))
    fov = torch.full((2,), 1.0)
    with trace.session() as rec:
        step_mod.train_step(state, meta, 1, gt[1], fov[1], fov[1],
                            torch.zeros(3), s, OptimizationConfig(),
                            track_stats=True)
    assert rec.counts("sync/") == TRAIN_SYNCS
    assert rec.counts("launch/") == {}          # the plain versions
    step_span = rec.spans[0]
    assert (step_span.name, step_span.attrs) == (
        "das3r::train_step", {"step": 1, "uid": 1})
    assert all(sp.root == 0 for sp in rec.spans)
    names = [sp.name for sp in rec.spans]
    for stage in ("das3r::render", "das3r::preprocess",
                  "das3r::bin_entry_stream", "das3r::blend",
                  "das3r::assemble", "das3r::loss", "das3r::adam"):
        assert names.count(stage) == 1, stage
    syncs = [n[len("das3r::"):] for n in names if n.startswith("das3r::sync/")]
    assert sorted(set(syncs)) == sorted(TRAIN_SYNCS)
    by_id = dict(enumerate(names))
    bin_id = names.index("das3r::bin_entry_stream")
    assert [by_id[sp.parent] for sp in rec.spans
            if sp.name == "das3r::sync/emit_keys"] == [by_id[bin_id]] * 2


def test_one_served_view_counts_its_syncs():
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.ops.splat import RasterSettings
    params, meta, poses = tiny_scene()
    s = RasterSettings(image_height=32, image_width=48, sh_degree=0,
                       max_per_tile=1024, max_tiles_per_gaussian=32)
    conf = torch.rand(params.xyz.shape[0],
                      generator=torch.Generator().manual_seed(1))
    with trace.session() as rec, torch.no_grad():
        out = render_mod.render(params, meta, s, poses.pose(0),
                                torch.zeros(3), 1.0, 0.8, mode="test",
                                conf_per_gaussian=conf, device="cpu")
    assert out.image.shape == (3, 32, 48)
    assert rec.counts("sync/") == VIEW_SYNCS
    assert rec.spans[0].name == "das3r::render"
    assert all(sp.root == 0 for sp in rec.spans)


def test_one_decode_batch_counts_its_syncs_and_spans():
    from das3r_tpu_torch.models.croco.convert import load_reference_state_dict
    from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
    from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                      random_torch_state_dict)
    from das3r_tpu_torch.predictor import inference
    model = AsymmetricCroCo3D(TINY)
    load_reference_state_dict(model, random_torch_state_dict(
        TINY, np.random.default_rng(0)))
    model.eval()
    images = np.random.default_rng(1).uniform(
        0, 1, (4, 3, 32, 48)).astype(np.float32)
    edges = [(i, j) for i in range(4) for j in range(4) if i != j][:8]
    with trace.session() as rec:
        got = inference.run_pairs(model, images, edges, encode_batch=4,
                                  decode_batch=8)
    assert got.pred_i.shape == (8, 32, 48, 3)
    assert rec.counts("sync/") == PAIRS_SYNCS
    names = [sp.name for sp in rec.spans]
    assert names[0] == "das3r::run_pairs"
    assert rec.spans[0].attrs == {"frames": 4, "pairs": 8}
    assert (names.count("das3r::encode"), names.count("das3r::decode"),
            names.count("das3r::heads"),
            names.count("das3r::sync/to_host")) == (1, 1, 1, 1)
    heads = rec.spans[names.index("das3r::heads")]
    assert names[heads.parent] == "das3r::decode"


def test_each_kernel_launch_counts_under_its_name(monkeypatch):
    """``kernels.launch`` counts ``launch/<name>`` once a launch is made,
    as each wrapper's ``.launches`` counted its own; a refused launch
    raises and counts nothing."""
    from das3r_tpu_torch.ops.splat import kernels

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    codes = {"blend_forward": 0, "extract_chunks": 0, "blend_backward": 9}
    for name, code in codes.items():
        monkeypatch.setitem(kernels._launchers, name,
                            lambda *a, code=code: code)
    with trace.session() as rec:
        kernels.launch("blend_forward", 1, 2)
        kernels.launch("blend_forward", 1, 2)
        kernels.launch("extract_chunks", 3)
        with pytest.raises(RuntimeError, match="cudaError 9"):
            kernels.launch("blend_backward")
    assert rec.counts("launch/") == {"launch/blend_forward": 2,
                                     "launch/extract_chunks": 1}


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the host waits only for a card")
    return torch.device("cuda")


def card_scene(cuda, n=20000):
    from das3r_tpu_torch.data.synthetic import random_gaussian_scene
    return random_gaussian_scene(n, n_frames=2, height=96, width=128,
                                 seed=0, sh_degree=0, device=cuda)


def waits(fn):
    """(fn(), the sync warnings it raised, as "file:line" of the Python
    line that made each wait)."""
    import warnings
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in got
             if "synchronizing CUDA operation" in str(w.message)]
    return out, where


@pytest.mark.cuda
def test_every_wait_of_a_step_a_view_and_a_decode_batch_is_counted(cuda):
    """One ``train_step``, one served view with its image copied to the
    host, and one decode batch: every synchronizing operation that the
    card reports is a counted ``sync/<site>``, and the kernels' launches
    are the step's and the view's."""
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.models.croco.convert import load_reference_state_dict
    from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
    from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                      random_torch_state_dict)
    from das3r_tpu_torch.ops.splat import RasterSettings
    from das3r_tpu_torch.predictor import inference
    from das3r_tpu_torch.train import step as step_mod
    from das3r_tpu_torch.train.config import OptimizationConfig
    params, meta, poses = card_scene(cuda)
    s = RasterSettings(image_height=96, image_width=128, sh_degree=0,
                       max_per_tile=1024, max_tiles_per_gaussian=8,
                       max_total_entries=1 << 20, light_dup_width=2,
                       heavy_rows_cap=8192)
    state = step_mod.init_train_state(params, poses)
    gt = torch.rand(2, 3, 96, 128, device=cuda)
    fov = torch.full((2,), 1.0, device=cuda)
    bg = torch.zeros(3, device=cuda)

    def step(uid):
        return step_mod.train_step(state, meta, uid, gt[uid], fov[uid],
                                   fov[uid], bg, s, OptimizationConfig(),
                                   track_stats=True)
    step(0)
    torch.cuda.synchronize()
    with trace.session() as rec:
        _, where = waits(lambda: step(1))
    assert rec.counts("sync/") == TRAIN_SYNCS, where
    assert len(where) == sum(TRAIN_SYNCS.values()), where
    assert rec.counts("launch/") == {"launch/extract_chunks": 1,
                                     "launch/blend_forward": 1,
                                     "launch/blend_backward": 1}

    served = RasterSettings(image_height=96, image_width=128, sh_degree=0,
                            max_per_tile=1024, max_tiles_per_gaussian=32)
    conf = torch.rand(params.xyz.shape[0], device=cuda)

    def view():
        with torch.no_grad():
            out = render_mod.render(params, meta, served, poses.pose(0), bg,
                                    1.0, 0.8, mode="test",
                                    conf_per_gaussian=conf, device=cuda)
        with trace.sync("image_to_host"):
            return out.image.cpu()
    view()
    torch.cuda.synchronize()
    with trace.session() as rec:
        _, where = waits(view)
    assert rec.counts("sync/") == {**VIEW_SYNCS, "sync/image_to_host": 1}
    assert len(where) == sum(VIEW_SYNCS.values()) + 1, where
    assert rec.counts("launch/") == {"launch/extract_chunks": 1,
                                     "launch/blend_forward": 1}

    model = AsymmetricCroCo3D(TINY)
    load_reference_state_dict(model, random_torch_state_dict(
        TINY, np.random.default_rng(0)))
    model.to(cuda).eval()
    images = np.random.default_rng(1).uniform(
        0, 1, (4, 3, 32, 48)).astype(np.float32)
    edges = [(i, j) for i in range(4) for j in range(4) if i != j][:8]
    inference.run_pairs(model, images, edges)
    torch.cuda.synchronize()
    with trace.session() as rec:
        _, where = waits(lambda: inference.run_pairs(model, images, edges))
    assert rec.counts("sync/") == PAIRS_SYNCS, where
    assert len(where) == sum(PAIRS_SYNCS.values()), where
    assert rec.counts("launch/") == {}


@pytest.mark.cuda
def test_spans_start_with_their_ranges_raw_records(cuda):
    """In a host-and-device profiler session over a warm ``train_step``,
    each span starts and ends within 50 us of its range's raw kineto
    record."""
    from torch.profiler import ProfilerActivity, profile

    from das3r_tpu_torch.ops.splat import RasterSettings
    from das3r_tpu_torch.train import step as step_mod
    from das3r_tpu_torch.train.config import OptimizationConfig
    params, meta, poses = card_scene(cuda)
    s = RasterSettings(image_height=96, image_width=128, sh_degree=0,
                       max_per_tile=1024, max_tiles_per_gaussian=8)
    state = step_mod.init_train_state(params, poses)
    gt = torch.rand(2, 3, 96, 128, device=cuda)
    fov = torch.full((2,), 1.0, device=cuda)
    bg = torch.zeros(3, device=cuda)

    def step(uid):
        step_mod.train_step(state, meta, uid, gt[uid], fov[uid], fov[uid],
                            bg, s, OptimizationConfig())
    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.session() as rec:
            for uid in (1, 0, 1):
                step(uid)
        torch.cuda.synchronize()
    raw = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CPU" and e.name().startswith("das3r::"):
            raw.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    seen = {}
    gaps = []
    for sp in rec.spans:
        k = seen.get(sp.name, 0)
        seen[sp.name] = k + 1
        start, end = sorted(raw[sp.name])[k]
        gaps.append((max(abs(sp.start_ns - start), abs(sp.end_ns - end)),
                     sp.name))
    assert len(gaps) >= 3 * 12
    assert max(gaps)[0] < 50_000, sorted(gaps)[-5:]
