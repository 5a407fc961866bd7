"""The join of the device's idle gaps with the program's spans
(``benchmark/spans.py``): on synthetic intervals, then through each cell
at its tiny CPU size with the session around the device-only window."""
from __future__ import annotations

import pytest

from benchmark import spans
from benchmark.tests.conftest import tiny_cell
from das3r_tpu_torch.utils.trace import Span


def sp(name, start, end, parent=-1, root=0):
    return Span(name, start, end, parent, root, {})


def test_each_gap_goes_into_one_row_and_the_rows_add_up():
    # device records [10, 20], [30, 40], [55, 60], [80, 90] (and one past
    # the window) in the window [0, 100]
    device = [(10, 20), (30, 40), (55, 60), (80, 90), (120, 130)]
    program = [
        sp("das3r::train_step", 6, 95),
        sp("das3r::render", 7, 50, parent=0),
        sp("das3r::sync/stream_total", 22, 41, parent=1),
        sp("das3r::adam", 62, 78, parent=0),
    ]
    profiler = [(91, 99)]
    rows = spans.idle_rows(device, program, profiler, 0, 100)
    assert rows == {
        spans.OUTSIDE: 10,              # (0, 10): no span open at 5
        # (20, 30): the host in the sync; (40, 55): the sync ends in it
        "das3r::sync/stream_total": 25,
        "das3r::adam": 20,              # (60, 80)
        "profiler": 10,                 # (90, 100)
    }
    busy = 10 + 10 + 5 + 10
    assert sum(rows.values()) == 100 - busy


def test_the_runtime_calls_in_each_rows_gaps():
    gaps = [(0, 10, "a"), (20, 30, "b"), (40, 50, "a")]
    calls = [(5, 25, "cudaMalloc"), (41, 43, "cudaLaunchKernel"),
             (60, 70, "cudaFree"), (12, 18, "cudaMemcpyAsync")]
    assert spans.calls_by_row(gaps, calls) == {
        "a": {"cudaMalloc": 5, "cudaLaunchKernel": 2},
        "b": {"cudaMalloc": 5}}


def test_a_gap_under_no_span_and_a_window_with_no_device_work():
    assert spans.idle_rows([], [], [], 0, 50) == {spans.OUTSIDE: 50}
    assert spans.idle_rows([(0, 50)], [sp("das3r::a", 0, 50)], [], 0,
                           50) == {}
    # the first of two syncs ending in one gap takes it
    two = [sp("das3r::step", 0, 100), sp("das3r::sync/a", 5, 30, 0),
           sp("das3r::sync/b", 31, 40, 0)]
    assert spans.idle_rows([(0, 20), (60, 100)], two, [], 0, 100) == {
        "das3r::sync/a": 40}


def test_readings_divide_the_session_by_its_units():
    from das3r_tpu_torch.utils import trace
    with trace.session() as rec:
        with trace.span(spans.STEP):
            with trace.sync("x", 3):
                pass
        with trace.span(spans.STEP):
            pass
    got = spans.readings(rec, {"das3r::sync/x": 4e6, "das3r::adam": 1e6},
                         2, {"das3r::heads": 0.010})
    assert got["syncs"] == 1.5
    assert got["sync_idle_ms"] == 2.0
    assert got["heads_ms"] == pytest.approx(5.0)
    steps = [s for s in rec.spans if s.name == spans.STEP]
    wait = rec.spans[1].end_ns - rec.spans[1].start_ns
    assert got["sync_wait_ms"] == pytest.approx(wait / 1e6 / 2)
    assert got["dispatch_ms"] == pytest.approx(
        (sum(s.end_ns - s.start_ns for s in steps) - wait) / 1e6 / 2)


@pytest.mark.parametrize("workload", list(spans.METRICS))
def test_each_cell_reads_its_span_metrics(workload, spec, tiny_bench,
                                          monkeypatch):
    """At the tiny CPU size (no device records: the window is all idle)
    the session sees each cell's syncs, and the rows add up to the
    window. The host window reduces ``das3r::heads`` too; on the CPU no
    kernel runs under it, so ``heads_ms`` has nothing to read."""
    from benchmark import outcome as oc
    from benchmark.run import run_cell
    cell = tiny_cell(spec, workload, tiny_bench)
    sessions = []
    monkeypatch.setattr(oc, "traced", spans.session_traced(sessions))
    _, out, _, _ = run_cell(cell, 11, 0.1, True, "cpu", oc.Clock())
    (ses,) = sessions
    assert sum(ses.rows.values()) == ses.t1 - ses.t0 > 0
    assert ses.rec.counts("sync/")
    got = spans.readings(ses.rec, ses.rows, out.units, out.trace.spans_s)
    keys = {k for k, _ in spans.METRICS[workload].values()} - {"heads_ms"}
    assert keys <= set(got), (keys, got)
    assert "das3r::heads" in out.trace.spans_s
    assert got["syncs"] > 0 and got["sync_wait_ms"] > 0
