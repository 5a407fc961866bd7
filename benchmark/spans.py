#!/usr/bin/env python3
"""The program's own spans and sync counters (``das3r_tpu_torch/utils/
trace.py``) joined with the device's idle gaps of a traced run's
device-only window, and a runner that reads them for one cell.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell as ``run.py --trace 1`` does, with a ``trace.session()``
open around the device-only window of ``outcome.traced`` and nothing
else, so the gaps between the device's records and the program's spans
share one clock and the window carries no host-side profiler cost. It
prints the result line with the cell's span metrics (``METRICS``) added
to its per-layer metrics, and before it, on standard error, one JSON line
that splits the window's idle time into rows, each with the CUDA runtime
calls the host was in during its gaps.

Every gap between device records (and the window's edges) goes into one
row: ``das3r::sync/<site>`` when a sync span of that site ends in it (the
first: the queue that sync drained refills), else ``profiler`` when its
midpoint lies in one of the profiler's own host records, else the
innermost program span open at its midpoint (a sync span too: the host
waits there, as in a copy from pageable memory, which drains the queue
before it starts), else ``outside the program``. So the rows add up to the
idle time, and the sync rows are the idle that the syncs leave.

The runner replaces ``outcome.traced`` in its own process only; ``run.py``
never imports this file.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time

# the profiler's own host records in a device-only session
PROFILER = ("Activity Buffer Request", "Buffer Flush")
SYNC = "das3r::sync/"
OUTSIDE = "outside the program"
STEP = "das3r::train_step"
TO_HOST = SYNC + "to_host"
# program ranges whose device time the host window's reduction adds
EXTRA_SPANS = ("das3r::heads",)
# per-layer metrics read here, by cell: name -> (reading, unit)
METRICS = {
    "davis50_1p5m.train": {
        "syncs_per_step.train": ("syncs", "syncs/step"),
        "sync_wait_ms.train": ("sync_wait_ms", "ms"),
        "sync_idle_ms.train": ("sync_idle_ms", "ms"),
        "dispatch_ms.train": ("dispatch_ms", "ms"),
    },
    "davis50_1p5m.orbit_render": {
        "syncs_per_view.render": ("syncs", "syncs/view"),
        "sync_wait_ms.render": ("sync_wait_ms", "ms"),
        "sync_idle_ms.render": ("sync_idle_ms", "ms"),
    },
    "dust3r_large.video_pairs": {
        "sync_wait_ms.stage1": ("to_host_wait_ms", "ms"),
        "sync_idle_ms.stage1": ("sync_idle_ms", "ms"),
        "heads_ms.stage1": ("heads_ms", "ms"),
    },
}


def _innermost(spans) -> tuple[list, list]:
    """(times, span index or -1): the innermost span open from each time
    on. Spans of one thread nest, so a stack holds them."""
    marks = []
    for i, s in enumerate(spans):
        marks.append((s.start_ns, 1, i))
        marks.append((s.end_ns, 0, i))
    marks.sort()
    times, owner, stack = [], [], []
    for t, opening, i in marks:
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        times.append(t)
        owner.append(stack[-1] if stack else -1)
    return times, owner


def gap_rows(device, spans, profiler, t0: int, t1: int) -> list:
    """[(start, end, row)] of the idle gaps of the window [t0, t1] (ns on
    one clock): ``device`` the device records' (start, end), ``spans`` the
    session's ``trace.Span``s, ``profiler`` the profiler's own host
    records' (start, end). Rows as the module docstring says."""
    iv = sorted((max(s, t0), min(e, t1)) for s, e in device
                if e > t0 and s < t1)
    gaps, cur = [], t0
    for s, e in iv:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    ends = sorted((s.end_ns, s.name) for s in spans
                  if s.name.startswith(SYNC))
    end_t = [t for t, _ in ends]
    prof = sorted(profiler)
    prof_s = [s for s, _ in prof]
    times, owner = _innermost(spans)
    out = []
    for a, b in gaps:
        k = bisect.bisect_right(end_t, a)
        if k < len(ends) and ends[k][0] <= b:
            out.append((a, b, ends[k][1]))
            continue
        mid = (a + b) / 2
        j = bisect.bisect_right(prof_s, mid) - 1
        if j >= 0 and prof[j][1] >= mid:
            out.append((a, b, "profiler"))
            continue
        j = bisect.bisect_right(times, mid) - 1
        i = owner[j] if j >= 0 else -1
        out.append((a, b, spans[i].name if i >= 0 else OUTSIDE))
    return out


def idle_rows(device, spans, profiler, t0: int, t1: int) -> dict:
    """{row: idle ns} of the window (``gap_rows``)."""
    rows = collections.Counter()
    for a, b, row in gap_rows(device, spans, profiler, t0, t1):
        rows[row] += b - a
    return dict(rows)


def calls_by_row(gaps: list, calls) -> dict:
    """{row: {call: ns}}: how long each of the CUDA runtime's host records
    ``calls`` ((start, end, name)) overlaps each row's ``gap_rows``: what
    the host was calling while the device waited."""
    starts = [a for a, _, _ in gaps]
    out: dict = collections.defaultdict(collections.Counter)
    for s, e, name in calls:
        j = bisect.bisect_right(starts, e) - 1
        while j >= 0 and gaps[j][1] > s:
            a, b, row = gaps[j]
            out[row][name] += max(0, min(b, e) - max(a, s))
            j -= 1
    return {row: dict(c) for row, c in out.items()}


def readings(rec, rows: dict, units: int, spans_s: dict) -> dict:
    """The span metrics' readings a unit (a step, a view or a pair) from
    the session's recorder, its idle rows and the host window's device
    seconds under each range (``trace.Trace.spans_s``)."""
    sync_ns = sum(s.end_ns - s.start_ns for s in rec.spans
                  if s.name.startswith(SYNC))
    in_step = sum(s.end_ns - s.start_ns for s in rec.spans
                  if s.name.startswith(SYNC)
                  and rec.spans[s.root].name == STEP)
    step_ns = sum(s.end_ns - s.start_ns for s in rec.spans
                  if s.name == STEP)
    to_host = sum(s.end_ns - s.start_ns for s in rec.spans
                  if s.name == TO_HOST)
    out = {
        "syncs": sum(rec.counts("sync/").values()) / units,
        "sync_wait_ms": sync_ns / 1e6 / units,
        "sync_idle_ms": sum(v for k, v in rows.items()
                            if k.startswith(SYNC)) / 1e6 / units,
        "to_host_wait_ms": to_host / 1e6 / units,
    }
    if step_ns:
        out["dispatch_ms"] = (step_ns - in_step) / 1e6 / units
    if spans_s.get("das3r::heads"):
        out["heads_ms"] = spans_s["das3r::heads"] * 1e3 / units
    return out


class Session:
    """What a traced window left: its recorder, its ends (ns), its idle
    rows and their sum, and the count of its device records."""

    def __init__(self, rec, prof, t0: int, t1: int):
        from torch.autograd import DeviceType

        from benchmark.trace import RANGES
        device, own, calls = [], [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                if (e.end_ns() > e.start_ns()
                        and not e.name().startswith(RANGES)):
                    device.append((e.start_ns(), e.end_ns()))
            elif e.name() in PROFILER:
                own.append((e.start_ns(), e.end_ns()))
            else:
                calls.append((e.start_ns(), e.end_ns(), e.name()))
        self.rec, self.t0, self.t1 = rec, t0, t1
        gaps = gap_rows(device, rec.spans, own, t0, t1)
        self.rows = collections.Counter()
        for a, b, row in gaps:
            self.rows[row] += b - a
        self.calls = calls_by_row(gaps, calls)
        self.records = len(device)
        self.idle_ns = sum(self.rows.values())


def session_traced(sessions: list):
    """``outcome.traced`` with a ``trace.session()`` around the window of
    its device-only session, whose ``Session`` it appends to ``sessions``,
    and ``EXTRA_SPANS`` added to the host window's spans."""
    from benchmark import outcome as oc
    from benchmark import trace as trace_mod
    from das3r_tpu_torch.utils import trace

    def traced(dev, unit, stages=(), spans=()):
        spans = tuple(spans) + tuple(s for s in EXTRA_SPANS
                                     if s not in spans)
        got, reduced = [], []
        for host in (False, True):
            oc.sync(dev)
            with oc.profiler(dev, host) as prof:
                with (contextlib.nullcontext() if host
                      else trace.session()) as rec:
                    t0, t0_ns = time.perf_counter(), time.time_ns()
                    got.append(unit())
                    oc.sync(dev)
                    window_s = time.perf_counter() - t0
                    t1_ns = time.time_ns()
            if not host:
                sessions.append(Session(rec, prof, t0_ns, t1_ns))
            reduced.append(trace_mod.reduce(prof, window_s, stages, spans))
        return trace_mod.merge(*reduced), got
    return traced


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    from benchmark import run as run_mod
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark import outcome as oc
    from benchmark import trace as trace_mod
    torch.set_num_threads(1)
    cell = harness.Cell(harness.load_json(run_mod.ROOT / "BENCHMARK.json"),
                        args.workload)
    dev = run_mod.require_cards(cell.workload["chips"])
    sessions = []
    oc.traced = session_traced(sessions)
    correct, out, metrics, checks = run_mod.run_cell(
        cell, args.seed, args.seconds, True, dev, oc.Clock(run_mod.T_START))
    ses = sessions[-1]
    got = readings(ses.rec, ses.rows, out.units, out.trace.spans_s)
    for name, (key, unit) in METRICS.get(cell.name, {}).items():
        if key in got:
            metrics[name] = {"value": float(got[key]), "unit": unit}
    window_ns = ses.t1 - ses.t0
    print(json.dumps({"idle_split": {
        "window_ms": window_ns / 1e6,
        "busy_ms": (window_ns - ses.idle_ns) / 1e6,
        "idle_ms": ses.idle_ns / 1e6,
        "run_idle_ms": (out.trace.window_s - out.trace.busy_s) * 1e3,
        "units": out.units, "device_records": ses.records,
        "syncs": ses.rec.counts("sync/"),
        "rows_ms": {k: v / 1e6 for k, v in sorted(
            ses.rows.items(), key=lambda kv: -kv[1])},
        "calls_ms": {row: {k: v / 1e6 for k, v in sorted(
            c.items(), key=lambda kv: -kv[1])[:3]}
            for row, c in ses.calls.items()}}}), file=sys.stderr)
    line = harness.result_line(
        correct, out.attempted, out.failed, metrics,
        run_mod.device_info(dev, cell.workload["chips"],
                            out.memory_peak_bytes, out.trace),
        checks, breakdown=trace_mod.breakdown(out.trace))
    print(harness.checks_text(checks), file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark import run as run_mod
    print(f"benchmark: pinned to core {run_mod.pin_to_one_core()}",
          file=sys.stderr)
    sys.exit(main())
