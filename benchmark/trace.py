"""Reductions of one ``torch.profiler`` session over a traced window:
the device's busy time, its idle gaps and what the host was doing in
them, device time by operation, by kernel and by the program's
``das3r::`` stage. The per-layer metric readers read a ``Trace``.

A stage's device time follows chip_smoke.py's ``stage_times``: a forward
operator belongs to the innermost listed ``das3r::`` range around it; a
backward operator (run by the autograd engine) belongs to the stage of
the forward operator with the same autograd sequence number.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

BACKWARD = "autograd::engine::evaluate_function"
# named ranges (the program's and the benchmark's), not device work
RANGES = ("das3r::", "bench::")


class Trace(NamedTuple):
    window_s: float             # host clock over the traced window
    busy_s: float               # union of device operations
    device_ops: list            # [(name, seconds)] by total time, all
    idle_gaps: list             # [(what the host was doing, seconds)]
    kernel_s: dict              # device seconds by operation name
    launches: int               # device records (kernels, copies, fills)
    stage_s: dict               # {stage: {"forward": s, "backward": s}}
    spans_s: dict               # device seconds under each named range


def _is_device(e) -> bool:
    from torch.autograd import DeviceType
    return e.device_type == DeviceType.CUDA


def union(intervals) -> tuple[float, list]:
    """(covered length, [(end, next start)] of the gaps between) of
    (start, end) intervals, in their unit."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def device_busy(prof) -> tuple[float, int]:
    """(seconds, records) of one profiler session's device operations,
    from its raw records: the union of their intervals, as ``reduce``
    takes it, and their count. It builds no event tree, so it is cheap
    enough for a whole measured window."""
    from torch.autograd import DeviceType
    iv = [(e.start_ns(), e.end_ns())
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA and e.end_ns() > e.start_ns()
          and not e.name().startswith(RANGES)]
    return union(iv)[0] / 1e9, len(iv)


def reduce(prof, window_s: float, stages=(), spans=()) -> Trace:
    """``stages``: ``das3r::`` range names whose forward and backward
    device time is wanted; ``spans``: range names (the benchmark's own or
    the program's) whose enclosed device time is wanted."""
    events = prof.events()
    dev = [e for e in events if _is_device(e)
           and not e.name.startswith(RANGES)
           and e.time_range.end > e.time_range.start]
    busy_us, gaps = union([(e.time_range.start, e.time_range.end)
                           for e in dev])
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    host = [e for e in events if not _is_device(e)]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [(_host_at(host, (a + b) / 2), (b - a) / 1e6)
            for a, b in gaps[:10]]
    return Trace(
        window_s=window_s, busy_s=busy_us / 1e6,
        device_ops=by_name.most_common(), idle_gaps=idle,
        kernel_s=dict(by_name), launches=len(dev),
        stage_s=_stage_times(events, stages),
        spans_s=_span_device(events, spans))


def _host_at(host, t_us: float) -> str:
    """The innermost named range or operator on the host spanning t."""
    best, width = "host", float("inf")
    for e in host:
        s, end = e.time_range.start, e.time_range.end
        if s <= t_us <= end and end - s < width and not e.name.startswith(
                ("cuda", "cu", "aten::empty", "[memory]")):
            best, width = e.name, end - s
    return best[:100]


def _kernels_us(e) -> float:
    return sum(k.duration for k in e.kernels
               if not k.name.startswith(RANGES))


def _stage_times(events, stages) -> dict:
    stages = tuple(stages)

    def owner(e):
        rng = ev = None
        while e is not None:
            if rng is None and e.name in stages:
                rng = e.name
            if e.name.startswith(BACKWARD):
                ev = e
            e = e.cpu_parent
        return rng, ev

    seq = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            rng, ev = owner(e)
            if ev is None and rng is not None:
                seq.setdefault(e.sequence_nr, rng)
    out = {s: {"forward": 0.0, "backward": 0.0} for s in stages}
    for e in events:
        if _is_device(e) or not e.kernels:
            continue
        rng, ev = owner(e)
        key = "forward"
        if ev is not None:
            key, rng = "backward", seq.get(ev.sequence_nr)
        if rng is not None:
            out[rng][key] += _kernels_us(e) / 1e6
    return out


def _span_device(events, spans) -> dict:
    """Device seconds of the kernels launched under each named range."""
    names = set(spans)
    out = {n: 0.0 for n in spans}
    for e in events:
        if _is_device(e) or not e.kernels:
            continue
        p, seen = e, set()
        while p is not None:
            if p.name in names and p.name not in seen:
                out[p.name] += _kernels_us(e) / 1e6
                seen.add(p.name)
            p = p.cpu_parent
    return out


def merge(device: Trace, full: Trace) -> Trace:
    """The device-only window's busy time, window, operations and
    launches with the full window's stages, spans and idle gaps; the
    full window alone where the device-only one recorded nothing."""
    if device.launches == 0:
        return full
    return full._replace(window_s=device.window_s, busy_s=device.busy_s,
                         device_ops=device.device_ops,
                         kernel_s=device.kernel_s, launches=device.launches)


def device_s(trace: Trace, substring: str) -> float:
    """Device seconds of the operations whose name contains
    ``substring``."""
    return sum(v for k, v in trace.kernel_s.items() if substring in k)


def breakdown(trace: Trace) -> dict:
    return {"device_ops": [[n, s] for n, s in trace.device_ops[:10]],
            "idle_gaps": [[n, s] for n, s in trace.idle_gaps[:10]]}
