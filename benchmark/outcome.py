"""What a driver hands back to ``run.py`` from one run of a cell."""
from __future__ import annotations

import contextlib
import dataclasses
import time


@dataclasses.dataclass
class Outcome:
    e2e: dict                  # end-to-end metric name -> value
    attempted: int             # steps, views or pairs sent in the window
    failed: int                # of those, the ones whose guard failed
    checks: dict               # compared number name -> value
    memory_peak_bytes: int
    trace: object = None       # trace.Trace of a traced run
    work: dict = dataclasses.field(default_factory=dict)   # frozen counts
    units: int = 0             # steps, views or pairs in the traced window


class Clock:
    """Seconds since the process started (``run.py`` sets ``t0`` first
    thing), on the host clock."""

    def __init__(self, t0: float | None = None):
        self.t0 = time.perf_counter() if t0 is None else t0

    def now(self) -> float:
        return time.perf_counter() - self.t0


def sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(torch.device(dev))


def peak_bytes(dev) -> int:
    import torch
    if torch.device(dev).type == "cuda":
        return int(torch.cuda.max_memory_allocated(torch.device(dev)))
    return 0


def free(dev) -> None:
    import gc

    import torch
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def profiler(dev, host: bool = True):
    from torch.profiler import ProfilerActivity, profile
    if not str(dev).startswith("cuda"):
        return profile(activities=[ProfilerActivity.CPU])
    acts = [ProfilerActivity.CPU] if host else []
    acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


@contextlib.contextmanager
def device_records(dev, on: bool = True):
    """A profiler session over the block that keeps the device's records
    alone (read them once the block has closed); None where ``on`` is
    false or ``dev`` is not a card."""
    if not on or not str(dev).startswith("cuda"):
        yield None
        return
    with profiler(dev, host=False) as prof:
        yield prof


def traced(dev, unit, stages=(), spans=()):
    """A traced run's two windows, one ``unit()`` each (an epoch, an
    orbit, a clip): the first records the device alone, so that the
    busy time, idle share and kernel times carry no host-side profiler
    cost; the second records the host too, for the program's stages,
    the benchmark's spans and what the host did in the idle gaps.
    Returns (trace.Trace, what each unit returned)."""
    from benchmark import trace as trace_mod
    got, reduced = [], []
    for host in (False, True):
        sync(dev)
        with profiler(dev, host) as prof:
            t0 = time.perf_counter()
            got.append(unit())
            sync(dev)
            window_s = time.perf_counter() - t0
        reduced.append(trace_mod.reduce(prof, window_s, stages, spans))
    return trace_mod.merge(*reduced), got


def reference_precision(tf32: bool = False) -> None:
    """Matrix products of the reference in full float32 (or TF32, the
    stage-1 control)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
