"""The port's tracing: named spans, the places where the host waits for
the device, and counters.

Three entry points:

* ``span(name, **attrs)``: a context manager around a stage of the
  program. It always enters ``torch.profiler.record_function(name)``, so
  a profiler session sees the range. Inside an open ``session()`` it also
  records a ``Span``: its name, start and end on the profiler's clock, the
  id of the span it is nested in, the id of the outermost open span (the
  step, view or batch it belongs to) and ``attrs``. Outside a session it
  costs one global read on top of the range.
* ``sync(site, n=1)``: a context manager around a statement that makes the
  host wait for the device (``int(t)``, ``.item()``, ``.cpu()``, boolean
  indexing, a copy from pageable host memory). It always adds ``n`` to the
  counter ``sync/<site>``; inside a session it also records the span
  ``das3r::sync/<site>``, which covers the host's blocked time.
* ``count(name, n=1)`` and ``counters()``: the program's counters, one
  dict. Each kernel launch adds to ``launch/<kernel>``
  (``ops/splat/kernels.launch``).

``session()`` yields a ``Recorder``: the spans (``.spans``) and the
counters' change over the session (``.counts()``), in memory; nothing is
written anywhere. Sessions do not nest, and only the thread that opened a
session records into it.

The clock: a span is stamped with ``time.time_ns()``, the Unix-epoch
nanoseconds in which kineto stamps its raw records
(``prof.profiler.kineto_results.events()``, ``start_ns()``), so spans and
a profiler session's device records over the same window lie on one
timeline as they are. A profiler that records the host spends up to
~60 us inside a range's opening, and stamps the record's start midway
through it, and up to ~100 us inside its closing, before it stamps the
record's end. So a span starts at the middle of its range's opening and
ends when the closing returns.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import NamedTuple

from torch.profiler import record_function

_counts: collections.defaultdict = collections.defaultdict(int)
_recorder: Recorder | None = None
_NOTHING = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int     # the id (index in ``Recorder.spans``) it is nested in;
    #                 -1 for an outermost span
    root: int       # the id of the outermost span it is nested in (its own
    #                 for an outermost span)
    attrs: dict


class Recorder:
    """What one session recorded: ``spans`` in the order they started (a
    span's id is its index), and the counters at the start and, once the
    session has closed, at its end."""

    def __init__(self):
        self.spans: list = []
        self.start_counts = counters()
        self.end_counts: dict | None = None
        self._open: list[int] = []
        self._thread = threading.get_ident()

    def counts(self, prefix: str = "") -> dict:
        """The counters' change over the session (so far, while it is
        open), those starting with ``prefix``."""
        now = counters() if self.end_counts is None else self.end_counts
        out = {k: v - self.start_counts.get(k, 0) for k, v in now.items()
               if k.startswith(prefix)}
        return {k: v for k, v in out.items() if v}


class _Recorded:
    __slots__ = ("rec", "name", "attrs", "range", "sid")

    def __init__(self, rec: Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.range = record_function(name)

    def __enter__(self):
        before = time.time_ns()
        self.range.__enter__()
        start = (before + time.time_ns()) // 2
        rec = self.rec
        opened = rec._open
        self.sid = sid = len(rec.spans)
        parent = opened[-1] if opened else -1
        root = opened[0] if opened else sid
        opened.append(sid)
        rec.spans.append([self.name, start, None, parent, root, self.attrs])
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec._open.pop()
        self.range.__exit__(*exc)
        rec.spans[self.sid][2] = time.time_ns()
        return False


def span(name: str, **attrs):
    """A named range of the program (module docstring)."""
    rec = _recorder
    if rec is None or rec._thread != threading.get_ident():
        return record_function(name)
    return _Recorded(rec, name, attrs)


def sync(site: str, n: int = 1):
    """Count ``n`` waits of the host at ``site`` (module docstring)."""
    _counts["sync/" + site] += n
    rec = _recorder
    if rec is None or rec._thread != threading.get_ident():
        return _NOTHING
    return _Recorded(rec, "das3r::sync/" + site, {})


def count(name: str, n: int = 1) -> None:
    _counts[name] += n


def counters(prefix: str = "") -> dict:
    """A copy of the counters (those starting with ``prefix``)."""
    return {k: v for k, v in _counts.items() if k.startswith(prefix)}


@contextlib.contextmanager
def session():
    """Record every span and sync of this thread while open; yields the
    ``Recorder``, whose spans are ``Span`` tuples once the block has
    closed."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a trace session is already open")
    rec = Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = None
        end = time.time_ns()
        rec.end_counts = counters()
        rec.spans = [Span(name, s, end if e is None else e, parent, root,
                          attrs)
                     for name, s, e, parent, root, attrs in rec.spans]
