"""Communication accounting of the sharded render and step, per
collective call (the counterpart of ``das3r_tpu/parallel/hlo_stats.py``,
which reads the same totals from compiled HLO).

Every collective the port issues goes through ``parallel/collectives.py``,
which reports it here. Inside ``with CommStats() as stats:`` each call
adds to ``stats``; outside any such context a report costs a list check.

Byte convention, as in ``hlo_stats``: the bytes of the call's RESULT per
participating rank, the data that lands on each rank. A gather counts the
full gathered size, a reduction the reduced buffer. A gather is carried
out as an all-reduce of a zero-filled buffer (``collectives``), so its
result, and its count here, is the gathered size either way.

    with CommStats() as stats:
        step(state, meta, uids, gts, fovx, fovy, bg)
    stats.families()   # {"all-reduce": {"bytes": ..., "count": ...}, ...}
    stats.calls        # [(family, tag, bytes), ...] in call order
"""
from __future__ import annotations

# The open contexts. A list, not a context variable: the backward's
# collectives run on the autograd engine's device thread, which does not
# see the caller's context variables.
_active: list["CommStats"] = []


class CommStats:
    """Collective calls made while the context is open."""

    def __init__(self):
        self.calls: list[tuple[str, str, int]] = []

    def __enter__(self) -> "CommStats":
        _active.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _active.remove(self)

    def families(self) -> dict:
        """{family: {"bytes": int, "count": int}} over the calls so far,
        only the families that occurred (``hlo_stats.collective_bytes``'s
        form)."""
        out: dict = {}
        for family, _, nbytes in self.calls:
            fam = out.setdefault(family, {"bytes": 0, "count": 0})
            fam["bytes"] += nbytes
            fam["count"] += 1
        return out


def record(family: str, tag: str, nbytes: int) -> None:
    """Report one collective call to every open context."""
    for stats in _active:
        stats.calls.append((family, tag, int(nbytes)))
