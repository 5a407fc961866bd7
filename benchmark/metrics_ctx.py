"""What a per-layer metric reader is given: the cell, the run's traced
window (``trace.Trace``), the frozen counts of that window's work, the
number of steps, views or pairs in it, and what the driver timed on the
host's clock (``e2e``)."""
from __future__ import annotations

from benchmark.work import peaks


class Ctx:
    def __init__(self, cell, out):
        self.cell = cell
        self.trace = out.trace
        self.work = out.work
        self.units = out.units
        self.e2e = out.e2e

    def idle_pct(self) -> float | None:
        t = self.trace
        if t is None or t.window_s <= 0:
            return None
        return 100.0 * (1.0 - t.busy_s / t.window_s)

    def per_unit_ms(self, seconds: float) -> float | None:
        if not self.units or seconds <= 0:
            return None
        return seconds * 1e3 / self.units

    def stage_ms(self, stage: str, backward: bool = True) -> float | None:
        s = self.trace.stage_s.get(stage)
        if s is None:
            return None
        return self.per_unit_ms(s["forward"]
                                + (s["backward"] if backward else 0.0))

    def roofline_pct(self, kernel: str, key: str) -> float | None:
        """Least time of the counted work ``key`` (``<key>_flop``,
        ``<key>_bytes``) over the device time of the kernels named
        ``kernel``; None where no such kernel ran."""
        from benchmark.trace import device_s
        t = device_s(self.trace, kernel)
        if t <= 0 or f"{key}_flop" not in self.work:
            return None
        least = peaks.least_s(self.work[f"{key}_flop"],
                              self.work.get(f"{key}_bytes", 0.0))
        return 100.0 * least / t

    def mfu_pct(self) -> float | None:
        if "step_flop" not in self.work or self.trace.window_s <= 0:
            return None
        return 100.0 * self.work["step_flop"] / (
            self.trace.window_s * peaks.FP32_FLOP_PER_S)
