"""The benchmark's data-driven core: find a cell's configuration, traffic
mix, driver, limits and per-layer metric readers by name, run the cell
once, and build its result line.

Files, by name (``bench`` is this directory):

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: one traffic mix's parameters; its
  ``driver`` names the general generator and loop that reads it,
  ``drivers/<driver>.py``;
* ``limits/<workload>.json``: each compared number's limit;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a
  ``read(ctx)`` that returns a number or None (nothing to read).

Adding a configuration, a mix, a cell or a metric adds files; nothing
here names one.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# whole top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "das3r_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with everything found by name."""

    def __init__(self, spec: dict, workload: str, bench: Path = BENCH):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
        self.spec, self.bench = spec, bench
        self.workload = cells[workload]
        self.name = workload
        self.config = load_json(bench / "configs"
                                / f"{self.workload['config']}.json")
        self.traffic = load_json(bench / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.limits = load_json(bench / "limits" / f"{workload}.json")
        self.driver = load_module(
            bench / "drivers" / f"{self.traffic['driver']}.py",
            f"bench_driver_{self.traffic['driver']}")

    def _applies(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def end_to_end(self) -> list[dict]:
        return [m for m in self.spec["end_to_end"] if self._applies(m)]

    def per_layer(self) -> list[dict]:
        """The per-layer metrics of this cell: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def read_metrics(self, ctx) -> dict:
        out = {}
        for m in self.per_layer():
            reader = load_module(self.bench / "metrics" / f"{m['name']}.py",
                                 "bench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(ctx)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every compared number at or
    under its limit, and each limit given. A number that is not finite
    fails."""
    missing = sorted(set(checks) ^ set(limits))
    if missing:
        raise KeyError(f"checks and limits differ on {missing}")
    table = {k: {"value": float(v), "limit": float(limits[k])}
             for k, v in checks.items()}
    ok = all(t["value"] <= t["limit"] for t in table.values())
    return ok, table


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    mods = sys.modules if modules is None else modules
    return sorted({m for m in mods if m.split(".")[0] in FORBIDDEN})


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks          # last: the numbers compared and limits
    return json.dumps(out)


def checks_text(checks: dict) -> str:
    return "\n".join(f"check {k}: {v['value']!r} limit {v['limit']!r}"
                     for k, v in checks.items())
