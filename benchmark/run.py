#!/usr/bin/env python3
"""Run one cell of the PyTorch port's benchmark once, on this machine's
cards, and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is a workload of ``BENCHMARK.json`` at the checkout's root; its
configuration, traffic mix, driver, limits and per-layer metric readers
are files under ``benchmark/`` found by name (``harness.py``). With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a ``torch.profiler``
session over the traced window, and the device's busy and window
seconds. Every run compares what its timed path produced with the plain
reference under ``benchmark/reference/`` and prints each compared number
beside its limit, last on standard error and last in the line.

It exits non-zero, printing no result, without enough CUDA cards, when
the program is missing, and when the JAX package or JAX itself was
loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# a library that would load JAX by itself is kept from it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# kernel caches at fixed paths inside the checkout: only a checkout's
# first run builds (the port's nvcc build is build/torch_ext, fixed there)
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))


def pin_to_one_core() -> int | None:
    """Hold this process, and every thread it starts from here on, to
    the last core it may run on: a run's host work (launches, copies to
    the host) then never migrates between cores."""
    if not hasattr(os, "sched_setaffinity"):
        return None
    core = max(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {core})
    return core


def require_cards(n: int) -> str:
    """The device to run on; exits 2 without ``n`` CUDA cards."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: needs {n} CUDA card(s), found {have}",
              file=sys.stderr)
        sys.exit(2)
    return "cuda:0"


def device_info(dev: str, n: int, peak: int, tr=None) -> dict:
    import torch
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": n, "memory_peak_bytes": peak}
    if tr is not None:
        d.update(busy_s=tr.busy_s, window_s=tr.window_s)
    return d


def run_cell(cell, seed: int, seconds: float, trace: bool, dev,
             clock, variant=None):
    """(correct, result line fields) of one run of ``cell``."""
    from benchmark import harness
    from benchmark.metrics_ctx import Ctx

    out = cell.driver.run(cell, seed, seconds, trace, dev, clock,
                          variant=variant)
    correct, checks = harness.judge(out.checks, cell.limits)
    correct = correct and out.failed == 0
    if trace:
        metrics = cell.read_metrics(Ctx(cell, out))
    else:
        metrics = {m["name"]: {"value": float(out.e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end()}
    return correct, out, metrics, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark.outcome import Clock

    # one host thread: the port's host work is launches and small copies,
    # and intra-op workers only add jitter (on one H100, splat_step_ms
    # spread 5.7% over six runs with the default pool, 2.8% with one)
    torch.set_num_threads(1)
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(spec, args.workload)
    dev = require_cards(cell.workload["chips"])
    correct, out, metrics, checks = run_cell(
        cell, args.seed, args.seconds, bool(args.trace), dev,
        Clock(T_START))
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    from benchmark import trace as trace_mod
    line = harness.result_line(
        correct, out.attempted, out.failed, metrics,
        device_info(dev, cell.workload["chips"], out.memory_peak_bytes,
                    out.trace if args.trace else None),
        checks,
        breakdown=trace_mod.breakdown(out.trace) if args.trace else None)
    print(harness.checks_text(checks), file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    # before torch starts a thread
    print(f"benchmark: pinned to core {pin_to_one_core()}", file=sys.stderr)
    sys.exit(main())
