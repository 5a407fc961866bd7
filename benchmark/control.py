#!/usr/bin/env python3
"""Readings of a cell's compared numbers for its limits, on the card, at
the cell's own size: the sound program, the control (the configuration's
next precision down: the program's bf16 attribute table for the splat
cells, the reference computed with TF32 for stage 1) and each planted
fault (``faults.py``), over several seeds in one process.

    python3 benchmark/control.py --workload <cell> --variant <v> ... \
        --seeds <n> <n> ... [--seconds 2]

``--variant``: ``program``, ``control`` or a fault's name, each run on
every seed of ``--seeds``. Each prints one JSON line: the variant, the
seed and every compared number. A one-card cell's fault is planted
around the driver in this process; a cell on several cards runs every
job in one launch of its ranks, its driver planting each fault inside
every rank. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, variant: str, seeds, seconds: float, dev) -> list:
    return job_readings(cell, [(variant, s) for s in seeds], seconds, dev)


def job_readings(cell, jobs, seconds: float, dev) -> list:
    """One line of readings for each (variant, seed) of ``jobs``."""
    from benchmark import faults
    from benchmark.outcome import Clock
    if cell.workload["chips"] > 1:
        outs = cell.driver.run_many(cell, [(s, v) for v, s in jobs],
                                    seconds, False, dev)
    else:
        outs = []
        for variant, seed in jobs:
            plant = (faults.FAULTS[variant]() if variant in faults.FAULTS
                     else contextlib.nullcontext())
            with plant:
                outs.append(cell.driver.run(
                    cell, seed, seconds, False, dev, Clock(),
                    variant="control" if variant == "control" else None))
    return [{"variant": v, "seed": s, "failed": o.failed, **o.checks}
            for (v, s), o in zip(jobs, outs)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    from benchmark import harness
    sys.path.insert(0, str(ROOT / "benchmark"))
    from run import require_cards
    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                        args.workload)
    dev = require_cards(cell.workload["chips"])
    t0 = time.perf_counter()
    jobs = [(v, s) for v in args.variant for s in args.seeds]
    for r in job_readings(cell, jobs, args.seconds, dev):
        print(json.dumps(r), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
