"""Each cell's run at a tiny size on the CPU, the harness's look for a
card skipped and the rest of the run driven: sound, it is correct; with
each fault the cell can have planted in the program underneath
(``faults.py``), and with the control in the program's place where the
CPU has it, ``correct`` comes out false. The cells run on one chip: no
fault leaves an exchange between chips out. Stage 1's control, the
reference in TF32, changes nothing on the CPU and is read on the card
(``test_stage1_control_fails_on_the_card``)."""
from __future__ import annotations

import pytest
import torch

from benchmark import faults
from benchmark.outcome import Clock
from benchmark.run import run_cell
from benchmark.tests.conftest import tiny_cell

CASES = [("davis50_1p5m.train", None, True),
         ("davis50_1p5m.train", "state_unchanged", False),
         ("davis50_1p5m.train", "half_batch", False),
         ("davis50_1p5m.train", "control", False),
         ("davis50_1p5m.orbit_render", None, True),
         ("davis50_1p5m.orbit_render", "altered_image", False),
         ("davis50_1p5m.orbit_render", "control", False),
         ("dust3r_large.video_pairs", None, True),
         ("dust3r_large.video_pairs", "altered_maps", False)]


@pytest.mark.parametrize("workload,variant,correct", CASES)
def test_the_check_passes_sound_runs_and_fails_planted_faults(
        spec, tiny_bench, workload, variant, correct):
    cell = tiny_cell(spec, workload, tiny_bench)
    plant = (faults.FAULTS[variant]() if variant in faults.FAULTS
             else faults.contextlib.nullcontext())
    with plant:
        got, out, _, checks = run_cell(cell, 2600000017, 0.2, False, "cpu",
                                       Clock(), variant=variant)
    assert got is correct, checks


@pytest.mark.cuda
def test_stage1_control_fails_on_the_card(spec):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 acts only there")
    from benchmark import harness
    from benchmark.control import readings
    cell = harness.Cell(spec, "dust3r_large.video_pairs")
    for r in readings(cell, "control", [2600000019], 1.0, "cuda:0"):
        ok, _ = harness.judge({k: r[k] for k in cell.limits}, cell.limits)
        assert not ok, r
