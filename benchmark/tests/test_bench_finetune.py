"""The four-card fine-tuning cell at a tiny size on the CPU: the plain
reference against the port's step in one process; the cell's run on two
gloo ranks through ``ranks.py`` (the cell on a card takes NCCL only),
sound and with each fault the cell can have planted inside every rank;
its work counts against ``torch.utils.flop_counter``; and the launcher's
end of a rank that dies, raises or hangs."""
from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, ranks, wall_pairs
from benchmark.outcome import Clock
from benchmark.reference import dust3r_model as ref_model
from benchmark.reference import stage1_finetune as ref
from benchmark.run import run_cell
from benchmark.tests.conftest import ROOT, TINY_MODEL, tiny_cell, tiny_copy
from benchmark.work import dust3r_finetune as work

CELL = "dust3r_large.finetune_dp4"
SEED = 2600000023
FAULTS = ("no_exchange", "local_means", "adamw_skipped", "half_rows",
          "no_weight_decay")


def test_reference_follows_the_ports_step_in_one_process(spec, tiny_bench):
    from das3r_tpu_torch.predictor import training
    from das3r_tpu_torch.predictor.datasets import TwoViewClip, batch_iterator
    cell = tiny_cell(spec, CELL, tiny_bench)
    drv, cfg = cell.driver, cell.config
    tr = dict(cell.traffic, ranks=1, pairs_per_rank=4)
    pool = [TwoViewClip(**wall_pairs.pair(SEED, i, 64, 32)) for i in range(8)]
    first = tr["check_from_step"]
    model = drv.dust3r_pairs._program_model(cfg, SEED, "cpu").train()
    tcfg = training.Stage1TrainConfig(**tr["recipe"], freeze=tr["freeze"])
    params, _ = training.split_params(model, freeze=tr["freeze"])
    opt = training.adamw_init(params)
    step = training.make_train_step(model, tcfg)
    start = {k: v.detach().clone() for k, v in params.items()}
    batches = [b for e in range(2)
               for b in batch_iterator(pool, 4, seed=SEED + e)]
    losses = []
    for i in range(3):
        a, b, rows = batches[i]
        assert np.array_equal(a, np.stack(
            [pool[j].img1 for j in drv.batch_rows(8, 4, SEED, i)]))
        losses.append(float(step(params, opt, torch.as_tensor(a),
                                 torch.as_tensor(b), rows.to("cpu"),
                                 first + i).total))
        if i == 0:
            g1 = ref.norms({k: m / 0.1 for k, m in opt.mu.items()})
    change = ref.norms({k: params[k] - start[k] for k in params})
    gaps = drv.reference_check(cfg, tr, SEED, "cpu", pool, 1,
                               (losses, g1, change), control=False)
    assert gaps["loss_gap"] < 1e-6 and gaps["grad_gap"] < 1e-5, gaps
    # past the warm-up (lr ~5e-5) the change is far above the weights'
    # rounding, so its norm agrees closely
    assert gaps["change_gap"] < 1e-4, gaps


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The tiny cell on two gloo ranks: a traced sound run through
    ``run.py``'s ``run_cell``, then every fault in one launch. (A tiny
    step still trains the mask heads' 36M parameters: the DPT widths are
    fixed.)"""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = tiny_cell(spec, CELL, tiny_copy(tmp_path_factory.mktemp("b")))
    sound = run_cell(cell, SEED, 0.2, True, "cpu", Clock())
    outs = cell.driver.run_many(cell, [(SEED, f) for f in FAULTS], 0.2,
                                False, "cpu")
    return cell, sound, dict(zip(FAULTS, outs))


def test_a_sound_run_on_two_ranks_is_correct_and_traced(two_ranks):
    _, (correct, out, metrics, checks), _ = two_ranks
    assert correct and out.failed == 0 and out.attempted == 4 * 8, checks
    assert {"mfu.finetune", "device_idle.finetune"} <= set(metrics)
    assert out.units == 2 and out.work["step_flop"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_each_fault_in_every_rank_fails_the_check(two_ranks, fault):
    cell, _, outs = two_ranks
    ok, table = harness.judge(outs[fault].checks, cell.limits)
    assert not ok, table


@pytest.mark.parametrize("fault", ["no_exchange", "local_means"])
def test_exchange_faults_read_ten_times_the_sound_run(two_ranks, fault):
    _, (_, out, _, _), outs = two_ranks
    sound, bad = out.checks, outs[fault].checks
    assert max(bad[k] / max(sound[k], 1e-12) for k in sound) >= 10, (
        sound, bad)


@pytest.mark.parametrize("stage, unit", [("encode", "frames"),
                                         ("decode", "pairs")])
def test_stage_readers_take_device_ms_a_frame_or_pair(spec, stage, unit):
    from types import SimpleNamespace
    cell = harness.Cell(spec, CELL)
    reader = harness.load_module(
        harness.BENCH / "metrics" / f"{stage}_ms.finetune.py", "r_" + stage)
    times = {"forward": 0.3, "backward": 0.1}
    ctx = SimpleNamespace(cell=cell, work={"frames": 32, "pairs": 16},
                          trace=SimpleNamespace(
                              stage_s={f"das3r::{stage}": times}))
    assert reader.read(ctx) == pytest.approx(400.0 / ctx.work[unit])
    # a window whose stage launched nothing on a device (the CPU) reads
    # nothing
    times.update(forward=0.0, backward=0.0)
    assert reader.read(ctx) is None


def test_work_counts_match_the_flop_counter():
    tiny = dict(patch_size=16, mlp_ratio=4.0, **TINY_MODEL)
    large = dict(patch_size=16, enc_embed_dim=1024, enc_depth=24,
                 enc_num_heads=16, dec_embed_dim=768, dec_depth=12,
                 dec_num_heads=12, mlp_ratio=4.0)
    for m, (h, w), pairs in ((large, (288, 512), 2), (tiny, (32, 64), 3)):
        with torch.device("meta"):
            model = ref_model.AsymmetricCroCo3D(ref_model.Dust3rConfig(**m))
            params = ref.trained_model(model)
            img = torch.zeros(pairs, 3, h, w)
            with FlopCounterMode(display=False) as fc:
                r1, r2 = model(img, img)
                torch.autograd.grad(r1["dynamic_mask"].sum()
                                    + r2["dynamic_mask"].sum(),
                                    list(params.values()))
        assert work.step_flop(m, h, w, pairs) == fc.get_total_flops()


def fails(rank, n, how, mark):
    """A rank function for the launcher's tests: rank 1 dies, raises or
    hangs while rank 0 waits in a collective."""
    import torch.distributed as dist
    if rank == 1:
        if how == "dies":
            os._exit(7)
        if how == "raises":
            raise ValueError("planted")
        if how == "hangs":
            time.sleep(600)
    dist.all_reduce(torch.zeros(1))
    return rank


@pytest.mark.parametrize("how", ["dies", "raises", "hangs"])
def test_a_failed_rank_ends_the_launch_and_leaves_no_process(how):
    t0 = time.monotonic()
    with pytest.raises(ranks.RankFailed):
        ranks.launch(__file__, "fails", 2, how, device="cpu",
                     backend="gloo", stall_s=20.0)
    assert multiprocessing.active_children() == []
    assert time.monotonic() - t0 < 60


def test_the_launcher_returns_every_ranks_value_and_refuses_a_backend():
    assert ranks.launch(__file__, "fails", 2, "none", device="cpu",
                        backend="gloo") == [0, 1]
    with pytest.raises(ranks.RankFailed, match="needs nccl"):
        ranks.launch(__file__, "fails", 2, "none", device="cpu",
                     backend="nccl")
    assert multiprocessing.active_children() == []


def test_cpusets_parse_and_each_rank_gets_a_core():
    assert ranks.parse_cpuset("0-3,8,10-11\n") == [0, 1, 2, 3, 8, 10, 11]
    cores = ranks.rank_cores(4)
    assert len(cores) == 4 and cores[0] == max(os.sched_getaffinity(0))


def test_without_four_cards_the_cell_exits_2_and_prints_nothing():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this machine has four cards")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "3000000001", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == "", p.stderr


@pytest.mark.cuda
def test_finetune_control_fails_on_four_cards(spec):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: the cell's ranks and TF32")
    from benchmark.control import readings
    cell = harness.Cell(spec, CELL)
    for r in readings(cell, "control", [2600000029], 0.0, "cuda:0"):
        ok, _ = harness.judge({k: r[k] for k in cell.limits}, cell.limits)
        assert not ok, r
