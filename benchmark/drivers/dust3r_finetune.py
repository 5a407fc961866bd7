"""Stage-1 fine-tuning traffic: DAS3R's recipe for the dynamic-mask heads,
the body of ``predictor/train_loop.py::fit(mesh=)``'s loop on ``ranks``
cards, one process a card (``benchmark/ranks.py``) joined over NCCL.

Each rank makes the same weights from the seed on its card, builds the
port's model and ``training.make_train_step(model, cfg,
group=make_mesh(data=ranks).group("data"))``, and steps it back to back:
``batch_iterator(pool, pairs_per_rank * ranks, seed=seed + epoch,
rank=r, ranks=ranks)`` draws its rows of each global batch, they are
copied to the card with ``torch.as_tensor``, and ``step_fn`` runs the
forward, the loss's global masked means, the mask heads' backward, one
all-reduce of their gradients and AdamW. The pool is ``pool_pairs``
of the benchmark's wall pairs (``wall_pairs.py``) made from the seed in
set-up (each rank renders its share on the host; the shares are
gathered over the process group), held in a list: the window ray-traces
nothing. Left out of ``fit``: evaluation, checkpoints and logs at each
epoch's end (once per ``steps_per_epoch`` steps in the recipe).

The steps are numbered from ``check_from_step``, past the recipe's
warm-up, so the learning rate is near its peak and AdamW's decay and
moments move the heads by more than rounding; the optimiser's moments
start from zero there, as a fresh ``fit`` starts them. Set-up runs the
first ``check_steps`` steps from the seed's state (rank 0 keeps their
global losses, the first all-reduced gradient as AdamW's first moment
holds it, and the mask heads after the last) and one more.
Untraced, the window steps until rank 0's clock passes ``seconds``; its
decision reaches every rank one step later through a one-element
all-reduce read once that step's inputs are on the card (where the
copies wait for the device anyway), and ``finetune_pairs_per_s`` is the
global pairs of the steps completed over rank 0's window, which ends
after a sync of its card. Traced, rank 0 profiles two passes over the
pool (``outcome.traced``).

After the window the ranks free their models and rank 0 follows the same
first steps with the plain reference (``reference/stage1_finetune.py``)
over the whole global batches, in blocks of one rank's rows, with TF32
off; the control puts the reference computed in TF32 in the program's
place. A fault (``faults.py``) is planted inside every rank.
"""
from __future__ import annotations

import contextlib
import math
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark import outcome as oc
from benchmark import ranks as ranks_mod
from benchmark import stage1_inputs as inputs
from benchmark import wall_pairs
from benchmark.drivers import dust3r_pairs
from benchmark.reference import dust3r_model as ref_model
from benchmark.reference import stage1_finetune as ref
from benchmark.work import dust3r_finetune as work

BACKEND = {"cuda": "nccl", "cpu": "gloo"}
STAGES = ("das3r::encode", "das3r::decode", "das3r::heads")
FIELDS = ref.FIELDS


def run(cell, seed: int, seconds: float, trace: bool, dev,
        clock: oc.Clock, variant: str | None = None) -> oc.Outcome:
    return run_many(cell, [(seed, variant)], seconds, trace, dev, clock)[0]


def run_many(cell, jobs, seconds: float, trace: bool, dev,
             clock: oc.Clock | None = None) -> list:
    """One launch of the ranks that runs each (seed, variant) of ``jobs``
    in turn: rank 0's outcomes, each with the largest peak of any rank."""
    device = torch.device(dev).type
    payload = dict(config=cell.config, traffic=cell.traffic,
                   jobs=list(jobs), seconds=seconds, trace=trace,
                   device=device, t0=(clock or oc.Clock()).t0)
    got = ranks_mod.launch(__file__, "rank_main", cell.traffic["ranks"],
                           payload, device=device, backend=BACKEND[device],
                           stall_s=150.0 + seconds)
    outs = got[0]
    for j, o in enumerate(outs):
        o.memory_peak_bytes = max([o.memory_peak_bytes]
                                  + [peaks[j] for peaks in got[1:]])
    return outs


def rank_main(rank: int, ranks: int, p: dict, mark) -> list:
    """Every job on this rank: rank 0's outcomes, the others' peaks."""
    from benchmark import faults
    from das3r_tpu_torch.parallel.mesh import make_mesh
    from das3r_tpu_torch.utils.device import resolve_device
    dev = (torch.device("cuda", torch.cuda.current_device())
           if p["device"] == "cuda" else torch.device("cpu"))
    resolve_device(dev)             # the port's entry: TF32 off
    mesh = make_mesh(data=ranks)
    out = []
    for seed, variant in p["jobs"]:
        plant = (faults.FAULTS[variant]() if variant in faults.FAULTS
                 else contextlib.nullcontext())
        with plant:
            o = _job(rank, ranks, mesh, p, seed, variant, dev, mark)
        out.append(o if rank == 0 else o.memory_peak_bytes)
        mark("job")
    return out


def _pack(c: dict) -> np.ndarray:
    return np.concatenate([np.asarray(c[f], np.float32).ravel()
                           for f in FIELDS])


def _unpack(row: np.ndarray, shapes: list):
    from das3r_tpu_torch.predictor.datasets import TwoViewClip
    parts, o = {}, 0
    for f, s in zip(FIELDS, shapes):
        n = math.prod(s)
        parts[f] = row[o:o + n].reshape(s)
        o += n
    for f in ("valid_1", "valid_2"):
        parts[f] = parts[f] > 0.5
    return TwoViewClip(**parts)


def make_pool(cfg: dict, tr: dict, seed: int, rank: int, ranks: int,
              dev) -> list:
    """The seed's ``pool_pairs`` wall pairs at the configuration's size,
    as the program's ``TwoViewClip``, in a list: this rank renders its
    share on the
    host, and the shares are gathered over the process group (an
    all-reduce of a buffer that holds this rank's rows and zeros). The
    render runs on a pool of threads spread over the machine's cores
    (numpy leaves the interpreter's lock in its array loops), gone before
    the first step; the rank's own thread stays on its core."""
    import torch.distributed as dist

    n = tr["pool_pairs"]
    share = n // ranks
    cores = ranks_mod.allowed_cores()
    with ThreadPoolExecutor(max(1, len(cores) // ranks),
                            initializer=os.sched_setaffinity,
                            initargs=(0, cores)) as ex:
        mine = list(ex.map(
            lambda i: wall_pairs.pair(seed, i, cfg["width"], cfg["height"]),
            range(rank * share, (rank + 1) * share)))
    shapes = [np.shape(mine[0][f]) for f in FIELDS]
    packed = np.stack([_pack(c) for c in mine])
    rows = torch.zeros((n,) + packed.shape[1:], device=dev)
    rows[rank * share:(rank + 1) * share] = torch.from_numpy(packed)
    dist.all_reduce(rows)
    rows = rows.cpu().numpy()
    return [_unpack(r, shapes) for r in rows]


def batch_rows(n: int, batch: int, seed: int, step: int) -> np.ndarray:
    """The pool rows of global step ``step`` (from 0): epoch ``e`` is a
    permutation drawn from ``seed + e``, cut into whole batches."""
    per_epoch = n // batch
    order = np.arange(n)
    np.random.default_rng(seed + step // per_epoch).shuffle(order)
    i = step % per_epoch
    return order[i * batch:(i + 1) * batch]


def _barrier(dev) -> None:
    import torch.distributed as dist
    x = torch.zeros(1, device=dev)
    dist.all_reduce(x)
    float(x)


def _window(draw, launch, losses: list, seconds: float, rank: int,
            dev) -> tuple[int, float]:
    """Steps until rank 0's clock passes ``seconds`` (module docstring):
    (steps, rank 0's seconds to the end of its last step)."""
    import torch.distributed as dist
    card = dev.type == "cuda"
    flag = torch.zeros(1, device=dev)
    seen = torch.zeros(1, pin_memory=card)
    ready = torch.cuda.Event() if card else None
    steps = 0
    t0 = time.perf_counter()
    while True:
        rows = draw()
        if steps:
            if ready is not None:
                ready.synchronize()
            if float(seen) > 0:
                break
        losses.append(launch(rows))
        steps += 1
        flag.fill_(float(rank == 0 and time.perf_counter() - t0 >= seconds))
        dist.all_reduce(flag)
        seen.copy_(flag, non_blocking=card)
        if ready is not None:
            ready.record()
    oc.sync(dev)
    return steps, time.perf_counter() - t0


def _job(rank, ranks, mesh, p, seed, variant, dev, mark) -> oc.Outcome:
    from das3r_tpu_torch.predictor import training
    from das3r_tpu_torch.predictor.datasets import batch_iterator

    cfg, tr = p["config"], p["traffic"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    B = tr["pairs_per_rank"] * ranks
    t = [time.perf_counter()]
    pool = make_pool(cfg, tr, seed, rank, ranks, dev)
    t.append(time.perf_counter())
    tcfg = training.Stage1TrainConfig(**tr["recipe"], freeze=tr["freeze"])
    # the pair cell's model from the seed's weights, in training mode as
    # ``fit`` leaves it
    model = dust3r_pairs._program_model(cfg, seed, dev).train()
    train_p, _ = training.split_params(model, freeze=tr["freeze"])
    opt = training.adamw_init(train_p)
    step_fn = training.make_train_step(model, tcfg, group=mesh.group("data"))
    t.append(time.perf_counter())

    def feed():
        epoch = 0
        while True:
            yield from batch_iterator(pool, B, seed=seed + epoch, rank=rank,
                                      ranks=ranks)
            epoch += 1
    rows_of = feed()
    first = tr["check_from_step"]
    done = first

    def launch(rows):
        nonlocal done
        img1, img2, batch = rows
        out = step_fn(train_p, opt, torch.as_tensor(img1, device=dev),
                      torch.as_tensor(img2, device=dev), batch.to(dev), done)
        done += 1
        return out.total

    def step():
        return launch(next(rows_of))

    # the checked steps, through the window's own call and feed
    n_chk = tr["check_steps"]
    start = ({k: v.detach().clone() for k, v in train_p.items()}
             if rank == 0 else None)
    checked = [step()]
    g1 = (ref.norms({k: m / (1 - tcfg.b1) for k, m in opt.mu.items()})
          if rank == 0 else None)
    checked += [step() for _ in range(n_chk - 1)]
    change = (ref.norms({k: train_p[k] - start[k] for k in train_p})
              if rank == 0 else None)
    del start
    window = [step()]               # the warm-up step
    oc.sync(dev)
    _barrier(dev)
    mark("ready")
    t.append(time.perf_counter())
    setup_s = t[-1] - p["t0"]
    unit_steps = len(pool) // B
    tr_ = None
    if p["trace"]:
        def unit():
            for _ in range(unit_steps):
                window.append(step())
        if rank == 0:
            tr_, _ = oc.traced(dev, unit, stages=STAGES)
            window_s, steps = tr_.window_s, unit_steps
        else:
            unit()
            unit()
    else:
        steps, window_s = _window(lambda: next(rows_of), launch, window,
                                  p["seconds"], rank, dev)
    oc.sync(dev)
    losses = [float(x) for x in checked]
    bad = int((~torch.isfinite(torch.stack(checked + window))).sum())
    peak = oc.peak_bytes(dev)
    del model, train_p, opt, step_fn, checked, window
    oc.free(dev)
    _barrier(dev)
    mark("window")
    out = oc.Outcome(e2e={}, attempted=B * (done - first), failed=B * bad,
                     checks={},
                     memory_peak_bytes=peak)
    if rank != 0:
        return out
    print(f"set-up on rank 0: the pool {t[1] - t[0]:.2f} s, the model "
          f"{t[2] - t[1]:.2f} s, {n_chk + 1} steps {t[3] - t[2]:.2f} s; "
          f"window: {steps} steps of {B} pairs in {window_s:.3f} s",
          file=sys.stderr)
    out.e2e = {"finetune_pairs_per_s": B * steps / window_s,
               "setup_s": setup_s}
    t0 = time.perf_counter()
    out.checks = reference_check(cfg, tr, seed, dev, pool, ranks,
                                 (losses, g1, change),
                                 control=variant == "control")
    print(f"reference: {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    out.units = unit_steps if p["trace"] else steps
    if tr_ is not None:
        out.trace = tr_
        m, pairs = cfg["model"], tr["pairs_per_rank"]
        out.work = {"step_flop": unit_steps * work.step_flop(
            m, cfg["height"], cfg["width"], pairs),
            "frames": unit_steps * 2 * pairs, "pairs": unit_steps * pairs}
    return out


def follow_reference(cfg, tr, seed, dev, pool, ranks):
    """The reference's ``check_steps`` steps from ``check_from_step``,
    from the seed's weights and fresh moments, over the same global
    batches: (losses, first gradient's norms, change's norms), by
    trained tensor."""
    B = tr["pairs_per_rank"] * ranks
    with torch.device("meta"):
        model = ref_model.AsymmetricCroCo3D(inputs.model_config(cfg))
    model.load_state_dict(inputs.weights(cfg, seed, dev), assign=True)
    params = ref.trained_model(model)
    batches = []
    for i in range(tr["check_steps"]):
        idx = batch_rows(len(pool), B, seed, i)
        batches.append({f: np.stack([getattr(pool[j], f) for j in idx])
                        for f in FIELDS})
    got = ref.follow(model, params, batches, tr["pairs_per_rank"],
                     ref.Recipe(**tr["recipe"]), dev,
                     first_step=tr["check_from_step"])
    del model, params
    oc.free(dev)
    return got


def reference_check(cfg, tr, seed, dev, pool, ranks, prog,
                    control: bool) -> dict:
    """The worst relative gap of the checked steps' losses, and by the
    worst trained tensor the gap of the first gradient's norm and of the
    change's norm against the reference's norm of that tensor or of the
    median tensor, whichever is larger; tensors whose reference gradient
    is under a thousandth of the median's are left out."""
    oc.reference_precision()
    truth = follow_reference(cfg, tr, seed, dev, pool, ranks)
    if control:
        oc.reference_precision(tf32=True)
        prog = follow_reference(cfg, tr, seed, dev, pool, ranks)
        oc.reference_precision()
    losses, g1, d = prog
    ref_losses, ref_g1, ref_d = truth
    med_g = statistics.median(ref_g1.values())
    keep = [k for k in ref_g1 if ref_g1[k] >= 1e-3 * med_g]
    med_g = statistics.median(ref_g1[k] for k in keep)
    med_d = statistics.median(ref_d[k] for k in keep)
    return {
        "loss_gap": max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                        for a, b in zip(losses, ref_losses)),
        "grad_gap": max(abs(g1[k] - ref_g1[k]) / max(ref_g1[k], med_g)
                        if math.isfinite(g1[k]) else math.inf for k in keep),
        "change_gap": max(abs(d[k] - ref_d[k]) / max(ref_d[k], med_d)
                          if math.isfinite(d[k]) else math.inf for k in keep),
    }
