"""Stage-2 training traffic: one client stepping the trainer's loop,
``das3r_tpu_torch.train.step.train_chunk``, one view a step over the
train frames in the trainer's shuffled epoch order (a closed loop: each
step starts from the state the last one left).

Set-up builds the scene from the seed, the program's state, and the
raster settings through the port's own capacity probe
(``models/autosize``, as ``train/scene_setup.build_scene`` sets them),
then drives that state through its first ``check_steps`` steps, whose
losses, first gradient (Adam's first moment after one step / (1 - b1))
and change after the last are read for the check. The window goes on
from there with the same state, an epoch a ``train_chunk`` call, until
``seconds`` have passed. Untraced, the profiler keeps the device's
records of every call (no host events), and ``splat_step_device_ms`` is
the device's busy time over all of them per step completed; traced, the
window runs without a profiler, ``step_ms`` is its host-clock time per
step (the per-layer ``step_ms.train``), and two traced epochs follow.

After the window the program's state is freed and the reference
(``benchmark/reference/splat.py``) follows the same first steps from
the scene as it was made.
"""
from __future__ import annotations

import dataclasses
import math
import random
import statistics
import sys
import time

import torch

from benchmark import outcome as oc
from benchmark import scene as scene_mod
from benchmark import splat_program
from benchmark import trace as trace_mod
from benchmark.reference import splat as ref
from benchmark.work import splat as work

STAGES = ("das3r::preprocess", "das3r::bin_entry_stream", "das3r::blend",
          "das3r::assemble", "das3r::loss", "das3r::adam")
B1 = 0.9


def frame_order(n_frames: int, steps: int, seed: int) -> list[int]:
    """The trainer's order (``trainer._plan_chunks``): each epoch a fresh
    shuffle of the train frames."""
    rng = random.Random(seed)
    out: list[int] = []
    while len(out) < steps:
        epoch = list(range(n_frames))
        rng.shuffle(epoch)
        out.extend(epoch)
    return out[:steps]


def probed_settings(params, meta, poses, sc, sh_degree: int):
    """Raster settings of the scene as ``build_scene`` probes them, at the
    active SH degree ``sh_degree``."""
    from das3r_tpu_torch.models import autosize
    from das3r_tpu_torch.ops.splat import RasterSettings
    settings = RasterSettings(
        image_height=sc.height, image_width=sc.width,
        sh_degree=sh_degree, max_per_tile=1024,
        max_tiles_per_gaussian=32,
        max_total_entries=8 * params.xyz.shape[0])
    stats = autosize.probe_capacities(params, meta, settings,
                                      poses.all_poses().detach(),
                                      sc.fovx, sc.fovy)
    entry_cap = -(-max(int(stats.max_total * 1.2), 8 * 1024) // 1024) * 1024
    dup_cap = min(-(-max(int(stats.max_dup * 1.3), 8) // 4) * 4,
                  settings.max_tiles_per_gaussian)
    return dataclasses.replace(
        settings, max_tiles_per_gaussian=dup_cap,
        max_total_entries=entry_cap,
        **autosize.auto_split_table(stats, params.xyz.shape[0], dup_cap))


def _dropped(m) -> torch.Tensor:
    """Steps of stacked StepMetrics that dropped entries."""
    return ((m.entry_overflow > 0) | (m.tile_overflow > 0)
            | (m.dup_overflow > 0) | (m.heavy_overflow > 0))


def regrow(settings, m):
    """The trainer's capacity regrow after a chunk whose steps dropped
    entries (``train/trainer.py::train_scene``, the overflow watch read
    at every log point, ``--log_every`` 50 by default: here after every
    epoch's call): the entry stream to (cap + drop) x 1.3, the
    duplication cap x 2, the split table's heavy rows to the live count
    x 1.5 or the cap x 1.5, the window x 1.5 up to 16,384."""
    from das3r_tpu_torch.models import autosize
    s = settings
    drop = int(m.entry_overflow.max())
    if drop > 0 and s.max_total_entries is not None:
        old = s.max_total_entries
        s = dataclasses.replace(s, max_total_entries=-(-max(
            int((old + drop) * 1.3), old + 1024) // 1024) * 1024)
    if int(m.dup_overflow.max()) > 0:
        s = dataclasses.replace(s, max_tiles_per_gaussian=-(-int(
            s.max_tiles_per_gaussian * 2) // 4) * 4)
    if int(m.heavy_overflow.max()) > 0 and s.heavy_rows_cap is not None:
        s = dataclasses.replace(s, heavy_rows_cap=max(
            autosize.auto_heavy_cap(int(m.heavy_rows.max())),
            -(-int(s.heavy_rows_cap * 1.5) // 1024) * 1024))
    if int(m.tile_overflow.max()) > 0:
        s = dataclasses.replace(s, max_per_tile=min(
            -(-int(s.max_per_tile * 1.5) // 128) * 128, 16384))
    return s


@torch.no_grad()
def _norms(group: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in
            group.items()}


def run(cell, seed: int, seconds: float, trace: bool, dev,
        clock: oc.Clock, variant: str | None = None) -> oc.Outcome:
    from das3r_tpu_torch.train import step as step_mod
    from das3r_tpu_torch.train.config import OptimizationConfig

    cfg, tr = cell.config, cell.traffic
    sc = scene_mod.make_scene(cfg, seed, dev)
    params, meta, poses = splat_program.program_state(sc, dev)
    settings = probed_settings(params, meta, poses, sc,
                               tr["active_sh_degree"])
    if variant == "control":
        settings = dataclasses.replace(settings, table_bf16=True)
    print(f"probed: {settings}", file=sys.stderr)
    ocfg = OptimizationConfig(**cfg["optimization"])
    gt = sc.gt
    F = gt.shape[0]
    fovx = torch.full((F,), sc.fovx, device=dev)
    fovy = torch.full((F,), sc.fovy, device=dev)
    bg = torch.tensor(tr["bg"], device=dev)
    state = step_mod.init_train_state(params, poses)
    kw = dict(spatial_lr_scale=sc.spatial_lr_scale,
              optim_pose=tr["optim_pose"], track_stats=tr["track_stats"])

    def chunk(uids):
        """One ``train_chunk`` call, then the trainer's regrow."""
        nonlocal meta, settings
        _, meta, m = step_mod.train_chunk(state, meta, uids, gt, fovx, fovy,
                                          bg, settings, ocfg, **kw)
        settings = regrow(settings, m)
        return m

    # the checked steps, through the window's own call and state
    n_chk = tr["check_steps"]
    order = frame_order(F, n_chk + 400 * F, seed)
    m1 = chunk(order[:1])
    g1 = {k: getattr(state.opt.mu, k) / (1 - B1)
          for k in ref.GAUSS_KEYS}
    g1.update({k: getattr(state.opt_cam.mu, k) / (1 - B1)
               for k in ref.CAM_KEYS})
    g1_norm = _norms(g1)
    del g1
    m_rest = chunk(order[1:n_chk])
    now = dict(**{k: getattr(state.params, k) for k in ref.GAUSS_KEYS},
               **{k: getattr(state.poses, k) for k in ref.CAM_KEYS})
    start = dict(sc.params, Q=sc.poses[:, :4], T=sc.poses[:, 4:],
                 fovx=torch.tensor(sc.fovx, device=dev),
                 fovy=torch.tensor(sc.fovy, device=dev))
    d_norm = _norms({k: now[k] - start[k] for k in now})
    losses = [float(x) for x in torch.cat([m1.loss, m_rest.loss])]
    # a checked step must drop nothing and stay finite
    bad_chk = int((_dropped(m1) | ~torch.isfinite(m1.loss)).sum()
                  + (_dropped(m_rest) | ~torch.isfinite(m_rest.loss)).sum())
    del now, start, sc
    oc.free(dev)

    # the window: an epoch's remainder, then whole epochs. Untraced, the
    # device's records of every call are kept (its busy time); traced,
    # the host's clock alone runs over it, and two traced epochs follow
    stacks = []
    oc.sync(dev)
    setup_s = clock.now()
    pos, steps, busy_s, recs = n_chk, 0, 0.0, []
    t0 = time.perf_counter()
    for b in range(F, len(order), F):
        with oc.device_records(dev, on=not trace) as prof:
            stacks.append(chunk(order[pos:b]))
            oc.sync(dev)
        if prof is not None:
            busy, n_rec = trace_mod.device_busy(prof)
            busy_s += busy
            recs.append(n_rec / (b - pos))
            del prof
        steps += b - pos
        pos = b
        if time.perf_counter() - t0 >= seconds:
            break
    oc.sync(dev)
    window_s = time.perf_counter() - t0
    if recs:
        print(f"window: device records a step, by call: {min(recs):.1f} "
              f"to {max(recs):.1f}; host {window_s * 1e3 / steps:.3f} ms "
              f"a step with the records on", file=sys.stderr)
    e2e = {"splat_step_device_ms": busy_s * 1e3 / steps,
           "step_ms": window_s * 1e3 / steps, "setup_s": setup_s}
    if trace:
        # the state the traced epochs start from, for their frozen counts
        at_trace = {k: getattr(state.params, k).detach().cpu()
                    for k in ref.GAUSS_KEYS}
        at_trace["poses"] = torch.cat([state.poses.Q, state.poses.T],
                                      1).detach().cpu()
        epochs = iter([order[pos:pos + F], order[pos + F:pos + 2 * F]])

        def unit():
            uids = next(epochs)
            stacks.append(chunk(uids))
            return uids
        tr_, got = oc.traced(dev, unit, stages=STAGES)
        traced, pos = got[0], pos + 2 * F
    # a window step fails when its loss is not finite; one that dropped
    # entries is the trainer's designed transient (it regrows after the
    # chunk, as ``regrow`` does here) and is counted apart
    failed = int(sum(int((~torch.isfinite(m.loss)).sum()) for m in stacks))
    dropped = int(sum(int(_dropped(m).sum()) for m in stacks))
    print(f"window: {steps} steps, {dropped} of them dropped entries "
          f"(regrown after their call); at the end {settings}",
          file=sys.stderr)
    peak = oc.peak_bytes(dev)
    del state, meta, params, poses, stacks, gt
    oc.free(dev)

    checks = _reference_check(cell, seed, dev, order[:n_chk], losses,
                              g1_norm, d_norm)
    out = oc.Outcome(
        e2e=e2e, attempted=pos, failed=failed + bad_chk, checks=checks,
        memory_peak_bytes=peak, units=F if trace else steps)
    if trace:
        out.trace = tr_
        out.work = _work(cell, seed, dev, traced, settings, at_trace)
    return out


def _reference_check(cell, seed, dev, uids, losses, g1_norm,
                     d_norm) -> dict:
    """The reference's first steps from the scene as it was made: the
    worst relative gap of the steps' losses, and by the worst leaf the
    gap of the first gradient's norm and of the change's norm against
    the reference's norm of that leaf or of the median leaf, whichever
    is larger. Leaves whose reference gradient is under a thousandth of
    the median leaf's (the unused FoV leaves) are left out."""
    cfg, tr = cell.config, cell.traffic
    oc.reference_precision()
    sc = scene_mod.make_scene(cfg, seed, dev)
    params = dict(sc.params, Q=sc.poses[:, :4].clone(),
                  T=sc.poses[:, 4:].clone(),
                  fovx=torch.tensor(sc.fovx, device=dev),
                  fovy=torch.tensor(sc.fovy, device=dev))
    start = {k: v.clone() for k, v in params.items()}
    opt = ref.new_state(params, ref.GAUSS_KEYS)
    opt_cam = ref.new_state(params, ref.CAM_KEYS)
    bg = torch.tensor(tr["bg"], device=dev)
    ref_losses, ref_g1 = [], None
    for i, uid in enumerate(uids):
        o = ref.train_step(params, opt, opt_cam, i + 1, uid, sc.gt[uid],
                           sc.fovx, sc.fovy, sc.pix_id, sc.height, sc.width,
                           tr["active_sh_degree"], bg, cfg["optimization"],
                           sc.spatial_lr_scale)
        ref_losses.append(o.loss)
        if i == 0:
            ref_g1 = _norms({k: (g if (k in ref.GAUSS_KEYS or o.cam_stepped)
                                 else torch.zeros_like(g))
                             for k, g in o.grads.items()})
        del o
    ref_d = _norms({k: params[k] - start[k] for k in params})
    del params, start, opt, opt_cam, sc
    oc.free(dev)
    med_g = statistics.median(ref_g1.values())
    keep = [k for k in ref_g1 if ref_g1[k] >= 1e-3 * med_g]
    med_g = statistics.median(ref_g1[k] for k in keep)
    med_d = statistics.median(ref_d[k] for k in keep)
    return {
        "loss_gap": max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                        for a, b in zip(losses, ref_losses)),
        "grad_gap": max(abs(g1_norm[k] - ref_g1[k]) / max(ref_g1[k], med_g)
                        for k in keep),
        "change_gap": max(abs(d_norm[k] - ref_d[k]) / max(ref_d[k], med_d)
                          for k in keep),
    }


def _work(cell, seed, dev, uids, settings, at_trace: dict) -> dict:
    """Frozen counts of the traced steps: each step's view of the state
    the traced epoch started from (``at_trace``, the program's Gaussians
    and poses, on the host), through the reference's binning and blend.
    The scene is made again for its sizes and pixel ids only."""
    cfg, tr = cell.config, cell.traffic
    deg = tr["active_sh_degree"]
    sc = scene_mod.make_scene(cfg, seed, dev)
    g = {k: at_trace[k].to(dev) for k in ref.GAUSS_KEYS}
    conf = g["conf_static"].reshape(-1)[sc.pix_id]
    opacity = torch.sigmoid(g["opacity"][:, 0]) * conf
    views = sorted(set(uids))
    poses = at_trace["poses"].to(dev)
    per = dict(zip(views, splat_program.view_work(
        sc, g, opacity, poses[views], deg,
        torch.tensor(tr["bg"], device=dev))))
    tiles = settings.n_tiles
    n = sc.params["xyz"].shape[0]
    n_params = sum(v.numel() for v in sc.params.values())
    pixels = sc.height * sc.width
    fw = [work.blend_forward(per[u], tiles, train=True) for u in uids]
    bw = [work.blend_backward(per[u], tiles) for u in uids]
    return {
        "B_flop": sum(f for f, _ in fw), "B_bytes": sum(b for _, b in fw),
        "C_flop": sum(f for f, _ in bw), "C_bytes": sum(b for _, b in bw),
        "step_flop": sum(work.train_step_flop(per[u], n, pixels, n_params,
                                              deg) for u in uids),
    }
