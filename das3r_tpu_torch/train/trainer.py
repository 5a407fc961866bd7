"""Stage-2 trainer (port of ``das3r_tpu/train/trainer.py``): the
reference's ``train_gui.py`` rendering runs and its ``train_test_psnr.py``
novel-view PSNR protocol, as a library function and a CLI.

    python -m das3r_tpu_torch.train.trainer -s <scene> -m <model> \\
        [--iter N] [--eval] [--densify] [--device cpu] ...

The loop keeps the JAX package's shape and semantics:

  * the frame schedule is planned on the host (a shuffled permutation per
    epoch, ``random.Random(seed)``) and cut into chunks at epoch
    boundaries, SH-degree bumps (every 3000 iterations) and densify /
    opacity-reset events; a chunk is a plain loop over ``train_step``
    (one ``lax.scan`` in the JAX package, which also falls back to
    per-step dispatch when that fails to compile: eager PyTorch has no such
    failure, so there is no fallback);
  * the main Adam always steps; the camera Adam is gated on frame PSNR;
  * eval mode: a test-pose-only pass over held-out cameras at every epoch
    boundary, its schedule from ``np.random.default_rng(seed + end)``;
  * testing iterations append masked test-view L1/PSNR to test_log.txt in
    the reference's line format; saving iterations write the PLY and the
    pose npy; checkpoint iterations the state ``.npz``;
  * the capacity regrows: ``max_total_entries`` on entry overflow,
    ``max_tiles_per_gaussian`` on dup overflow, ``heavy_rows_cap`` on
    heavy-row overflow, ``max_per_tile`` on tile overflow (the [T, K]
    window path), with the JAX package's rules and warning texts.

Output channels: ``progress`` carries only the parseable protocol lines
(``[ITER N] loss ... psnr ...`` and the ``Evaluating train/test`` lines);
every warning and telemetry line goes to ``warn``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import random
import time

import numpy as np
import torch

from das3r_tpu_torch.data import readers
from das3r_tpu_torch.models import autosize
from das3r_tpu_torch.models import densify as densify_mod
from das3r_tpu_torch.models import render as render_mod
from das3r_tpu_torch.train import checkpoint as ckpt
from das3r_tpu_torch.train import optim, scene_setup
from das3r_tpu_torch.train import step as step_mod
from das3r_tpu_torch.train.config import OptimizationConfig, to_json
from das3r_tpu_torch.utils import tblog
from das3r_tpu_torch.utils.device import resolve_device
from das3r_tpu_torch.utils.image import psnr as psnr_fn


@dataclasses.dataclass
class TrainResult:
    state: step_mod.TrainState
    test_pose_state: step_mod.TestPoseState | None
    last_loss: float
    test_psnr: float | None
    iters_per_sec: float
    # settings as of the last chunk: SH-degree bumps and capacity regrows
    final_settings: object | None = None
    meta: object | None = None          # GaussianMeta after the last chunk
    losses: list | None = None          # loss of every iteration run


def _plan_chunks(iterations: int, n_frames: int, seed: int,
                 extra_boundaries=()):
    """Shuffled-per-epoch uids, cut into chunks at epoch and SH-bump
    (every 3000 iterations) boundaries and at ``extra_boundaries``.
    Returns a list of (start_iter, uid_array)."""
    rng = random.Random(seed)
    uids: list[int] = []
    while len(uids) < iterations:
        epoch = list(range(n_frames))
        rng.shuffle(epoch)
        uids.extend(epoch)
    uids = uids[:iterations]

    boundaries = {0, iterations}
    boundaries.update(range(0, iterations, n_frames))        # epoch starts
    boundaries.update(range(3000, iterations, 3000))
    boundaries.update(b for b in extra_boundaries if 0 < b < iterations)
    cuts = sorted(boundaries)
    return [(a, np.asarray(uids[a:b], np.int32))
            for a, b in zip(cuts[:-1], cuts[1:]) if b > a]


def _densify_schedule(cfg, densify: bool, white_background: bool):
    """Iterations at which densify and opacity-reset events fire
    (reference train_gui.py:612-623, flag-enabled)."""
    dens_iters, reset_iters = set(), set()
    if not densify:
        return dens_iters, reset_iters
    until = min(cfg.densify_until_iter, cfg.iterations)
    for it in range(cfg.densification_interval,
                    until, cfg.densification_interval):
        if it > cfg.densify_from_iter:
            dens_iters.add(it)
    for it in range(cfg.opacity_reset_interval, until,
                    cfg.opacity_reset_interval):
        reset_iters.add(it)
    if white_background and cfg.densify_from_iter < until:
        reset_iters.add(cfg.densify_from_iter)
    return dens_iters, reset_iters


def _densify_generator(seed: int, end: int, dev) -> torch.Generator:
    """The split-noise generator of the event at iteration ``end``: seeded
    from (seed + 7, end), so a resumed run draws the same noise."""
    return torch.Generator(device=dev).manual_seed(
        ((seed + 7) << 32) + end)


def _on(group, dev):
    """A copy of a parameter or meta dataclass with every tensor on dev."""
    return dataclasses.replace(group, **{
        f.name: getattr(group, f.name).to(dev)
        for f in dataclasses.fields(group)})


def train_scene(
    bundle: scene_setup.SceneBundle,
    cfg: OptimizationConfig,
    *,
    model_path: str | None = None,
    white_background: bool = False,
    optim_pose: bool = True,
    optim_test_pose: bool = True,
    testing_iterations=(),
    saving_iterations=(),
    checkpoint_iterations=(),
    log_every: int = 50,
    seed: int = 0,
    densify: bool = False,
    densify_clone: bool = False,
    densify_split: bool = False,
    start_checkpoint: str | None = None,
    profile_dir: str | None = None,
    tb_writer=None,
    progress=print,
    warn=print,
    device=None,
) -> TrainResult:
    """Train ``bundle`` for ``cfg.iterations`` on ``device`` (default
    CUDA; a RuntimeError without it). The bundle's parameters and poses
    are updated in place."""
    dev = resolve_device(device)
    train = bundle.train_data
    test = bundle.test_data
    settings = bundle.settings
    scene = bundle.scene

    def stack(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    gt_images, fovx, fovy = (stack(train.images), stack(train.fovx),
                             stack(train.fovy))
    bg = (torch.ones(3, device=dev) if white_background
          else torch.zeros(3, device=dev))

    state = step_mod.init_train_state(_on(bundle.params, dev),
                                      _on(bundle.poses, dev))
    meta = _on(bundle.meta, dev)
    first_iter = 0
    if start_checkpoint:
        state, loaded_meta = ckpt.load_train_state(start_checkpoint, state,
                                                   meta_template=meta)
        if loaded_meta is not None:
            meta = loaded_meta
        first_iter = int(state.step)
        warn(f"resumed from {start_checkpoint} at iteration {first_iter}")
    tp_state = None
    test_gt = test_fovx = test_fovy = test_masks = None
    if test is not None:
        test_poses = _on(bundle.test_poses, dev)
        tp_state = step_mod.TestPoseState(poses=test_poses,
                                          opt=optim.adam_init(test_poses))
        test_gt, test_fovx, test_fovy = (stack(test.images),
                                         stack(test.fovx), stack(test.fovy))
        if test.gt_dynamic_mask is not None:
            test_masks = stack(np.repeat(test.gt_dynamic_mask[:, None], 3, 1))
        else:
            test_masks = torch.zeros_like(test_gt)

    dens_iters, reset_iters = _densify_schedule(cfg, densify,
                                                white_background)
    chunks = _plan_chunks(cfg.iterations, scene.n_frames, seed,
                          extra_boundaries=dens_iters | reset_iters)
    events = sorted(set(testing_iterations) | set(saving_iterations)
                    | set(checkpoint_iterations))
    loss_handles = []
    test_psnr_last = None
    t0 = time.perf_counter()

    todo = [c for c in chunks if c[0] + len(c[1]) > first_iter]
    # trace the second pending chunk (the first carries the one-time
    # costs); a single-chunk run traces that one
    profile_at = (todo[1][0] if len(todo) > 1 else
                  todo[0][0] if todo else None)
    for start, uids in chunks:
        end = start + len(uids)
        if end <= first_iter:
            continue                      # resumed past this chunk
        sh_degree = min(start // 3000, scene.max_sh_degree)
        if settings.sh_degree != sh_degree:
            settings = dataclasses.replace(settings, sh_degree=sh_degree)

        track_stats = densify and end <= cfg.densify_until_iter
        profiling = profile_dir is not None and start == profile_at
        with (torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                *([torch.profiler.ProfilerActivity.CUDA]
                  if dev.type == "cuda" else [])])
              if profiling else contextlib.nullcontext()) as prof:
            state, meta, metrics = step_mod.train_chunk(
                state, meta, [int(u) for u in uids], gt_images, fovx, fovy,
                bg, settings, cfg, spatial_lr_scale=scene.spatial_lr_scale,
                optim_pose=optim_pose, track_stats=track_stats)
            if profiling and dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if profiling:
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir,
                                                  "trace.json"))
            warn("profiler trace written")
        loss_handles.append(metrics.loss)

        # densify and opacity-reset events land exactly at chunk boundaries
        if end in dens_iters:
            dcfg = densify_mod.DensifyConfig(
                grad_threshold=cfg.densify_grad_threshold,
                min_opacity=0.005,
                percent_dense=cfg.percent_dense,
                max_screen_size=(20.0 if end > cfg.opacity_reset_interval
                                 else 0.0),
                extent=float(scene.spatial_lr_scale),
                enable_clone=densify_clone,
                enable_split=densify_split)
            params, meta, opt, rep = densify_mod.densify_and_prune(
                state.params, meta, state.opt,
                _densify_generator(seed, end, dev), dcfg)
            state = dataclasses.replace(state, params=params, opt=opt)
            if log_every:
                warn(f"[ITER {end}] densify: +{int(rep.n_cloned)} clone "
                     f"+{int(rep.n_split)} split -{int(rep.n_pruned)} "
                     f"prune (overflow {int(rep.n_overflow)})")
        if end in reset_iters:
            params, opt = densify_mod.reset_opacity(state.params, state.opt)
            state = dataclasses.replace(state, params=params, opt=opt)

        # test-pose pass at epoch boundaries
        if test is not None and optim_test_pose and end < cfg.iterations:
            tuids = np.random.default_rng(seed + end).permutation(
                test.n_frames)
            tp_state, _ = step_mod.test_pose_chunk(
                tp_state, state.params, meta, [int(u) for u in tuids],
                test_gt, test_masks, test_fovx, test_fovy, bg, state.step,
                settings, cfg)

        for ev in [e for e in events if start < e <= end]:
            if ev in testing_iterations:
                _report_train(tb_writer, model_path, ev, state, meta,
                              settings, gt_images, fovx, fovy, bg, progress)
            if ev in testing_iterations and test is not None:
                test_psnr_last = _report_test(
                    tb_writer, model_path, ev, state, tp_state, meta,
                    settings, test_gt, test_masks, test_fovx, test_fovy, bg,
                    progress)
            if ev in saving_iterations and model_path:
                ckpt.save_scene_ply(
                    os.path.join(model_path, "point_cloud",
                                 f"iteration_{ev}", "point_cloud.ply"),
                    state.params, meta)
                ckpt.save_pose_npy(
                    os.path.join(model_path, "pose", f"pose_{ev}.npy"),
                    state.poses)
            if ev in checkpoint_iterations and model_path:
                ckpt.save_train_state(
                    os.path.join(model_path, f"chkpnt{ev}.npz"), state,
                    meta=meta)

        at_log = log_every and (start // log_every != end // log_every
                                or end == cfg.iterations)
        # Entry-overflow watch -> regrow (the analog of the CUDA
        # rasterizer's dynamic buffer growth: the probe sized the stream
        # for the initial occupancy; Gaussians move and densify). Read at
        # the first pending chunk and at log points, as in the JAX package.
        if settings.max_total_entries is not None and (
                at_log or (todo and start == todo[0][0])):
            drop = int(metrics.entry_overflow.max())
            if drop > 0:
                old = settings.max_total_entries
                new_cap = -(-max(int((old + drop) * 1.3), old + 1024)
                            // 1024) * 1024
                settings = dataclasses.replace(settings,
                                               max_total_entries=new_cap)
                warn(f"[ITER {end}] entry overflow {drop}: regrow "
                     f"max_total_entries {old} -> {new_cap} "
                     f"(recompile at next chunk)")
                tblog.scalars(tb_writer, end, train__entry_overflow=drop,
                              train__entry_cap=new_cap)
        if at_log:
            t_ovf = int(metrics.tile_overflow.max())
            d_ovf = int(metrics.dup_overflow.max())
            if d_ovf > 0:
                # a Gaussian's rect outgrew the probed cap; x2 as in the
                # JAX package (where each regrow costs a recompile)
                old_d = settings.max_tiles_per_gaussian
                new_d = -(-int(old_d * 2) // 4) * 4
                settings = dataclasses.replace(
                    settings, max_tiles_per_gaussian=new_d)
                warn(f"[ITER {end}] dup overflow {d_ovf}: regrow "
                     f"max_tiles_per_gaussian {old_d} -> {new_d} "
                     f"(recompile at next chunk)")
            h_ovf = int(metrics.heavy_overflow.max())
            if h_ovf > 0 and settings.heavy_rows_cap is not None:
                # Gaussians grew past the split table's light width faster
                # than the probed heavy capacity: regrow from the live
                # heavy-row count, as the JAX package does
                old_h = settings.heavy_rows_cap
                new_h = max(autosize.auto_heavy_cap(
                    int(metrics.heavy_rows.max())),
                    -(-int(old_h * 1.5) // 1024) * 1024)
                settings = dataclasses.replace(settings,
                                               heavy_rows_cap=new_h)
                warn(f"[ITER {end}] heavy-row overflow {h_ovf}: regrow "
                     f"heavy_rows_cap {old_h} -> {new_h} "
                     f"(recompile at next chunk)")
                tblog.scalars(tb_writer, end, train__heavy_overflow=h_ovf,
                              train__heavy_cap=new_h)
            if t_ovf > 0:
                # [T, K] window truncation; K stays a multiple of 128 (or a
                # divisor: window_blend._pick_chunk), at most 16384
                old_k = settings.max_per_tile
                new_k = min(-(-int(old_k * 1.5) // 128) * 128, 16384)
                if new_k > old_k:
                    settings = dataclasses.replace(settings,
                                                   max_per_tile=new_k)
                    warn(f"[ITER {end}] tile overflow {t_ovf}: regrow "
                         f"max_per_tile {old_k} -> {new_k} "
                         f"(recompile at next chunk)")
                else:
                    warn(f"[ITER {end}] capacity warning: tile_overflow "
                         f"{t_ovf} (window path truncating at the "
                         f"max_per_tile ceiling {old_k})")
            if t_ovf > 0 or d_ovf > 0:
                tblog.scalars(tb_writer, end, train__tile_overflow=t_ovf,
                              train__dup_overflow=d_ovf)
            lossv = float(metrics.loss[-1])
            psnrv = float(metrics.psnr[-1])
            progress(f"[ITER {end}] loss {lossv:.5f} psnr {psnrv:.2f}")
            tblog.scalars(tb_writer, end, train__total_loss=lossv,
                          train__psnr=psnrv)

    losses = (torch.cat(loss_handles).tolist() if loss_handles else [])
    dt = time.perf_counter() - t0
    n_done = max(cfg.iterations - first_iter, 1)
    return TrainResult(state=state, test_pose_state=tp_state,
                       last_loss=losses[-1] if losses else float("nan"),
                       test_psnr=test_psnr_last,
                       iters_per_sec=n_done / max(dt, 1e-9),
                       final_settings=settings, meta=meta, losses=losses)


@torch.no_grad()
def _eval_views(params, meta, pose7s, uids, gt_stack, mask_stack, fovx,
                fovy, bg, settings):
    """Mean masked L1 and PSNR over the ``uids`` views."""
    l1s, psnrs = [], []
    for uid in uids:
        out = render_mod.render(params, meta, settings, pose7s[uid], bg,
                                fovx[uid], fovy[uid], mode="train",
                                device=bg.device)
        img = torch.clamp(out.image, 0.0, 1.0)
        gt = torch.clamp(gt_stack[uid], 0.0, 1.0)
        m = 1.0 - mask_stack[uid]
        p, g = img * m, gt * m
        l1s.append(torch.abs(p - g).mean())
        psnrs.append(psnr_fn(p[None], g[None]).mean())
    return float(torch.stack(l1s).mean()), float(torch.stack(psnrs).mean())


def _append_log(model_path, fname, line, progress):
    progress(line)
    if model_path:
        os.makedirs(model_path, exist_ok=True)
        with open(os.path.join(model_path, fname), "a") as f:
            f.write(line + "\n")


def _report_train(tb_writer, model_path, iteration, state, meta, settings,
                  gt_images, fovx, fovy, bg, progress, n_sample: int = 5):
    """L1/PSNR on sampled TRAIN views -> train_log.txt (train_gui
    training_report :666-712 renders 5 sample train cameras)."""
    n = gt_images.shape[0]
    uids = np.linspace(0, n - 1, min(n_sample, n)).astype(np.int32)
    l1_t, psnr_t = _eval_views(
        state.params, meta, state.poses.all_poses().detach(),
        [int(u) for u in uids], gt_images, torch.zeros_like(gt_images),
        fovx, fovy, bg, settings)
    _append_log(model_path, "train_log.txt",
                f"[ITER {iteration}] Evaluating train: L1 {l1_t} "
                f"PSNR {psnr_t}", progress)
    tblog.scalars(tb_writer, iteration, train__eval_l1=l1_t,
                  train__eval_psnr=psnr_t)
    return psnr_t


def _report_test(tb_writer, model_path, iteration, state, tp_state, meta,
                 settings, test_gt, test_masks, test_fovx, test_fovy, bg,
                 progress):
    """Masked L1/PSNR over all test frames, appended to test_log.txt in
    the reference's format (train_test_psnr.training_report :241-302)."""
    pose7s = torch.cat([tp_state.poses.Q, tp_state.poses.T], -1).detach()
    l1_t, psnr_t = _eval_views(
        state.params, meta, pose7s, range(test_gt.shape[0]), test_gt,
        test_masks, test_fovx, test_fovy, bg, settings)
    _append_log(model_path, "test_log.txt",
                f"[ITER {iteration}] Evaluating test: L1 {l1_t} "
                f"PSNR {psnr_t}", progress)
    tblog.scalars(tb_writer, iteration, test__l1=l1_t, test__psnr=psnr_t)
    return psnr_t


def main(argv=None):
    ap = argparse.ArgumentParser(description="DAS3R stage-2 trainer "
                                 "(PyTorch)")
    ap.add_argument("-s", "--source_path", required=True)
    ap.add_argument("-m", "--model_path", required=True)
    ap.add_argument("--iter", "--iterations", dest="iterations", type=int,
                    default=4000)
    ap.add_argument("--eval", action="store_true",
                    help="hold out the (i+5)%%10 test split")
    ap.add_argument("--eval_pose", action="store_true", dest="optim_pose",
                    default=True)
    ap.add_argument("--no-optim-pose", dest="optim_pose",
                    action="store_false")
    ap.add_argument("--freeze_attrs", action="store_true",
                    help="freeze features/scaling/rotation/opacity (an "
                         "ablation: the reference trains every attribute)")
    ap.add_argument("--no-optim-test-pose", dest="optim_test_pose",
                    action="store_false", default=True,
                    help="strict parity with the reference (its test-pose "
                         "optimization is a silent no-op)")
    ap.add_argument("--sh_degree", type=int, default=3)
    ap.add_argument("--conf_thre", type=float, default=1.0)
    ap.add_argument("--entry_cap", type=int, default=None,
                    help="rasterizer entry capacity; default probes the "
                         "scene's occupancy (models/autosize.py)")
    ap.add_argument("--max_points", type=int, default=1_500_000,
                    help="cap dense init at the N highest-confidence "
                         "pixels (0 = keep all, reference behavior)")
    ap.add_argument("--white_background", action="store_true")
    ap.add_argument("--psnr_threshold", type=float, default=26.0)
    ap.add_argument("--dataset", default="davis")
    ap.add_argument("--gt_dynamic_mask", default=None)
    ap.add_argument("--test_iterations", type=int, nargs="*", default=None)
    ap.add_argument("--save_iterations", type=int, nargs="*", default=None)
    ap.add_argument("--checkpoint_iterations", type=int, nargs="*",
                    default=[])
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--densify", action="store_true",
                    help="enable densification/pruning at chunk boundaries "
                         "(the reference ships with this commented out)")
    ap.add_argument("--densify_clone", action="store_true",
                    help="also enable INRIA clone densification")
    ap.add_argument("--densify_split", action="store_true",
                    help="also enable INRIA split densification")
    ap.add_argument("--start_checkpoint", default=None,
                    help="resume from a chkpnt<N>.npz (train_gui.py:505-507)")
    ap.add_argument("--detect_anomaly", action="store_true",
                    help="abort at the op that produces the first "
                         "non-finite gradient (torch.autograd anomaly "
                         "mode, reference train_gui.py:749)")
    ap.add_argument("--tensorboard", action="store_true",
                    help="write TB scalars to <model_path>/tb (guarded "
                         "import, reference train_gui.py:33-37)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler chrome trace of one "
                         "training chunk to DIR/trace.json")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (fails without it)")
    args = ap.parse_args(argv)

    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    dev = resolve_device(args.device)
    data = readers.load_scene(args.source_path, eval_mode=args.eval,
                              gt_dynamic_mask_dir=args.gt_dynamic_mask,
                              gt_mask_kind=args.dataset)
    bundle = scene_setup.build_scene(data, sh_degree=args.sh_degree,
                                     conf_thre=args.conf_thre,
                                     max_points=args.max_points or None,
                                     entry_cap=args.entry_cap, device=dev)
    cfg = OptimizationConfig(iterations=args.iterations,
                             psnr_threshold=args.psnr_threshold,
                             freeze_attrs=args.freeze_attrs)
    os.makedirs(args.model_path, exist_ok=True)
    with open(os.path.join(args.model_path, "cfg.json"), "w") as f:
        f.write(to_json(cfg))

    test_iters = (args.test_iterations if args.test_iterations is not None
                  else [args.iterations])
    save_iters = (args.save_iterations if args.save_iterations is not None
                  else [args.iterations])

    ckpt.save_pose_npy(os.path.join(args.model_path, "pose", "pose_org.npy"),
                       bundle.poses)
    readers.save_cameras_json(os.path.join(args.model_path, "cameras.json"),
                              data)
    tb_writer = tblog.make_writer(os.path.join(args.model_path, "tb")
                                  if args.tensorboard else None)
    try:
        result = _run_training(args, bundle, cfg, test_iters, save_iters,
                               tb_writer, dev)
    finally:
        tblog.close(tb_writer)
    print(f"done: loss {result.last_loss:.5f} "
          f"iters/s {result.iters_per_sec:.2f} "
          f"test_psnr {result.test_psnr}")
    return result


def _run_training(args, bundle, cfg, test_iters, save_iters, tb_writer,
                  dev):
    return train_scene(
        bundle, cfg, model_path=args.model_path,
        white_background=args.white_background,
        optim_pose=args.optim_pose, optim_test_pose=args.optim_test_pose,
        testing_iterations=set(test_iters),
        saving_iterations=set(save_iters),
        checkpoint_iterations=set(args.checkpoint_iterations),
        log_every=args.log_every,
        densify=args.densify, densify_clone=args.densify_clone,
        densify_split=args.densify_split,
        start_checkpoint=args.start_checkpoint,
        profile_dir=args.profile,
        tb_writer=tb_writer, device=dev)


if __name__ == "__main__":
    main()
