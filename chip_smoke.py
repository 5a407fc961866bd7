#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (``das3r_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line, each raising (non-zero exit) on
failure:

1. device: needs CUDA; prints the card's name and power limit
   (``nvidia-smi``) and turns TF32 off.
2. build: compiles every kernel under ``das3r_tpu_torch/csrc`` with nvcc
   (one process per source, in parallel) into ``build/torch_ext/``; prints
   ptxas's registers and spills and the blocks per SM of the kernels that
   report it.
3. scene: a synthetic 8-frame stage-1 scene at 288x512, rearranged, plus
   a 1.5M-Gaussian SH-degree-3 scene from a seed, written as the trained
   checkpoint (PLY + stage-1 w2c poses) that the render tool loads.
4. parity: for view 0 of that scene at full size, kernels A, B, C against
   their plain PyTorch versions on the card (``extract_chunks`` bitwise,
   ``blend_forward`` within 2e-4 with and without its ``n_last`` output,
   ``blend_backward`` within 2e-5 x max|g| per column group on cotangents
   from a seed), with CUDA-event times of kernel, plain version and the
   library call that computes the same function (where one exists), and
   each kernel's bound from the bytes and operations of this run.
5. reference: a small scene rendered on the card equals the port's CPU
   render (plain versions, held against JAX and the f64 oracle by
   ``tests/test_torch_*.py``) within 2e-4, and so do the gradients of its
   training loss, within 2e-5 x max|g| per parameter.
6. main: ``das3r_tpu_torch.eval.render_tool.render_sets`` renders all 8
   views on ``cuda``; checks 8 finite, non-constant PNGs, no dropped
   entry, and that the forward kernels launched once per view.
7. profile: one more render of view 1 under ``torch.profiler``: the
   device time by kernel, the host time by operator, and the device's
   idle share of the render's wall time.
8. train: ``das3r_tpu_torch.train.step.train_step``, 10 steps over frames
   0 and 1 of the synthetic scene at full width (the 1.5M Gaussians with
   every SH band filled, ``conf_static`` from the scene's dynamic maps,
   the stage-1 poses and FoVs), densification statistics tracked; checks
   finite losses, gradients (through the Adam moments), parameters and
   statistics, the Adam count, no dropped entry, that frame 0's loss fell,
   and that every kernel launched once per step.
9. train_profile: one more step under ``torch.profiler``: device ms by
   ``das3r::`` stage, forward and backward (a backward op belongs to the
   stage whose forward op has its autograd sequence number), the top
   kernels and the idle share.
10. trainer_scene: a synthetic 12-frame stage-1 scene at 288x512,
   rearranged, loaded in eval mode (11 train frames) and built by
   ``das3r_tpu_torch.train.scene_setup.build_scene`` with its defaults on
   ``cuda``: the dense init capped at 1.5M points, the k-NN scales and the
   window-path capacity probe (each timed).
11. trainer_entry_parity: kernels A, B, C as in phase 4 on view 0 of that
   bundle's entry stream, the non-saturating scene of the trainer's entry
   run, where most of their launches run.
12. window_parity: view 0 of that bundle at full size on the [T, K] window
   path, K from the probe's largest tile (a multiple of 128, at most
   16384): ``extract_windows`` bitwise, ``window_blend_forward`` within
   2e-4, ``window_blend_backward`` within 2e-5 x max|g| per attribute
   group, each against its plain version, timed and bounded as above; and,
   where no tile overflows K, the window-path image against the
   entry-stream image within 2e-4.
13. trainer: ``das3r_tpu_torch.train.trainer.train_scene`` twice on its
   own copy of the bundle, 44 iterations each (4 epochs), densify with
   clone and split at 10, 20 and 30, an opacity reset at 30, a test
   report, a save and a checkpoint at 44: once on the entry stream, once
   on the window path with the probed K. Checks finite losses and
   parameters, that the loss of iterations 12-22 is below that of 1-11,
   the written PLY, pose npy, npz and test log, the npz read back equal,
   and which kernels each run launched.

Then the ``kernels`` line (A, B, C at the trainer scene with their
random-scene numbers under ``random_scene``; D, E, F at the trainer
scene), the ``nvidia-smi`` line, and last the device line. Everything it
writes lives under ``build/`` and is removed at exit (the kernel
libraries stay cached in ``build/torch_ext/``). The package is imported
from this script's own checkout, so the script fails, having printed
nothing, when it stands alone.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

N_GAUSSIANS = 1_500_000
HEIGHT, WIDTH = 288, 512
N_FRAMES = 8
SH_DEGREE = 3
SEED = 0
BLEND_TOL = 2e-4

# Published peaks of one H100 SXM at its full 700 W limit: HBM bandwidth
# and FP32 rate (NVIDIA data sheet); exp runs on the special-function
# units, 16 results per clock per SM (CUDA programming guide throughput
# table, compute capability 9.0) x 132 SMs x 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
BLEND_FLOP_PER_EVAL = 15     # power, alpha, the tests and the T update
# blend_backward per evaluation: power and alpha (~12), T restore, w,
# gC . c, dalpha and S (~13), the nine gradient terms (~30); on the
# special-function units the exp and the reciprocals of three divisions
BLEND_BWD_FLOP_PER_EVAL = 55
BLEND_BWD_SFU_PER_EVAL = 4
GRAD_TOL = 2e-5              # x max|g|: the JAX gradient bar
TRAIN_STEPS = 10
# window_blend_backward per evaluation: the replay (~15) and the backward
# (~40) FP32 operations; on the special-function units two exps and the
# reciprocals of two divisions
WINDOW_BWD_FLOP_PER_EVAL = 55
WINDOW_BWD_SFU_PER_EVAL = 4
TRAINER_FRAMES = 12          # eval mode holds out one: 11 train frames
TRAINER_ITERS = 44           # 4 epochs of the 11 train frames
K_CEILING = 16384            # the trainer's max_per_tile regrow ceiling
# table columns by what they hold
GROUPS = {"mean2d": [0, 1], "conic": [2, 3, 4], "color": [5, 6, 7],
          "opacity": [8]}
# a kernel's numbers on a phase's line and beside the other scene's
SUMMARY_KEYS = ("max_abs_err", "err_over_max_g", "ms", "ms_with_n_last",
                "plain_ms", "library_ms", "bound_ms", "bound_by")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops_seconds: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    if ops_seconds > t_bytes:
        return ops_seconds * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def prefix_bytes(es, need, row_bytes):
    """Bytes of the ranks and distinct table rows in each tile's first
    ``need[t]`` slots: what a walk over those prefixes must read."""
    import torch
    dev = need.device
    tiles = torch.repeat_interleave(torch.arange(need.numel(), device=dev),
                                    need)
    first = torch.cumsum(need, 0) - need
    slots = (es.astart.long()[tiles] + torch.arange(tiles.numel(), device=dev)
             - first[tiles])
    rows = int(torch.unique(es.rank[slots]).numel())
    return slots.numel(), slots.numel() * 4 + rows * row_bytes


def kernel_counters():
    from das3r_tpu_torch.ops.splat import binning, entry_blend, window_blend
    return {"extract_chunks": binning.extract_chunks,
            "blend_forward": entry_blend.blend_forward,
            "blend_backward": entry_blend.blend_backward,
            "extract_windows": binning.extract_windows,
            "window_blend_forward": window_blend.window_forward,
            "window_blend_backward": window_blend.window_backward}


def run_counted(fn):
    """(fn(), {kernel: launches during the call}): every count set to 0
    just before, read just after."""
    counted = kernel_counters()
    for f in counted.values():
        f.launches = 0
    out = fn()
    return out, {name: f.launches for name, f in counted.items()}


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    smi = smi.splitlines()[torch.cuda.current_device()]
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def blocks_per_sm(lib, name: str, chunk: int = 128) -> int | None:
    """Blocks of kernel ``name`` resident per SM, from the CUDA occupancy
    calculator, where its library reports it."""
    import ctypes
    fn = getattr(lib, f"{name}_blocks_per_sm", None)
    if fn is None:
        return None
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(chunk)


def phase_build():
    from das3r_tpu_torch.ops.splat import kernels
    t0 = time.perf_counter()
    built = kernels.build_all()
    ptxas = {name: [ln.strip() for ln in b["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, b in built.items()}
    occupancy = {name: blocks_per_sm(kernels.library(name), name)
                 for name in kernels.SIGNATURES}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas,
         blocks_per_sm={k: v for k, v in occupancy.items() if v is not None})


def phase_scene():
    """Stage-1 dir -> rearranged scene; random 1.5M-Gaussian checkpoint."""
    import numpy as np
    from das3r_tpu_torch.data import ply, readers, rearrange, synthetic

    t0 = time.perf_counter()
    if WORK.exists():
        shutil.rmtree(WORK)
    stage1, scene, model = WORK / "stage1", WORK / "scene", WORK / "model"
    synthetic.make_synthetic_stage1_dir(str(stage1), n_frames=N_FRAMES,
                                        height=HEIGHT, width=WIDTH, seed=SEED)
    rearrange.rearrange_scene(str(stage1), str(scene))
    data = readers.load_scene(str(scene))

    params, _, _ = synthetic.random_gaussian_scene(
        N_GAUSSIANS, n_frames=N_FRAMES, height=HEIGHT, width=WIDTH,
        seed=SEED, sh_degree=SH_DEGREE, device="cpu")
    rng = np.random.default_rng(SEED + 1)
    f_rest = rng.normal(0.0, 0.05, params.features_rest.shape)
    conf = rng.uniform(0.5, 1.0, N_GAUSSIANS)
    ply.write_gaussians(
        str(model / "point_cloud" / "iteration_1" / "point_cloud.ply"),
        xyz=params.xyz.numpy(), f_dc=params.features_dc.numpy(),
        f_rest=f_rest.astype(np.float32),
        opacity_logit=params.opacity.numpy(),
        conf_per_gaussian=conf.astype(np.float32),
        scaling=params.scaling.numpy(), rotation=params.rotation.numpy())
    # the stage-1 poses as the trained w2c poses
    (model / "pose").mkdir(parents=True)
    w2c = np.linalg.inv(data.poses_c2w.astype(np.float64))
    np.save(model / "pose" / "pose_1.npy", w2c.astype(np.float32))
    emit("scene", seconds=time.perf_counter() - t0, n_gaussians=N_GAUSSIANS,
         height=data.height, width=data.width, frames=data.n_frames)
    return scene, model, data


def view0_prep(model: Path, data, settings, dev):
    """Preprocess view 0 of the checkpoint as ``render`` does."""
    import numpy as np
    import torch
    from das3r_tpu_torch.eval.render_tool import load_gaussians_ply
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.ops.splat.preprocess import preprocess
    from das3r_tpu_torch.utils.quat import w2c_to_pose

    params, _, conf = load_gaussians_ply(
        str(model / "point_cloud" / "iteration_1" / "point_cloud.ply"),
        SH_DEGREE, dev)
    w2c = np.load(model / "pose" / "pose_1.npy")
    pose = w2c_to_pose(torch.as_tensor(w2c, device=dev))[0]
    xyz_cam, rot_cam = render_mod._camera_frame_gaussians(params, pose)
    view, proj, campos, tfx, tfy = render_mod._raster_common(
        float(data.fovx[0]), float(data.fovy[0]), dev)
    opacity = torch.sigmoid(params.opacity) * conf[:, None]
    return preprocess(
        xyz_cam, opacity, settings, viewmatrix=view, projmatrix=proj,
        campos=campos,
        shs=torch.cat([params.features_dc, params.features_rest], 1),
        scales=torch.exp(params.scaling), rotations=rot_cam,
        tan_fovx=tfx, tan_fovy=tfy)


def entry_kernel_parity(prep, settings, dev):
    """Kernels A, B and C against their plain versions on one view's entry
    stream (``prep`` binned with ``settings``), timed and bounded at its
    shapes. Returns (results, the stream's sizes)."""
    import numpy as np
    import torch
    from das3r_tpu_torch.ops.splat import binning, entry_blend

    n = prep.depth.shape[0]
    es = binning.bin_entry_stream(prep, settings)
    attr = torch.cat([prep.mean2d, prep.conic, prep.color,
                      prep.opacity[:, None]], 1)
    table = torch.cat([attr[es.order], torch.zeros_like(attr[:1])]
                      ).contiguous()
    ks = binning._sorted_key_stream(prep, settings)
    keys = ks.sorted_packed
    results = []

    # --- kernel A: extract_chunks -------------------------------------
    lay = binning.chunk_layout(keys, ks.nbits, settings,
                               binning.entry_stream_cap(settings, n))
    src0, nlive = lay.src0, lay.nlive
    got = binning.extract_chunks(keys, src0, nlive, ks.nbits, n)
    want = binning.extract_chunks_plain(keys, src0, nlive, ks.nbits, n)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"extract_chunks differs on {bad} slots")
    if not torch.equal(got, es.rank):
        raise AssertionError("extract_chunks disagrees with the stream")
    lane = torch.arange(binning.CHUNK, device=dev)
    idx = torch.clamp_max(src0[:, None] + lane, max(keys.numel() - 1, 0)
                          ).reshape(-1)
    nbytes = (keys.numel() * 8 + src0.numel() * 8 + nlive.numel() * 4
              + got.numel() * 4)
    b_ms, b_by = bound(nbytes)
    results.append(dict(
        name="extract_chunks", route="cuda",
        source="das3r_tpu_torch/csrc/extract_chunks.cu",
        replaces="das3r_tpu/ops/splat/binning.py:563",
        max_abs_err=0.0,
        ms=time_ms(lambda: binning.extract_chunks(keys, src0, nlive,
                                                  ks.nbits, n)),
        plain_ms=time_ms(lambda: binning.extract_chunks_plain(
            keys, src0, nlive, ks.nbits, n)),
        library_ms=time_ms(lambda: keys[idx]),
        bound_ms=b_ms, bound_by=b_by,
        slots=got.numel(), live_slots=int(nlive.sum()), bytes=nbytes))

    # --- kernel B: blend_forward --------------------------------------
    cpre, tfinal = entry_blend.blend_forward(table, es.rank, es.astart,
                                             es.count, settings)
    plain = entry_blend.blend_forward_plain(table, es.rank, es.astart,
                                            es.count, settings)
    torch.cuda.synchronize()
    err = torch.cat([(cpre - plain.cpre).abs().reshape(-1),
                     (tfinal - plain.tfinal).abs().reshape(-1)])
    max_err, mean_err = float(err.max()), float(err.mean())
    if not max_err <= BLEND_TOL:
        raise AssertionError(f"blend_forward max err {max_err} > {BLEND_TOL}")
    n_eval = int(plain.n_eval.sum())
    live = int(es.count.sum())
    # The serial loops need a prefix of each tile's list: as long as its
    # longest-running pixel's. Those slots' ranks and table rows are the
    # bytes this run's data needs.
    n_slots, pre_bytes = prefix_bytes(es, plain.n_eval.amax(1),
                                      entry_blend.N_ATTR * 4)
    nbytes = (pre_bytes + es.astart.numel() * 4 + es.count.numel() * 4
              + cpre.numel() * 4 + tfinal.numel() * 4)
    ops_s = max(n_eval * BLEND_FLOP_PER_EVAL / FP32_FLOP_PER_S,
                n_eval / SFU_OPS_PER_S)
    b_ms, b_by = bound(nbytes, ops_s)
    results.append(dict(
        name="blend_forward", route="cuda",
        source="das3r_tpu_torch/csrc/blend_forward.cu",
        replaces="das3r_tpu/ops/splat/entry_blend.py:145",
        max_abs_err=max_err, mean_abs_err=mean_err,
        plain_ms=time_ms(lambda: entry_blend.blend_forward_plain(
            table, es.rank, es.astart, es.count, settings)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        entries=live, entries_needed=n_slots,
        pixel_entry_evals=n_eval,
        evals_if_no_saturation=live * settings.tile * settings.tile,
        chunks_skipped=plain.chunks_skipped, bytes=nbytes))

    # the training forward: the same kernel, also writing n_last
    def fwd(for_backward):
        return entry_blend.blend_forward(table, es.rank, es.astart,
                                         es.count, settings, for_backward)

    cpre_n, tfinal_n, n_last = fwd(True)
    torch.cuda.synchronize()
    err_n = max(float((cpre_n - plain.cpre).abs().max()),
                float((tfinal_n - plain.tfinal).abs().max()))
    if not err_n <= BLEND_TOL:
        raise AssertionError(f"blend_forward with n_last: max err {err_n}")
    # timed in turns, n_last off, on, on, off: one call's noise is larger
    # than the difference
    turns = [time_ms(lambda b=b: fwd(b)) for b in (False, True, True, False)]
    results[-1].update(
        ms=(turns[0] + turns[3]) / 2, ms_with_n_last=(turns[1] + turns[2]) / 2,
        ms_turns_off_on_on_off=turns, max_abs_err_with_n_last=err_n,
        n_last_agrees=float((n_last == plain.n_last).float().mean()))

    # --- kernel C: blend_backward -------------------------------------
    gen = np.random.default_rng(SEED + 4)
    g_cpre = torch.as_tensor(gen.normal(size=tuple(cpre.shape)).astype(
        np.float32), device=dev)
    g_tfinal = torch.as_tensor(gen.normal(size=tuple(tfinal.shape)).astype(
        np.float32), device=dev)
    bwd_args = (table, es.rank, es.astart, es.count, settings)
    got = entry_blend.blend_backward(*bwd_args, tfinal_n, n_last, g_cpre,
                                     g_tfinal)
    want = entry_blend.blend_backward_plain(
        *bwd_args, plain.tfinal, plain.tin, g_cpre, g_tfinal).g_table
    torch.cuda.synchronize()
    rel = {k: float((got[:, c] - want[:, c]).abs().max()
                    / want[:, c].abs().max()) for k, c in GROUPS.items()}
    if not (torch.isfinite(got).all() and max(rel.values()) <= GRAD_TOL):
        raise AssertionError(f"blend_backward err / max|g| {rel} > "
                             f"{GRAD_TOL}")
    evals = int(n_last.sum())
    # The walk visits each tile's list up to its largest n_last; every
    # pixel tests the entries before its own n_last.
    n_slots, pre_bytes = prefix_bytes(es, n_last.amax(1).long(),
                                      entry_blend.N_ATTR * 4)
    nbytes = (pre_bytes + (n_last.numel() + es.astart.numel()
                           + es.count.numel()) * 4
              + (tfinal.numel() + g_cpre.numel() + g_tfinal.numel()) * 4
              + got.numel() * 4)
    ops_s = max(evals * BLEND_BWD_FLOP_PER_EVAL / FP32_FLOP_PER_S,
                evals * BLEND_BWD_SFU_PER_EVAL / SFU_OPS_PER_S)
    b_ms, b_by = bound(nbytes, ops_s)
    results.append(dict(
        name="blend_backward", route="cuda",
        source="das3r_tpu_torch/csrc/blend_backward.cu",
        replaces="das3r_tpu/ops/splat/entry_blend.py:237",
        max_abs_err=float((got - want).abs().max()),
        err_over_max_g=rel,
        ms=time_ms(lambda: entry_blend.blend_backward(
            *bwd_args, tfinal_n, n_last, g_cpre, g_tfinal)),
        plain_ms=time_ms(lambda: entry_blend.blend_backward_plain(
            *bwd_args, plain.tfinal, plain.tin, g_cpre, g_tfinal)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        pixel_entry_evals=evals, entries_needed=n_slots,
        max_n_last=int(n_last.max()), bytes=nbytes))
    sizes = dict(n_gaussians=n, entries=live, stream_slots=es.rank.numel(),
                 max_tile_entries=int(es.count.max()),
                 entry_overflow=int(es.entry_overflow))
    return results, sizes


def summary(results):
    return {r["name"]: {k: r[k] for k in SUMMARY_KEYS if k in r}
            for r in results}


def phase_parity(model: Path, data, settings, dev):
    """Kernels A, B, C against their plain versions at the serving path's
    shapes: view 0 of the random scene."""
    t0 = time.perf_counter()
    prep = view0_prep(model, data, settings, dev)
    results, sizes = entry_kernel_parity(prep, settings, dev)
    emit("parity", seconds=time.perf_counter() - t0, **sizes,
         kernels=summary(results))
    return results


def phase_reference(dev):
    """Small scene: the card's render and training gradients equal the
    port's on the CPU."""
    import dataclasses

    import numpy as np
    import torch
    from das3r_tpu_torch.data import synthetic
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.models.gaussians import GaussianParams
    from das3r_tpu_torch.ops.splat import RasterSettings
    from das3r_tpu_torch.train.loss import photometric_loss

    t0 = time.perf_counter()
    params, meta, poses = synthetic.random_gaussian_scene(
        2000, n_frames=1, height=64, width=96, seed=SEED + 2,
        sh_degree=SH_DEGREE, device="cpu")
    rng = np.random.default_rng(SEED + 3)
    params.features_rest = torch.as_tensor(rng.normal(
        0.0, 0.05, params.features_rest.shape).astype(np.float32))
    s = RasterSettings(image_height=64, image_width=96, sh_degree=SH_DEGREE,
                       max_tiles_per_gaussian=32)
    bg = torch.tensor([0.1, 0.2, 0.3])
    imgs = {d: render_mod.render(
        params, meta, s, poses.pose(0), bg, 1.0, 1.0, mode="no_soft",
        device=d).image.cpu() for d in ("cpu", dev)}
    err = float((imgs["cpu"] - imgs[dev]).abs().max())
    if not (torch.isfinite(imgs[dev]).all() and err <= 2e-4):
        raise AssertionError(f"card render differs from CPU render: {err}")

    # the gradients of the training loss, every parameter field and the
    # pose, on the card against the CPU
    gt = torch.as_tensor(np.random.default_rng(SEED + 5).uniform(
        0, 1, (3, 64, 96)).astype(np.float32))
    grads = {}
    for d in ("cpu", dev):
        p = GaussianParams(**{f.name: getattr(params, f.name).detach()
                              .to(d).requires_grad_(True)
                              for f in dataclasses.fields(params)})
        pose = poses.pose(0).detach().to(d).requires_grad_(True)
        out = render_mod.render(p, meta, s, pose, bg, 1.0, 1.0,
                                mode="train", device=d)
        loss = photometric_loss(out.image, gt.to(d), p.conf_static[0]).loss
        leaves = [getattr(p, f.name) for f in dataclasses.fields(p)]
        grads[d] = [g.cpu() for g in torch.autograd.grad(loss, leaves
                                                         + [pose])]
    names = [f.name for f in dataclasses.fields(params)] + ["pose"]
    rel = {k: float((a - b).abs().max() / b.abs().max())
           for k, a, b in zip(names, grads[dev], grads["cpu"])}
    if not max(rel.values()) <= GRAD_TOL:
        raise AssertionError(f"card gradients differ from CPU: {rel}")
    emit("reference", seconds=time.perf_counter() - t0, max_abs_err=err,
         shape=list(imgs[dev].shape), grad_err_over_max_g=rel)


def phase_main(scene: Path, model: Path, device=None):
    """The render tool over every view; returns each kernel's launches."""
    import numpy as np
    from PIL import Image
    from das3r_tpu_torch.eval import render_tool

    counted = kernel_counters()
    t0 = time.perf_counter()
    stats: list[dict] = []
    for fn in counted.values():
        fn.launches = 0
    _, paths = render_tool.render_sets(str(scene), str(model), iteration=1,
                                       stats=stats, device=device)
    launches = {name: fn.launches for name, fn in counted.items()}
    seconds = time.perf_counter() - t0

    if len(paths) != N_FRAMES:
        raise AssertionError(f"{len(paths)} PNGs, expected {N_FRAMES}")
    for p in paths:
        arr = np.asarray(Image.open(p))
        if arr.shape != (HEIGHT, WIDTH, 3) or arr.min() == arr.max():
            raise AssertionError(f"{p}: shape {arr.shape}, constant image")
    for st in stats:
        if not st["finite"] or st["entry_overflow"] != 0:
            raise AssertionError(f"view {st['view']}: {st}")
    ms = [st["ms"] for st in stats]
    emit("main", seconds=seconds, views=len(paths),
         render_ms_median_views_2_8=statistics.median(ms[1:]),
         render_ms=ms, entries_per_view=[st["entries"] for st in stats],
         launches=launches)
    return launches


def phase_profile(model: Path, data, settings, dev):
    """View 1 once more, under torch.profiler, after the main phase."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from das3r_tpu_torch.eval.render_tool import load_gaussians_ply
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.utils.quat import w2c_to_pose

    params, meta, conf = load_gaussians_ply(
        str(model / "point_cloud" / "iteration_1" / "point_cloud.ply"),
        SH_DEGREE, dev)
    pose = w2c_to_pose(torch.as_tensor(
        np.load(model / "pose" / "pose_1.npy"), device=dev))[1]
    bg = torch.zeros(3, device=dev)

    def view1():
        return render_mod.render(params, meta, settings, pose, bg,
                                 float(data.fovx[1]), float(data.fovy[1]),
                                 mode="test", conf_per_gaussian=conf,
                                 device=dev)

    view1()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        view1()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # das3r:: ranges are the rasterizer's stages (ops/splat/rasterize.py,
    # binning.py). Each also shows as a device-side span, which is not a
    # kernel; an operator's or a stage's device time is that of its kernels.
    kern = sorted((e for e in events if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("das3r::")),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    host = [e for e in events if e.device_type == DeviceType.CPU]
    stages = [e for e in host if e.key.startswith("das3r::")]
    ops = sorted((e for e in host if not e.key.startswith("das3r::")),
                 key=lambda e: -e.device_time_total)
    host.sort(key=lambda e: -e.self_cpu_time_total)
    emit("profile", wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / wall_ms,
         kernel_launches=sum(e.count for e in kern),
         stages=[dict(name=e.key, host_ms=e.cpu_time_total / 1e3,
                      device_ms=e.device_time_total / 1e3) for e in stages],
         ops_top=[dict(name=e.key, calls=e.count,
                       device_ms=e.device_time_total / 1e3)
                  for e in ops[:12]],
         host_top=[dict(name=e.key[:60], calls=e.count,
                        ms=e.self_cpu_time_total / 1e3)
                   for e in host[:8]],
         device_top=[dict(name=e.key[:100], calls=e.count,
                          ms=e.self_device_time_total / 1e3)
                     for e in kern[:8]])


def train_scene(data, dev):
    """The 1.5M-Gaussian scene of the serving phases, every SH band filled,
    with ``conf_static`` from the scene's dynamic maps and the stage-1
    poses and FoVs, as training parameters on ``dev``."""
    import numpy as np
    import torch
    from das3r_tpu_torch.data import synthetic
    from das3r_tpu_torch.models.gaussians import init_pose_params

    params, meta, _ = synthetic.random_gaussian_scene(
        N_GAUSSIANS, n_frames=N_FRAMES, height=HEIGHT, width=WIDTH,
        seed=SEED, sh_degree=SH_DEGREE, device=dev)
    rng = np.random.default_rng(SEED + 1)
    params.features_rest = torch.as_tensor(rng.normal(
        0.0, 0.05, tuple(params.features_rest.shape)).astype(np.float32),
        device=dev)
    params.conf_static = torch.as_tensor(
        1.0 - data.dyna_avg.astype(np.float32), device=dev)
    w2c = np.linalg.inv(data.poses_c2w.astype(np.float64)).astype(np.float32)
    poses = init_pose_params(w2c, float(data.fovx[0]), float(data.fovy[0]),
                             device=dev)
    return params, meta, poses


def phase_train(data, settings, dev):
    """``train_step`` at full width over frames 0 and 1; returns the
    state, meta, each kernel's launches and what one more step needs."""
    import dataclasses
    import math

    import torch
    from das3r_tpu_torch.train import step as step_mod
    from das3r_tpu_torch.train.config import OptimizationConfig

    t0 = time.perf_counter()
    params, meta, poses = train_scene(data, dev)
    state = step_mod.init_train_state(params, poses)
    cfg = OptimizationConfig()
    gts = torch.as_tensor(data.images, device=dev)
    bg = torch.zeros(3, device=dev)

    def step(state, meta, uid):
        return step_mod.train_step(
            state, meta, uid, gts[uid], float(data.fovx[uid]),
            float(data.fovy[uid]), bg, settings, cfg, track_stats=True)

    setup_s = time.perf_counter() - t0
    counted = kernel_counters()
    for fn in counted.values():
        fn.launches = 0
    marks, metrics = [], []
    for i in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, meta, m = step(state, meta, i % 2)
        end.record()
        marks.append((start, end))
        metrics.append(m)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    ms = [a.elapsed_time(b) for a, b in marks]
    losses = [float(m.loss) for m in metrics]

    finite = all(math.isfinite(x) for x in losses)
    for opt in (state.opt, state.opt_cam):
        for group in (opt.mu, opt.nu):
            finite &= all(bool(torch.isfinite(getattr(group, f.name)).all())
                          for f in dataclasses.fields(group))
    for group in (state.params, state.poses):
        finite &= all(bool(torch.isfinite(getattr(group, f.name)).all())
                      for f in dataclasses.fields(group))
    finite &= bool(torch.isfinite(meta.xyz_grad_accum).all())
    if not finite:
        raise AssertionError(f"non-finite loss, gradient or parameter: "
                             f"losses {losses}")
    if int(state.opt.count) != TRAIN_STEPS or state.step != TRAIN_STEPS:
        raise AssertionError(f"Adam count {int(state.opt.count)}, step "
                             f"{state.step}, expected {TRAIN_STEPS}")
    dropped = sum(int(m.entry_overflow) for m in metrics)
    if dropped:
        raise AssertionError(f"{dropped} entries dropped")
    if not losses[TRAIN_STEPS - 2] < losses[0]:
        raise AssertionError(f"frame 0's loss did not fall: {losses}")
    # the entry-stream kernels once per step, the window path's never
    entry = ("extract_chunks", "blend_forward", "blend_backward")
    for name, count in launches.items():
        if count != (TRAIN_STEPS if name in entry else 0):
            raise AssertionError(f"{name} launched {count} times in "
                                 f"{TRAIN_STEPS} train steps")
    emit("train", seconds=time.perf_counter() - t0, setup_seconds=setup_s,
         steps=TRAIN_STEPS, step_ms_median_steps_2_10=statistics.median(
             ms[1:]), step_ms=ms, losses=losses,
         psnr=[float(m.psnr) for m in metrics],
         cam_steps=int(state.opt_cam.count),
         visible=[int(m.radii_nonzero) for m in metrics],
         stats_denom_max=float(meta.denom.max()),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         launches=launches)
    return launches, lambda: step(state, meta, 0)


def stage_times(prof) -> dict:
    """Device ms of each top-level ``das3r::`` stage of a profiled train
    step, forward and backward, from the kernels each operator launched
    (a range's own device-side span is not counted). A forward operator
    belongs to its enclosing top-level stage range; a backward operator
    (run by the autograd engine, on its own thread for the GPU) belongs to
    the stage of the forward operator with the same autograd sequence
    number. Operators outside every range (the camera transform,
    activations, the conf gather, gradient accumulation) fall under
    ``render_other``."""
    top = ("das3r::preprocess", "das3r::bin_entry_stream",
           "das3r::bin_gaussians", "das3r::blend", "das3r::assemble",
           "das3r::loss", "das3r::adam")
    events = prof.events()
    backward = "autograd::engine::evaluate_function"

    def owner(e):
        """(top-level range, evaluate_function) enclosing ``e``."""
        rng = ev = None
        while e is not None:
            if rng is None and e.name in top:
                rng = e.name[len("das3r::"):]
            if e.name.startswith(backward):
                ev = e
            e = e.cpu_parent
        return rng or "render_other", ev

    seq = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            rng, ev = owner(e)
            if ev is None:
                seq.setdefault(e.sequence_nr, rng)
    out: dict[str, dict[str, float]] = {}
    for e in events:
        if not e.kernels or e.name.startswith("das3r::"):
            continue
        rng, ev = owner(e)
        key = "forward_ms"
        if ev is not None:
            key, rng = "backward_ms", seq.get(ev.sequence_nr, "render_other")
        d = out.setdefault(rng, {})
        d[key] = d.get(key, 0.0) + sum(k.duration for k in e.kernels) / 1e3
    return out


def phase_train_profile(one_step, phase: str = "train_profile"):
    """One more train step under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kern = sorted((e for e in events if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("das3r::")),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    stages = stage_times(prof)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU
                   and not e.key.startswith("das3r::")),
                  key=lambda e: -e.self_cpu_time_total)
    emit(phase, wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / wall_ms,
         kernel_launches=sum(e.count for e in kern),
         stages=stages, stages_total_ms=sum(
             sum(d.values()) for d in stages.values()),
         host_top=[dict(name=e.key[:60], calls=e.count,
                        ms=e.self_cpu_time_total / 1e3)
                   for e in host[:8]],
         device_top=[dict(name=e.key[:100], calls=e.count,
                          ms=e.self_device_time_total / 1e3)
                     for e in kern[:12]])


class _Timed:
    """Wrap ``module.name`` while inside: each call's seconds (after a
    synchronize) and its result are kept, so that one stage of an entry
    point can be timed without running it twice."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.seconds, self.results = [], []

    def __enter__(self):
        import torch
        self.orig = orig = getattr(self.module, self.name)

        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            self.results.append(out)
            return out
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def phase_trainer_scene(dev):
    """The trainer's scene: 12 synthetic frames at full width, eval split,
    ``build_scene`` with its defaults (k-NN and probe timed)."""
    import torch
    from das3r_tpu_torch.data import readers, rearrange, synthetic
    from das3r_tpu_torch.models import autosize, gaussians
    from das3r_tpu_torch.train import scene_setup

    t0 = time.perf_counter()
    stage1, scene = WORK / "trainer_stage1", WORK / "trainer_scene"
    synthetic.make_synthetic_stage1_dir(str(stage1), n_frames=TRAINER_FRAMES,
                                        height=HEIGHT, width=WIDTH,
                                        seed=SEED + 7)
    rearrange.rearrange_scene(str(stage1), str(scene))
    data = readers.load_scene(str(scene), eval_mode=True)
    io_s = time.perf_counter() - t0
    with _Timed(gaussians, "knn_mean_sq_dist") as knn, \
            _Timed(autosize, "probe_capacities") as probe:
        t1 = time.perf_counter()
        bundle, launches = run_counted(
            lambda: scene_setup.build_scene(data, device=dev))
        build_s = time.perf_counter() - t1
    stats = probe.results[0]
    k_probe = min(-(-stats.max_tile // 128) * 128, K_CEILING)
    n_live = int(bundle.meta.alive.sum())
    # every synthetic pixel passes the confidence test; the init keeps the
    # 1.5M most confident of the 11 train frames' pixels
    if (n_live != min(1_500_000, 11 * HEIGHT * WIDTH)
            or len(bundle.train_data.images) != 11):
        raise AssertionError(f"{n_live} live Gaussians, "
                             f"{len(bundle.train_data.images)} train frames")
    for name in ("extract_windows", "window_blend_forward"):
        if launches[name] == 0:
            raise AssertionError(f"the probe launched no {name}")
    st = bundle.settings
    emit("trainer_scene", seconds=time.perf_counter() - t0, io_seconds=io_s,
         build_scene_seconds=build_s, knn_seconds=knn.seconds,
         probe_seconds=probe.seconds, probe=stats._asdict(),
         k_probe=k_probe, n_gaussians=n_live,
         capacity=int(bundle.params.xyz.shape[0]),
         settings=dict(max_per_tile=st.max_per_tile,
                       max_tiles_per_gaussian=st.max_tiles_per_gaussian,
                       max_total_entries=st.max_total_entries,
                       light_dup_width=st.light_dup_width,
                       heavy_rows_cap=st.heavy_rows_cap),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         launches=launches)
    return bundle, k_probe, launches


def visited_chunk_work(counts, deltas, tin, chunk, eps):
    """(live slots in the visited chunks, visited chunks) of the window
    blend: what the serial loops of kernels D and E evaluate per pixel."""
    import torch
    n_chunks = tin.shape[1]
    visited = tin.amax(2) >= eps                               # [T, nc]
    c = torch.arange(n_chunks, device=tin.device)
    lo = torch.clamp(deltas.long()[:, None] - c * chunk, 0, chunk)
    hi = torch.clamp((deltas + counts).long()[:, None] - c * chunk, 0, chunk)
    slots = torch.where(visited, hi - lo, torch.zeros_like(lo))
    return int(slots.sum()), int(visited.sum())


def trainer_view0_prep(bundle, settings, dev):
    """View 0 of the trainer's bundle, preprocessed as
    ``render(mode="train")`` preprocesses it."""
    import torch
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.models.gaussians import per_gaussian_conf
    from das3r_tpu_torch.ops.splat.preprocess import preprocess

    params, meta = bundle.params, bundle.meta
    xyz_cam, rot_cam = render_mod._camera_frame_gaussians(
        params, bundle.poses.pose(0))
    view, proj, campos, tfx, tfy = render_mod._raster_common(
        float(bundle.train_data.fovx[0]), float(bundle.train_data.fovy[0]),
        dev)
    opacity = (torch.sigmoid(params.opacity)
               * per_gaussian_conf(params, meta)[:, None]
               * meta.alive[:, None])
    return preprocess(
        xyz_cam, opacity, settings, viewmatrix=view, projmatrix=proj,
        campos=campos,
        shs=torch.cat([params.features_dc, params.features_rest], 1),
        scales=torch.exp(params.scaling), rotations=rot_cam,
        tan_fovx=tfx, tan_fovy=tfy)


def phase_trainer_entry_parity(bundle, dev):
    """Kernels A, B, C against their plain versions on view 0 of the
    trainer's bundle on the entry stream: the scene of the trainer's entry
    run, where most of their launches run. Its opacities never saturate a
    tile, so every pixel walks its tile's whole list."""
    import torch
    t0 = time.perf_counter()
    with torch.no_grad():
        prep = trainer_view0_prep(bundle, bundle.settings, dev)
        results, sizes = entry_kernel_parity(prep, bundle.settings, dev)
    emit("trainer_entry_parity", seconds=time.perf_counter() - t0, **sizes,
         kernels=summary(results))
    return results


def phase_window_parity(bundle, k_probe: int, dev):
    """Kernels D, E, F against their plain versions on view 0 of the
    trainer's bundle at full size, with K from the probe."""
    import dataclasses

    import numpy as np
    import torch
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.ops.splat import binning, window_blend

    t0 = time.perf_counter()
    s = dataclasses.replace(bundle.settings, max_per_tile=k_probe,
                            entry_stream=False)
    params, meta, poses = bundle.params, bundle.meta, bundle.poses
    fovx, fovy = (float(bundle.train_data.fovx[0]),
                  float(bundle.train_data.fovy[0]))
    results = []
    with torch.no_grad():
        prep = trainer_view0_prep(bundle, s, dev)
        n = prep.depth.shape[0]

        # --- kernel F: extract_windows --------------------------------
        ks = binning._sorted_key_stream(prep, s)
        keys = binning._pad128(ks.sorted_packed,
                               ((s.n_tiles + 1) << ks.nbits) - 1,
                               extra=k_probe + 128)
        bounds = torch.searchsorted(keys, torch.arange(
            s.n_tiles + 1, dtype=torch.int64, device=dev) << ks.nbits)
        start = bounds[:-1].contiguous()
        full_count = bounds[1:] - start
        args_f = (keys, start, k_probe, ks.nbits, n)
        got = binning.extract_windows(*args_f)
        want = binning.extract_windows_plain(*args_f)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"extract_windows differs on "
                                 f"{int((got != want).sum())} slots")
        mask = (1 << ks.nbits) - 1
        win_idx = start[:, None] + torch.arange(k_probe, device=dev)
        # distinct keys the windows cover (the windows overlap)
        cover = torch.zeros(keys.numel() + 1, dtype=torch.int32, device=dev)
        cover.index_add_(0, start, torch.ones_like(start, dtype=torch.int32))
        cover.index_add_(0, torch.clamp_max(start + k_probe, keys.numel()),
                         -torch.ones_like(start, dtype=torch.int32))
        keys_read = int((torch.cumsum(cover, 0)[:-1] > 0).sum())
        nbytes = keys_read * 8 + start.numel() * 8 + got.numel() * 4
        b_ms, b_by = bound(nbytes)
        results.append(dict(
            name="extract_windows", route="cuda",
            source="das3r_tpu_torch/csrc/extract_windows.cu",
            replaces="das3r_tpu/ops/splat/binning.py:96",
            max_abs_err=0.0,
            ms=time_ms(lambda: binning.extract_windows(*args_f)),
            plain_ms=time_ms(lambda: binning.extract_windows_plain(*args_f)),
            library_ms=time_ms(lambda: torch.clamp_max(
                keys[win_idx] & mask, n - 1).to(torch.int32)),
            bound_ms=b_ms, bound_by=b_by, slots=got.numel(),
            keys_read=keys_read, bytes=nbytes))

        # --- kernel D: window_blend_forward ---------------------------
        bins = binning.bin_gaussians(prep, s)
        attr = torch.cat([prep.mean2d, prep.conic, prep.color,
                          prep.opacity[:, None]], 1)
        attrs = attr[bins.order][bins.rank].transpose(1, 2).contiguous()
        bg = torch.zeros(3, device=dev)
        args_d = (attrs, bins.count, bins.delta, bg, s)
        out = window_blend.window_forward(*args_d)
        plain = window_blend.window_forward_plain(*args_d)
        torch.cuda.synchronize()
        errs = {name: float((a - b).abs().max())
                for name, a, b in zip(("colors", "tfinal", "tin"), out,
                                      plain)}
        if not max(errs.values()) <= BLEND_TOL:
            raise AssertionError(f"window_blend_forward err {errs}")
        chunk = window_blend._pick_chunk(attrs.shape[2])
        slots, n_vis = visited_chunk_work(bins.count, bins.delta, plain[2],
                                          chunk, s.transmittance_eps)
        P = s.tile * s.tile
        evals = slots * P
        in_bytes = (n_vis * chunk * 9 * 4
                    + (bins.count.numel() + bins.delta.numel()) * 4)
        out_bytes = sum(x.numel() * 4 for x in out)
        ops_s = max(evals * BLEND_FLOP_PER_EVAL / FP32_FLOP_PER_S,
                    evals / SFU_OPS_PER_S)
        b_ms, b_by = bound(in_bytes + out_bytes, ops_s)
        results.append(dict(
            name="window_blend_forward", route="cuda",
            source="das3r_tpu_torch/csrc/window_blend_forward.cu",
            replaces="das3r_tpu/ops/splat/pallas_blend.py:145",
            max_abs_err=max(errs.values()), err_by_output=errs,
            ms=time_ms(lambda: window_blend.window_forward(*args_d)),
            plain_ms=time_ms(lambda: window_blend.window_forward_plain(
                *args_d)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            k_width=int(attrs.shape[2]), chunk=chunk, visited_chunks=n_vis,
            visited_live_slots=slots, pixel_slot_evals=evals,
            live_slots=int(bins.count.sum()),
            tile_overflow=int((full_count > k_probe).sum()),
            bytes=in_bytes + out_bytes))

        # --- kernel E: window_blend_backward --------------------------
        g = torch.as_tensor(np.random.default_rng(SEED + 8).normal(
            size=tuple(out[0].shape)).astype(np.float32), device=dev)
        args_e = (attrs, bins.count, bins.delta, bg, g, plain[1], plain[2],
                  s)
        got = window_blend.window_backward(*args_e)
        want = window_blend.window_backward_plain(*args_e)
        torch.cuda.synchronize()
        rel = {k: float((got[:, c] - want[:, c]).abs().max()
                        / want[:, c].abs().max()) for k, c in GROUPS.items()}
        if not (torch.isfinite(got).all() and max(rel.values()) <= GRAD_TOL):
            raise AssertionError(f"window_blend_backward err / max|g| {rel}")
        in_bytes += (g.numel() + plain[1].numel() + plain[2].numel()) * 4
        out_bytes = got.numel() * 4
        ops_s = max(evals * WINDOW_BWD_FLOP_PER_EVAL / FP32_FLOP_PER_S,
                    evals * WINDOW_BWD_SFU_PER_EVAL / SFU_OPS_PER_S)
        b_ms, b_by = bound(in_bytes + out_bytes, ops_s)
        results.append(dict(
            name="window_blend_backward", route="cuda",
            source="das3r_tpu_torch/csrc/window_blend_backward.cu",
            replaces="das3r_tpu/ops/splat/pallas_blend.py:220",
            max_abs_err=float((got - want).abs().max()),
            err_over_max_g=rel,
            ms=time_ms(lambda: window_blend.window_backward(*args_e)),
            plain_ms=time_ms(lambda: window_blend.window_backward_plain(
                *args_e)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            pixel_slot_evals=evals, bytes=in_bytes + out_bytes))

        # --- the window image against the entry-stream image ----------
        overflow = int((full_count > k_probe).sum())
        img_err = None
        if overflow == 0:
            imgs = [render_mod.render(
                params, meta, dataclasses.replace(s, entry_stream=es),
                poses.pose(0), bg, fovx, fovy, mode="train",
                device=dev).image for es in (False, True)]
            img_err = float((imgs[0] - imgs[1]).abs().max())
            if not img_err <= BLEND_TOL:
                raise AssertionError(f"window image differs from the entry "
                                     f"stream's by {img_err}")
    emit("window_parity", seconds=time.perf_counter() - t0, k_width=k_probe,
         max_tile_entries=int(full_count.max()), tile_overflow=overflow,
         image_err_vs_entry_stream=img_err,
         kernels=summary(results))
    return results


def _bundle_copy(bundle):
    """The bundle with its own parameters, poses and meta (the trainer
    updates them in place)."""
    import dataclasses

    def clone(group):
        return None if group is None else dataclasses.replace(group, **{
            f.name: getattr(group, f.name).detach().clone()
            for f in dataclasses.fields(group)})
    return dataclasses.replace(
        bundle, params=clone(bundle.params), meta=clone(bundle.meta),
        poses=clone(bundle.poses), test_poses=clone(bundle.test_poses))


def phase_trainer(bundle, k_probe: int, dev):
    """``train_scene`` on the entry stream and on the window path."""
    import dataclasses
    import math

    import numpy as np
    import torch
    from das3r_tpu_torch.models import densify as densify_mod
    from das3r_tpu_torch.train import checkpoint as ckpt
    from das3r_tpu_torch.train import step as step_mod
    from das3r_tpu_torch.train import trainer
    from das3r_tpu_torch.train.config import OptimizationConfig

    cfg = OptimizationConfig(iterations=TRAINER_ITERS, densify_from_iter=5,
                             densification_interval=10,
                             densify_until_iter=35, opacity_reset_interval=30)
    runs, launches = {}, {}
    want = {"entry_stream": ("extract_chunks", "blend_forward",
                             "blend_backward"),
            "window": ("extract_windows", "window_blend_forward",
                       "window_blend_backward")}
    for path, settings in (
            ("entry_stream", bundle.settings),
            ("window", dataclasses.replace(bundle.settings,
                                           entry_stream=False,
                                           max_per_tile=k_probe))):
        model = WORK / f"trainer_model_{path}"
        run_bundle = dataclasses.replace(_bundle_copy(bundle),
                                         settings=settings)
        warns, progress = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # each step, densify event and save timed (a synchronize after each)
        with _Timed(step_mod, "train_step") as steps, \
                _Timed(densify_mod, "densify_and_prune") as dens, \
                _Timed(ckpt, "save_train_state") as save_npz, \
                _Timed(ckpt, "save_scene_ply") as save_ply:
            res, counts = run_counted(lambda: trainer.train_scene(
                run_bundle, cfg, model_path=str(model), log_every=1,
                densify=True, densify_clone=True, densify_split=True,
                testing_iterations={TRAINER_ITERS},
                saving_iterations={TRAINER_ITERS},
                checkpoint_iterations={TRAINER_ITERS},
                progress=progress.append, warn=warns.append, device=dev))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[path] = counts
        losses = res.losses
        state = res.state
        finite = all(math.isfinite(x) for x in losses) and all(
            bool(torch.isfinite(getattr(state.params, f.name)).all())
            for f in dataclasses.fields(state.params))
        if not finite or len(losses) != TRAINER_ITERS:
            raise AssertionError(f"{path}: non-finite loss or parameter, or "
                                 f"{len(losses)} losses: {losses}")
        early, later = (statistics.mean(losses[0:11]),
                        statistics.mean(losses[11:22]))
        if not later < early:
            raise AssertionError(f"{path}: mean loss of iterations 12-22 "
                                 f"{later} not below 1-11 {early}")
        files = [model / "point_cloud" / f"iteration_{TRAINER_ITERS}" /
                 "point_cloud.ply",
                 model / "pose" / f"pose_{TRAINER_ITERS}.npy",
                 model / f"chkpnt{TRAINER_ITERS}.npz", model / "test_log.txt"]
        missing = [str(f) for f in files if not f.exists()]
        if missing:
            raise AssertionError(f"{path}: not written: {missing}")
        loaded, meta = ckpt.load_train_state(str(files[2]), state,
                                             meta_template=res.meta)
        flat = [ckpt._flatten_with_paths(x)
                for x in (loaded, state, meta, res.meta)]
        if not (flat[0].keys() == flat[1].keys()
                and all(np.array_equal(flat[0][k], flat[1][k])
                        for k in flat[0])
                and all(np.array_equal(flat[2][k], flat[3][k])
                        for k in flat[2])):
            raise AssertionError(f"{path}: the checkpoint reads back "
                                 "different")
        for name in want[path]:
            if counts[name] == 0:
                raise AssertionError(f"{path}: {name} never launched")
        st = res.final_settings
        step_ms = [x * 1e3 for x in steps.seconds]
        runs[path] = dict(
            seconds=seconds, ms_per_iter=seconds * 1e3 / TRAINER_ITERS,
            step_ms_median=statistics.median(step_ms[1:]), step_ms=step_ms,
            densify_seconds=dens.seconds, save_npz_seconds=save_npz.seconds,
            save_ply_seconds=save_ply.seconds,
            iters_per_sec=res.iters_per_sec, losses=losses,
            mean_loss_1_11=early, mean_loss_12_22=later,
            test_psnr=res.test_psnr, progress=progress, warnings=warns,
            alive=int(res.meta.alive.sum()),
            settings=dict(max_per_tile=st.max_per_tile,
                          max_tiles_per_gaussian=st.max_tiles_per_gaussian,
                          max_total_entries=st.max_total_entries,
                          entry_stream=st.entry_stream),
            launches=counts)
        shutil.rmtree(model, ignore_errors=True)
        # one more step of frame 0 on this path, profiled by das3r:: stage
        gt0 = torch.as_tensor(bundle.train_data.images[0], device=dev)
        fov0 = (float(bundle.train_data.fovx[0]),
                float(bundle.train_data.fovy[0]))

        def one_step(state=state, meta=res.meta, st=st):
            return step_mod.train_step(state, meta, 0, gt0, *fov0,
                                       torch.zeros(3, device=dev), st, cfg)
        one_step()
        phase_train_profile(one_step, f"trainer_{path}_step_profile")
        del res, state, loaded, run_bundle, one_step
        torch.cuda.empty_cache()
    emit("trainer", iterations=TRAINER_ITERS, runs=runs,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return launches


def main() -> int:
    t_all = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    import das3r_tpu_torch
    if Path(das3r_tpu_torch.__file__).resolve().parents[1] != ROOT:
        raise SystemExit(f"chip_smoke: das3r_tpu_torch came from "
                         f"{das3r_tpu_torch.__file__}, not from {ROOT}")
    smi = phase_device()
    import torch
    from das3r_tpu_torch.ops.splat import RasterSettings

    try:
        phase_build()
        scene, model, data = phase_scene()
        settings = RasterSettings(image_height=HEIGHT, image_width=WIDTH,
                                  sh_degree=SH_DEGREE, max_per_tile=1024,
                                  max_tiles_per_gaussian=32)
        random_scene = phase_parity(model, data, settings, "cuda")
        torch.cuda.empty_cache()
        phase_reference("cuda")
        serve = phase_main(scene, model)
        phase_profile(model, data, settings, "cuda")
        torch.cuda.empty_cache()
        train, one_step = phase_train(data, settings, "cuda")
        phase_train_profile(one_step)
        del one_step
        torch.cuda.empty_cache()
        bundle, k_probe, build = phase_trainer_scene("cuda")
        # A, B, C at the trainer scene, where most of their launches run;
        # their serving-scene numbers beside
        results = phase_trainer_entry_parity(bundle, "cuda")
        for r, r_random in zip(results, random_scene):
            r["scene"] = "trainer view 0"
            r["random_scene"] = {k: r_random[k] for k in SUMMARY_KEYS
                                 if k in r_random}
        torch.cuda.empty_cache()
        results += phase_window_parity(bundle, k_probe, "cuda")
        torch.cuda.empty_cache()
        trainer = phase_trainer(bundle, k_probe, "cuda")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    # serving runs the entry-stream forward kernels once per view and no
    # other kernel
    want = {"extract_chunks": N_FRAMES, "blend_forward": N_FRAMES}
    for kname, count in serve.items():
        if count != want.get(kname, 0):
            raise AssertionError(
                f"{kname} launched {count} times over {N_FRAMES} views")

    name, power = (x.strip() for x in smi.split(",", 1))
    for r in results:
        k = r["name"]
        r["launches_by_path"] = {
            "serve_8_views": serve[k], f"train_{TRAIN_STEPS}_steps": train[k],
            "build_scene_probe": build[k],
            f"trainer_entry_stream_{TRAINER_ITERS}_iters":
                trainer["entry_stream"][k],
            f"trainer_window_{TRAINER_ITERS}_iters": trainer["window"][k]}
        r["launches"] = sum(r["launches_by_path"].values())
        r["card"], r["power_limit"] = name, power
    emit("done", seconds=time.perf_counter() - t_all)
    print(json.dumps({"kernels": results}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
