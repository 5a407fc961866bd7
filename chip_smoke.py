#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (``das3r_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line, each raising (non-zero exit) on
failure:

1. device: needs CUDA; prints the card's name and power limit
   (``nvidia-smi``) and turns TF32 off.
2. build: compiles every kernel under ``das3r_tpu_torch/csrc`` with nvcc
   (one process per source, in parallel) into ``build/torch_ext/``.
3. scene: a synthetic 8-frame stage-1 scene at 288x512, rearranged, plus
   a 1.5M-Gaussian SH-degree-3 scene from a seed, written as the trained
   checkpoint (PLY + stage-1 w2c poses) that the render tool loads.
4. parity: for view 0 at full size, each kernel against its plain PyTorch
   version on the card (``extract_chunks`` bitwise, ``blend_forward``
   within 2e-4), with CUDA-event times of kernel, plain version and the
   library call that computes the same function (where one exists), and
   each kernel's bound from the bytes and operations of this run.
5. reference: a small scene rendered on the card equals the port's CPU
   render (plain versions, held against JAX and the f64 oracle by
   ``tests/test_torch_*.py``) within 2e-4.
6. main: ``das3r_tpu_torch.eval.render_tool.render_sets`` renders all 8
   views on ``cuda``; checks 8 finite, non-constant PNGs, no dropped
   entry, and that every kernel launched once per view.
7. profile: one more render of view 1 under ``torch.profiler``: the
   device time by kernel, the host time by operator, and the device's
   idle share of the render's wall time.

Then the ``kernels`` line, the ``nvidia-smi`` line, and last the device
line. Everything it writes lives under ``build/`` and is removed at exit.
The package is imported from this script's own checkout, so the script
fails, having printed nothing, when it stands alone.
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


def phase_build():
    from das3r_tpu_torch.ops.splat import kernels
    t0 = time.perf_counter()
    built = kernels.build_all()
    ptxas = {name: [ln.strip() for ln in b["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, b in built.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)


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


def view0_stream(model: Path, data, settings, dev):
    """Preprocess and bin view 0 of the checkpoint as ``render`` does."""
    import numpy as np
    import torch
    from das3r_tpu_torch.eval.render_tool import load_gaussians_ply
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.ops.splat import binning
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
    prep = preprocess(
        xyz_cam, opacity, settings, viewmatrix=view, projmatrix=proj,
        campos=campos,
        shs=torch.cat([params.features_dc, params.features_rest], 1),
        scales=torch.exp(params.scaling), rotations=rot_cam,
        tan_fovx=tfx, tan_fovy=tfy)
    es = binning.bin_entry_stream(prep, settings)
    attr = torch.cat([prep.mean2d, prep.conic, prep.color,
                      prep.opacity[:, None]], 1)
    table = torch.cat([attr[es.order], torch.zeros_like(attr[:1])])
    return prep, es, table.contiguous()


def phase_parity(model: Path, data, settings, dev):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from das3r_tpu_torch.ops.splat import binning, entry_blend

    t0 = time.perf_counter()
    prep, es, table = view0_stream(model, data, settings, dev)
    n = prep.depth.shape[0]
    ks = binning._sorted_key_stream(prep, settings)
    keys = ks.sorted_packed
    results = []

    # --- kernel A: extract_chunks -------------------------------------
    lay = binning.chunk_layout(keys, ks.nbits, settings)
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
    need = plain.n_eval.amax(1)
    tiles = torch.repeat_interleave(torch.arange(need.numel(), device=dev),
                                    need)
    first = torch.cumsum(need, 0) - need
    slots = (es.astart.long()[tiles] + torch.arange(tiles.numel(), device=dev)
             - first[tiles])
    rows = int(torch.unique(es.rank[slots]).numel())
    nbytes = (slots.numel() * 4 + rows * entry_blend.N_ATTR * 4
              + es.astart.numel() * 4 + es.count.numel() * 4
              + cpre.numel() * 4 + tfinal.numel() * 4)
    ops_s = max(n_eval * BLEND_FLOP_PER_EVAL / FP32_FLOP_PER_S,
                n_eval / SFU_OPS_PER_S)
    b_ms, b_by = bound(nbytes, ops_s)
    results.append(dict(
        name="blend_forward", route="cuda",
        source="das3r_tpu_torch/csrc/blend_forward.cu",
        replaces="das3r_tpu/ops/splat/entry_blend.py:145",
        max_abs_err=max_err, mean_abs_err=mean_err,
        ms=time_ms(lambda: entry_blend.blend_forward(
            table, es.rank, es.astart, es.count, settings)),
        plain_ms=time_ms(lambda: entry_blend.blend_forward_plain(
            table, es.rank, es.astart, es.count, settings)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        entries=live, entries_needed=slots.numel(),
        pixel_entry_evals=n_eval,
        evals_if_no_saturation=live * settings.tile * settings.tile,
        chunks_skipped=plain.chunks_skipped, bytes=nbytes))
    emit("parity", seconds=time.perf_counter() - t0, n_gaussians=n,
         entries=live, stream_slots=es.rank.numel(),
         max_tile_entries=int(es.count.max()),
         kernels={r["name"]: {k: r[k] for k in
                              ("max_abs_err", "ms", "plain_ms",
                               "library_ms", "bound_ms")}
                  for r in results})
    return results


def phase_reference(dev):
    """Small scene: the card's render equals the port's CPU render."""
    import numpy as np
    import torch
    from das3r_tpu_torch.data import synthetic
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.ops.splat import RasterSettings

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
    emit("reference", seconds=time.perf_counter() - t0, max_abs_err=err,
         shape=list(imgs[dev].shape))


def phase_main(scene: Path, model: Path, device=None):
    """The render tool over every view; returns each kernel's launches."""
    import numpy as np
    from PIL import Image
    from das3r_tpu_torch.eval import render_tool
    from das3r_tpu_torch.ops.splat import binning, entry_blend

    counted = {"extract_chunks": binning.extract_chunks,
               "blend_forward": entry_blend.blend_forward}
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
        results = phase_parity(model, data, settings, "cuda")
        torch.cuda.empty_cache()
        phase_reference("cuda")
        launches = phase_main(scene, model)
        phase_profile(model, data, settings, "cuda")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    for kname, count in launches.items():
        if count != N_FRAMES:
            raise AssertionError(
                f"{kname} launched {count} times over {N_FRAMES} views")

    name, power = (x.strip() for x in smi.split(",", 1))
    for r in results:
        r["launches"] = launches[r["name"]]
        r["launches_per_view"] = launches[r["name"]] / N_FRAMES
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
