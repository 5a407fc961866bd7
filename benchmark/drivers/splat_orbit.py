"""Serving traffic: one viewer orbiting a trained scene. Views go one at
a time along an ellipse through the train cameras' plane, each looking
at the scene; a view is sent (``models.render.render``, mode 'test' with
the per-Gaussian confidence a trained PLY carries, at the render tool's
settings: ``max_per_tile`` 1024, the unprobed duplication table, a
stream sized per render), its image copied to the host, and only then is
the next one sent (a closed loop). ``render_p95_ms`` is the 95th
percentile of all the window's views, each from its send until its image
is on the host.

The images of ``check_views`` views drawn from the seed, at their first
render in the window, are held against the reference's render of the
scene as it was made.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time

import torch

from benchmark import outcome as oc
from benchmark import scene as scene_mod
from benchmark import splat_program
from benchmark.reference import splat as ref
from benchmark.work import splat as work

STAGES = ("das3r::preprocess", "das3r::bin_entry_stream", "das3r::blend",
          "das3r::assemble")


def settings_of(cfg: dict, tr: dict, sc):
    from das3r_tpu_torch.ops.splat import RasterSettings
    return RasterSettings(image_height=sc.height, image_width=sc.width,
                          sh_degree=cfg["sh_degree"],
                          max_per_tile=tr["max_per_tile"],
                          max_tiles_per_gaussian=tr["max_tiles_per_gaussian"])


def p95(xs: list[float]) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(xs)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def run(cell, seed: int, seconds: float, trace: bool, dev,
        clock: oc.Clock, variant: str | None = None) -> oc.Outcome:
    from das3r_tpu_torch.models import render as render_mod

    cfg, tr = cell.config, cell.traffic
    sc = scene_mod.make_scene(cfg, seed, dev)
    params, meta, _ = splat_program.program_state(sc, dev)
    conf = sc.params["conf_static"].reshape(-1)[sc.pix_id].clone()
    settings = settings_of(cfg, tr, sc)
    if variant == "control":
        settings = dataclasses.replace(settings, table_bf16=True)
    n_views = tr["views_per_orbit"]
    poses = scene_mod.orbit(sc, n_views, tr["widen"])
    bg = torch.tensor(tr["bg"], device=dev)
    fovx, fovy = sc.fovx, sc.fovy
    gt_scale = (sc.height, sc.width)
    del sc
    oc.free(dev)

    def view(v: int):
        with torch.no_grad():
            out = render_mod.render(params, meta, settings, poses[v], bg,
                                    fovx, fovy, mode=tr["mode"],
                                    conf_per_gaussian=conf, device=dev)
        return out.image.cpu(), out.aux

    for v in range(tr["warmup_views"]):
        view(v)
    checked = sorted(random.Random(seed).sample(range(n_views),
                                                tr["check_views"]))
    kept = {}
    guards = []
    lat = []

    def send(v: int):
        t_send = time.perf_counter()
        img, aux = view(v % n_views)
        lat.append((time.perf_counter() - t_send) * 1e3)
        guards.append(aux.entry_overflow + aux.dup_overflow
                      + aux.tile_overflow)
        if v < n_views and v in checked:
            kept[v] = img

    oc.sync(dev)
    setup_s = clock.now()
    v = 0
    if trace:
        def unit():
            nonlocal v
            for _ in range(n_views):
                send(v)
                v += 1
        tr_, _ = oc.traced(dev, unit, stages=STAGES)
    else:
        t0 = time.perf_counter()
        while v < n_views or time.perf_counter() - t0 < seconds:
            send(v)
            v += 1
    failed = int((torch.stack(guards) > 0).sum()) + sum(
        int(not torch.isfinite(i).all()) for i in kept.values())
    peak = oc.peak_bytes(dev)
    del params, meta, conf
    oc.free(dev)

    checks = {"image_gap": _reference_gap(cell, seed, dev, poses, kept,
                                          fovx, fovy, bg)}
    out = oc.Outcome(e2e={"render_p95_ms": p95(lat), "setup_s": setup_s},
                     attempted=v, failed=failed, checks=checks,
                     memory_peak_bytes=peak, units=n_views)
    if trace:
        out.trace = tr_
        out.work = _work(cell, seed, dev, poses, n_views, gt_scale)
    return out


def _reference_gap(cell, seed, dev, poses, kept, fovx, fovy, bg) -> float:
    """The worst relative L2 gap of a checked view's image from the
    reference's: ||program - reference|| / ||reference||."""
    cfg = cell.config
    oc.reference_precision()
    sc = scene_mod.make_scene(cfg, seed, dev)
    conf = sc.params["conf_static"].reshape(-1)[sc.pix_id]
    opacity = torch.sigmoid(sc.params["opacity"][:, 0]) * conf
    worst = 0.0
    with torch.no_grad():
        for v, img in kept.items():
            r = ref.render(sc.params, opacity, poses[v], fovx, fovy,
                           sc.height, sc.width, cfg["sh_degree"], bg,
                           grad=False).image.cpu()
            gap = float((img - r).norm() / r.norm())
            worst = max(worst, gap if math.isfinite(gap) else math.inf)
    del sc
    oc.free(dev)
    return worst


def _work(cell, seed, dev, poses, n_rendered, hw) -> dict:
    """Frozen counts of the traced views (every orbit view, in turn)."""
    cfg, tr = cell.config, cell.traffic
    sc = scene_mod.make_scene(cfg, seed, dev)
    conf = sc.params["conf_static"].reshape(-1)[sc.pix_id]
    opacity = torch.sigmoid(sc.params["opacity"][:, 0]) * conf
    per = splat_program.view_work(sc, sc.params, opacity, poses,
                                  cfg["sh_degree"],
                                  torch.tensor(tr["bg"], device=dev))
    tiles = -(-hw[0] // 16) * -(-hw[1] // 16)
    n = sc.params["xyz"].shape[0]
    seq = [per[i % len(per)] for i in range(n_rendered)]
    fw = [work.blend_forward(p, tiles, train=False) for p in seq]
    return {"B_flop": sum(f for f, _ in fw), "B_bytes": sum(b for _, b in fw),
            "step_flop": sum(work.render_flop(p, n, cfg["sh_degree"])
                              for p in seq)}
