"""The frozen work counts: the reference's per-pixel evaluation count
against a scalar walk of each pixel's list, and stage 1's operation
formulas against ``torch.utils.flop_counter`` on the reference model."""
from __future__ import annotations

import json
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import scene as scene_mod
from benchmark.reference import dust3r_model as ref_model
from benchmark.reference import splat as ref
from benchmark.tests.conftest import TINY_MODEL
from benchmark.work import dust3r as work_d
from benchmark.work import splat as work_s


def test_blend_evaluations_match_a_scalar_walk(tiny_bench):
    cfg = json.loads((tiny_bench / "configs"
                      / "davis50_288x512_1p5m.json").read_text())
    sc = scene_mod.make_scene(cfg, 5, "cpu")
    conf = sc.params["conf_static"].reshape(-1)[sc.pix_id]
    opacity = torch.sigmoid(sc.params["opacity"][:, 0]) * conf
    pose = sc.poses[3]
    H, W = sc.height, sc.width
    s = ref.project(sc.params, opacity, pose, sc.fovx, sc.fovy, H, W, 3)
    bins = ref.bin_tiles(s, W, H)
    r = ref.render(sc.params, opacity, pose, sc.fovx, sc.fovy, H, W, 3,
                   torch.zeros(3), grad=False)
    t = s.table.detach().double().tolist()
    gauss, start, count = (bins.gauss.tolist(), bins.start.tolist(),
                           bins.count.tolist())
    tiles_x = -(-W // 16)
    walked = torch.zeros(H, W, dtype=torch.long)
    for py in range(H):
        for px in range(W):
            tile = (py // 16) * tiles_x + px // 16
            a = start[tile]
            T, n = 1.0, 0
            for g in gauss[a:a + count[tile]]:
                if T < ref.T_EPS:
                    break
                n += 1
                mx, my, cxx, cxy, cyy, _, _, _, op = t[g]
                dx, dy = mx - px, my - py
                power = -0.5 * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy
                alpha = min(ref.ALPHA_CLIP, op * math.exp(power))
                if power <= 0 and alpha >= ref.ALPHA_FLOOR:
                    T *= 1 - alpha
            walked[py, px] = n
    assert int(walked.sum()) > 0
    # float32 against float64 transmittances may end a walk one entry
    # apart at the cutoff
    assert int((walked - r.n_eval).abs().max()) <= 1
    assert abs(int(walked.sum()) - int(r.n_eval.sum())) <= 1e-3 * int(
        walked.sum())
    v = {"evals": int(r.n_eval.sum()), "entries": r.entries,
         "binnable": r.binnable}
    f, b = work_s.blend_forward(v, bins.count.numel(), train=False)
    assert f == 15 * v["evals"] and b > 36 * v["binnable"]


def _counted(cfg, h, w):
    with torch.device("meta"):
        model = ref_model.AsymmetricCroCo3D(cfg)
        img = torch.zeros(1, 3, h, w)
        with FlopCounterMode(display=False) as enc:
            f, pos = model.encode(img)
        with FlopCounterMode(display=False) as dec:
            model.decode(f, pos, f, pos, h, w)
    return enc.get_total_flops(), dec.get_total_flops()


def test_stage1_formulas_match_the_flop_counter():
    large = dict(patch_size=16, enc_embed_dim=1024, enc_depth=24,
                 enc_num_heads=16, dec_embed_dim=768, dec_depth=12,
                 dec_num_heads=12, mlp_ratio=4.0)
    tiny = dict(patch_size=16, mlp_ratio=4.0, **TINY_MODEL)
    for m, (h, w) in ((large, (288, 512)), (tiny, (32, 64)),
                      (tiny, (48, 80))):
        enc, dec = _counted(ref_model.Dust3rConfig(**m), h, w)
        assert work_d.encode_flop(m, h, w) == enc
        assert work_d.decode_flop(m, h, w) == dec


def test_preprocess_count_follows_the_active_sh_degree():
    # degree 3 keeps the count of every band: geometry 241, basis 40,
    # 16 x 3 multiply-adds
    assert work_s.preprocess_flop(3) == 377
    assert [work_s.preprocess_flop(d) for d in range(4)] == sorted(
        {work_s.preprocess_flop(d) for d in range(4)})
    v = {"evals": 1000, "entries": 10, "binnable": 5}
    assert (work_s.train_step_flop(v, 7, 11, 13, 3)
            - work_s.train_step_flop(v, 7, 11, 13, 0)
            == 3 * 7 * (377 - work_s.preprocess_flop(0)))
