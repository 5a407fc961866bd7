"""Video traffic for stage 1: back-to-back clips, each through the
runner's pair inference (``das3r_tpu_torch.predictor.inference.
run_pairs``: every frame encoded once, ``encode_batch`` frames a call,
then the decoder and heads over ``decode_batch`` pairs a call, every
batch's maps copied to the host) over the runner's default scene graph,
symmetrised. One client, a clip after the last (a closed loop); the
window ends with the clip that crosses ``seconds``, and
``stage1_pairs_per_s`` is its pairs over its length.

Set-up makes the weights and a pool of clips from the seed, loads the
weights into the port's model and runs one clip's shapes (both encode
batches, a full and the last short decode batch). After the window the
model is freed and the reference (a frozen copy of the model code,
``benchmark/reference/dust3r_model.py``) recomputes ``check_pairs``
pairs of the first clip, drawn from the seed, from the same weights and
frames.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import outcome as oc
from benchmark import stage1_inputs as inputs
from benchmark.reference import dust3r_model as ref_model
from benchmark.work import dust3r as work

MAPS = (("pts3d", "pred_i", "pred_j"), ("conf", "conf_i", "conf_j"),
        ("mask", "mask_i", "mask_j"))


def _program_model(cfg: dict, seed: int, dev):
    from das3r_tpu_torch.models.croco import dust3r
    m = cfg["model"]
    pcfg = dust3r.Dust3rConfig(**{k: m[k] for k in (
        "patch_size", "enc_embed_dim", "enc_depth", "enc_num_heads",
        "dec_embed_dim", "dec_depth", "dec_num_heads", "mlp_ratio",
        "rope_base", "conf_vmin", "head_type")})
    with torch.device("meta"):
        model = dust3r.AsymmetricCroCo3D(pcfg)
    model.load_state_dict(inputs.weights(cfg, seed, dev), assign=True)
    return model.eval()


class _Spans:
    """The benchmark's own ranges around the model's encode and decode,
    set on the instance in traced runs only."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        m = self.model
        enc, dec = m.encode, m.decode

        def encode(*a, **k):
            with record_function("bench::encode"):
                return enc(*a, **k)

        def decode(*a, **k):
            with record_function("bench::decode"):
                return dec(*a, **k)
        m.encode, m.decode = encode, decode
        return self

    def __exit__(self, *exc):
        del self.model.encode, self.model.decode


def run(cell, seed: int, seconds: float, trace: bool, dev,
        clock: oc.Clock, variant: str | None = None) -> oc.Outcome:
    from das3r_tpu_torch.predictor import inference
    from das3r_tpu_torch.utils.device import resolve_device

    cfg, tr = cell.config, cell.traffic
    resolve_device(dev)             # the port's entry: TF32 off
    model = _program_model(cfg, seed, dev)
    F = tr["clip_frames"]
    edges = inputs.scene_graph(F, tr["graph_window"], tr["graph_stride"])
    pool = [inputs.clip(cfg, seed, k, F, dev).cpu().numpy()
            for k in range(tr["clips_in_pool"])]
    batches = dict(encode_batch=tr["encode_batch"],
                   decode_batch=tr["decode_batch"])
    last = len(edges) % tr["decode_batch"] or tr["decode_batch"]
    inference.run_pairs(model, pool[0], edges[:tr["decode_batch"] + last],
                        **batches)
    checked = sorted(random.Random(seed).sample(range(len(edges)),
                                                tr["check_pairs"]))
    kept = None
    clips = 0

    def unit():
        nonlocal kept, clips
        preds = inference.run_pairs(model, pool[clips % len(pool)], edges,
                                    **batches)
        if clips == 0:
            kept = {name: np.stack([getattr(preds, a)[checked],
                                    getattr(preds, b)[checked]])
                    for name, a, b in MAPS}
        clips += 1

    oc.sync(dev)
    setup_s = clock.now()
    if trace:
        with _Spans(model):
            tr_, _ = oc.traced(dev, unit,
                               spans=("bench::encode", "bench::decode"))
        window_s = tr_.window_s
    else:
        t0 = time.perf_counter()
        while True:
            unit()
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    pairs = clips * len(edges)
    bad = np.zeros(len(checked), bool)
    for v in kept.values():
        bad |= ~np.isfinite(v.reshape(2, len(checked), -1)).all(axis=(0, 2))
    failed = int(bad.sum())
    peak = oc.peak_bytes(dev)
    del model
    oc.free(dev)

    checks = _reference_check(cfg, seed, dev, F, edges, checked, kept,
                              control=variant == "control")
    out = oc.Outcome(e2e={"stage1_pairs_per_s": pairs / window_s,
                          "setup_s": setup_s},
                     attempted=pairs, failed=failed, checks=checks,
                     memory_peak_bytes=peak,
                     units=len(edges) if trace else pairs)
    if trace:
        out.trace = tr_
        m = dict(cfg["model"])
        out.work = {"frames": F,
                    "step_flop": (
                        F * work.encode_flop(m, cfg["height"], cfg["width"])
                        + len(edges) * work.decode_flop(
                            m, cfg["height"], cfg["width"]))}
    return out


@torch.no_grad()
def reference_maps(cfg, seed, dev, F, edges, checked) -> dict:
    """The reference's maps of the checked pairs of clip 0, stacked as
    the program's are kept: {name: [2 sides, pairs, H, W(, 3)]}."""
    with torch.device("meta"):
        model = ref_model.AsymmetricCroCo3D(inputs.model_config(cfg))
    model.load_state_dict(inputs.weights(cfg, seed, dev), assign=True)
    model.eval()
    imgs = (inputs.clip(cfg, seed, 0, F, dev) - 0.5) / 0.5
    H, W = cfg["height"], cfg["width"]
    tokens = {}

    def enc(i):
        if i not in tokens:
            tokens[i] = model.encode(imgs[i:i + 1])
        return tokens[i]

    got = {name: ([], []) for name, _, _ in MAPS}
    for e in checked:
        i, j = edges[e]
        r1, r2 = model.decode(*enc(i), *enc(j), H, W)
        for (name, _, _), (a, b) in zip(MAPS, (
                (r1["pts3d"], r2["pts3d_in_other_view"]),
                (r1["conf"], r2["conf"]),
                (r1["dynamic_mask"], r2["dynamic_mask"]))):
            got[name][0].append(a[0].cpu().numpy())
            got[name][1].append(b[0].cpu().numpy())
    del model, tokens
    oc.free(dev)
    return {k: np.stack([np.stack(s0), np.stack(s1)])
            for k, (s0, s1) in got.items()}


def _reference_check(cfg, seed, dev, F, edges, checked, kept,
                     control: bool) -> dict:
    """Per map kind, the worst relative L2 gap ||program - reference|| /
    ||reference|| over the checked pairs and both views. The control
    puts the reference computed with TF32 in the program's place."""
    oc.reference_precision()
    truth = reference_maps(cfg, seed, dev, F, edges, checked)
    if control:
        oc.reference_precision(tf32=True)
        kept = reference_maps(cfg, seed, dev, F, edges, checked)
        oc.reference_precision()
    out = {}
    for name, _, _ in MAPS:
        p = kept[name].reshape(2, len(checked), -1).astype(np.float64)
        r = truth[name].reshape(2, len(checked), -1).astype(np.float64)
        gaps = np.linalg.norm(p - r, axis=2) / np.linalg.norm(r, axis=2)
        out[f"{name}_gap"] = float(np.max(np.where(np.isfinite(gaps), gaps,
                                                   np.inf)))
    return out
