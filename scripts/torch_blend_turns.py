#!/usr/bin/env python3
"""Kernels B and C of this tree against those of an older tree of the
PyTorch port, on one card, in turns.

    mkdir -p build/old && git archive <commit> das3r_tpu_torch/csrc \\
        | tar -x -C build/old
    python3 scripts/torch_blend_turns.py --old build/old/das3r_tpu_torch/csrc

On view 0 of ``chip_smoke.py``'s trainer scene (built as its
``trainer_scene`` phase builds it, ~90 s of k-NN), both trees' whole-image
launches on the same inputs: B's outputs (cpre, tfinal and, in training,
n_last) must be bitwise equal, and C's ``g_table`` within 2e-5 x max|g| per
column group (its atomics add in an order that changes from run to run);
then each kernel's device time (``chip_smoke.device_ms``, the kernel alone
in ``torch.profiler``, median of 10) in turns old, new, new, old. Prints
one JSON line and exits non-zero on a failed check. The older sources'
launch functions are those before the tile-range argument: this tree's
signatures without ``tile0``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("blend_forward", "blend_backward")


def build_old(csrc: Path, out: Path) -> dict:
    """The older tree's B and C, built as this tree's are, typed with
    this tree's signatures less ``tile0`` (the sixth argument)."""
    from das3r_tpu_torch.ops.splat import kernels
    out.mkdir(parents=True, exist_ok=True)
    fns = {}
    for name in NAMES:
        lib = out / f"lib{name}_old.so"
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                        str(csrc), "-o", str(lib), str(csrc / f"{name}.cu")],
                       check=True, capture_output=True)
        fn = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
        sig = list(kernels.SIGNATURES[name])
        del sig[5]
        fn.argtypes, fn.restype = sig, ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="the older tree's das3r_tpu_torch/csrc")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from das3r_tpu_torch.ops.splat import binning, entry_blend, kernels

    smi = cs.phase_device()
    cs.phase_build()
    old = build_old(args.old, ROOT / "build" / "old_turns")
    if cs.WORK.exists():
        raise SystemExit(f"{cs.WORK} exists: another run's work directory")
    try:
        bundle = cs.phase_trainer_scene("cuda")[0]
        s = bundle.settings
        with torch.no_grad():
            prep = cs.trainer_view0_prep(bundle, s, "cuda")
        del bundle
    finally:
        import shutil
        shutil.rmtree(cs.WORK, ignore_errors=True)
    es = binning.bin_entry_stream(prep, s)
    attr = torch.cat([prep.mean2d, prep.conic, prep.color,
                      prep.opacity[:, None]], 1)
    table = torch.cat([attr[es.order], torch.zeros_like(attr[:1])]
                      ).contiguous()
    n_tiles, P = s.n_tiles, s.tile * s.tile
    gen = np.random.default_rng(cs.SEED + 4)
    g_cpre = torch.as_tensor(gen.normal(size=(n_tiles, 3, P)).astype(
        np.float32), device="cuda")
    g_tfinal = torch.as_tensor(gen.normal(size=(n_tiles, 1, P)).astype(
        np.float32), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    head = (table.data_ptr(), es.rank.data_ptr(), es.astart.data_ptr(),
            es.count.data_ptr(), n_tiles)

    def fwd(tree: str, n_last: bool):
        cpre = torch.empty(n_tiles, 3, P, device="cuda")
        tfinal = torch.empty(n_tiles, 1, P, device="cuda")
        nl = (torch.empty(n_tiles, P, dtype=torch.int32, device="cuda")
              if n_last else None)
        tail = (s.tiles_x, s.alpha_clip, s.alpha_floor, s.transmittance_eps,
                cpre.data_ptr(), tfinal.data_ptr(),
                None if nl is None else nl.data_ptr())
        if tree == "new":
            kernels.launch("blend_forward", *head, 0, *tail)
        elif old["blend_forward"](*head, *tail, stream) != 0:
            raise RuntimeError("the older blend_forward did not launch")
        return cpre, tfinal, nl

    _, tfinal, n_last = fwd("new", True)

    def bwd(tree: str):
        g = torch.zeros_like(table)
        tail = (s.tiles_x, s.alpha_clip, s.alpha_floor, tfinal.data_ptr(),
                n_last.data_ptr(), g_cpre.data_ptr(), g_tfinal.data_ptr(),
                g.data_ptr())
        if tree == "new":
            kernels.launch("blend_backward", *head, 0, *tail)
        elif old["blend_backward"](*head, *tail, stream) != 0:
            raise RuntimeError("the older blend_backward did not launch")
        return g

    report = dict(scene="trainer view 0", n_tiles=n_tiles,
                  entries=int(es.count.sum()), card=smi)
    for n_last_on in (False, True):
        a, b = fwd("old", n_last_on), fwd("new", n_last_on)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)
        report[f"b_{'train' if n_last_on else 'serve'}_bitwise"] = same
    g_old, g_new = bwd("old"), bwd("new")
    torch.cuda.synchronize()
    rel = {k: float((g_new[:, c] - g_old[:, c]).abs().max()
                    / g_old[:, c].abs().max()) for k, c in cs.GROUPS.items()}
    report["c_err_over_max_g"] = rel
    cases = {"b_serve": (lambda t: fwd(t, False), "blend_forward_kernel"),
             "b_train": (lambda t: fwd(t, True), "blend_forward_kernel"),
             "c": (bwd, "blend_backward_kernel")}
    for key, (fn, kname) in cases.items():
        turns = [cs.device_ms(lambda t=t: fn(t), kname)["device_ms"]
                 for t in ("old", "new", "new", "old")]
        report[f"{key}_device_ms_old_new_new_old"] = turns
        report[f"{key}_new_over_old"] = (turns[1] + turns[2]) / (
            turns[0] + turns[3])
    print(json.dumps(report), flush=True)
    ok = (report["b_serve_bitwise"] and report["b_train_bitwise"]
          and max(rel.values()) <= cs.GRAD_TOL)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
