"""Build, load and launch the port's CUDA kernels (``das3r_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. No source
includes PyTorch's headers, so a build takes seconds, not minutes. All
kernels are built together, one ``nvcc`` process per source started at
once, at the first launch of any of them, into ``build/torch_ext/`` at the
root of the checkout. A library's file name carries a hash of its source,
of every shared header (``csrc/*.cuh``) and of the flags, so an edited
source or header is rebuilt and a stale library never loads.

Every launch function takes the device pointers, the sizes and the CUDA
stream, launches on that stream without synchronising, and returns
``cudaGetLastError()``; ``launch`` raises when it is not 0 and counts each
launch under ``launch/<name>`` (``utils/trace.counters()``). A kernel is
named by its launch function; a source may define more than one
(``VARIANTS``: the bf16-table forms of B and C live in the sources of their
f32 forms, and ``dup_count`` and ``dup_emit`` in ``dup_keys.cu``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from das3r_tpu_torch.utils import trace

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C signature of each kernel's launch function (stream last).
SIGNATURES = {
    # keys, src0, nlive, n_chunks, nbits, n, rank_out, stream
    "extract_chunks": (_P, _P, _P, _L, _I, _I, _P, _P),
    # table, rank, astart, count, n_tiles, tile0, tiles_x, alpha_clip,
    # alpha_floor, eps, cpre_out, tfinal_out, n_last_out (may be NULL),
    # stream
    "blend_forward": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P, _P,
                      _P),
    # table, rank, astart, count, n_tiles, tile0, tiles_x, alpha_clip,
    # alpha_floor, tfinal, n_last, g_cpre, g_tfinal, g_table_out, stream
    "blend_backward": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P,
                       _P, _P),
    # keys, n_keys, start, n_tiles, k_cap, nbits, n, rank_out, stream
    "extract_windows": (_P, _L, _P, _I, _I, _I, _I, _P, _P),
    # attrs, count, delta, bg, n_tiles, K, chunk, tile0, tiles_x,
    # alpha_clip, alpha_floor, eps, colors_out, tfinal_out, tin_out, stream
    "window_blend_forward": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                             _F, _P, _P, _P, _P),
    # attrs, count, delta, bg, g_colors, tfinal, tin, n_tiles, K, chunk,
    # tile0, tiles_x, alpha_clip, alpha_floor, eps, g_attrs_out, stream
    "window_blend_backward": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _F, _F, _F, _P, _P),
    # order, rect_min, rect_max, ntt, binnable, mean2d, conic, q_cap, h_pos
    # (may be NULL), n, d_cap, light, heavy_cap, tiles_x, tile, tight,
    # counts_out, stream
    "dup_count": (_P,) * 9 + (_I,) * 7 + (_P, _P),
    # dup_count's arguments up to tight, then counts, incl, nbits,
    # keys_out, stream
    "dup_emit": (_P,) * 9 + (_I,) * 7 + (_P, _P, _I, _P, _P),
}
# launch functions defined in another source: name -> source
VARIANTS = {"blend_forward_bf16": "blend_forward",
            "blend_backward_bf16": "blend_backward",
            "dup_count": "dup_keys", "dup_emit": "dup_keys"}
# the bf16 forms take the f32 forms' arguments (the table is [M, 11] bf16)
SIGNATURES.update({k + "_bf16": SIGNATURES[k]
                   for k in ("blend_forward", "blend_backward")})

_loaded: dict[str, ctypes.CDLL] = {}
# each kernel's ``<name>_launch``, resolved and typed once
_launchers: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source(name: str) -> str:
    """The ``csrc/<source>.cu`` that defines kernel ``name``."""
    return VARIANTS.get(name, name)


def _lib_path(name: str) -> Path:
    name = source(name)
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, dict]:
    """Compile every kernel whose library is missing, all in parallel.
    Returns {name: {"path", "seconds", "log"}} (log: nvcc's ptxas
    register/shared-memory report, empty when the library was cached)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs, out = {}, {}
    for name in sorted({source(k) for k in SIGNATURES}):
        path = _lib_path(name)
        out[name] = {"path": str(path), "seconds": 0.0, "log": ""}
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, path)
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, path)
        out[name].update(seconds=time.perf_counter() - t0, log=log)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (its source's)."""
    if name not in _loaded:
        build_all()
        for kname, argtypes in SIGNATURES.items():
            lib = ctypes.CDLL(str(_lib_path(kname)))
            fn = getattr(lib, f"{kname}_launch")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[kname] = lib
            _launchers[kname] = fn
    return _loaded[name]


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current CUDA stream; raise on a
    launch error (a refused launch never runs and synchronize() would
    not report it)."""
    if name not in _launchers:
        library(name)
    err = _launchers[name](*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    trace.count("launch/" + name)


def check(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int,
          device: torch.device | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` with
    ``ndim`` dimensions (on ``device`` when given)."""
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{what} must be on {device or 'cuda'}, "
                         f"not {t.device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{what} must be {ndim}-D {dtype}, got "
                         f"{t.dim()}-D {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
