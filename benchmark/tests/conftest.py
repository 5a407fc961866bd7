"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data
files under a temporary directory, its configurations cut to a size the
CPU runs in seconds (the drivers, references and readers are the
benchmark's own)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
BENCH = ROOT / "benchmark"

TINY_SPLAT = dict(frames=10, height=32, width=64, max_points=3000)
TINY_MODEL = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4,
                  dec_embed_dim=32, dec_depth=4, dec_num_heads=2)


def _edit(path: Path, **changes) -> None:
    d = json.loads(path.read_text())
    for k, v in changes.items():
        if isinstance(v, dict):
            d[k].update(v)
        else:
            d[k] = v
    path.write_text(json.dumps(d))


@pytest.fixture
def tiny_bench(tmp_path) -> Path:
    return tiny_copy(tmp_path / "bench")


def tiny_copy(b: Path) -> Path:
    """The benchmark's data files and drivers under ``b``, cut to size."""
    for sub in ("configs", "traffic", "limits", "drivers", "metrics"):
        shutil.copytree(BENCH / sub, b / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    _edit(b / "configs" / "davis50_288x512_1p5m.json", **TINY_SPLAT)
    _edit(b / "configs" / "dust3r_vitl_dpt512.json", height=32, width=64,
          model=TINY_MODEL)
    _edit(b / "traffic" / "orbit_render.json", views_per_orbit=8,
          check_views=2, warmup_views=1)
    _edit(b / "traffic" / "video_pairs.json", clip_frames=4, check_pairs=3,
          decode_batch=3, encode_batch=2, clips_in_pool=2)
    _edit(b / "traffic" / "finetune_dp4.json", ranks=2, pairs_per_rank=2,
          pool_pairs=8)
    return b


@pytest.fixture
def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cell(spec: dict, workload: str, bench: Path):
    from benchmark import harness
    return harness.Cell(spec, workload, bench=bench)
