"""The harness: the contract's shape of BENCHMARK.json, files found by
name (a configuration, a traffic mix and a metric added as new files),
the result line, the judgement, and the import rules by whole top-level
module name."""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import BENCH, ROOT, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_has_the_contract_shape(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    cells = [w["name"] for w in spec["workloads"]]
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    assert {w["config"] for w in spec["workloads"]} == set(names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert len(c["why"]) <= 200 and "\n" not in c["why"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(cells)
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for w in cells:
        cell = harness.Cell(spec, w)
        assert cell.per_layer() and len(cell.end_to_end()) >= 2


def test_a_new_config_traffic_and_metric_are_found_by_name(
        spec, tiny_bench):
    (tiny_bench / "configs" / "wall_small.json").write_text(
        (tiny_bench / "configs" / "davis50_288x512_1p5m.json").read_text())
    t = json.loads((tiny_bench / "traffic" / "orbit_render.json")
                   .read_text())
    t["widen"] = 1.2
    (tiny_bench / "traffic" / "close_orbit.json").write_text(json.dumps(t))
    (tiny_bench / "limits" / "wall_small.close_orbit.json").write_text(
        json.dumps({"image_gap": 1e-3}))
    (tiny_bench / "metrics" / "views_traced.render.py").write_text(
        "def read(ctx):\n    return ctx.units\n")
    spec = json.loads(json.dumps(spec))
    spec["configs"].append(dict(spec["configs"][0], name="wall_small"))
    spec["workloads"].append({"name": "wall_small.close_orbit",
                              "config": "wall_small",
                              "traffic": "close_orbit", "chips": 1,
                              "why": "a closer orbit"})
    spec["end_to_end"][3]["workloads"].append("wall_small.close_orbit")
    spec["per_layer"].append({
        "name": "views_traced.render", "unit": "views",
        "better": "higher", "source": "program_counter", "layer": "device",
        "moves": "render_p95_ms", "workloads": ["wall_small.close_orbit"]})
    from benchmark.outcome import Clock
    from benchmark.run import run_cell
    cell = tiny_cell(spec, "wall_small.close_orbit", tiny_bench)
    assert cell.traffic["widen"] == 1.2
    correct, out, metrics, checks = run_cell(cell, 5, 0.1, True, "cpu",
                                             Clock())
    assert correct and metrics["views_traced.render"]["value"] == 8
    correct, out, metrics, checks = run_cell(cell, 5, 0.1, False, "cpu",
                                             Clock())
    assert set(metrics) == {"setup_s", "render_p95_ms"}


def test_the_train_cell_reports_device_time_untraced_and_host_traced(
        spec, tiny_bench):
    from benchmark.outcome import Clock
    from benchmark.run import run_cell
    from benchmark.scene import train_frames
    cell = tiny_cell(spec, "davis50_1p5m.train", tiny_bench)
    correct, out, metrics, _ = run_cell(cell, 7, 0.1, False, "cpu", Clock())
    assert correct and set(metrics) == {"setup_s", "splat_step_device_ms"}
    correct, out, metrics, _ = run_cell(cell, 7, 0.1, True, "cpu", Clock())
    assert correct and metrics["step_ms.train"]["value"] > 0
    assert out.units == len(train_frames(cell.config))


def test_union_merges_overlaps_and_lists_the_gaps():
    from benchmark.trace import union
    busy, gaps = union([(5, 7), (0, 2), (1, 3), (3, 4), (9, 9)])
    assert busy == 6 and gaps == [(4, 5), (7, 9)]
    assert union([]) == (0.0, [])


def test_the_result_line_has_the_contract_keys_and_checks_last():
    line = harness.result_line(
        True, 10, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
        {"platform": "gpu", "kind": "x", "count": 1,
         "memory_peak_bytes": 3}, {"loss_gap": {"value": 1e-6,
                                                "limit": 1e-4}},
        breakdown={"device_ops": [], "idle_gaps": []})
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics",
                       "device", "breakdown", "checks"]
    assert "limit 0.0001" in harness.checks_text(d["checks"])


def test_judge_holds_every_number_to_its_limit():
    ok, table = harness.judge({"a": 1e-6, "b": 2.0}, {"a": 1e-5, "b": 1.0})
    assert not ok and table["b"] == {"value": 2.0, "limit": 1.0}
    assert harness.judge({"a": 1e-6}, {"a": 1e-5})[0]
    assert not harness.judge({"a": float("nan")}, {"a": 1.0})[0]
    with pytest.raises(KeyError):
        harness.judge({"a": 1.0}, {"b": 1.0})


def test_forbidden_modules_compare_whole_top_level_names():
    mods = dict.fromkeys(["das3r_tpu_torch", "das3r_tpu_torch.ops",
                          "jaxtyping", "flaxen", "torch"])
    assert harness.forbidden_modules(mods) == []
    mods.update(dict.fromkeys(["jax.numpy", "das3r_tpu.ops", "flax",
                               "jaxlib"]))
    assert harness.forbidden_modules(mods) == ["das3r_tpu.ops", "flax",
                                               "jax.numpy", "jaxlib"]


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        assert not _imports(p) & set(harness.FORBIDDEN), p


def test_the_references_import_nothing_of_the_program():
    for p in (BENCH / "reference").glob("*.py"):
        assert _imports(p) <= {"__future__", "dataclasses", "functools",
                               "math", "typing", "numpy", "torch"}, p


def test_without_cards_a_run_exits_nonzero_and_prints_nothing(tmp_path):
    """Here there is no CUDA card; a checkout with the benchmark and no
    program fails as well."""
    for root in (ROOT, tmp_path):
        if root == tmp_path:
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(BENCH, tmp_path / "benchmark",
                            ignore=shutil.ignore_patterns("__pycache__"))
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "davis50_1p5m.train", "--seed", "3000000001", "--seconds", "1",
             "--trace", "0"], cwd=root, capture_output=True, text=True,
            timeout=300)
        assert p.returncode != 0 and p.stdout.strip() == ""
