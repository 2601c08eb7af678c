"""Cells are found by name, and new ones come as files alone; the
benchmark's file keeps to its contract."""

import hashlib
import json
import os
import re
import shutil

import pytest

from conftest import with_loop_cells
from harness import loader, runner

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    return loader.load_benchmark(ROOT)


def digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_cells_resolve_to_their_files():
    b = with_loop_cells(bench())
    for w in b["workloads"]:
        cfg = loader.config(b, w["config"], ROOT)
        tr = loader.traffic(w["traffic"])
        assert callable(loader.driver(tr["driver"]).run)
        assert "missing" in loader.limits(w["name"])
        assert set(cfg["trace"]) >= {"ray_count", "max_bounces", "epsilon"}
    with pytest.raises(KeyError):
        loader.workload(b, "no_such.cell")


def test_metric_files_agree_with_the_benchmark():
    b = with_loop_cells(bench())
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            mod = loader.metric(m["name"])
            assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
            assert mod.LAYER == m.get("layer")
            assert mod.MOVES == m.get("moves")


def test_metrics_of_a_cell():
    b = bench()
    e2e = [m["name"] for m in loader.metrics_of(b, "bake_1m.frames", False)]
    assert e2e == ["rays_per_s", "setup_s"]
    layer = [m["name"] for m in loader.metrics_of(
        with_loop_cells(b), "sample_scene.static_60hz", True)]
    assert "refill_ms.loop" in layer and "glue_ms.bake" not in layer


@pytest.mark.parametrize("held", [False, True],
                         ids=["benchmark", "with_loop_cells"])
def test_benchmark_keeps_to_its_contract(held):
    b = with_loop_cells(bench()) if held else bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmarks"] and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmarks/") and len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in b["workloads"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = [m for m in b["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_a_new_cell_comes_as_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    driver, a metric and their cell by new files and new entries; no file
    it had changes, and a run on the CPU takes every new piece up."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = digests(root / "benchmarks")
    bd = root / "benchmarks"
    cfg = json.load(open(bd / "configs" / "bake_1m.json"))
    cfg.update(name="tiny", scene=dict(cfg["scene"], spheres=4, aabbs=8,
                                       obbs=4, targets=2))
    cfg["trace"].update(ray_count=256)
    (bd / "configs" / "tiny.json").write_text(json.dumps(cfg))
    tr = json.load(open(bd / "traffic" / "frames.json"))
    tr.update(driver="counted_frames", traced_frames=2)
    (bd / "traffic" / "tiny_frames.json").write_text(json.dumps(tr))
    (bd / "drivers" / "counted_frames.py").write_text(
        "import importlib.util, os\n"
        "_p = os.path.join(os.path.dirname(__file__), "
        "'back_to_back_frames.py')\n"
        "_s = importlib.util.spec_from_file_location('_b2b', _p)\n"
        "_m = importlib.util.module_from_spec(_s)\n"
        "_s.loader.exec_module(_m)\n"
        "def run(ctx):\n"
        "    _m.run(ctx)\n"
        "    ctx.values['counted'] = ctx.attempted\n")
    (bd / "limits" / "tiny.tiny_frames.json").write_text(json.dumps(dict(
        muffle_gap=1.0, strength_gap=1.0, volume_gap=1.0, ir_gap=10.0,
        position_gap=0.0, missing=0)))
    (bd / "metrics" / "frames_counted.py").write_text(
        'UNIT, SOURCE, LAYER, MOVES = "frames", "program_counter", '
        '"runtime", "rays_per_s"\n\n\n'
        "def read(ctx):\n    return ctx.values.get('counted')\n")
    b = json.load(open(root / "BENCHMARK.json"))
    b["configs"].append(dict(name="tiny", source="https://example.org",
                             file="benchmarks/configs/tiny.json",
                             reduced=[], why="a test's"))
    b["workloads"].append(dict(name="tiny.tiny_frames", config="tiny",
                               traffic="tiny_frames", chips=1,
                               why="a test's"))
    for m in b["end_to_end"]:
        if m["name"] == "rays_per_s":
            m["workloads"].append("tiny.tiny_frames")
    b["per_layer"].append(dict(name="frames_counted", unit="frames",
                               better="higher", source="program_counter",
                               layer="runtime", moves="rays_per_s",
                               workloads=["tiny.tiny_frames"]))
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    after = digests(root / "benchmarks")
    assert {k: after[k] for k in before} == before

    out = runner.run_cell("tiny.tiny_frames", 5, 0.3, True, device="cpu",
                          root=str(root))
    assert out["metrics"]["frames_counted"]["value"] == out["attempted"] > 0
    assert out["correct"] is True
    out = runner.run_cell("tiny.tiny_frames", 5, 0.3, False, device="cpu",
                          root=str(root))
    assert set(out["metrics"]) == {"rays_per_s", "setup_s"}
