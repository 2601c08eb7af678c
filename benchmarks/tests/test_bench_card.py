"""The command as the checks run it. Without a card it must print no
result and fail; on a card (tests marked ``card``) a short run of each
cell is correct, the control at the cell's own size is not, and a
directory holding the benchmark alone cannot run."""

import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
CELLS = ("bake_1m.frames",)


def command(cwd, *args, timeout=900):
    return subprocess.run(
        [sys.executable, "benchmarks/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=timeout)


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def result(out):
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_without_a_card_there_is_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = command(ROOT, "--workload", CELLS[0], "--seed", "1",
                  "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(cell):
    need_card()
    r = result(command(ROOT, "--workload", cell, "--seed", "2718281828",
                       "--seconds", "3", "--trace", "0"))
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert list(r)[-1] == "checks"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_at_the_cells_size_is_not_correct(cell):
    need_card()
    for seed in (11, 2**31 + 5, 3_141_592_653):
        r = result(command(ROOT, "--workload", cell, "--seed", str(seed),
                           "--seconds", "3", "--trace", "0",
                           "--control", "1"))
        assert r["correct"] is False, r["checks"]


@pytest.mark.card
def test_the_benchmark_alone_does_not_run(tmp_path):
    need_card()
    shutil.copytree(BENCH_DIR, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = command(tmp_path, "--workload", CELLS[0], "--seed", "1",
                  "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
