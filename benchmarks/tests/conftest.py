"""The benchmark's own tests: on the CPU, at small sizes, apart from the
repository's ``tests/``. Run from the checkout's root:

    python -m pytest benchmarks/tests -q

Tests marked ``card`` need a CUDA device; each decides inside itself
whether there is one and skips without. The real-time loop's cells,
held back from ``BENCHMARK.json`` (``loop_cells.json``), are driven
through ``bench_root``: a checkout whose ``BENCHMARK.json`` holds them
too.
"""

import json
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


def with_loop_cells(bench: dict) -> dict:
    """``bench`` with the held-back loop cells' entries added."""
    with open(os.path.join(BENCH_DIR, "tests", "loop_cells.json")) as f:
        held = json.load(f)
    out = {k: list(v) if isinstance(v, list) else v
           for k, v in bench.items()}
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        out[k] = out[k] + held[k]
    return out


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory) -> str:
    """A checkout of this one's program and benchmark whose
    ``BENCHMARK.json`` also holds the loop cells."""
    root = tmp_path_factory.mktemp("checkout")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (root / "BENCHMARK.json").write_text(json.dumps(with_loop_cells(bench)))
    (root / "benchmarks").symlink_to(BENCH_DIR)
    return str(root)
