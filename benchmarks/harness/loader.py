"""Find everything of a cell by the names in ``BENCHMARK.json``.

Each piece sits in a file of its own under the benchmark's directory,
found by name, so that a new configuration, traffic mix, driver, metric
or cell is new files and new entries, and no edit:

- configuration ``<c>``: the file its ``configs`` entry names
  (``configs/<c>.json``): the sizes as run, ``source``, ``assumed``,
  ``reduced``;
- traffic mix ``<t>``: ``traffic/<t>.json``, whose ``driver`` names
- driver ``<d>``: ``drivers/<d>.py`` with ``run(ctx)``;
- metric ``<m>``: ``metrics/<m>.py`` with ``read(ctx)`` and its ``UNIT``,
  ``SOURCE``, ``LAYER`` and ``MOVES``;
- the limits of cell ``<w>``: ``limits/<w>.json``.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(root, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def limits(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "limits", f"{name}.json"))


def _module(kind: str, name: str, bench_dir: str):
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, bench_dir: str = BENCH_DIR):
    return _module("drivers", name, bench_dir)


def metric(name: str, bench_dir: str = BENCH_DIR):
    return _module("metrics", name, bench_dir)


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    with ``trace`` false, the per-layer ones with it true; an entry with
    ``workloads`` only in the cells it lists."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def merged(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts key by key."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = v
    return out
