"""Run one cell of the benchmark on the card and print its result.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic,
driver, metrics and limits are found by name from ``BENCHMARK.json``
(``harness/loader.py``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number the
comparison with the reference made beside its limit; the last lines of
standard error give the same numbers. Without a CUDA card, or with fewer
cards than the cell asks for, or when a module of the JAX package is
loaded once the window has closed, it prints no result and exits with 2.

``--control 1`` runs the program in its next lower precision tier (the
control whose readings bound the limits); the benchmark's own runs never
do.
"""

from __future__ import annotations

import time

T_ENTRY = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _since_start() -> float:
    """Seconds since this process started (Linux), 0 elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, AttributeError, IndexError):
        return 0.0


T_START = T_ENTRY - max(0.0, _since_start() - (time.perf_counter()
                                                - T_ENTRY))


def _environment():
    """Every build and kernel cache under the checkout, at fixed paths;
    one thread for the host's parallel loops (the load is one process
    with few threads), and the process pinned to one core: the last this
    process may use, the same in every run, so that no run's host thread
    moves between cores (runs of one seed with and without: PERF.md)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    base = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    def err(*msg):
        print(*msg, file=sys.stderr, flush=True)

    _environment()
    sys.path[:0] = [ROOT, BENCH_DIR]
    import torch

    from harness import loader, runner

    bench = loader.load_benchmark(ROOT)
    chips = loader.workload(bench, a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        err(f"needs {chips} CUDA device(s); "
            f"found {torch.cuda.device_count()}")
        return 2
    import audio_raytracer_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(ROOT + os.sep):
        err(f"the program loaded from {port.__file__}, not this checkout")
        return 2
    out = runner.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                          device="cuda", t_start=T_START,
                          control=bool(a.control), root=ROOT, log=err)
    bad = runner.forbidden_modules()
    if bad:
        err(f"modules of the JAX package were loaded: {bad}")
        return 2
    out["device"] = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                         count=chips, **out["device"])
    if a.trace:
        err(f"card: {runner.power_limit()}")
    err(f"build_s {out['build_s']!r} (set-up includes it)")
    checks = out.pop("checks")
    out["checks"] = checks
    for name, c in checks.items():
        err(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
