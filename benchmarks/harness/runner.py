"""One run of one cell: load it by name, drive it, judge it, report it.

``run_cell`` is the whole run without the look for a card, so the tests
drive it on the CPU at a small size. ``run.py`` adds the look, the
result line and the exit code.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import subprocess
import sys
import time

import torch

from harness import judge, loader

# Top-level module names that may not be loaded by a run (compared whole:
# the program's own name only begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_raytracer_tpu")


@dataclasses.dataclass
class Ctx:
    """What a driver is given and fills in."""

    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    control: bool = False
    log: object = print
    setup_s: float | None = None
    # Filled by the driver: sample lists and single values for the
    # metrics, the reference's counts, the numbers compared, the answers.
    samples: dict = dataclasses.field(default_factory=dict)
    values: dict = dataclasses.field(default_factory=dict)
    counts: dict | None = None
    trace_data: object = None
    numbers: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    marks: list = dataclasses.field(default_factory=list)

    @property
    def compute_dtype(self) -> str:
        """The program's compute type: the configuration's, or its next
        lower tier for the control."""
        return "bfloat16" if self.control else \
            self.config["trace"].get("compute_dtype", "float32")

    def mark(self, name: str):
        """Note how far set-up has come (seconds since the start)."""
        self.marks.append((name, time.perf_counter() - self.t_start))

    def setup_done(self):
        """The first timed tick or frame starts now. The set-up's garbage
        is collected and what is left frozen (``gc.freeze``), so that the
        window's collections walk only what the window allocates."""
        if self.setup_s is None:
            gc.collect()
            gc.freeze()
            self.setup_s = time.perf_counter() - self.t_start
            self.log("setup: " + ", ".join(
                f"{n} {t:.3f}" for n, t in self.marks + [
                    ("done", self.setup_s)]) + " s")

    def sample(self, name: str, value: float):
        self.samples.setdefault(name, []).append(value)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def forbidden_modules(names=None) -> list[str]:
    """The module names (by default the loaded modules') whose top-level
    name is one of FORBIDDEN."""
    names = list(sys.modules) if names is None else names
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip() or out.stderr.strip()


def load_libraries() -> tuple[float, bool]:
    """Load the program's kernel and registry libraries, building them
    first where the checkout has none yet (its first run); returns the
    seconds it took and whether it compiled."""
    from audio_raytracer_tpu_torch.ops.cuda import build
    from audio_raytracer_tpu_torch.runtime import native

    t0 = time.perf_counter()
    paths = [build.lib_path(n) for n in build.SOURCES] + [native.lib_path()]
    compiled = not all(os.path.exists(p) for p in paths)
    build.build_all()
    native.load()
    return time.perf_counter() - t0, compiled


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device, t_start: float | None = None, control: bool = False,
             overrides: dict | None = None, root: str = loader.ROOT,
             log=None) -> dict:
    """Run ``cell`` and return its result: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device`` (without ``platform``, ``kind``
    and ``count``, which the caller adds), ``breakdown`` (traced),
    ``build_s`` and ``checks``. ``overrides`` replaces keys of the
    configuration (``config``) and the traffic (``traffic``), for small
    test runs."""
    bench = loader.load_benchmark(root)
    bench_dir = f"{root}/benchmarks"
    w = loader.workload(bench, cell)
    over = overrides or {}
    cfg = loader.merged(loader.config(bench, w["config"], root),
                        over.get("config"))
    tr = loader.merged(loader.traffic(w["traffic"], bench_dir),
                       over.get("traffic"))
    t_load = time.perf_counter()
    ctx = Ctx(cell=cell, config=cfg, traffic=tr,
              limits=loader.limits(cell, bench_dir), seed=seed,
              seconds=seconds, trace=trace, device=torch.device(device),
              t_start=time.perf_counter() if t_start is None else t_start,
              control=control,
              log=log or (lambda *a: print(*a, file=sys.stderr, flush=True)))
    ctx.marks.append(("imports", t_load - ctx.t_start))
    build_s = 0.0
    if ctx.device.type == "cuda":
        seconds, compiled = load_libraries()
        ctx.mark("build" if compiled else "libraries")
        build_s = seconds if compiled else 0.0
    loader.driver(tr["driver"], bench_dir).run(ctx)

    ok, checks = judge.decide(ctx.numbers, ctx.limits)
    metrics = {}
    for m in loader.metrics_of(bench, cell, trace):
        value = loader.metric(m["name"], bench_dir).read(ctx)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    dev = dict(memory_peak_bytes=ctx.memory_peak_bytes)
    out = dict(correct=ok and ctx.failed == 0, attempted=ctx.attempted,
               failed=ctx.failed, metrics=metrics, device=dev)
    if trace and ctx.trace_data is not None:
        t = ctx.trace_data
        lo, hi = t.window()
        dev["busy_s"] = t.busy_s(t.in_window(), lo, hi)
        dev["window_s"] = (hi - lo) * 1e-6
        out["breakdown"] = t.breakdown()
    # Seconds of set-up spent compiling the program (0 where the
    # checkout's build was there); set-up includes them.
    out["build_s"] = build_s
    out["checks"] = checks
    return out
