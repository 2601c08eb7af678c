"""Profiling and metrics.

The reference instruments with editor-only Stopwatches and an FPS HUD
(Audio/AudioRayTracer.cs:58-59, _Editor/DebugDataDisplay.cs). On the
card the equivalents are ``torch.profiler`` traces and step timing that
waits for the device: PyTorch returns before the card has finished, so a
host clock around work without a synchronize measures the enqueue.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time

import torch

from audio_raytracer_tpu_torch.types import resolve_device, tensors_of

TRACE_FILE = "trace.json"
# Chrome-trace categories of work that ran on the card.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def sync(tree) -> float:
    """Wait for the device of ``tree``'s first tensor (a tensor or a
    dataclass of tensors) and return that tensor's first element."""
    leaf = next(tensors_of(tree))
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return float(leaf.reshape(-1)[0])


@contextlib.contextmanager
def step_timer(results: dict, key: str):
    """Wall-time a step into results[key] (call sync() inside the block)."""
    t0 = time.perf_counter()
    yield
    results[key] = results.get(key, 0.0) + (time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """``torch.profiler`` over the block, host and ``device`` activities,
    written as a Chrome trace to ``log_dir/trace.json`` (open it in
    chrome://tracing or Perfetto; ``summarize_trace`` reads it)."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class ThroughputMeter:
    """Rolling rays/s meter (the DebugDataDisplay FPS average analog)."""

    def __init__(self, window: int = 20):
        self.window = window
        self._samples: list[tuple[float, float]] = []

    def record(self, rays: int, seconds: float):
        self._samples.append((rays, seconds))
        if len(self._samples) > self.window:
            self._samples.pop(0)

    @property
    def rays_per_s(self) -> float:
        if not self._samples:
            return 0.0
        rays = sum(r for r, _ in self._samples)
        secs = sum(s for _, s in self._samples)
        return rays / secs if secs else 0.0


def summarize_trace(log_dir: str, top: int = 20) -> list[tuple[str, float]]:
    """[(op name, total ms)] of the ``top`` device ops by total time in
    the trace ``device_trace`` wrote under ``log_dir``, largest first.

    Device ops are the trace's kernels, copies and memsets; a trace taken
    on the CPU has none, and then its host ops (``cpu_op``) are summed.
    """
    path = os.path.join(log_dir, TRACE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {TRACE_FILE} under {log_dir}")
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    cats = DEVICE_CATEGORIES
    if not any(e.get("cat") in cats for e in events):
        cats = ("cpu_op",)
    tot = collections.Counter()
    for e in events:
        if e.get("cat") in cats:
            tot[e.get("name", "")] += e["dur"]
    return [(name, dur / 1000.0) for name, dur in tot.most_common(top)]
