"""Profiling: spans that name the program's steps, and device time per stage.

The reference instruments with editor-only Stopwatches and an FPS HUD
(Audio/AudioRayTracer.cs:58-59, _Editor/DebugDataDisplay.cs). On the
card the equivalents are ``torch.profiler`` traces and step timing that
waits for the device: PyTorch returns before the card has finished, so a
host clock around work without a synchronize measures the enqueue.

Spans come in two halves, both on the clock of a ``torch.profiler``
trace:

- ``span(name)``: a host range ``art.<name>`` (``record_function``)
  around what runs outside a captured graph: a compiled call's refill,
  warm-up, capture, replay and copy out, the loop's tick and its steps,
  and every host wait of the frame path (``art.sync``, each one also
  counted in ``ops/cuda/kernels.py::host_syncs``). It enters only while
  ``torch.profiler`` records; otherwise it returns a shared null context.
- ``device_span(name, device)``: the same host range and, on a CUDA
  device, a marker kernel (``csrc/spans.cu``) on the current stream at
  the span's begin and at its end. A capture records the markers like
  any other kernel, so every replay of a graph carries its stages on the
  device's timeline, and a marker's name (``marker_names``) says which
  stage it bounds. The end marker adds the span's device nanoseconds and
  one to the span's words of a buffer: a captured call's own
  (``CapturedCall.span_totals``), else one per device
  (``span_totals(device)``). ``set_device_spans(False)`` leaves the
  markers out; every captured call's key holds the switch, so its next
  capture follows it.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes
import json
import os
import re

import torch

from audio_raytracer_tpu_torch.types import resolve_device, tensors_of

TRACE_FILE = "trace.json"
# Chrome-trace categories of work that ran on the card.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# The device spans, in the order of csrc/spans.cu's ART_SPANS.
SPANS = ("frame", "trace", "trace.bounce", "trace.compact", "trace.restore",
         "permeation", "reverb", "process", "step.loss", "step.backward",
         "step.adam", "map.permeation")
HOST_PREFIX = "art."
MARKER_PREFIX = "art_span_"
# int64 words per span in a span buffer: the begin marker's stamp, the
# summed nanoseconds, the number of ends.
WORDS = 3

_INDEX = {name: i for i, name in enumerate(SPANS)}
_NULL = contextlib.nullcontext()
_device_spans = True
# The buffer the markers of this thread's current call accumulate into
# (``spans_into``); None: the device's own.
_target = contextvars.ContextVar("art_span_buffer", default=None)
_device_buffers: dict[torch.device, torch.Tensor] = {}
_lib = None


def sync(tree) -> float:
    """Wait for the device of ``tree``'s first tensor (a tensor or a
    dataclass of tensors) and return that tensor's first element."""
    leaf = next(tensors_of(tree))
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return float(leaf.reshape(-1)[0])


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


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


def span(name: str):
    """The host range ``art.<name>`` while ``torch.profiler`` records, a
    shared null context otherwise."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(HOST_PREFIX + name)


def marker_names(name: str) -> tuple[str, str]:
    """The CUDA function names of device span ``name``'s begin and end
    markers: ``art_span_<name>_begin`` and ``_end``, dots as
    underscores."""
    if name not in _INDEX:
        raise ValueError(f"no device span {name!r}; expected one of {SPANS}")
    base = MARKER_PREFIX + name.replace(".", "_")
    return base + "_begin", base + "_end"


_MARKERS = {m: (name, k == 1) for name in SPANS
            for k, m in enumerate(marker_names(name))}


def marker_span(kernel: str) -> tuple[str, bool] | None:
    """(span, is the end) of a marker kernel's name, bare or as a trace
    writes it (with its parameters); None for any other kernel."""
    m = re.match(r"(?:void\s+)?(art_span_[A-Za-z0-9_]+)", kernel)
    return _MARKERS.get(m.group(1)) if m else None


def set_device_spans(enabled: bool) -> None:
    """Launch the device spans' markers (the default) or leave them out.
    Read at every eager span and at a captured call's key."""
    global _device_spans
    _device_spans = bool(enabled)


def device_spans_enabled() -> bool:
    return _device_spans


def span_buffer(device) -> torch.Tensor:
    """A zeroed buffer of every device span's words ([len(SPANS), WORDS]
    int64) on ``device``."""
    return torch.zeros((len(SPANS), WORDS), dtype=torch.int64,
                       device=device)


@contextlib.contextmanager
def spans_into(buf: torch.Tensor | None):
    """Markers launched by this thread in the block accumulate into
    ``buf`` (a ``span_buffer``; None: the device's own)."""
    token = _target.set(buf)
    try:
        yield
    finally:
        _target.reset(token)


@contextlib.contextmanager
def device_span(name: str, device):
    """Device span ``name`` (one of SPANS) over the block: its host range
    and, on a CUDA device with the spans on, its begin and end markers
    on the current stream."""
    i = _INDEX[name]
    dev = torch.device(device)
    mark = _device_spans and dev.type == "cuda"
    with span(name):
        if mark:
            _mark(i, 0, dev)
        yield
        if mark:
            _mark(i, 1, dev)


def device_spans(name: str, device, items):
    """The items of ``items``, the body of a loop over them each in its
    own device span ``name`` (the span of an item ends when the loop
    asks for the next)."""
    for item in items:
        with device_span(name, device):
            yield item


def _indexed(dev: torch.device) -> torch.device:
    if dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _buffer(dev: torch.device) -> torch.Tensor:
    buf = _target.get()
    if buf is not None and buf.device == dev:
        return buf
    buf = _device_buffers.get(dev)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a capture's device spans need a buffer of "
                               "their own (spans_into)")
        buf = _device_buffers[dev] = span_buffer(dev)
    return buf


def _spans_lib():
    """The markers' library, its span count checked against SPANS."""
    global _lib
    if _lib is None:
        from audio_raytracer_tpu_torch.ops.cuda import build

        lib = build.load("spans")
        n = ctypes.c_int()
        build.check("span_count", lib.span_count(ctypes.byref(n)))
        if n.value != len(SPANS):
            raise RuntimeError(f"csrc/spans.cu has {n.value} spans, "
                               f"SPANS {len(SPANS)}")
        _lib = lib
    return _lib


def _mark(i: int, end: int, dev: torch.device) -> None:
    from audio_raytracer_tpu_torch.ops.cuda import build

    dev = _indexed(dev)
    err = _spans_lib().span_mark(i, end, _buffer(dev).data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    build.check("span_mark", err)


def totals(buf: torch.Tensor | None) -> dict[str, tuple[int, float]]:
    """{span: (count, device ms)} of the spans a buffer has seen end, in
    one copy to the host."""
    if buf is None:
        return {}
    return {name: (w[2], w[1] * 1e-6)
            for name, w in zip(SPANS, buf.cpu().tolist()) if w[2]}


def span_totals(device="cuda") -> dict[str, tuple[int, float]]:
    """``totals`` of the device spans run eagerly on ``device`` (outside
    any captured call) since the process started."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    return totals(_device_buffers.get(_indexed(dev)))
