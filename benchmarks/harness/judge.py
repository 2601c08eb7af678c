"""The comparison that decides ``correct``.

For each judged frame the program's per-target settings and impulse
response are held against the reference's for the same inputs:

- ``muffle_gap``: the largest |muffle gap| over the targets;
- ``strength_gap``, ``volume_gap``: |reverb strength gap|, |reverb volume
  gap|;
- ``ir_gap``: the largest |bin gap| of the impulse response over the
  reference's largest bin;
- ``position_gap``: the largest |perceived position gap|, exact (the
  target positions the frame was traced for).

Over a run's judged frames each is taken at its largest (the name) and,
with ``_median`` after it, at its median. The cell's limits file names
the numbers that are compared and the limit of each; ``missing`` (answers
due in the window that never came) is compared with its limit too.
"""

from __future__ import annotations

import statistics

import torch

NUMBERS = ("muffle_gap", "strength_gap", "volume_gap", "ir_gap",
           "position_gap")


def _f(x) -> float:
    return float(torch.as_tensor(x).detach().double().cpu().max())


def frame_gaps(settings, ir, ref: dict) -> dict:
    """The gaps of one frame: ``settings`` the program's (muffle,
    reverb_strength, reverb_volume, perceived_position), ``ir`` its
    impulse response or None, ``ref`` the reference's frame."""
    dev = ref["muffle"].device

    def gap(a, b):
        return _f((torch.as_tensor(a).to(dev, torch.float64)
                   - torch.as_tensor(b).to(dev, torch.float64)).abs())

    out = dict(
        muffle_gap=gap(settings.muffle, ref["muffle"]),
        strength_gap=gap(settings.reverb_strength, ref["reverb_strength"]),
        volume_gap=gap(settings.reverb_volume, ref["reverb_volume"]),
        position_gap=gap(settings.perceived_position,
                         ref["perceived_position"]))
    if "reverb_ir" in ref:
        top = _f(ref["reverb_ir"].abs())
        out["ir_gap"] = (float("inf") if ir is None
                         else gap(ir, ref["reverb_ir"]) / max(top, 1e-30))
    return out


def summarize(frames: list[dict]) -> dict:
    """Each number's largest and median over the judged frames."""
    out = {}
    for k in NUMBERS:
        xs = [f[k] for f in frames if k in f]
        if xs:
            out[k] = max(xs)
            out[f"{k}_median"] = statistics.median(xs)
    return out


def decide(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the limits' names: each
    number at or under its limit; a number that is missing, or not a
    number, fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        if name.startswith("_"):
            continue
        v = numbers.get(name)
        good = v is not None and v == v and v <= limit
        ok &= good
        checks[name] = dict(value=v, limit=limit)
    return ok, checks


def failed_frames(frames: list[dict], limits: dict) -> int:
    """Judged frames with a gap over its limit (the largest-gap limits)."""
    return sum(any(k in limits and v > limits[k] for k, v in f.items())
               for f in frames)
