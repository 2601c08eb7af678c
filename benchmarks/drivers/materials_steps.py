"""Driver: materials training steps of the program, back to back.

An offline calibration: ``make_train_step(cfg, return_map=True)`` (on
the card a ``StepGraph``, one replay of a captured CUDA graph a step)
fits the 9 material tensors of the configuration's scene (drawn from its
``layout_seed``) to loudness maps recorded at ``positions`` listener
positions, drawn from the seed in +/- ``listener_extent``. The layout's
own materials are the true ones: set-up makes each position's map with
the program's ``loudness_map`` at them (no gradient), draws the
materials training starts from (the configuration's ``train``:
``init_seed``, ``init_ranges``) and builds Adam at ``lr``, then runs
``warmup_steps`` steps (the eager warm-up, the capture, replays).
Step i trains on position i mod ``positions``.

The window enqueues steps until its seconds have passed, at most
``in_flight`` ahead of the device, and ends in a synchronize. After each
step its loss and loudness map (the step's own outputs, copied out of
the graph), the 9 tensors' gradients and the optimizer's state (the 9
tensors, Adam's two moments and its step counts) are copied on the
device, so that any step's inputs and outputs can be judged.

Values: ``rays`` (rays x steps completed) and ``window_s``. With
``--trace`` a further ``traced_steps`` steps run under the profiler, each
in a ``bench.frame`` span.

Correct: one step drawn from the seed, among the window's (among the
traced ones in a traced run, whose counts B4's roofline takes), is held
against ``reference/materials.py`` for the same geometry, directions,
listener, target map and starting materials:

- the step's loudness map: ``muffle_gap``, ``permeation_gap`` and
  ``reverb_gap``, the largest |gap| of each, and ``ir_gap``, the impulse
  response's largest |gap| over its largest bin;
- ``loss_gap``: |loss - ref| over |ref|;
- the gradients, taken by the reference at the step's own map (its
  ``grads_at``): the loss is a sum of squared gaps between a map and its
  target, so a gradient is the map's gap to the target times the sums'
  derivatives, and the map is judged above; ``grad_gap`` is the largest
  over the 9 tensors of max|g - g_ref| over max|g_ref|, and
  ``grad_gap_median`` the median of that ratio;
- ``update_gap``: the tensors' change in the step against a plain Adam
  update (the configuration's ``lr``, ``betas`` and ``eps``) from the
  optimizer's state before it and the reference's gradients, |change -
  ref| over |ref| (2-norms over the 9 tensors): a step that leaves the
  tensors as they were reads 1;
- ``missing``: the window's steps whose loss came back not finite.

The control (``--control 1``): the program's differentiable engine has
float32 alone, so the control puts the reference computed in bfloat16
(``reference.step(dtype=torch.bfloat16)`` and its Adam update in
bfloat16, on the same float32 scene and inputs) in the judged step's
place, and judges it as the program's.
"""

from __future__ import annotations

import collections
import inspect
import math
import statistics
import time

import torch

from harness import devtrace, scene
from reference import frame as geometry
from reference import materials as reference

MAP = ("muffle", "permeation", "reverb_energy", "reverb_ir")


def start_materials(layout: dict, seed: int, ranges: dict, device) -> list:
    """The 9 material tensors training starts from (``reference.
    leaf_names()``' order): a draw of each field's distribution
    (``ranges``: field -> (low, high)) from ``seed``."""
    g = scene.generator(seed, device)
    out = []
    for k in scene.TYPES:
        n = layout[f"{k}_mat"].shape[0]
        for f in reference.FIELDS:
            lo, hi = ranges[f]
            out.append(lo + (hi - lo) * torch.rand((n,), generator=g,
                                                   device=device))
    return out


def _top(x) -> float:
    """max|x| (0 for no elements)."""
    return float(x.detach().double().abs().max()) if x.numel() else 0.0


def _ratio(g, r) -> float:
    """max|g - r| over max|r| (0 where both are all zero)."""
    g, r = g.detach().double(), r.to(g.device).double()
    top, diff = _top(r), _top(g - r)
    return diff / top if top > 0.0 else (0.0 if diff == 0.0 else math.inf)


def gaps(loss: float, pred: dict, grads, change, ref: dict,
         ref_change) -> tuple[dict, list]:
    """The numbers compared (see the module), and each tensor's gradient
    ratio. ``pred``: the judged step's loudness map; ``change`` and
    ``ref_change``: the 9 tensors' change in the step and in the
    reference's Adam update."""
    ratios = [_ratio(g, r) for g, r in zip(grads, ref["grads_at"])]
    m = ref["loudness"]

    def absolute(name):
        a = pred[name].detach().double()
        return float((a - m[name].to(a.device).double()).abs().max())

    flat = [torch.cat([x.detach().double().reshape(-1).cpu() for x in xs])
            for xs in (change, ref_change)]
    return dict(muffle_gap=absolute("muffle"),
                permeation_gap=absolute("permeation"),
                reverb_gap=absolute("reverb_energy"),
                ir_gap=_ratio(pred["reverb_ir"], m["reverb_ir"]),
                loss_gap=abs(loss - ref["loss"]) / max(abs(ref["loss"]),
                                                       1e-30),
                grad_gap=max(ratios),
                grad_gap_median=statistics.median(ratios),
                update_gap=float((flat[0] - flat[1]).norm()
                                 / max(float(flat[1].norm()), 1e-30))), \
        ratios


def _flat(tensors) -> torch.Tensor:
    return torch.cat([x.detach().reshape(-1) for x in tensors])


def _state(leaves, opt) -> torch.Tensor:
    """The 9 tensors, Adam's first and second moments of each and its
    step counts (zero where Adam holds none yet), flat on the device."""
    def get(x, key):
        v = opt.state.get(x, {}).get(key)
        if v is None:
            return x.new_zeros((1,) if key == "step" else x.shape)
        return torch.as_tensor(v).to(x)

    return _flat([*leaves, *(get(x, "exp_avg") for x in leaves),
                  *(get(x, "exp_avg_sq") for x in leaves),
                  *(get(x, "step") for x in leaves)])


def _unstate(flat: torch.Tensor, sizes: list) -> tuple:
    """``_state``'s flat tensor as (tensors, exp_avg, exp_avg_sq, steps),
    9 each."""
    parts = flat.split(sizes * 3 + [1] * len(sizes))
    n = len(sizes)
    return (parts[:n], parts[n:2 * n], parts[2 * n:3 * n],
            [float(x) for x in parts[3 * n:]])


def run(ctx):
    from audio_raytracer_tpu_torch.models.differentiable import (
        SceneParams,
        adam,
        loudness_map,
        make_train_step,
    )
    from audio_raytracer_tpu_torch.types import Materials, TraceConfig

    if "return_map" not in inspect.signature(make_train_step).parameters:
        raise RuntimeError("this program's training step does not return "
                           "its loudness map (make_train_step(return_map="
                           "True)), which the cell judges")
    tr, sc, dev = ctx.traffic, ctx.config["scene"], ctx.device
    train = ctx.config["train"]
    tcfg = TraceConfig(**ctx.config["trace"])
    layout = scene.random_layout(sc.get("layout_seed", ctx.seed),
                                 sc["spheres"], sc["aabbs"],
                                 sc["obbs"], sc["targets"], sc["extent"],
                                 sc["size_range"], dev)
    dirs = geometry.fibonacci_directions(tcfg.ray_count, dev)
    start = start_materials(layout, train["init_seed"],
                            train["init_ranges"], dev)
    port = scene.port_scene(layout)
    g = scene.generator(ctx.seed + 1, dev)
    ext, n_pos = tr["listener_extent"], tr["positions"]
    pos = (torch.rand((n_pos, 3), generator=g, device=dev) * 2 - 1) * ext
    with torch.no_grad():
        maps = [loudness_map(pos[k], dirs, port, tcfg, device=dev)
                for k in range(n_pos)]
    params = SceneParams(*(Materials(*(x.clone()
                                       for x in start[3 * i:3 * i + 3]))
                           for i in range(3)))
    step, init = make_train_step(tcfg, optimizer=adam(train["lr"]),
                                 device=dev, return_map=True)
    opt = init(params)
    leaves = params.leaves()
    ctx.mark("inputs")
    n_warm = tr["warmup_steps"]
    for k in range(n_warm):
        step(params, opt, port, pos[k % n_pos], dirs, maps[k % n_pos])
        ctx.sync()
        if k < 2:
            ctx.mark(("first step", "capture")[k])
    ctx.setup_done()

    def one(i):
        """Step i: (position, loss, map, gradients and state after)."""
        k = i % n_pos
        _, _, loss, pred = step(params, opt, port, pos[k], dirs, maps[k])
        return (k, loss, {f: getattr(pred, f) for f in MAP},
                _flat(x.grad for x in leaves), _state(leaves, opt))

    # Step i of the window is step n_warm + i, the traced ones after the
    # window's; the state before the window's first step is ``first``.
    first = _state(leaves, opt)
    done, pending = [], collections.deque()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        done.append(one(n_warm + len(done)))
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > tr["in_flight"]:
                pending.popleft().synchronize()
    ctx.sync()
    t1 = time.perf_counter()
    n_done = len(done)
    ctx.values.update(rays=tcfg.ray_count * n_done, window_s=t1 - t0)
    ctx.attempted = n_done
    missing = int((~torch.isfinite(torch.stack([s[1] for s in done])))
                  .sum()) if done else 0

    u = float(torch.rand((), generator=scene.generator(ctx.seed + 2,
                                                       "cpu")))
    lo, n = 0, n_done
    if ctx.trace:
        holder = {}
        with devtrace.profiled(dev, holder):
            for i in range(tr["traced_steps"]):
                with torch.profiler.record_function("bench.frame"):
                    done.append(one(n_warm + n_done + i))
        ctx.trace_data = holder["trace"]
        lo, n = n_done, tr["traced_steps"]
    # B4's roofline finds the judged step among the traced ones by this.
    ctx.values["judged_step"] = min(int(u * n), n - 1)
    j = lo + ctx.values["judged_step"]
    k, loss, pred, grads, after = done[j]
    before = done[j - 1][4] if j > 0 else first
    if dev.type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    sizes = [x.numel() for x in leaves]
    grads = grads.split(sizes)
    before, exp_avg, exp_avg_sq, steps = _unstate(before, sizes)
    after = _unstate(after, sizes)[0]
    target = {f: getattr(maps[k], f) for f in MAP}
    hyper = dict(lr=train["lr"], betas=tuple(train["betas"]),
                 eps=train["eps"])
    del step, opt, params, leaves, done
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def ref_step(**kw):
        return reference.step(layout, before, pos[k], target,
                              ctx.config["trace"], dev, directions=dirs,
                              **kw)

    t_ref = time.perf_counter()
    if ctx.control:
        low = ref_step(dtype=torch.bfloat16)
        loss, grads, pred = low["loss"], low["grads"], low["loudness"]
        after = reference.adam(before, grads, exp_avg, exp_avg_sq, steps,
                               dtype=torch.bfloat16, **hyper)
    else:
        loss = float(loss)
    ref = ref_step(at=pred)
    ctx.values["reference_s"] = time.perf_counter() - t_ref
    ctx.log(f"reference: step {j} in {ctx.values['reference_s']:.2f} s")
    ctx.counts = dict(hitting=ref["counts"]["hitting"],
                      sets=sc["targets"],
                      prims=(sc["spheres"], sc["aabbs"], sc["obbs"]))
    ref_after = reference.adam(before, ref["grads_at"], exp_avg, exp_avg_sq,
                               steps, **hyper)
    change = [a.double() - b.double() for a, b in zip(after, before)]
    ref_change = [a - b.double() for a, b in zip(ref_after, before)]
    numbers, ratios = gaps(loss, pred, grads, change, ref, ref_change)
    own = ", ".join(f"{_ratio(g, r):.3g}"
                    for g, r in zip(grads, ref["grads"]))
    ctx.log("gradient gaps: " + ", ".join(
        f"{name} {r:.3g} (max {_top(x):.3g})"
        for name, r, x in zip(reference.leaf_names(), ratios,
                              ref["grads_at"]))
        + f"; loss {loss!r}, reference {ref['loss']!r}; against the "
        f"reference's gradients at its own map: {own}")
    ctx.numbers = dict(numbers, missing=missing)
    ctx.failed = missing + int(any(
        name in ctx.limits and v > ctx.limits[name]
        for name, v in numbers.items()))
