"""The port's materials training step against the benchmark's plain
reference of it (``benchmarks/reference/materials.py``), on the CPU.

The reference is written from the differentiable model's equations, in
plain PyTorch, and imports nothing of the port; the benchmark's cell
``calib_1m.materials_step`` judges the step on the card by it. Here a
small seeded scene (its layout drawn by the benchmark's
``harness/scene.py``) takes one step of ``make_train_step(...,
device="cpu")`` on the kernel backend (the kernels' plain versions) and
on the dense backend, and the loss and all 9 material gradients are held
to the reference's for the same starting materials, listener,
directions and target map.
"""

import dataclasses
import os
import sys

import pytest
import torch

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)

from harness import scene as layouts  # noqa: E402
from reference import frame as geometry  # noqa: E402
from reference import materials  # noqa: E402

from audio_raytracer_tpu_torch.models.differentiable import (  # noqa: E402
    SceneParams,
    _loudness_mse,
    adam,
    loudness_map,
    make_train_step,
)
from audio_raytracer_tpu_torch.ops.trace import trace  # noqa: E402
from audio_raytracer_tpu_torch.types import (  # noqa: E402
    Materials,
    TraceConfig,
)

CPU = "cpu"
CFG = TraceConfig(ray_count=512, max_bounces=4, max_ray_life=300.0,
                  num_reverb_bins=8)
# Loss: both sides sum the same float32 terms in another order and the
# reference adds its blocks in float64; up to 3e-7 of the loss measured,
# 1e-5 leaves room.
LOSS_RTOL = 1e-5
# Gradients, each tensor's largest |gap| over its largest |gradient|.
# Absorption and echo are sums of energy-weighted terms of one sign a ray:
# float32 order alone, up to 4.7e-7 measured; 1e-4 leaves room. Density
# rides the permeation's gap to its target (~1e-4 of the map here), and
# the map is a float32 number near strength x effectiveness, so its
# rounding (~3e-8) moves each density gradient by that over the gap: up
# to 1.7e-4 measured; 1e-3 leaves room and stays far under a wrong
# gradient's 1.
GRAD_TOL = {"absorption": 1e-4, "echo": 1e-4, "density": 1e-3}
# The reference's gradients taken at the port's own map (``grads_at``):
# the map's rounding is then the same on both sides, and what is left is
# the order of float32 sums, up to 7e-7 measured; 1e-5 leaves room.
AT_TOL = 1e-5
SEEDS = (3, 11, 2**33 + 7)


def layout(seed: int) -> dict:
    return layouts.random_layout(seed, 4, 8, 4, 3, 5.0, (1.0, 3.0), CPU)


def start(lay: dict, seed: int) -> list:
    """The 9 material tensors a step starts from: a second draw of the
    layout's distributions, type-major."""
    g = layouts.generator(seed, CPU)
    out = []
    for k in layouts.TYPES:
        n = lay[f"{k}_mat"].shape[0]
        for lo, hi in ((0.0, 0.3), (0.2, 2.0), (0.5, 2.0)):
            out.append(lo + (hi - lo) * torch.rand((n,), generator=g))
    return out


def inputs(seed: int):
    """(layout, the port's scene, listener, directions, target map, the
    starting materials) of one case."""
    lay = layout(seed)
    port = layouts.port_scene(lay)
    g = layouts.generator(seed + 1, CPU)
    origin = (torch.rand((3,), generator=g) * 2 - 1) * 4.0
    dirs = geometry.fibonacci_directions(CFG.ray_count, CPU)
    with torch.no_grad():
        target = loudness_map(origin, dirs, port, CFG, device=CPU)
    return lay, port, origin, dirs, target, start(lay, seed + 2)


def target_dict(target) -> dict:
    return {f: getattr(target, f) for f in (
        "muffle", "permeation", "reverb_energy", "reverb_ir")}


def port_step(backend: str, port, origin, dirs, target, mats,
              with_map=False):
    """One step of the port: (loss, the 9 gradients), and its loudness
    map ``with_map``."""
    params = SceneParams(*(Materials(*(x.clone() for x in mats[3 * i:
                                                             3 * i + 3]))
                           for i in range(3)))
    step, init = make_train_step(CFG, backend=backend, device=CPU,
                                 return_map=True)
    opt = init(params)
    _, _, loss, pred = step(params, opt, port, origin, dirs, target)
    out = float(loss), [x.grad.clone() for x in params.leaves()]
    return (*out, pred) if with_map else out


def reference_step(lay, origin, dirs, target, mats, **kw):
    return materials.step(lay, mats, origin, target_dict(target),
                          dataclasses.asdict(CFG), CPU, directions=dirs,
                          **kw)


def mismatches(loss, grads, ref) -> list[str]:
    """The numbers outside their tolerances, by name."""
    bad = []
    if abs(loss - ref["loss"]) > LOSS_RTOL * abs(ref["loss"]):
        bad.append("loss")
    for name, g, r in zip(materials.leaf_names(), grads, ref["grads"]):
        tol = GRAD_TOL[name.split(".")[1]]
        if float((g - r).abs().max()) > tol * float(r.abs().max()):
            bad.append(name)
    return bad


@pytest.fixture(scope="module")
def cases():
    return {seed: inputs(seed) for seed in SEEDS}


@pytest.fixture(scope="module")
def references(cases):
    return {seed: reference_step(lay, origin, dirs, target, mats)
            for seed, (lay, _, origin, dirs, target, mats) in cases.items()}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_a_step_matches_the_reference(cases, references, backend, seed):
    lay, port, origin, dirs, target, mats = cases[seed]
    ref = references[seed]
    assert ref["loss"] > 0 and all(float(r.abs().max()) > 0
                                   for r in ref["grads"])
    assert ref["counts"]["hitting"] > CFG.ray_count // 4
    # Every ray resolves alike in the port's forward and the reference's
    # geometry: a ray that parts by rounding (an epsilon-offset origin
    # self-hitting a grazed box) moves a gradient of this small scene by
    # a few percent, beyond what the tolerances are for.
    lay_at = dict(lay)
    for i, k in enumerate(layouts.TYPES):
        lay_at[f"{k}_mat"] = torch.stack(mats[3 * i:3 * i + 3], dim=-1)
    params = SceneParams(*(Materials(*mats[3 * i:3 * i + 3])
                           for i in range(3)))
    fwd = trace(origin, dirs, params.into_scene(port), CFG)
    frame = geometry.frame(lay_at, origin, dataclasses.asdict(CFG), CPU,
                           directions=dirs)
    assert torch.equal(fwd.echo_distances == 0,
                       frame["echo_distances"] == 0)
    loss, grads = port_step(backend, port, origin, dirs, target, mats)
    assert mismatches(loss, grads, ref) == []


@pytest.mark.parametrize("block", [17, 64, 300])
def test_the_blocked_reference_equals_one_block(cases, block):
    """Blocks of rays only regroup the sums (each block's in float32,
    their totals in float64): the same hits, and the loss and gradients
    within the tolerances above (the loss moved by up to 4.3e-6 of itself:
    it is a sum of squared gaps between nearly equal maps, so a sum's
    rounding moves it more than the sum)."""
    lay, _, origin, dirs, target, mats = cases[SEEDS[0]]
    whole = reference_step(lay, origin, dirs, target, mats,
                           ray_block=CFG.ray_count)
    got = reference_step(lay, origin, dirs, target, mats, ray_block=block)
    assert got["counts"] == whole["counts"]
    assert mismatches(got["loss"], got["grads"], whole) == []


@pytest.mark.parametrize("kind", range(3), ids=layouts.TYPES)
def test_a_reference_without_an_absorption_gradient_fails(cases,
                                                          references, kind):
    lay, port, origin, dirs, target, mats = cases[SEEDS[1]]
    ref = dict(references[SEEDS[1]])
    loss, grads = port_step("kernel", port, origin, dirs, target, mats)
    assert mismatches(loss, grads, ref) == []
    ref["grads"] = list(ref["grads"])
    ref["grads"][3 * kind] = torch.zeros_like(ref["grads"][3 * kind])
    assert mismatches(loss, grads, ref) == \
        [f"{layouts.TYPES[kind]}.absorption"]


@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_the_step_returns_its_own_map(cases, backend):
    """``return_map``: the map the step took its loss of, which is the
    loudness map at the materials it started from."""
    lay, port, origin, dirs, target, mats = cases[SEEDS[0]]
    loss, _, pred = port_step(backend, port, origin, dirs, target, mats,
                              with_map=True)
    params = SceneParams(*(Materials(*mats[3 * i:3 * i + 3])
                           for i in range(3)))
    with torch.no_grad():
        want = loudness_map(origin, dirs, params.into_scene(port), CFG,
                            backend=backend, device=CPU)
    for f in target_dict(target):
        assert not getattr(pred, f).requires_grad
        torch.testing.assert_close(getattr(pred, f), getattr(want, f),
                                   rtol=0, atol=0)
    assert loss == float(_loudness_mse(want, target))


@pytest.mark.parametrize("seed", SEEDS)
def test_at_the_ports_map_the_gradients_agree_to_rounding(cases, seed):
    lay, port, origin, dirs, target, mats = cases[seed]
    _, grads, pred = port_step("kernel", port, origin, dirs, target, mats,
                               with_map=True)
    ref = reference_step(lay, origin, dirs, target, mats,
                         at=target_dict(pred))
    for name, g, r in zip(materials.leaf_names(), grads, ref["grads_at"]):
        assert float((g - r).abs().max()) <= AT_TOL * float(
            r.abs().max()), name


def test_the_reference_adam_is_the_ports_adam():
    """Three steps of the port's Adam against ``reference.adam`` from the
    optimizer's state before each."""
    g = torch.Generator().manual_seed(5)
    xs = [torch.rand((n,), generator=g) for n in (3, 5, 7)]
    opt = adam(1e-2)(xs)
    for _ in range(3):
        before = [x.detach().clone() for x in xs]
        state = [dict(opt.state.get(x, {})) for x in xs]
        for x in xs:
            x.grad = torch.randn(x.shape, generator=g)
        want = materials.adam(
            before, [x.grad for x in xs],
            [s.get("exp_avg", torch.zeros_like(x)).clone()
             for s, x in zip(state, xs)],
            [s.get("exp_avg_sq", torch.zeros_like(x)).clone()
             for s, x in zip(state, xs)],
            [float(s.get("step", 0.0)) for s in state],
            lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
        opt.step()
        # The port's tensors are float32, so their change carries their
        # rounding: half an ulp of a value below 1 is 6e-8.
        for x, w, b in zip(xs, want, before):
            torch.testing.assert_close(x.double() - b.double(),
                                       w - b.double(), rtol=1e-5,
                                       atol=1e-7)
