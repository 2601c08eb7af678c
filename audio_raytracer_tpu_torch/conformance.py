"""Conformance runner of the port: BASELINE configs 1-5, one command.

``python -m audio_raytracer_tpu_torch.conformance`` runs each config
end-to-end through the port with its gate and prints one verdict line per
config plus a summary (exit code 0 iff all pass). The configs and gates
are those of the JAX runner (``audio_raytracer_tpu/conformance.py``):

  1  64 sphere colliders, 4K rays, direct-path occlusion
         gate: full allclose vs the scalar NumPy oracle (utils/oracle)
  2  mixed AABB/OBB/sphere, 256 colliders, permeation attenuation
         gate: oracle allclose at an oracle-tractable ray subsample (the
         oracle is scalar Python) + the full 64K-ray workload executed
         through the port
  3  multi-bounce depth 4 + reverb impulse-response time bins
         gate: oracle allclose + IR-vs-oracle-echo binning consistency
  4  gradient workload (materials to a target loudness map)
         gate: finite-difference directional checks (float64) + material
         recovery (loudness error shrinks toward the target's)
  5  pod-scale structure: 8 sources, rays x prims sharded
         gate: a 4x2 ('rays', 'prims') mesh == 1 process, identical
         workload (shard invariance), the 8 ranks spawned as processes
         joined over gloo

Configs 1-3 run on ``--device`` (default ``cuda``; the card's kernels
with ``--backend kernel``, their plain versions on ``cpu``). Config 4
runs in float64 on the CPU through the dense tier, whatever ``--device``
says, as the JAX runner runs it in a CPU child with x64. Config 5's
ranks run on ``--device`` too (all on the one card, over gloo, since
NCCL puts one rank on a card), as the JAX runner runs it in a child with
8 virtual devices. Scenes come from the port's ``random_scene`` with
numpy seeds, so their bits differ from the JAX runner's; each gate
compares the port with the oracle, or with itself unsharded, on the
same scene.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch


def _first_line(e: Exception) -> str:
    lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
    return "; ".join(lines[:2]) if lines else type(e).__name__


CONFIG_NAMES = {
    1: "64 spheres, 4K rays, direct-path occlusion",
    2: "mixed 256 colliders, 64K rays, permeation",
    3: "multi-bounce depth 4 + reverb IR bins",
    4: "gradient workload: material recovery",
    5: "pod-scale structure: rays x prims sharded, 8 sources",
}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _oracle_gate(scene, cfg, backend, device, gate_rays=None):
    """Run the port and the oracle on the same scene. Returns (ok, detail)
    on a failure, (True, detail, result, oracle trace, gate cfg) on a
    pass. ``gate_rays``: oracle subsample size (None = all)."""
    from audio_raytracer_tpu_torch.models.raytracer import make_forward
    from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
    from audio_raytracer_tpu_torch.utils import oracle

    origin = torch.zeros((3,), device=device)
    dirs = fibonacci_directions(cfg.ray_count, device=device)
    if gate_rays is None or gate_rays >= cfg.ray_count:
        gate_cfg, gate_dirs = cfg, dirs
    else:
        # Per-ray semantics do not depend on the ray budget except
        # through the accumulator reduction, so the gates compare a
        # prefix of the rays, traced at the subsample size so the [B, T]
        # reductions compare like with like (config 2 runs the full size
        # itself).
        gate_cfg = dataclasses.replace(cfg, ray_count=gate_rays)
        gate_dirs = dirs[:gate_rays]
    result, settings = make_forward(gate_cfg, collect_debug=True,
                                    backend=backend, device=device)(
        origin, gate_dirs, scene)

    osc = oracle.from_scene(scene)
    host_dirs = _host(gate_dirs)
    otr = oracle.oracle_trace(
        osc, np.zeros(3), host_dirs, gate_cfg.max_hits_per_ray,
        gate_cfg.max_ray_life, gate_cfg.max_muffle_hit_distance,
        gate_cfg.num_accum_batches)
    operm = oracle.oracle_permeation(
        osc, np.zeros(3), host_dirs, gate_cfg.permeation_strength_per_ray,
        gate_cfg.num_accum_batches)
    oproc = oracle.oracle_process(
        otr["echo"], otr["muffle_hits"], operm, osc.target_positions,
        gate_cfg.ray_count, gate_cfg.max_hits_per_ray,
        gate_cfg.muffle_effectiveness,
        gate_cfg.permeation_strength_per_ray,
        gate_cfg.permeation_effectiveness, gate_cfg.max_reverb_distance)

    echo = _host(result.echo_distances).astype(np.float64)
    match = np.isclose(echo, otr["echo"], rtol=1e-4, atol=1e-3)
    if match.mean() <= 0.995:
        return False, f"echo mismatch rate {1 - match.mean():.4f}"
    hc = _host(result.hit_counts) == otr["hit_counts"]
    if hc.mean() <= 0.99:
        return False, f"hit_count mismatch rate {1 - hc.mean():.4f}"
    # Consistent with the 99.5% per-ray agreement gate: up to 0.5% of
    # (ray, bounce) slots may flip a razor-edge muffle visibility.
    muffle_budget = max(1, int(0.005 * gate_cfg.ray_count
                               * gate_cfg.max_hits_per_ray))
    muffle_diff = int(np.abs(_host(result.muffle_hits).astype(np.int64)
                             - otr["muffle_hits"]).sum())
    if muffle_diff > muffle_budget:
        return False, (f"muffle count divergence: {muffle_diff} flips "
                       f"(budget {muffle_budget})")
    muffle = _host(settings.muffle)
    try:
        np.testing.assert_allclose(_host(result.permeation).astype(
            np.float64), operm, rtol=1e-4, atol=1e-2)
        # Scalar-reduction tolerances admit the allowed 0.5% per-ray
        # trajectory divergence (one razor-edge occlusion flip in R rays
        # moves the echo sums by ~dist*echo/(R*max_reverb) ~ 1e-3).
        np.testing.assert_allclose(muffle, oproc["muffle"], rtol=1e-3,
                                   atol=3e-3)
        np.testing.assert_allclose(float(settings.reverb_strength),
                                   oproc["reverb_strength"], rtol=2e-2,
                                   atol=3e-3)
        np.testing.assert_allclose(float(settings.reverb_volume),
                                   oproc["reverb_volume"], rtol=2e-2,
                                   atol=3e-3)
    except AssertionError as e:
        return False, _first_line(e)
    detail = (f"echo match {match.mean():.4f}, "
              f"muffle {np.round(muffle, 3).tolist()} == oracle")
    return True, detail, result, otr, gate_cfg


def config_1(args):
    """Single source + listener, 64 spheres, 4K rays, direct path."""
    from audio_raytracer_tpu_torch.models.raytracer import random_scene
    from audio_raytracer_tpu_torch.types import TraceConfig

    rays = 1024 if args.fast else 4096
    cfg = TraceConfig(ray_count=rays, max_bounces=0, max_ray_life=200.0)
    scene = random_scene(1, num_spheres=64, num_aabbs=0, num_obbs=0,
                         num_targets=1, extent=30.0, size_range=(0.5, 3.0),
                         device=args.device)
    out = _oracle_gate(scene, cfg, args.backend, args.device)
    return out[0], (f"{out[1]}; gate @ {rays} rays x 64 spheres (full "
                    "fidelity)")


def config_2(args):
    """Mixed 256 colliders with permeation; the full 64K-ray run + the
    oracle gate at a tractable subsample."""
    from audio_raytracer_tpu_torch.models.raytracer import (
        make_forward,
        random_scene,
    )
    from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
    from audio_raytracer_tpu_torch.types import TraceConfig

    full_rays = 8192 if args.fast else 65536
    gate_rays = 256 if args.fast else 1024
    cfg = TraceConfig(ray_count=full_rays, max_bounces=1, max_ray_life=200.0)
    scene = random_scene(2, num_spheres=64, num_aabbs=128, num_obbs=64,
                         num_targets=2, extent=40.0, size_range=(0.5, 4.0),
                         device=args.device)
    # Full-size execution through the port (the named workload).
    t0 = time.perf_counter()
    _, settings = make_forward(cfg, backend=args.backend,
                               device=args.device)(
        torch.zeros(3, device=args.device),
        fibonacci_directions(full_rays, device=args.device), scene)
    muffle = _host(settings.muffle)
    full_ms = (time.perf_counter() - t0) * 1e3
    if not bool(np.all(np.isfinite(muffle))):
        return False, "full-size run produced non-finite muffle"
    out = _oracle_gate(scene, cfg, args.backend, args.device,
                       gate_rays=gate_rays)
    return out[0], (f"{out[1]}; oracle gate @ {gate_rays} rays, full "
                    f"{full_rays}-ray x 256-collider run {full_ms:.0f} ms")


def config_3(args):
    """Multi-bounce depth 4 + reverb IR accumulation into time bins."""
    from audio_raytracer_tpu_torch.models.raytracer import random_scene
    from audio_raytracer_tpu_torch.ops import reverb
    from audio_raytracer_tpu_torch.types import TraceConfig

    rays = 256 if args.fast else 512
    cfg = TraceConfig(ray_count=rays, max_bounces=4, max_ray_life=150.0,
                      num_reverb_bins=32, ir_max_distance=150.0)
    scene = random_scene(3, num_spheres=32, num_aabbs=64, num_obbs=32,
                         num_targets=2, extent=25.0, size_range=(1.0, 4.0),
                         device=args.device)
    out = _oracle_gate(scene, cfg, args.backend, args.device)
    if not out[0]:
        return False, out[1]
    detail, result, otr, gate_cfg = out[1:]
    # The port's histogram must equal binning the ORACLE's echo
    # distances; razor-edge trajectory divergence moves a few echoes
    # across bins, so compare distributions, not bins bitwise.
    ir = _host(result.reverb_ir)
    ir_oracle = _host(reverb.impulse_response(
        torch.as_tensor(otr["echo"], dtype=torch.float32), gate_cfg))
    denom = max(float(ir_oracle.sum()), 1.0)
    l1 = float(np.abs(ir - ir_oracle).sum()) / denom
    if l1 > 0.02:
        return False, f"IR L1 divergence {l1:.4f} vs oracle echo binning"
    return True, (f"{detail}; IR L1 divergence {l1:.4f} over "
                  f"{cfg.num_reverb_bins} bins @ depth 4")


def config_4(args):
    """Gradient workload: FD checks + material recovery, float64 on the
    CPU through the dense tier."""
    from audio_raytracer_tpu_torch.models.differentiable import (
        SceneParams,
        adam,
        loudness_loss,
        loudness_map,
        make_train_step,
    )
    from audio_raytracer_tpu_torch.models.raytracer import random_scene
    from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
    from audio_raytracer_tpu_torch.types import Materials, TraceConfig

    f64, cpu = torch.float64, "cpu"
    cfg = TraceConfig(ray_count=48 if args.fast else 64, max_bounces=3,
                      max_ray_life=150.0)
    scene = random_scene(11, num_spheres=10, num_aabbs=14, num_obbs=10,
                         num_targets=2, extent=12.0, size_range=(1.5, 5.0),
                         device=cpu, dtype=f64)
    origin = torch.zeros(3, dtype=f64)
    dirs = fibonacci_directions(cfg.ray_count, device=cpu, dtype=f64)
    kw = dict(backend="dense", device=cpu)
    target = loudness_map(origin, dirs, scene, cfg, **kw)

    # FD probes at PERTURBED params (the self-target point has zero loss
    # and zero gradient: every probe would be degenerate).
    def unravel(flat):
        parts = (x.clone() for x in torch.split(flat, sizes))
        return SceneParams(*(Materials(*(next(parts) for _ in range(3)))
                             for _ in range(3)))

    base = SceneParams.from_scene(scene).leaves()
    sizes = [x.numel() for x in base]
    flat_x = torch.clamp(torch.cat(base) * 0.6 + 0.15, min=0.05)

    def f(flat):
        return loudness_loss(unravel(flat), scene, origin, dirs, cfg,
                             target, **kw)

    x = flat_x.clone().requires_grad_(True)
    (flat_g,) = torch.autograd.grad(f(x), [x])
    eps = 1e-3
    checked = 0
    gen = np.random.default_rng(0)
    with torch.no_grad():
        for _ in range(3):
            v = torch.as_tensor(gen.standard_normal(flat_x.shape[0]))
            v = v / torch.linalg.vector_norm(v)
            fd = float((f(flat_x + eps * v) - f(flat_x - eps * v))
                       / (2 * eps))
            an = float(flat_g @ v)
            if abs(fd) < 1e-7 and abs(an) < 1e-7:
                continue
            if not np.isclose(an, fd, rtol=0.05, atol=1e-6):
                return False, (f"FD mismatch: analytic {an:.3e} vs "
                               f"central-diff {fd:.3e}")
            checked += 1
    if checked < 1:
        return False, "all FD probes degenerate"

    # Recovery gate: perturbed materials move the loudness map back.
    step, init = make_train_step(cfg, optimizer=adam(3e-2), **kw)
    p = unravel(flat_x)
    opt = init(p)

    @torch.no_grad()
    def loudness_err(pp):
        pred = loudness_map(origin, dirs, pp.into_scene(scene), cfg, **kw)
        return (float((pred.muffle - target.muffle).abs().max())
                + float((pred.permeation - target.permeation).abs().max()))

    err0 = loudness_err(p)
    steps = 40 if args.fast else 60
    for _ in range(steps):
        p, opt, loss = step(p, opt, scene, origin, dirs, target)
    err1 = loudness_err(p)
    if not (np.isfinite(float(loss)) and err1 < 0.5 * err0):
        return False, (f"recovery stalled: loudness err "
                       f"{err0:.4f} -> {err1:.4f}")
    return True, (f"{checked} FD probes within 5%; recovery err "
                  f"{err0:.4f} -> {err1:.4f} in {steps} steps")


def _config_5_workload(fast: bool, device):
    from audio_raytracer_tpu_torch.models.raytracer import random_scene
    from audio_raytracer_tpu_torch.types import TraceConfig

    rays = 1024 if fast else 4096
    prims = 128 if fast else 512
    cfg = TraceConfig(ray_count=rays, max_bounces=2, max_ray_life=150.0,
                      num_accum_batches=4)
    scene = random_scene(5, num_spheres=prims // 4, num_aabbs=prims // 2,
                         num_obbs=prims // 4, num_targets=8, extent=50.0,
                         size_range=(0.5, 4.0), device=device)
    return cfg, scene


def _config_5_rank(fast: bool, backend: str, device: str):
    """One rank of config 5's 4x2 mesh: its settings and its B1-B3
    launches."""
    from audio_raytracer_tpu_torch.ops.cuda import fused as F
    from audio_raytracer_tpu_torch.ops.cuda import kernels as K
    from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
    from audio_raytracer_tpu_torch.parallel.distributed import (
        local_ray_slice,
        settings_arrays,
    )
    from audio_raytracer_tpu_torch.parallel.mesh import (
        make_mesh,
        pad_scene_for_prim_shards,
        shard_scene,
    )
    from audio_raytracer_tpu_torch.parallel.sharded import (
        make_sharded_forward,
    )

    mesh = make_mesh(4, 2, backend="gloo", device=device)
    cfg, scene = _config_5_workload(fast, mesh.device)
    dirs = fibonacci_directions(cfg.ray_count, device=mesh.device)
    wrappers = (K.run_closest_hit, F.run_multi_any_hit, F.run_multi_chord)
    for w in wrappers:
        w.launches = 0
    settings = make_sharded_forward(cfg, mesh, backend=backend)(
        torch.zeros(3, device=mesh.device),
        dirs[local_ray_slice(cfg.ray_count, mesh)],
        shard_scene(pad_scene_for_prim_shards(scene, 2), mesh))
    return settings_arrays(settings), [w.launches for w in wrappers]


def config_5(args):
    """Shard invariance: a 4x2 ('rays', 'prims') mesh == 1 process."""
    from audio_raytracer_tpu_torch.models.raytracer import make_forward
    from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
    from audio_raytracer_tpu_torch.parallel.distributed import (
        settings_arrays,
        spawn,
    )

    cfg, scene = _config_5_workload(args.fast, args.device)
    _, dense = make_forward(cfg, backend=args.backend, device=args.device)(
        torch.zeros(3, device=args.device),
        fibonacci_directions(cfg.ray_count, device=args.device), scene)
    want = settings_arrays(dense)
    ranks = spawn(_config_5_rank, 8,
                  (args.fast, args.backend, str(args.device)))
    got, launches = ranks[0]
    try:
        for got_r, _ in ranks:
            for k in want:
                np.testing.assert_allclose(got_r[k], want[k], rtol=1e-5,
                                           atol=1e-6)
    except AssertionError as e:
        return False, _first_line(e)
    err = float(np.abs(got["muffle"] - want["muffle"]).max())
    return True, (f"4x2 mesh == 1 process @ {cfg.ray_count} rays x "
                  f"{scene.num_primitives} prims x 8 sources (muffle "
                  f"max|diff| {err:.2e}); rank 0 launched B1/B2/B3 "
                  f"{'/'.join(map(str, launches))} [8 ranks over gloo "
                  f"on {args.device}]")


CONFIGS = {1: config_1, 2: config_2, 3: config_3, 4: config_4,
           5: config_5}


def main(argv=None):
    from audio_raytracer_tpu_torch.types import resolve_device

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--only", type=int, choices=sorted(CONFIGS),
                   action="append",
                   help="run only these configs (repeatable)")
    p.add_argument("--fast", action="store_true",
                   help="reduced gate sizes (CI lane)")
    p.add_argument("--backend", default="kernel", choices=["kernel", "dense"],
                   help="intersection engine for the forward gates")
    p.add_argument("--device", default="cuda",
                   help="device of configs 1-3 and 5 (config 4 runs on "
                        "the CPU)")
    args = p.parse_args(argv)
    args.device = resolve_device(args.device)

    which = sorted(set(args.only)) if args.only else sorted(CONFIGS)
    failures = 0
    for i in which:
        t0 = time.perf_counter()
        try:
            ok, detail = CONFIGS[i](args)
        except Exception as e:  # a crash is a FAIL, not an abort
            ok, detail = False, f"exception: {type(e).__name__}: {e}"
        dt = time.perf_counter() - t0
        verdict = "PASS" if ok else "FAIL"
        print(f"config {i} [{CONFIG_NAMES[i]}]: {verdict} ({dt:.1f}s) "
              f"- {detail}", flush=True)
        failures += 0 if ok else 1
    total = len(which)
    print(f"conformance: {total - failures}/{total} PASS", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
