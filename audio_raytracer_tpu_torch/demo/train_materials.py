"""Material calibration CLI: learn audio materials from a loudness map.

The counterpart of ``audio_raytracer_tpu/demo/train_materials.py``. The
reference's materials are hand-authored ScriptableObject assets
(Assets/ScriptableObjects/AudioMaterials/*.asset — Concrete, Wood,
Steel, Echo) tuned by ear. This framework makes them LEARNABLE
(BASELINE config 4): trace the target loudness map with the scene's
authored materials, reinitialize (or perturb) the material parameters,
and recover them by gradient descent through the differentiable tracer
(models/differentiable.py — the chord adjoints as CUDA kernels on the
kernel backend, straight-through trajectories). It runs on the card
unless asked for the CPU (``--device cpu``).

Usage:
  python -m audio_raytracer_tpu_torch.demo.train_materials      # sample
  python -m audio_raytracer_tpu_torch.demo.train_materials \\
      --scene my.json --steps 300 --rays 512 --lr 0.02 --init noisy \\
      --checkpoint /tmp/calib
Prints a JSON summary line, last on stdout; with --checkpoint, training
is resumable (params + optimizer moments + step counter round-trip,
--resume).

--recover-pose switches from materials to POSES:
  --recover-pose source    perturb the audio-target positions, then
      triangulate them back from loudness recordings at several known
      listener positions (models.differentiable.make_source_recovery_step)
  --recover-pose listener  perturb the listener origin, then recover it
      from one recording with the IR histogram enabled (distance
      -resolved observables; make_pose_recovery_step)

The noise of --init noisy and of the pose perturbation comes from a
torch.Generator seeded by --seed: the same start on every device, not
the JAX package's. The JAX CLI's --mesh (training over a device mesh)
is not ported yet (ROADMAP item 10b); the sharded materials step it
would call is parallel/train.py::make_sharded_train_step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from audio_raytracer_tpu_torch.types import resolve_device


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _material_errors(params, truth, active_counts=None):
    """Mean |learned - authored| per material field, ACTIVE prims only.

    ``active_counts``: {"sphere": n, "aabb": n, "obb": n}, the count of
    leading entries of each type to average over (all when None)."""
    errs = {}
    for field in ("absorption", "density", "echo"):
        num, den = 0.0, 0
        for tname in ("sphere", "aabb", "obb"):
            a = _host(getattr(getattr(params, tname), field))
            b = _host(getattr(getattr(truth, tname), field))
            n = a.size if active_counts is None else active_counts[tname]
            num += np.abs(a[:n] - b[:n]).sum()
            den += n
        errs[field] = float(num / max(den, 1))
    return errs


def _load(args, dev):
    """(loaded scene, its snapshot on ``dev``, the config at --rays, the
    listener origin and the Fibonacci directions on ``dev``)."""
    from audio_raytracer_tpu_torch.demo.sample_scene import sample_scene_dict
    from audio_raytracer_tpu_torch.demo.scene_format import (
        build_registry,
        load_scene_file,
    )
    from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions

    loaded = (load_scene_file(args.scene) if args.scene
              else build_registry(sample_scene_dict()))
    scene = loaded.registry.snapshot(device=dev)
    cfg = dataclasses.replace(loaded.cfg, ray_count=args.rays)
    origin = torch.as_tensor(loaded.listener_position, dtype=torch.float32,
                             device=dev)
    return loaded, scene, cfg, origin, fibonacci_directions(args.rays,
                                                            device=dev)


def _recover_pose(args, dev):
    """--recover-pose: perturb poses with a seeded offset, then
    recover them by gradient descent through the chord/echo paths."""
    from audio_raytracer_tpu_torch.models.differentiable import (
        PoseParams,
        adam,
        loudness_map,
        make_pose_recovery_step,
        make_source_recovery_step,
        stack_loudness,
    )

    loaded, scene, cfg, origin, dirs = _load(args, dev)
    gen = torch.Generator().manual_seed(args.seed)
    true_tp = scene.target_positions

    def noise(shape):
        return args.pose_perturbation * torch.randn(
            shape, generator=gen).to(dev)

    if args.recover_pose == "source":
        # Recordings at the authored listener + 3 offset vantage points
        # (acoustic triangulation; one vantage point is unobservable —
        # see make_source_recovery_step).
        origins = torch.stack([
            origin,
            origin + torch.tensor([5.0, 0.5, -3.0], device=dev),
            origin + torch.tensor([-5.0, 1.0, 3.0], device=dev),
            origin + torch.tensor([2.0, 0.0, -6.0], device=dev),
        ])
        with torch.no_grad():
            recs = stack_loudness([
                loudness_map(origins[i], dirs, scene, cfg,
                             backend=args.backend, device=dev)
                for i in range(origins.shape[0])])
        tp = true_tp + noise(true_tp.shape)
        step, init = make_source_recovery_step(
            cfg, num_listeners=origins.shape[0], optimizer=adam(args.lr),
            backend=args.backend, device=dev)
        opt = init(tp)

        def pose_error():
            return float(torch.linalg.vector_norm(
                tp.detach() - true_tp, dim=-1).mean())

        def take_step():
            return step(tp, opt, scene, origins, dirs, recs)[2]
    else:  # listener
        # One recording, IR histogram on (distance-resolved bins make
        # the origin well-determined).
        if cfg.num_reverb_bins == 0:
            cfg = dataclasses.replace(cfg, num_reverb_bins=48,
                                      ir_max_distance=cfg.max_ray_life)
        with torch.no_grad():
            rec = loudness_map(origin, dirs, scene, cfg,
                               backend=args.backend, device=dev)
        pose = PoseParams(origin=origin + noise((3,)),
                          target_positions=true_tp.clone())
        step, init = make_pose_recovery_step(
            cfg, optimizer=adam(args.lr), backend=args.backend,
            recover=("origin",), device=dev)
        opt = init(pose)

        def pose_error():
            return float(torch.linalg.vector_norm(
                pose.origin.detach() - origin))

        def take_step():
            return step(pose, opt, scene, dirs, rec)[2]

    err0 = pose_error()
    loss = float("nan")
    for i in range(args.steps):
        loss = take_step()
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d}: loss {float(loss):.3e} "
                  f"pose_err {pose_error():.4f}", file=sys.stderr)
    err1 = pose_error()

    print(json.dumps({
        "mode": f"recover_pose_{args.recover_pose}",
        "steps": args.steps,
        "final_loss": float(loss),
        "pose_error_initial": round(err0, 4),
        "pose_error_final": round(err1, 4),
        "backend": args.backend,
        "device": str(dev),
    }), flush=True)
    loaded.registry.close()


def _noisy(truth, gen):
    """The authored materials with N(0, 0.3) noise from ``gen`` (drawn on
    the CPU), clamped at 0 and absorption at 1."""
    from audio_raytracer_tpu_torch.types import Materials

    def jitter(x):
        n = torch.randn(x.shape, generator=gen).to(x.device)
        return torch.clamp(x + 0.3 * n, min=0.0)

    def noisy(m):
        return Materials(absorption=torch.clamp(jitter(m.absorption),
                                                max=1.0),
                         density=jitter(m.density), echo=jitter(m.echo))

    return type(truth)(sphere=noisy(truth.sphere), aabb=noisy(truth.aabb),
                       obb=noisy(truth.obb))


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", help="scene JSON (default: built-in sample)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--rays", type=int, default=512)
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--backend", default="kernel", choices=["kernel", "dense"],
                   help="kernel: the CUDA kernels and their adjoints; "
                        "dense: plain [rays, prims] grids under autograd")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--init", default="default",
                   choices=["default", "noisy"],
                   help="start from AudioMaterialProperties.Default "
                        "{0,1,1} or from the authored values + noise")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", metavar="DIR",
                   help="save {params, opt_state, step} here")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", action="store_true",
                   help="restore from --checkpoint and continue")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--recover-pose", choices=["source", "listener"],
                   help="recover poses instead of materials (see module "
                        "docstring)")
    p.add_argument("--pose-perturbation", type=float, default=0.8,
                   help="seeded perturbation magnitude for --recover-pose")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        p.error(str(e))

    if args.recover_pose:
        _recover_pose(args, dev)
        return 0

    from audio_raytracer_tpu_torch.models.differentiable import (
        SceneParams,
        adam,
        loudness_map,
        make_train_step,
    )
    from audio_raytracer_tpu_torch.types import Materials
    from audio_raytracer_tpu_torch.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    loaded, scene, cfg, origin, dirs = _load(args, dev)

    # Target = the authored materials' loudness map (the "recording").
    truth = SceneParams.from_scene(scene)
    with torch.no_grad():
        target = loudness_map(origin, dirs, scene, cfg,
                              backend=args.backend, device=dev)

    if args.init == "default":
        params = SceneParams(
            *(Materials.default(m.count, device=dev)
              for m in (truth.sphere, truth.aabb, truth.obb)))
    else:
        params = _noisy(truth, torch.Generator().manual_seed(args.seed))

    active_counts = {"sphere": scene.spheres.count,
                     "aabb": scene.aabbs.count, "obb": scene.obbs.count}
    step, init = make_train_step(cfg, optimizer=adam(args.lr),
                                 backend=args.backend, device=dev)
    start = 0
    opt_state = None
    if args.resume and args.checkpoint:
        state = restore_checkpoint(
            args.checkpoint, {"params": params,
                              "opt_state": init(params).state_dict(),
                              "step": 0})
        params, opt_state = state["params"], state["opt_state"]
        start = int(state["step"])
        print(f"resumed from step {start}", file=sys.stderr)
    opt = init(params)
    if opt_state is not None:
        opt.load_state_dict(opt_state)

    loss = float("nan")
    for i in range(start, args.steps):
        params, opt, loss = step(params, opt, scene, origin, dirs, target)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d}: loss {float(loss):.3e}", file=sys.stderr)
        if args.checkpoint and ((i + 1) % args.ckpt_every == 0
                                or i == args.steps - 1):
            save_checkpoint(args.checkpoint,
                            {"params": params, "opt_state": opt.state_dict(),
                             "step": i + 1})

    errs = _material_errors(params, truth, active_counts)
    print(json.dumps({
        "steps": args.steps,
        "final_loss": float(loss),
        "material_mae": {k: round(v, 4) for k, v in errs.items()},
        "backend": args.backend,
        "device": str(dev),
    }), flush=True)
    loaded.registry.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
