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
unless asked for the CPU (``--device cpu``); there, with the kernel
backend, every step after the second replays one captured CUDA graph
(models/step_graph.py); so do --mesh steps on ranks joined by NCCL (a
card each), while gloo ranks sharing a card step eagerly.

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
the JAX package's.

--mesh RxP trains the materials over an R x P ('rays', 'prims') mesh of
rank processes (parallel/train.py::make_sharded_train_step, the
materials split over the prim shards): the scene is padded per prim
shard and the parameters re-derived on the padded scene; the MAE covers
the active primitives only. Rank 0 logs and writes the checkpoint (the
parameters and Adam moments gathered from every shard); --resume
restores every rank from it. The ranks come from torchrun or the ART_*
variables, or are started locally
(``parallel/distributed.py::run_meshed``).
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


def _parser():
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
    p.add_argument("--mesh", metavar="RxP",
                   help="train sharded over an R x P ('rays', 'prims') "
                        "mesh of rank processes (params split over prims)")
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
    return p


def _gather_prims(tensors, mesh):
    """Each tensor's full leading axis from this rank's prim shard of it
    (zeros elsewhere, summed over the ``prims`` group)."""
    out = []
    for x in tensors:
        per = x.shape[0]
        full = x.new_zeros((per * mesh.prim_shards,) + tuple(x.shape[1:]))
        full[mesh.prim_index * per:(mesh.prim_index + 1) * per] = x.detach()
        out.append(full)
    from audio_raytracer_tpu_torch.parallel import comm

    return comm.all_reduce_sums(out, mesh.prims)


def _full_state(params, opt, mesh):
    """(the padded scene's parameters, the optimizer's state_dict with
    its moments) gathered from every prim shard (a collective)."""
    from audio_raytracer_tpu_torch.models.differentiable import SceneParams
    from audio_raytracer_tpu_torch.types import Materials

    leaves = _gather_prims(params.leaves(), mesh)
    full = SceneParams(*(Materials(*leaves[3 * i:3 * i + 3])
                         for i in range(3)))
    sd = opt.state_dict()
    keys = sorted(sd["state"])
    moments = _gather_prims([sd["state"][k][m] for k in keys
                             for m in ("exp_avg", "exp_avg_sq")], mesh)
    state = {k: dict(sd["state"][k], exp_avg=moments[2 * i],
                     exp_avg_sq=moments[2 * i + 1])
             for i, k in enumerate(keys)}
    return full, dict(sd, state=state)


def _shard_state(opt_state, mesh):
    """A gathered optimizer state_dict cut to this rank's prim shard."""
    from audio_raytracer_tpu_torch.parallel.mesh import shard_rows

    def cut(st):
        return {k: shard_rows(v, mesh).clone() if k != "step" else v
                for k, v in st.items()}

    return dict(opt_state, state={k: cut(v)
                                  for k, v in opt_state["state"].items()})


def _train(args, mesh=None):
    """The materials calibration on ``args.device`` (on ``mesh.device``
    over a mesh); returns the JSON summary (None on a mesh's other
    ranks)."""
    from audio_raytracer_tpu_torch.models.differentiable import (
        SceneParams,
        adam,
        loudness_map,
        make_train_step,
    )
    from audio_raytracer_tpu_torch.types import Materials, tensors_of
    from audio_raytracer_tpu_torch.utils.checkpoint import (
        load_optimizer_state,
        restore_checkpoint,
        save_checkpoint,
    )

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    leader = mesh is None or torch.distributed.get_rank() == 0
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
    local, local_dirs = scene, dirs
    if mesh is None:
        step, init = make_train_step(cfg, optimizer=adam(args.lr),
                                     backend=args.backend, device=dev)
    else:
        from audio_raytracer_tpu_torch.parallel import comm
        from audio_raytracer_tpu_torch.parallel.distributed import (
            local_ray_slice,
        )
        from audio_raytracer_tpu_torch.parallel.mesh import (
            pad_scene_for_prim_shards,
            shard_scene,
        )
        from audio_raytracer_tpu_torch.parallel.train import (
            make_sharded_train_step,
            shard_params,
        )

        if cfg.ray_count % mesh.ray_shards:
            raise ValueError(f"--rays {cfg.ray_count} must divide by "
                             f"{mesh.ray_shards} ray shards")
        # Every rank trains toward rank 0's recording, bit for bit.
        for t in tensors_of(target):
            comm.broadcast(t, src=0, group=mesh.world)
        scene = pad_scene_for_prim_shards(scene, mesh.prim_shards)
        # Re-derive the parameters on the padded scene: the padding's
        # entries start at the truth (inactive, they get no gradient).
        truth = SceneParams.from_scene(scene)
        params = SceneParams(*(Materials(*(
            torch.cat([p, t[p.shape[0]:]])
            for p, t in zip(params.leaves()[3 * i:3 * i + 3],
                            truth.leaves()[3 * i:3 * i + 3])))
            for i in range(3)))
        local = shard_scene(scene, mesh)
        local_dirs = dirs[local_ray_slice(cfg.ray_count, mesh)]
        step, init = make_sharded_train_step(cfg, mesh,
                                             optimizer=adam(args.lr),
                                             backend=args.backend)

    start = 0
    opt_state = None
    if args.resume and args.checkpoint:
        state = restore_checkpoint(
            args.checkpoint, {"params": params, "opt_state": None,
                              "step": 0})
        params, opt_state = state["params"], state["opt_state"]
        start = int(state["step"])
        if leader:
            print(f"resumed from step {start}", file=sys.stderr)
    if mesh is not None:
        params = shard_params(params, mesh)
        if opt_state is not None:
            opt_state = _shard_state(opt_state, mesh)
    opt = init(params)
    if opt_state is not None:  # before the first step: the graph's key
        load_optimizer_state(opt, opt_state)

    def full_state():
        if mesh is None:
            return params, opt.state_dict()
        return _full_state(params, opt, mesh)

    loss = first_loss = float("nan")
    for i in range(start, args.steps):
        params, opt, loss = step(params, opt, local, origin, local_dirs,
                                 target)
        if i == start:
            first_loss = float(loss)
        if leader and (i % args.log_every == 0 or i == args.steps - 1):
            print(f"step {i:4d}: loss {float(loss):.3e}", file=sys.stderr)
        if args.checkpoint and ((i + 1) % args.ckpt_every == 0
                                or i == args.steps - 1):
            full, opt_full = full_state()
            if leader:
                save_checkpoint(args.checkpoint,
                                {"params": full, "opt_state": opt_full,
                                 "step": i + 1})

    full, _ = full_state()
    loaded.registry.close()
    if not leader:
        return None
    errs = _material_errors(full, truth, active_counts)
    return {
        "steps": args.steps,
        "start_step": start,
        "first_loss": first_loss,
        "final_loss": float(loss),
        "material_mae": {k: round(v, 4) for k, v in errs.items()},
        "backend": args.backend,
        "device": str(dev),
        "mesh": args.mesh,
    }


def main(argv=None, mesh_timeout=None):
    """The CLI. ``mesh_timeout``: seconds before the local ranks of
    ``--mesh`` are stopped (None: no deadline), for callers that must
    not wait on a hung rank."""
    from audio_raytracer_tpu_torch.parallel import distributed

    p = _parser()
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
        if args.mesh:
            distributed.parse_mesh(args.mesh)
            if args.recover_pose:
                raise ValueError("--mesh trains materials only (as the JAX "
                                 "CLI): drop --recover-pose")
    except (RuntimeError, ValueError) as e:
        p.error(str(e))

    if args.recover_pose:
        _recover_pose(args, dev)
        return 0
    if args.mesh:
        summary = distributed.run_meshed(
            _train, args.mesh, (args,), device=args.device,
            log=lambda m: print(f"train_materials: {m}", file=sys.stderr,
                                flush=True),
            timeout=mesh_timeout)
    else:
        summary = _train(args)
    if summary is not None:
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
