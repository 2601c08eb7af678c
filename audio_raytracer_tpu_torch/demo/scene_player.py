"""Headless scene player: the demo-app layer as a CLI.

The counterpart of ``audio_raytracer_tpu/demo/scene_player.py``. It
reproduces the Unity demo semantics without an engine: a frame loop
(UpdateScheduler analog) ticks waypoint animations (PlatformMover),
publishes scene mutations through the double-buffered registry, runs the
raytrace loop, feeds per-target settings into the spatializer DSP chain,
and optionally renders the result to a stereo WAV. It runs on the card
unless asked for the CPU (``--device cpu``).

Usage:
  python -m audio_raytracer_tpu_torch.demo.scene_player      # sample scene
  python -m audio_raytracer_tpu_torch.demo.scene_player --scene my.json \\
      --frames 120 --render-wav out.wav --npz trace.npz
  python -m audio_raytracer_tpu_torch.demo.scene_player --mesh 2x2

``--mesh RxP`` serves through the meshed loop
(``AsyncRaytraceLoop(mesh=)``), one process per rank: rank 0 animates
the scene and writes the history, the WAV and the viz, the other ranks
serve. The ranks come from ``parallel/distributed.py::run_meshed``:
under torchrun or the ART_* variables each process is a rank; otherwise
the player starts R x P local ranks, NCCL with one card per rank where
there are cards enough, else gloo with the ranks sharing the one
device. Its first log line says which.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import wave

import numpy as np
import torch

from audio_raytracer_tpu_torch.runtime.orchestrator import AsyncRaytraceLoop
from audio_raytracer_tpu_torch.types import TargetSettings, resolve_device


def simulate(loaded, frames=60, dt=1.0 / 60.0, backend="kernel",
             listener_path=None, verbose=True, viz_every=0, viz_path=None,
             device="cuda", mesh=None):
    """Run the frame loop on ``device``; returns the per-frame settings
    history as numpy arrays on the host.

    mesh: this rank's ('rays', 'prims') ``parallel/mesh.py::Mesh``; the
    loop then serves through the sharded forward on ``mesh.device``
    (``AsyncRaytraceLoop(mesh=)``). Every rank calls ``simulate`` with
    the same document and ``frames``: rank 0 animates, ticks with the
    listener's position and returns the history; the other ranks only
    serve its ticks and return None. Muffle values depend on
    ``num_accum_batches`` by reference semantics (the permeation
    overwrite writes one slot per thread batch), and the meshed loop
    takes one batch per ray shard.

    The loop is synchronous (``compute_async=False``), as in the JAX
    player, so the history is deterministic: each frame's settings are
    those of the frame before it. ``backend``: "kernel" or "dense".

    listener_path: optional callable t -> [3] position (the
    PlayerController analog). Falls back to the scene's
    "listener.waypoints" scripted path (scene_format.ListenerAnimation)
    when present, else a stationary listener.

    viz_every: dump a gizmo-layer PNG of the live scene every N frames
    (the in-loop equivalent of the reference's editor gizmos drawing
    WHILE the sim runs, Audio/AudioRayTracer.cs:291-355); the frame index
    is appended to ``viz_path`` (default "frame.png" -> frame_0042.png).
    """
    if mesh is not None and torch.distributed.get_rank() != 0:
        loop = AsyncRaytraceLoop(None, loaded.cfg, backend=backend,
                                 compute_async=False, mesh=mesh)
        for _ in range(frames):
            loop.tick()
        return None
    dev = resolve_device(device) if mesh is None else mesh.device
    loop = AsyncRaytraceLoop(loaded.registry, loaded.cfg, backend=backend,
                             compute_async=False, device=dev, mesh=mesh)
    if listener_path is None and loaded.listener_animation is not None:
        anim = loaded.listener_animation

        def listener_path(_t, _anim=anim, _dt=dt):
            return _anim.step(_dt)
    T = len(loaded.target_names)
    n_bins = loaded.cfg.num_reverb_bins
    history = dict(muffle=np.zeros((frames, T)),
                   reverb_strength=np.zeros(frames),
                   reverb_volume=np.zeros(frames),
                   listener=np.zeros((frames, 3)),
                   perceived_position=np.zeros((frames, T, 3)),
                   frame_ms=np.zeros(frames))
    if n_bins > 0:
        history["reverb_ir"] = np.zeros((frames, n_bins))

    for f in range(frames):
        t0 = time.perf_counter()
        sim_t = f * dt
        pos = (listener_path(sim_t) if listener_path
               else loaded.listener_position)
        for anim in loaded.animations:
            anim.step(loaded.registry, dt)
        settings = loop.tick(pos)
        if settings is not None:
            history["muffle"][f] = settings.muffle.cpu().numpy()
            history["reverb_strength"][f] = float(settings.reverb_strength)
            history["reverb_volume"][f] = float(settings.reverb_volume)
            # The position the completed trace actually used — the
            # PercievedAudioPosition the DSP pans with
            # (AudioTargetRTSettings.cs:8-16; moving sources via
            # TargetAnimation land here a harvest later).
            history["perceived_position"][f] = \
                settings.perceived_position.cpu().numpy()
            if n_bins > 0 and loop.reverb_ir is not None:
                history["reverb_ir"][f] = loop.reverb_ir.cpu().numpy()
        else:
            history["perceived_position"][f] = loaded.registry.snapshot(
                device=dev).target_positions.cpu().numpy()
        history["listener"][f] = np.asarray(pos)
        history["frame_ms"][f] = (time.perf_counter() - t0) * 1e3
        if viz_every and f % viz_every == 0:
            from audio_raytracer_tpu_torch.demo.visualize import plot_trace

            base = viz_path or "frame.png"
            root, ext = os.path.splitext(base)
            out = f"{root}_{f:04d}{ext or '.png'}"
            if os.path.dirname(out):
                os.makedirs(os.path.dirname(out), exist_ok=True)
            plot_trace(loaded, out, rays=min(loaded.cfg.ray_count, 256),
                       backend=backend, listener=pos, device=dev)
            if verbose:
                print(f"frame {f:4d}: wrote {out}", file=sys.stderr)
        if verbose and f % max(1, frames // 10) == 0:
            m = history["muffle"][f]
            print(f"frame {f:4d}: muffle={np.round(m, 3)} "
                  f"reverb={history['reverb_strength'][f]:.3f} "
                  f"({history['frame_ms'][f]:.1f} ms)", file=sys.stderr)
    return history


def render_wav(loaded, history, path, sample_rate=48000, dt=1.0 / 60.0,
               device="cuda"):
    """Render each target as a distinct tone through the DSP chain on
    ``device``, using the per-frame ray-traced settings; mix on the host
    to a stereo 16-bit WAV.

    When the trace recorded an impulse response (the history has
    ``reverb_ir``), the IR-driven convolution tail is rendered too — the
    audible reverb the reference delegated to Unity's AudioReverbFilter.

    Every buffer goes through one ``make_spatialize`` step, as the JAX
    player's through one jitted ``spatialize``: on the card a replay of
    its captured CUDA graph, every target sharing it.
    """
    from audio_raytracer_tpu_torch.models.spatializer import (
        DSPState,
        SpatializerSettings,
        ir_kernel_length,
        make_spatialize,
    )

    dev = resolve_device(device)
    frames = len(history["reverb_strength"])
    T = history["muffle"].shape[1]
    n_per_frame = int(sample_rate * dt)
    settings = SpatializerSettings.default(device=dev)
    ir_hist = history.get("reverb_ir")
    tail_len = None
    if ir_hist is not None:
        settings = dataclasses.replace(
            settings, render_reverb_tail=True,
            reverb_ir_max_distance=torch.tensor(
                float(loaded.cfg.ir_max_distance), device=dev))
        tail_len = ir_kernel_length(ir_hist.shape[1],
                                    float(loaded.cfg.ir_max_distance),
                                    float(sample_rate)) - 1
    spatialize = make_spatialize(settings, float(sample_rate), device=dev)
    freqs = [220.0 * (1.5 ** i) for i in range(T)]
    states = [DSPState.zero(tail_len=tail_len, device=dev) for _ in range(T)]
    # Per-frame perceived positions (moving sources pan audibly);
    # histories without the key fall back to the registry's static
    # target positions.
    pos_hist = history.get("perceived_position")
    if pos_hist is None:
        static = loaded.registry.snapshot(
            device="cpu").target_positions.numpy()
        pos_hist = np.broadcast_to(static, (frames,) + static.shape)

    def put(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=dev)

    mix = np.zeros((frames * n_per_frame, 2), np.float32)
    phase = np.zeros(T)
    for f in range(frames):
        targets = np.asarray(pos_hist[f])
        rt = TargetSettings(
            muffle=put(history["muffle"][f]),
            reverb_strength=put(history["reverb_strength"][f]),
            reverb_volume=put(history["reverb_volume"][f]),
            perceived_position=put(targets))
        listener = history["listener"][f]
        ir = put(ir_hist[f]) if ir_hist is not None else None
        for ti in range(T):
            n = n_per_frame
            tt = (np.arange(n) + phase[ti]) / sample_rate
            phase[ti] += n
            tone = 0.25 * np.sin(2 * np.pi * freqs[ti] * tt)
            buf = put(np.stack([tone, tone], -1))
            rel = targets[ti] - listener
            dist = float(np.linalg.norm(rel))
            out, states[ti], _ = spatialize(
                buf, states[ti], rt, ti, put(rel / max(dist, 1e-6)),
                put(dist), reverb_ir=ir)
            mix[f * n:(f + 1) * n] += out.cpu().numpy()

    peak = np.abs(mix).max() or 1.0
    pcm = np.clip(mix / max(peak, 1.0), -1, 1)
    pcm16 = (pcm * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16.tobytes())


def _parser():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", help="scene JSON (default: built-in sample)")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--dt", type=float, default=1.0 / 60.0)
    p.add_argument("--backend", default="kernel", choices=["kernel", "dense"],
                   help="kernel: the CUDA kernels; dense: plain "
                        "[rays, prims] grids")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--render-wav", metavar="PATH")
    p.add_argument("--npz", metavar="PATH", help="save settings history")
    p.add_argument("--viz", metavar="PATH",
                   help="render the final frame's traced hits + scene "
                        "geometry to PNG (demo.visualize; needs "
                        "matplotlib)")
    p.add_argument("--viz-every", type=int, default=0, metavar="N",
                   help="ALSO dump a gizmo PNG every N frames while the "
                        "sim runs (live view; frame index appended to "
                        "the --viz path)")
    p.add_argument("--orbit", action="store_true",
                   help="listener orbits the origin (PlayerController "
                        "stand-in)")
    p.add_argument("--mesh", metavar="RxP",
                   help="serve through an R x P ('rays', 'prims') mesh of "
                        "rank processes (module docstring)")
    return p


def _play(args, mesh=None):
    """Load the scene, run ``simulate`` on ``args.device`` (on
    ``mesh.device`` over a mesh) and write the outputs; returns the JSON
    summary (None on a mesh's other ranks)."""
    from audio_raytracer_tpu_torch.demo.sample_scene import sample_scene_dict
    from audio_raytracer_tpu_torch.demo.scene_format import (
        build_registry,
        load_scene_file,
    )

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    loaded = (load_scene_file(args.scene) if args.scene
              else build_registry(sample_scene_dict()))
    leader = mesh is None or torch.distributed.get_rank() == 0
    if mesh is not None and loaded.cfg.ray_count % mesh.ray_shards:
        rc = -(-loaded.cfg.ray_count // mesh.ray_shards) * mesh.ray_shards
        if leader:
            print(f"rounding ray_count {loaded.cfg.ray_count} -> {rc} for "
                  f"{mesh.ray_shards} ray shards", file=sys.stderr)
        loaded.cfg = dataclasses.replace(loaded.cfg, ray_count=rc)

    listener_path = None
    if args.orbit:
        base = np.asarray(loaded.listener_position)

        def listener_path(t):
            return base + np.asarray(
                [6.0 * np.sin(0.5 * t), 0.0, 6.0 * np.cos(0.5 * t)])

    history = simulate(loaded, frames=args.frames, dt=args.dt,
                       backend=args.backend, listener_path=listener_path,
                       viz_every=args.viz_every, viz_path=args.viz,
                       device=dev, mesh=mesh)
    if not leader:
        loaded.registry.close()
        return None

    summary = {
        "frames": args.frames,
        "targets": loaded.target_names,
        "muffle_mean": np.round(history["muffle"].mean(axis=0), 4).tolist(),
        "muffle_range": [np.round(history["muffle"].min(axis=0), 4).tolist(),
                         np.round(history["muffle"].max(axis=0), 4).tolist()],
        "reverb_strength_mean": round(float(
            history["reverb_strength"].mean()), 4),
        "reverb_volume_mean": round(float(
            history["reverb_volume"].mean()), 4),
        "frame_ms_median": round(float(np.median(history["frame_ms"])), 2),
        "backend": args.backend,
        "device": str(dev),
        "mesh": args.mesh,
    }
    if args.npz:
        np.savez(args.npz, **history)
        print(f"saved history to {args.npz}", file=sys.stderr)
    if args.render_wav:
        render_wav(loaded, history, args.render_wav, dt=args.dt, device=dev)
        print(f"rendered {args.render_wav}", file=sys.stderr)
    if args.viz:
        from audio_raytracer_tpu_torch.demo.visualize import plot_trace

        # Trace from where the listener ENDED (the scene geometry is
        # already at its final animated state in the registry).
        plot_trace(loaded, args.viz, rays=max(loaded.cfg.ray_count, 256),
                   backend=args.backend, listener=history["listener"][-1],
                   device=dev)
        print(f"wrote {args.viz}", file=sys.stderr)
    loaded.registry.close()
    return summary


def main(argv=None, mesh_timeout=None):
    """The CLI. ``mesh_timeout``: seconds before the local ranks of
    ``--mesh`` are stopped (None: no deadline), for callers that must
    not wait on a hung rank."""
    from audio_raytracer_tpu_torch.parallel import distributed

    p = _parser()
    args = p.parse_args(argv)
    try:
        resolve_device(args.device)
        if args.mesh:
            distributed.parse_mesh(args.mesh)
    except (RuntimeError, ValueError) as e:
        p.error(str(e))
    if args.mesh:
        summary = distributed.run_meshed(
            _play, args.mesh, (args,), device=args.device,
            log=lambda m: print(f"scene_player: {m}", file=sys.stderr,
                                flush=True),
            timeout=mesh_timeout)
    else:
        summary = _play(args)
    if summary is not None:
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
