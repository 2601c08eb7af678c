"""Ray/hit visualization: the reference's editor gizmo layer as a CLI.

The counterpart of ``audio_raytracer_tpu/demo/visualize.py``; the frame
is traced on the card unless asked for the CPU (``--device cpu``).
matplotlib is imported only where a figure is drawn: without it, these
functions and the CLI raise an ImportError that names it.

The reference's only verification tool is gizmo drawing — hit markers,
ray trails, echo lines, collider wireframes, capped at 5000 gizmos
(Audio/AudioRayTracer.cs:291-355, AudioColliderManager.cs:144-160).
This renders the same picture headlessly: one traced frame's bounce
points over the scene geometry, top-down (x-z) and side (x-y), saved as
a PNG — so demo regressions are visible, not just numeric.

Usage:
  python -m audio_raytracer_tpu_torch.demo.visualize          # sample scene
  python -m audio_raytracer_tpu_torch.demo.visualize --scene my.json \
      --out trace.png --rays 1024 --trails 48
  python -m audio_raytracer_tpu_torch.demo.visualize --history run.npz \
      --history-out history.png          # muffle/reverb over frames

Color method (single-hue sequential for bounce depth; identity colors
only for the listener/target marks; geometry in recessive gray ink):
hit points darken with bounce index — magnitude, not identity — so the
trace's spatial decay reads directly off the figure.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from audio_raytracer_tpu_torch.types import resolve_device

# Chart surface / ink / series colors (validated default palette; the
# sequential blue ramp is slot-1 blue stepped light->dark).
SURFACE = "#fcfcfb"
INK_PRIMARY = "#0b0b0b"
INK_SECONDARY = "#52514e"
INK_MUTED = "#8a8984"
SERIES_BLUE = "#2a78d6"
SERIES_ORANGE = "#eb6834"
GIZMO_CAP = 5000  # the reference's gizmo budget (AudioRayTracer.cs:309-316)


def _quat_conj_rot(inv_q, v):
    """Rotate v by the INVERSE of the stored inverse quaternion == the
    box orientation (ops/quaternion conventions, xyzw)."""
    x, y, z, w = -inv_q[0], -inv_q[1], -inv_q[2], inv_q[3]
    q = np.array([x, y, z])
    t = 2.0 * np.cross(q, v)
    return v + w * t + np.cross(q, t)


def _box_outline(center, half, inv_rot=None, axes=(0, 2)):
    """[5, 2] closed outline of a box footprint on the given axes."""
    a, b = axes
    corners = []
    for sa, sb in [(-1, -1), (1, -1), (1, 1), (-1, 1), (-1, -1)]:
        off = np.zeros(3)
        off[a] = sa * half[a]
        off[b] = sb * half[b]
        if inv_rot is not None:
            off = _quat_conj_rot(np.asarray(inv_rot), off)
        corners.append([center[a] + off[a], center[b] + off[b]])
    return np.asarray(corners)


def _draw_scene(ax, scene, axes=(0, 2)):
    import matplotlib.patches as mpatches

    a, b = axes
    sp, ab, ob = scene.spheres, scene.aabbs, scene.obbs
    for i in range(sp.count):
        if not bool(sp.active[i]):
            continue
        c = np.asarray(sp.center[i])
        ax.add_patch(mpatches.Circle((c[a], c[b]), float(sp.radius[i]),
                                     fill=False, edgecolor=INK_MUTED,
                                     linewidth=1.0))
    for i in range(ab.count):
        if not bool(ab.active[i]):
            continue
        o = _box_outline(np.asarray(ab.center[i]),
                         np.asarray(ab.half_extents[i]), axes=axes)
        ax.plot(o[:, 0], o[:, 1], color=INK_MUTED, linewidth=1.0)
    for i in range(ob.count):
        if not bool(ob.active[i]):
            continue
        o = _box_outline(np.asarray(ob.center[i]),
                         np.asarray(ob.half_extents[i]),
                         inv_rot=np.asarray(ob.inv_rot[i]), axes=axes)
        ax.plot(o[:, 0], o[:, 1], color=INK_MUTED, linewidth=1.0)


def _bounce_ramp(H):
    """Single-hue light->dark blue steps for bounce depth (sequential:
    one hue, magnitude = lightness; never a rainbow)."""
    import matplotlib.colors as mcolors

    base = np.asarray(mcolors.to_rgb(SERIES_BLUE))
    white = np.ones(3)
    # H steps from 65% white blend (light) to 35% black blend (dark).
    steps = []
    for i in range(H):
        t = i / max(H - 1, 1)
        if t < 0.5:
            c = white * (0.65 - 1.3 * t * 0.65) + base * (
                0.35 + 1.3 * t * 0.65)
        else:
            c = base * (1.0 - (t - 0.5) * 0.7)
        steps.append(np.clip(c, 0, 1))
    return steps


def plot_trace(loaded, out_path: str, rays: int = 1024, trails: int = 48,
               backend: str = "kernel", listener=None, device="cuda"):
    """Trace one frame on ``device`` with debug capture and render hits +
    trails.

    ``listener``: trace origin override (default: the scene's authored
    listener position). Pass the simulation's current listener when
    visualizing after a run with a moving listener path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from audio_raytracer_tpu_torch.models.raytracer import forward
    from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions

    dev = resolve_device(device)
    cfg = dataclasses.replace(loaded.cfg, ray_count=rays)
    gpu_scene = loaded.registry.snapshot(device=dev)
    origin = torch.as_tensor(
        np.asarray(loaded.listener_position if listener is None
                   else listener), dtype=torch.float32, device=dev)
    dirs = fibonacci_directions(rays, device=dev)
    with torch.no_grad():
        result, settings = forward(origin, dirs, gpu_scene, cfg,
                                   collect_debug=True, backend=backend,
                                   device=dev)

    pts = result.hit_points.cpu().numpy()  # [R, H, 3]
    hit_counts = result.hit_counts.cpu().numpy()  # [R]
    scene = loaded.registry.snapshot(device="cpu")
    hit_mask = hit_counts[:, None] > np.arange(
        pts.shape[1])[None, :]  # [R, H] true where the bounce happened
    H = pts.shape[1]
    ramp = _bounce_ramp(H)
    targets = np.asarray(scene.target_positions)
    lis = origin.cpu().numpy()

    fig, axs = plt.subplots(1, 2, figsize=(13, 6.2), facecolor=SURFACE)
    views = [((0, 2), "top-down (x-z)"), ((0, 1), "side (x-y)")]
    # Respect the reference's gizmo cap across both views.
    budget = GIZMO_CAP // 2

    for ax, (axes_pair, title) in zip(axs, views):
        a, b = axes_pair
        ax.set_facecolor(SURFACE)
        _draw_scene(ax, scene, axes=axes_pair)

        # Ray trails: a subsample of rays as thin polylines
        # origin -> hit1 -> hit2 ... (the gizmo ray-trail drawing).
        stride = max(1, rays // max(trails, 1))
        for r in range(0, rays, stride):
            n = int(hit_counts[r])
            if n == 0:
                continue
            path = np.vstack([lis[None, :], pts[r, :n]])
            ax.plot(path[:, a], path[:, b], color=INK_MUTED,
                    linewidth=0.5, alpha=0.45, zorder=1)

        # Hit markers, one sequential step per bounce slot.
        drawn = 0
        for h in range(H):
            sel = hit_mask[:, h]
            if drawn >= budget:
                break
            p = pts[sel, h]
            if len(p) > budget - drawn:
                p = p[: budget - drawn]
            drawn += len(p)
            ax.scatter(p[:, a], p[:, b], s=9, color=ramp[h],
                       label=f"bounce {h + 1}" if axes_pair == (0, 2)
                       else None, zorder=2, linewidths=0)

        # Listener + targets: identity marks with direct labels (text in
        # ink, never the series color).
        ax.scatter([lis[a]], [lis[b]], marker="*", s=140,
                   color=INK_PRIMARY, zorder=4)
        ax.annotate("listener", (lis[a], lis[b]),
                    textcoords="offset points", xytext=(6, 6),
                    color=INK_PRIMARY, fontsize=9)
        for ti, tp in enumerate(targets):
            ax.scatter([tp[a]], [tp[b]], marker="o", s=60,
                       color=SERIES_ORANGE, zorder=4,
                       edgecolors=SURFACE, linewidths=1.5)
            name = (loaded.target_names[ti]
                    if ti < len(loaded.target_names) else f"target {ti}")
            ax.annotate(name, (tp[a], tp[b]), textcoords="offset points",
                        xytext=(6, 6), color=INK_PRIMARY, fontsize=9)

        ax.set_title(title, color=INK_PRIMARY, fontsize=11)
        ax.set_aspect("equal")
        ax.tick_params(colors=INK_SECONDARY, labelsize=8)
        for s in ax.spines.values():
            s.set_color(INK_MUTED)
            s.set_linewidth(0.6)

    leg = axs[0].legend(loc="upper left", fontsize=8, frameon=True,
                        labelcolor=INK_SECONDARY, framealpha=0.9,
                        edgecolor=INK_MUTED)
    leg.get_frame().set_facecolor(SURFACE)
    muf = ", ".join(f"{m:.2f}" for m in settings.muffle.tolist())
    fig.suptitle(
        f"{rays} rays | muffle [{muf}] | "
        f"reverb {float(settings.reverb_strength):.3f}",
        color=INK_SECONDARY, fontsize=10)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130, facecolor=SURFACE)
    plt.close(fig)
    return out_path


def plot_history(npz_path: str, out_path: str, target_names=None):
    """Per-frame settings history (--npz captures) as line charts."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h = np.load(npz_path)
    muffle = h["muffle"]  # [frames, T]
    frames = np.arange(muffle.shape[0])
    T = muffle.shape[1]
    names = (target_names
             or [f"target {i}" for i in range(T)])
    # Categorical slots, fixed order, all-pairs safe up to 3 series;
    # beyond that fold into gray "other" lines.
    slots = [SERIES_BLUE, SERIES_ORANGE, "#1baf7a"]

    n_panels = 2 + (1 if "reverb_ir" in h else 0)
    fig, axs = plt.subplots(1, n_panels, figsize=(4.6 * n_panels, 3.6),
                            facecolor=SURFACE)
    axs = np.atleast_1d(axs)
    for ax in axs:
        ax.set_facecolor(SURFACE)
        ax.tick_params(colors=INK_SECONDARY, labelsize=8)
        for s in ax.spines.values():
            s.set_color(INK_MUTED)
            s.set_linewidth(0.6)
        ax.grid(color=INK_MUTED, alpha=0.25, linewidth=0.5)

    for t in range(T):
        color = slots[t] if t < len(slots) else INK_MUTED
        axs[0].plot(frames, muffle[:, t], color=color, linewidth=2.0,
                    label=names[t] if t < len(names) else f"target {t}")
    axs[0].set_title("muffle strength per frame", color=INK_PRIMARY,
                     fontsize=10)
    axs[0].set_ylim(-0.02, 1.02)
    axs[0].legend(fontsize=8, frameon=False, labelcolor=INK_SECONDARY)

    axs[1].plot(frames, h["reverb_strength"], color=SERIES_BLUE,
                linewidth=2.0, label="strength")
    axs[1].plot(frames, h["reverb_volume"], color=SERIES_ORANGE,
                linewidth=2.0, label="volume")
    axs[1].set_title("reverb per frame", color=INK_PRIMARY, fontsize=10)
    axs[1].set_ylim(-0.02, 1.02)
    axs[1].legend(fontsize=8, frameon=False, labelcolor=INK_SECONDARY)

    if "reverb_ir" in h:
        ir = h["reverb_ir"]
        im = axs[2].imshow(ir.T, aspect="auto", origin="lower",
                           cmap="Blues", interpolation="nearest")
        axs[2].set_title("impulse response (bin x frame)",
                         color=INK_PRIMARY, fontsize=10)
        fig.colorbar(im, ax=axs[2], shrink=0.85)

    fig.tight_layout()
    fig.savefig(out_path, dpi=130, facecolor=SURFACE)
    plt.close(fig)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", help="scene JSON (default: built-in sample)")
    p.add_argument("--out", default="trace.png", metavar="PATH")
    p.add_argument("--rays", type=int, default=1024)
    p.add_argument("--trails", type=int, default=48,
                   help="number of ray trails to draw (0 = none)")
    p.add_argument("--backend", default="kernel", choices=["kernel", "dense"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--history", metavar="NPZ",
                   help="also plot a scene_player --npz capture")
    p.add_argument("--history-out", default="history.png", metavar="PATH")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        p.error(str(e))

    from audio_raytracer_tpu_torch.demo.sample_scene import sample_scene_dict
    from audio_raytracer_tpu_torch.demo.scene_format import (
        build_registry,
        load_scene_file,
    )

    loaded = (load_scene_file(args.scene) if args.scene
              else build_registry(sample_scene_dict()))
    out = plot_trace(loaded, args.out, rays=args.rays, trails=args.trails,
                     backend=args.backend, device=dev)
    print(f"wrote {out}", file=sys.stderr)
    if args.history:
        out2 = plot_history(args.history, args.history_out,
                            target_names=loaded.target_names)
        print(f"wrote {out2}", file=sys.stderr)
    loaded.registry.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
