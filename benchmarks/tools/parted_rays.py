"""Which rays part between the program and the materials reference, and
what the gaps are without them.

    python3 benchmarks/tools/parted_rays.py --seeds <n,n,...> --steps 40 \\
        [--device cuda] [--rays R --scene spheres,aabbs,obbs,extent]

For each seed, as ``calib_1m.materials_step`` draws them: the listener
positions and their target maps, the materials training starts from,
then ``--steps`` of the program's training steps, so the materials are
those a step of the window starts from (at ``--rays`` below the cell's
own, a layout of ``--scene`` drawn from the seed). At the next step's
position and target it records, per ray and bounce, the program's live
hits, echo distances, and echo and muffle visibility (its
``loudness_map`` with ``_secondary_occlusion`` watched) and the
reference's (``reference/materials.py``'s pass one), and parts the rays
where any of them differ. Then it takes the program's loss and
gradients (eager) and the reference's, once on every ray and once on the
rays that resolve alike (both normalised by every ray), and prints one
JSON line a seed: the parted rays and what parted them, and for both
sets the map's gaps, the loss's, and each tensor's gradient gap at the
reference's own map (``own``) and at the program's (``at``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
CELL = "calib_1m.materials_step"


def records(D, M, F, layout, mats, origin, dirs, scene, tc, tcfg, dev):
    """(program, reference): each [live, echo distance, echo seen, muffle
    seen] per bounce and ray ([H, R] and [H, R, T])."""
    import torch

    real, got = D._secondary_occlusion, []

    def watched(engine, sc, c, off, p, o, live_hit):
        dist, ev, mv = real(engine, sc, c, off, p, o, live_hit)
        got.append((live_hit, dist.detach(), ev & live_hit,
                    mv & live_hit[:, None]))
        return dist, ev, mv

    D._secondary_occlusion = watched
    try:
        with torch.no_grad():
            D.loudness_map(origin, dirs, scene, tcfg, device=dev)
    finally:
        D._secondary_occlusion = real
    prog = [torch.stack([g[i] for g in got]) for i in range(4)]
    ref = [torch.zeros_like(x) for x in prog]
    sc = F.Scene(layout, dev)
    absorption = torch.cat([mats[0], mats[3], mats[6]])
    R = dirs.shape[0]
    with torch.no_grad():
        for s in range(0, R, M.RAY_BLOCK):
            hits, _ = M._trace_block(sc, origin, dirs[s:s + M.RAY_BLOCK],
                                     tc, absorption)
            for k, (idx, _, dist, seen, mvis) in enumerate(hits):
                for x, v in zip(ref, (True, dist, seen, mvis)):
                    x[k, s + idx] = v
    return prog, ref


def parted(prog, ref):
    """[R] bool, the rays that resolve otherwise, and a count of each
    cause (a ray may have more than one)."""
    import torch

    live = (prog[0] == ref[0]).all(0)
    near = ((prog[1] - ref[1]).abs()
            <= 1e-3 * torch.clamp(ref[1], min=1.0)) | ~ref[0]
    dist = near.all(0)
    echo = (prog[2] == ref[2]).all(0)
    muffle = (prog[3] == ref[3]).all(-1).all(0)
    why = dict(live=~live, distance=live & ~dist, echo=live & ~echo,
               muffle=live & ~muffle)
    return ~(live & dist & echo & muffle), {k: int(v.sum())
                                            for k, v in why.items()}


def compare(D, M, drv, layout, mats, origin, dirs, port, target, tc, tcfg,
            R, dev):
    """The program's eager loss, map and gradients on ``dirs`` (normalised
    by ``R`` rays) against the reference's."""
    import torch

    from audio_raytracer_tpu_torch.types import Materials

    leaves = [x.detach().clone().requires_grad_() for x in mats]
    params = D.SceneParams(*(Materials(*leaves[3 * i:3 * i + 3])
                             for i in range(3)))
    pred = D.loudness_map(origin, dirs, params.into_scene(port), tcfg,
                          device=dev, total_ray_count=R)
    loss = D._loudness_mse(pred, D.Loudness(*(target[f] for f in drv.MAP)))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    pred = {f: getattr(pred, f).detach() for f in drv.MAP}
    ref = M.step(layout, mats, origin, target, tc, dev, directions=dirs,
                 at=pred)
    loss = float(loss.detach())
    out = dict(loss_gap=abs(loss - ref["loss"]) / abs(ref["loss"]))
    for f in drv.MAP:
        out[f] = float((pred[f].double()
                        - ref["loudness"][f].double()).abs().max())
    for key, name in (("grads", "own"), ("grads_at", "at")):
        out[name] = [float(f"{drv._ratio(g, r):.3g}")
                     for g, r in zip(grads, ref[key])]
    out["largest"] = [float(f"{drv._top(r):.3g}") for r in ref["grads_at"]]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--device", default="cuda")
    p.add_argument("--rays", type=int, default=0)
    p.add_argument("--scene", default="")
    a = p.parse_args(argv)
    sys.path[:0] = [ROOT, BENCH_DIR]
    import torch

    from harness import loader, runner
    from harness import scene as layouts
    from reference import frame as F
    from reference import materials as M

    dev = torch.device(a.device)
    if dev.type == "cuda":
        runner.load_libraries()
    from audio_raytracer_tpu_torch.models import differentiable as D
    from audio_raytracer_tpu_torch.types import Materials, TraceConfig

    bench = loader.load_benchmark(ROOT)
    w = loader.workload(bench, CELL)
    cfg = loader.config(bench, w["config"], ROOT)
    tr = loader.traffic(w["traffic"], BENCH_DIR)
    drv = loader.driver(tr["driver"], BENCH_DIR)
    sc, train = cfg["scene"], cfg["train"]
    tc = dict(cfg["trace"])
    if a.rays:
        tc["ray_count"] = a.rays
    R = tc["ray_count"]
    tcfg = TraceConfig(**tc)
    n_pos, ext = tr["positions"], tr["listener_extent"]
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        if a.scene:
            ns, na, no, extent = a.scene.split(",")
            layout = layouts.random_layout(seed, int(ns), int(na), int(no),
                                           sc["targets"], float(extent),
                                           sc["size_range"], dev)
            ext = min(ext, float(extent) / 2)
        else:
            layout = layouts.random_layout(
                sc["layout_seed"], sc["spheres"], sc["aabbs"], sc["obbs"],
                sc["targets"], sc["extent"], sc["size_range"], dev)
        dirs = F.fibonacci_directions(R, dev)
        port = layouts.port_scene(layout)
        g = layouts.generator(seed + 1, dev)
        pos = (torch.rand((n_pos, 3), generator=g, device=dev) * 2 - 1) * ext
        with torch.no_grad():
            maps = [D.loudness_map(pos[k], dirs, port, tcfg, device=dev)
                    for k in range(n_pos)]
        start = drv.start_materials(layout, train["init_seed"],
                                    train["init_ranges"], dev)
        params = D.SceneParams(*(Materials(*(x.clone()
                                             for x in start[3 * i:3 * i + 3]))
                                 for i in range(3)))
        step, init = D.make_train_step(tcfg, optimizer=D.adam(train["lr"]),
                                       device=dev)
        opt = init(params)
        for i in range(a.steps):
            step(params, opt, port, pos[i % n_pos], dirs, maps[i % n_pos])
        k = a.steps % n_pos
        mats = [x.detach().clone() for x in params.leaves()]
        del step, opt, params
        target = {f: getattr(maps[k], f) for f in drv.MAP}
        at = dict(layout)
        for i, t in enumerate(layouts.TYPES):
            at[f"{t}_mat"] = torch.stack(mats[3 * i:3 * i + 3], dim=-1)
        scene = D.SceneParams(*(Materials(*mats[3 * i:3 * i + 3])
                                for i in range(3))).into_scene(port)
        prog, ref = records(D, M, F, at, mats, pos[k], dirs, scene, tc,
                            tcfg, dev)
        bad, why = parted(prog, ref)
        del prog, ref
        args = (D, M, drv, layout, mats, pos[k])
        rest = (port, target, tc, tcfg, R, dev)
        print(json.dumps(dict(
            seed=seed, steps=a.steps, rays=R, parted=int(bad.sum()),
            why=why, every=compare(*args, dirs, *rest),
            alike=compare(*args, dirs[~bad], *rest),
            seconds=round(time.perf_counter() - t0, 1))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
