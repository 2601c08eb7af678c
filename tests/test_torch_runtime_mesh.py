"""The port's meshed serving loop and the demos' --mesh, on the CPU.

Mirrors tests/test_runtime.py:177-270 (the meshed loop against the
one-process forward with num_accum_batches = ray shards, mid-run
mutations, registry growth, ``reconfigure``, and the loop without an
IR) and tests/test_demo.py:292-309 (``simulate`` over a mesh). The port
runs one process per rank: every case of one mesh runs in one
``parallel/distributed.py::spawn`` of gloo ranks on the CPU, under its
deadline, as tests/test_torch_sharding.py does. The JAX tests use a 4x2
mesh of the 8 virtual CPU devices; these use 2x2, which keeps the spawn
to four processes. The parity test holds the port's 2x2 loop to the JAX
loop over ``make_mesh(ray_shards=2, prim_shards=2)`` on the same
registry operations (rtol 1e-5 / atol 1e-6, tests/test_sharding.py's
settings tolerance), the lockstep test forces rank 0's completion probe
to "not done" for some ticks, and the calibration CLI trains over 2x2
ranks and resumes from rank 0's checkpoint.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from audio_raytracer_tpu.parallel.mesh import make_mesh as j_make_mesh
from audio_raytracer_tpu.runtime import AsyncRaytraceLoop as JLoop
from audio_raytracer_tpu.runtime import SceneRegistry as JRegistry
from audio_raytracer_tpu.types import TraceConfig as JConfig
from audio_raytracer_tpu_torch.demo import scene_player, train_materials
from audio_raytracer_tpu_torch.demo.sample_scene import sample_scene_dict
from audio_raytracer_tpu_torch.demo.scene_format import build_registry
from audio_raytracer_tpu_torch.demo.scene_player import simulate
from audio_raytracer_tpu_torch.models.raytracer import forward
from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu_torch.parallel import comm
from audio_raytracer_tpu_torch.parallel.distributed import (
    parse_mesh,
    run_meshed,
    spawn,
)
from audio_raytracer_tpu_torch.parallel.mesh import make_mesh
from audio_raytracer_tpu_torch.runtime import AsyncRaytraceLoop, SceneRegistry
from audio_raytracer_tpu_torch.types import TraceConfig

torch.set_num_threads(1)

SETTINGS = dict(rtol=1e-5, atol=1e-6)
SPAWN_TIMEOUT = 240.0
R_SHARDS, P_SHARDS = 2, 2
CFG = dict(ray_count=128, max_bounces=2, max_ray_life=120.0,
           num_reverb_bins=8)
# Ticks at which rank 0's probe says "still running" in the lockstep case.
FORCED_SKIPS = (2, 3, 4)
LOCKSTEP_TICKS = 8


def populate(reg):
    """tests/test_runtime.py's scene: a wall, a sphere, an OBB and two
    targets; returns the handles the mutations move."""
    wall = reg.add_aabb([0, 0, 3], [5, 5, 0.5], material=(0.1, 2.0, 1.0))
    reg.add_sphere([4, 0, -2], 1.0, material=(0.0, 1.0, 2.0))
    reg.add_obb([-3, 1, 5], [1.5, 1, 0.5], [0, 0, 0, 1])
    t = reg.add_target([0, 0, 6])
    reg.add_target([-5, 0, -5])
    return wall, t


def mutate(reg, wall, t):
    """Move the target and the wall, and grow the registry past its
    sphere capacity of 8 (the snapshot's counts double)."""
    reg.set_target_position(t, [0, 0, -6])
    reg.update_aabb(wall, [0, 0, 9], [5, 5, 0.5], material=(0.1, 2.0, 1.0))
    for i in range(8):
        reg.add_sphere([6.0 + i, 2, 4], 0.8)


def settings_of(s, ir=None):
    out = {k: getattr(s, k).detach().cpu().numpy()
           for k in ("muffle", "reverb_strength", "reverb_volume",
                     "perceived_position")}
    out["ir"] = None if ir is None else ir.detach().cpu().numpy()
    return out


def one_process(reg, origin, cfg):
    """The one-process forward with num_accum_batches = ray shards on the
    registry's current snapshot (the reference the meshed loop equals)."""
    cfg_d = dataclasses.replace(cfg, num_accum_batches=R_SHARDS)
    res, s = forward(torch.tensor(origin, dtype=torch.float32),
                     fibonacci_directions(cfg.ray_count, device="cpu"),
                     reg.snapshot(device="cpu"), cfg_d, backend="dense",
                     device="cpu")
    return settings_of(s, res.reverb_ir)


def counters(loop):
    return (loop.frames_dispatched, loop.frames_harvested)


# ---------------------------------------------------------------------------
# One rank: every case on one 2x2 mesh
# ---------------------------------------------------------------------------


def mesh_rank():
    mesh = make_mesh(R_SHARDS, P_SHARDS, device="cpu")
    leader = torch.distributed.get_rank() == 0
    out = dict(rank=torch.distributed.get_rank())

    def org(x):
        return x if leader else None

    # The meshed loop, mutations, growth and reconfigure.
    reg = SceneRegistry() if leader else None
    handles = populate(reg) if leader else None
    cfg = TraceConfig(**CFG)
    loop = AsyncRaytraceLoop(reg, cfg, compute_async=False, device="cpu",
                             mesh=mesh)
    loop.tick(org([0, 0, 0]))
    first = loop.tick(org([0, 0, 0]))
    out["first"] = settings_of(first, loop.reverb_ir)
    capacity = [loop._padded.spheres.count]
    if leader:
        out["first_ref"] = one_process(reg, [0, 0, 0], cfg)
        mutate(reg, *handles)
    loop.tick(org([0.5, 0, 0]))
    moved = loop.tick(org([0.5, 0, 0]))
    out["moved"] = settings_of(moved, loop.reverb_ir)
    out["sphere_capacity"] = capacity + [loop._padded.spheres.count]
    if leader:
        out["moved_ref"] = one_process(reg, [0.5, 0, 0], cfg)
    loop.reconfigure(dataclasses.replace(cfg, ray_count=256))
    loop.tick(org([0, 0, 0]))
    after = loop.tick(org([0, 0, 0]))
    out["after"] = settings_of(after, loop.reverb_ir)
    out["local_dirs"] = tuple(loop._directions.shape)
    out["counters"] = counters(loop)
    if leader:
        out["after_ref"] = one_process(
            reg, [0, 0, 0], dataclasses.replace(cfg, ray_count=256))
        reg.close()

    # num_reverb_bins == 0: the step's [0]-shaped IR becomes None.
    reg = SceneRegistry() if leader else None
    if leader:
        reg.add_aabb([0, 0, 5], [2, 2, 1])
        reg.add_target([0, 0, 3])
    loop = AsyncRaytraceLoop(reg, TraceConfig(ray_count=64, max_bounces=1,
                                              max_ray_life=80.0),
                             compute_async=False, device="cpu", mesh=mesh)
    loop.tick(org([0, 0, 0]))
    out["no_ir"] = (loop.tick(org([0, 0, 0])) is not None, loop.reverb_ir)
    if leader:
        reg.close()

    # Lockstep: rank 0's probe alone decides; the others follow.
    reg = SceneRegistry() if leader else None
    if leader:
        populate(reg)
    loop = AsyncRaytraceLoop(reg, cfg, compute_async=True, device="cpu",
                             mesh=mesh)
    tick_no = [0]
    if leader:
        loop._done = lambda: tick_no[0] not in FORCED_SKIPS
    trail = []
    for i in range(LOCKSTEP_TICKS):
        tick_no[0] = i
        s = loop.tick(org([0.1 * i, 0, 0]))
        trail.append((counters(loop), None if s is None
                      else float(s.reverb_volume)))
    out["lockstep"] = trail
    if leader:
        reg.close()

    try:
        AsyncRaytraceLoop(SceneRegistry() if leader else None,
                          TraceConfig(ray_count=127), device="cpu",
                          mesh=mesh)
        out["indivisible"] = ""
    except ValueError as e:
        out["indivisible"] = str(e)

    # The broadcast itself.
    x = torch.full((3,), float(torch.distributed.get_rank()))
    out["broadcast"] = comm.broadcast(x, src=0, group=mesh.world).numpy()
    out["broadcast_none"] = comm.broadcast(torch.ones(2), group=None).numpy()

    # The demo player over the mesh (tests/test_demo.py:292-309).
    loaded = build_registry(sample_scene_dict(ray_count=64, max_bounces=1))
    history = simulate(loaded, frames=6, dt=0.1, verbose=False,
                       device="cpu", mesh=mesh)
    if leader:
        anim = loaded.animations[0]
        out["sim"] = dict(history=history, moved=not np.allclose(
            anim.position, anim.waypoints[0]))
    else:
        out["sim"] = history
    loaded.registry.close()
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn(mesh_rank, R_SHARDS * P_SHARDS, timeout=SPAWN_TIMEOUT)


def assert_settings(got, want):
    for k in ("muffle", "reverb_strength", "reverb_volume"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **SETTINGS)


# ---------------------------------------------------------------------------
# tests/test_runtime.py:177-270
# ---------------------------------------------------------------------------


def test_meshed_loop_matches_dense_and_tracks_mutations(ranks):
    r0 = ranks[0]
    assert_settings(r0["first"], r0["first_ref"])
    assert r0["first"]["ir"].shape == (8,)
    assert_settings(r0["moved"], r0["moved_ref"])
    np.testing.assert_allclose(r0["moved"]["perceived_position"][0],
                               [0, 0, -6], atol=1e-6)
    # The wall move changed the echo geometry.
    assert float(r0["moved"]["reverb_volume"]) != \
        float(r0["first"]["reverb_volume"])
    # reconfigure() rebuilds the sharded step: 256 rays over 2 shards.
    assert_settings(r0["after"], r0["after_ref"])
    for r in ranks:
        assert r["local_dirs"] == (128, 3)


def test_registry_growth_flows_through_mid_run(ranks):
    # Nine spheres outgrow the snapshot's capacity of 8: it doubles, and
    # the padded counts reach every rank (the same settings everywhere).
    for r in ranks:
        assert r["sphere_capacity"] == [8, 16]
    for r in ranks[1:]:
        for k in ("first", "moved", "after"):
            assert_settings(r[k], ranks[0][k])
            np.testing.assert_array_equal(r[k]["ir"], ranks[0][k]["ir"])


def test_meshed_loop_without_ir(ranks):
    for r in ranks:
        harvested, ir = r["no_ir"]
        assert harvested and ir is None


def test_meshed_counters_agree_on_every_rank(ranks):
    assert len({r["counters"] for r in ranks}) == 1
    dispatched, harvested = ranks[0]["counters"]
    # Six ticks, each dispatching; reconfigure drops the frame in
    # flight, so the fifth tick harvests nothing.
    assert dispatched == 6 and harvested == 4


# ---------------------------------------------------------------------------
# Lockstep: rank 0's probe decides for every rank
# ---------------------------------------------------------------------------


def test_followers_skip_the_ticks_rank_zero_skips(ranks):
    trails = [r["lockstep"] for r in ranks]
    assert all(t == trails[0] for t in trails[1:])
    counts = [c for c, _ in trails[0]]
    # The frame dispatched at tick 1 stays in flight through the forced
    # skips: no dispatch and no harvest at ticks 2-4.
    for i in FORCED_SKIPS:
        assert counts[i] == counts[FORCED_SKIPS[0] - 1]
    assert counts[-1] == (LOCKSTEP_TICKS - len(FORCED_SKIPS),
                          LOCKSTEP_TICKS - len(FORCED_SKIPS) - 1)


def test_broadcast_sends_rank_zeros_tensor(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["broadcast"], np.zeros(3))
        np.testing.assert_array_equal(r["broadcast_none"], np.ones(2))


def test_meshed_loop_refuses_misuse(ranks):
    # Without a mesh the loop owns its registry; on a mesh a ray count
    # that does not split over the ray shards is refused on every rank,
    # before any collective.
    with pytest.raises(ValueError, match="registry"):
        AsyncRaytraceLoop(None, TraceConfig(), device="cpu")
    for r in ranks:
        assert "does not split" in r["indivisible"]


# ---------------------------------------------------------------------------
# tests/test_demo.py:292-309: simulate over a mesh
# ---------------------------------------------------------------------------


def test_simulate_over_mesh(ranks):
    sim = ranks[0]["sim"]
    history = sim["history"]
    assert np.isfinite(history["muffle"]).all()
    assert (history["reverb_volume"][2:] > 0).any()
    assert sim["moved"]
    assert all(r["sim"] is None for r in ranks[1:])


def test_simulate_over_mesh_equals_one_process_with_batches():
    """The meshed history equals the one-process player's with
    num_accum_batches = ray shards (rank 0's output of the spawn above
    is not reused: this runs its own ranks on the same document)."""
    history = spawn(simulate_rank, R_SHARDS * P_SHARDS,
                    timeout=SPAWN_TIMEOUT)[0]
    loaded = build_registry(sample_scene_dict(ray_count=64, max_bounces=1))
    loaded.cfg = dataclasses.replace(loaded.cfg, num_accum_batches=R_SHARDS)
    ref = simulate(loaded, frames=6, dt=0.1, verbose=False, device="cpu")
    loaded.registry.close()
    for k in ("muffle", "reverb_strength", "reverb_volume",
              "perceived_position", "reverb_ir"):
        if k in ref:
            np.testing.assert_allclose(history[k], ref[k], err_msg=k,
                                       **SETTINGS)


def simulate_rank():
    mesh = make_mesh(R_SHARDS, P_SHARDS, device="cpu")
    loaded = build_registry(sample_scene_dict(ray_count=64, max_bounces=1))
    history = simulate(loaded, frames=6, dt=0.1, verbose=False,
                       device="cpu", mesh=mesh)
    loaded.registry.close()
    return history


# ---------------------------------------------------------------------------
# The JAX meshed loop on the same registry operations
# ---------------------------------------------------------------------------


def test_meshed_loop_matches_the_jax_meshed_loop(ranks):
    jreg = JRegistry()
    wall, t = populate(jreg)
    jmesh = j_make_mesh(ray_shards=R_SHARDS, prim_shards=P_SHARDS,
                        devices=jax.devices()[:R_SHARDS * P_SHARDS])
    jcfg = JConfig(**CFG)
    loop = JLoop(jreg, jcfg, backend="jnp", compute_async=False, mesh=jmesh)

    def run(origin):
        loop.tick(origin)
        s = loop.tick(origin)
        return {k: np.asarray(getattr(s, k)) for k in
                ("muffle", "reverb_strength", "reverb_volume")}, \
            np.asarray(loop.reverb_ir)

    theirs = [run([0, 0, 0])]
    mutate(jreg, wall, t)
    theirs.append(run([0.5, 0, 0]))
    loop.reconfigure(dataclasses.replace(jcfg, ray_count=256))
    theirs.append(run([0, 0, 0]))
    jreg.close()
    for key, (s, ir) in zip(("first", "moved", "after"), theirs):
        ours = ranks[0][key]
        assert_settings(ours, s)
        np.testing.assert_allclose(ours["ir"], ir, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# train_materials --mesh 2x2 on the CPU
# ---------------------------------------------------------------------------


def run_cli(argv, capsys):
    assert train_materials.main(argv, mesh_timeout=SPAWN_TIMEOUT) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_train_materials_over_a_mesh_and_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    base = ["--device", "cpu", "--mesh", "2x2", "--rays", "64", "--init",
            "noisy", "--lr", "0.05", "--checkpoint", ck, "--ckpt-every", "4"]
    first = run_cli(base + ["--steps", "8", "--log-every", "1"], capsys)
    assert first["mesh"] == "2x2"
    # The same run in one process: the mesh changes no number.
    single = run_cli([a for a in base if a not in ("--mesh", "2x2")]
                     + ["--steps", "8", "--checkpoint", str(tmp_path / "c1")],
                     capsys)
    np.testing.assert_allclose(first["final_loss"], single["final_loss"],
                               rtol=1e-4)
    assert first["material_mae"] == pytest.approx(single["material_mae"],
                                                  abs=1e-3)
    resumed = run_cli(base + ["--steps", "12", "--resume"], capsys)
    again = run_cli([a for a in base if a not in ("--mesh", "2x2")]
                    + ["--steps", "12", "--resume", "--checkpoint",
                       str(tmp_path / "c1")], capsys)
    np.testing.assert_allclose(resumed["final_loss"], again["final_loss"],
                               rtol=1e-4)
    assert resumed["final_loss"] < first["final_loss"]


# ---------------------------------------------------------------------------
# The demos' launcher: parallel/distributed.py::run_meshed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text, shards", [("2x2", (2, 2)), ("4X1", (4, 1)),
                                          ("1x8", (1, 8))])
def test_parse_mesh(text, shards):
    assert parse_mesh(text) == shards


@pytest.mark.parametrize("text", ["2", "2x", "axb", "0x2", "2x2x2"])
def test_parse_mesh_refuses(text):
    with pytest.raises(ValueError, match="mesh"):
        parse_mesh(text)


def failing_rank(bad, mesh):
    if torch.distributed.get_rank() == bad:
        raise RuntimeError("this rank fails")
    torch.distributed.barrier()  # the others would wait for it forever


def test_run_meshed_without_a_deadline_stops_on_a_failed_rank():
    """With no deadline the local ranks still stop when one fails."""
    logs = []
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_meshed(failing_rank, "2x2", (1,), device="cpu",
                   log=logs.append)
    assert logs == ["mesh 2x2, 4 local ranks over gloo, sharing cpu"]


def test_scene_player_cli_over_a_mesh(tmp_path, capsys):
    """scene_player --mesh 2x2 on the sample scene: the history it saves
    equals the one-process player's with num_accum_batches = 2."""
    npz = str(tmp_path / "history.npz")
    assert scene_player.main(["--device", "cpu", "--mesh", "2x2", "--frames",
                              "6", "--npz", npz],
                             mesh_timeout=SPAWN_TIMEOUT) == 0
    out, err = capsys.readouterr()
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["mesh"] == "2x2" and summary["frames"] == 6
    assert "scene_player: mesh 2x2, 4 local ranks over gloo" in err
    with np.load(npz) as f:
        got = {k: f[k] for k in f.files}
    loaded = build_registry(sample_scene_dict())
    loaded.cfg = dataclasses.replace(loaded.cfg, num_accum_batches=R_SHARDS)
    ref = simulate(loaded, frames=6, verbose=False, device="cpu")
    loaded.registry.close()
    for k in ("muffle", "reverb_strength", "reverb_volume", "reverb_ir"):
        if k in ref:
            np.testing.assert_allclose(got[k], ref[k], err_msg=k, **SETTINGS)
