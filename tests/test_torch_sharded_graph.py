"""The sharded frame and the sharded materials step under a graph, on the
CPU.

On a mesh of NCCL groups on the card ``make_sharded_forward`` returns a
``ShardedFrameGraph`` and ``make_sharded_train_step`` a ``StepGraph``
(``parallel/sharded.py::graphed_mesh``); gloo, the CPU and the dense
engine run eagerly. Here the ranks are gloo processes on the CPU, so
the rank functions patch ``graphed_mesh`` to ask for the graph objects
anyway: their warm-up and "replays" then run the closure on the static
buffers, and the refill, the key and the copy out run as on the card.
They are held bit for bit to the eager step (``graph=False``) with the
kernel engine's plain versions, and within tests/test_torch_sharding.py's
tolerances to the eager dense step and to the JAX package's
``make_sharded_forward`` and ``make_sharded_train_step`` (settings rtol
1e-5 / atol 1e-6, echo distances rtol 1e-5 / atol 1e-5, gradients read
through SGD at lr 1 rtol 2e-4 / atol 2e-6) on JAX's ``random_scene(
key(7), 6, 10, 8, 3 targets)`` carried across with ``convert``. One
spawned world per mesh shape (1x2 and 2x1), each under a deadline; the
meshed loop's graph frames against its eager frames run in the same
world. The rule that picks a graph is checked in this process with
``dist.get_backend`` and the card mocked.
"""

import contextlib
import copy
import dataclasses
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_runtime_mesh import mutate, populate
from test_torch_sharding import (
    ECHO,
    GRAD,
    PERM,
    RAYS,
    SETTINGS,
    arrays,
    forward_cfg,
    host,
    j_mesh,
    j_target,
    sgd_lr1,
    train_cfg,
)

from audio_raytracer_tpu.models import differentiable as jdiff
from audio_raytracer_tpu.models.raytracer import random_scene as j_random_scene
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions as j_fib
from audio_raytracer_tpu.parallel import make_sharded_forward as j_sharded
from audio_raytracer_tpu.parallel import pad_scene_for_prim_shards as j_pad
from audio_raytracer_tpu.parallel.train import (
    make_sharded_train_step as j_train,
)
from audio_raytracer_tpu.types import TraceConfig as JConfig
from audio_raytracer_tpu_torch import convert
from audio_raytracer_tpu_torch.models import differentiable as D
from audio_raytracer_tpu_torch.models.frame_graph import engine_state
from audio_raytracer_tpu_torch.models.raytracer import random_scene
from audio_raytracer_tpu_torch.models.step_graph import StepGraph
from audio_raytracer_tpu_torch.ops.backend import PrimShardedBackend
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.ops.cuda.backend import KernelBackend
from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu_torch.parallel import sharded as S
from audio_raytracer_tpu_torch.parallel import train as T
from audio_raytracer_tpu_torch.parallel.distributed import (
    local_ray_slice,
    spawn,
)
from audio_raytracer_tpu_torch.parallel.mesh import make_mesh
from audio_raytracer_tpu_torch.runtime import AsyncRaytraceLoop, SceneRegistry
from audio_raytracer_tpu_torch.types import TraceConfig

torch.set_num_threads(1)

SHAPES = [(1, 2), (2, 1)]
SPAWN_TIMEOUT = 240.0
# The step's options, each a graph object of its own.
OPTIONS = {"result": dict(return_result=True), "ir": dict(return_ir=True),
           "settings": {}}
# The listener of each call: scene A twice (the second call skips the
# refill), the moved scene B twice, the grown scene C once.
ORIGINS = ([0.0, 0.0, 0.0], [0.4, -0.2, 0.3], [0.4, -0.2, 0.3],
           [-0.3, 0.1, 0.2], [0.1, 0.1, 0.1])
SCENE_OF_CALL = ("A", "A", "B", "B", "C")
TRAIN_STEPS = 3
LOOP_TICKS = 6
LR = 1e-2


@contextlib.contextmanager
def graphed_here():
    """The graph objects on the CPU's gloo ranks too (unless
    ``graph=False``; the kernel engine only)."""
    def rule(mesh, backend, graph=True):
        return graph and backend == "kernel"

    with mock.patch.object(S, "graphed_mesh", rule), \
            mock.patch.object(T, "graphed_mesh", rule):
        yield


def flat(out):
    """Every tensor of a step's output by position and field, in numpy."""
    items = out if isinstance(out, tuple) else (out,)
    d = {}
    for i, x in enumerate(items):
        if isinstance(x, torch.Tensor):
            d[f"{i}"] = host(x)
            continue
        for f in dataclasses.fields(x):
            v = getattr(x, f.name)
            if isinstance(v, torch.Tensor):
                d[f"{i}.{f.name}"] = host(v)
    return d


def engine_dtype(graph):
    engine = graph._engine
    return str(getattr(engine, "engine", engine).compute_dtype)


# ---------------------------------------------------------------------------
# One rank: every case of one mesh shape
# ---------------------------------------------------------------------------


def forward_cases(mesh, R, inp, scenes):
    """Each option's graph object over ORIGINS and SCENE_OF_CALL beside
    the eager kernel and dense steps on the same inputs."""
    dirs = fibonacci_directions(RAYS, device="cpu")[
        local_ray_slice(RAYS, mesh)]
    out = {}
    for name, opts in OPTIONS.items():
        cfg = TraceConfig(**forward_cfg(R))
        graph = S.make_sharded_forward(cfg, mesh, backend="kernel", **opts)
        assert isinstance(graph, S.ShardedFrameGraph), type(graph)
        eager = S.make_sharded_forward(cfg, mesh, backend="kernel",
                                       graph=False, **opts)
        dense = S.make_sharded_forward(cfg, mesh, backend="dense",
                                       graph=False, **opts)
        calls, keys, prev = [], [], None
        for o, s in zip(ORIGINS, SCENE_OF_CALL):
            o = torch.tensor(o)
            got = graph(o, dirs, scenes[s], reuse_scene=s == prev)
            calls.append(dict(graph=flat(got),
                              eager=flat(eager(o, dirs, scenes[s])),
                              dense=flat(dense(o, dirs, scenes[s]))))
            keys.append(graph.key)
            prev = s
        out[name] = dict(calls=calls, keys_equal=[k == keys[0] for k in keys],
                         counters=(graph.warmups, graph.captures,
                                   graph.replays, graph.refills),
                         mesh_in_key=(R, mesh.prim_shards) in graph.key,
                         key=repr(graph.key))
    # The bfloat16 tier: the same engine in B1-B3's bfloat16 plain
    # versions, graph and eager alike.
    cfg = TraceConfig(**forward_cfg(R), compute_dtype="bfloat16",
                      epsilon=0.05)
    graph = S.make_sharded_forward(cfg, mesh, return_ir=True)
    eager = S.make_sharded_forward(cfg, mesh, return_ir=True, graph=False)
    calls = []
    for o in ORIGINS[:3]:
        o = torch.tensor(o)
        calls.append(dict(graph=flat(graph(o, dirs, scenes["A"])),
                          eager=flat(eager(o, dirs, scenes["A"]))))
    out["bf16"] = dict(calls=calls, dtype=engine_dtype(graph),
                       counters=(graph.warmups, graph.captures,
                                 graph.replays))
    # The eager path builds one engine per local-scene object.
    with mock.patch.object(S, "make_local_engine",
                           wraps=S.make_local_engine) as made:
        eager = S.make_sharded_forward(TraceConfig(**forward_cfg(R)), mesh,
                                       graph=False)
        for s in ("A", "A", "A", "B", "B"):
            eager(torch.zeros(3), dirs, scenes[s])
    out["eager_engines"] = made.call_count
    return out


def train_cases(mesh, R, inp, scenes):
    """The materials step: Adam over TRAIN_STEPS steps (the last on the
    moved scene) graph and eager from one start; then two SGD(lr 1)
    steps of the graph, whose parameter moves are the gradients."""
    dirs = fibonacci_directions(RAYS, device="cpu")[
        local_ray_slice(RAYS, mesh)]
    cfg = TraceConfig(**train_cfg(R))
    target = convert.loudness_from_arrays(inp["target"], "cpu")
    origin = torch.zeros(3)

    def start():
        return convert.shard_from_arrays(inp["scene"], mesh,
                                         inp["params"])[1]

    out = {}
    runs = {}
    for name, graph in (("graph", True), ("eager", False)):
        step, init = T.make_sharded_train_step(cfg, mesh,
                                               optimizer=D.adam(LR),
                                               graph=graph)
        params = start()
        opt = init(params)
        losses = []
        for i in range(TRAIN_STEPS):
            scene = scenes["A" if i < TRAIN_STEPS - 1 else "B"]
            _, _, loss = step(params, opt, scene, origin, dirs, target)
            losses.append(float(loss))
        runs[name] = dict(step=step, losses=losses,
                          params=[host(x) for x in params.leaves()])
    g = runs["graph"]["step"]
    assert isinstance(g, StepGraph), type(g)
    out["adam"] = dict(
        {n: dict(losses=r["losses"], params=r["params"])
         for n, r in runs.items()},
        counters=(g.warmups, g.captures, g.replays, g.refills),
        mesh_in_key=(R, mesh.prim_shards) in g.key[0])
    step, init = T.make_sharded_train_step(cfg, mesh, optimizer=sgd_lr1)
    params = start()
    opt = init(params)
    moves, losses = [], []
    for _ in range(2):
        before = [x.detach().clone() for x in params.leaves()]
        _, _, loss = step(params, opt, scenes["A"], origin, dirs, target)
        moves.append([host(b - x) for b, x in zip(before, params.leaves())])
        losses.append(float(loss))
    out["sgd"] = dict(moves=moves, losses=losses,
                      counters=(step.warmups, step.captures, step.replays))
    return out


def loop_case(mesh, R):
    """The meshed loop with graph frames against the meshed loop with
    eager frames, ticked in lockstep on one registry (rank 0's): the
    wall moves every other tick, the registry grows at tick 4."""
    leader = torch.distributed.get_rank() == 0
    reg = SceneRegistry() if leader else None
    wall, t = populate(reg) if leader else (None, None)
    cfg = TraceConfig(ray_count=32, max_bounces=2, max_ray_life=120.0,
                      num_reverb_bins=8)
    loops = {name: AsyncRaytraceLoop(reg, cfg, compute_async=False,
                                     device="cpu", mesh=mesh, graph=graph)
             for name, graph in (("graph", True), ("eager", False))}
    assert isinstance(loops["graph"].graph_frames, S.ShardedFrameGraph)
    assert loops["eager"].graph_frames is None
    ticks = []
    for i in range(LOOP_TICKS):
        if leader and i % 2 == 1:
            reg.update_aabb(wall, [0.5 * i, 0, 3], [5, 5, 0.5],
                            material=(0.1, 2.0, 1.0))
        if leader and i == 4:
            mutate(reg, wall, t)
        origin = [0.1 * i, 0.0, -0.2 * i] if leader else None
        got = {}
        for name, loop in loops.items():
            s = loop.tick(origin)
            got[name] = None if s is None else dict(
                muffle=host(s.muffle), reverb_strength=host(
                    s.reverb_strength), reverb_volume=host(s.reverb_volume),
                ir=host(loop.reverb_ir))
        ticks.append(got)
    g = loops["graph"].graph_frames
    if leader:
        reg.close()
    return dict(ticks=ticks, counters=(g.warmups, g.captures, g.replays,
                                       g.refills))


def rank_cases(R, P, inp):
    mesh = make_mesh(R, P, device="cpu")
    scenes = {k: convert.shard_from_arrays(inp[k], mesh)[0]
              for k in ("A", "B", "C")}
    out = dict(index=(mesh.ray_index, mesh.prim_index))
    with graphed_here():
        out["forward"] = forward_cases(mesh, R, inp, scenes)
        out["train"] = train_cases(mesh, R, inp, scenes)
        out["loop"] = loop_case(mesh, R)
    return out


# ---------------------------------------------------------------------------
# The JAX side in this process, the port's ranks spawned
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jscene():
    return j_random_scene(jax.random.key(7), num_spheres=6, num_aabbs=10,
                          num_obbs=8, num_targets=3)


def moved(scene):
    """``scene`` with its first AABB moved next to the listener, where it
    changes every output."""
    aabbs = dataclasses.replace(
        scene.aabbs, center=scene.aabbs.center.at[0].set(
            jnp.asarray([0.0, 0.0, 4.0])))
    return dataclasses.replace(scene, aabbs=aabbs)


@pytest.fixture(scope="module")
def runs(jscene):
    """{(R, P): (port ranks' outputs by (ray_index, prim_index), the JAX
    side's outputs)}, computed once per shape on first use."""
    cache = {}

    def get(shape):
        if shape in cache:
            return cache[shape]
        R, P = shape
        grown = j_random_scene(jax.random.key(7), num_spheres=6,
                               num_aabbs=14, num_obbs=8, num_targets=3)
        padded = {k: j_pad(s, P) for k, s in (
            ("A", jscene), ("B", moved(jscene)), ("C", grown))}
        inp = {k: arrays(s) for k, s in padded.items()}
        inp.update(scene=inp["A"], target=arrays(j_target(3)),
                   params=arrays(jdiff.SceneParams.from_scene(padded["A"])))
        ranks = spawn(rank_cases, R * P, (R, P, inp), timeout=SPAWN_TIMEOUT)
        port = {r["index"]: r for r in ranks}

        mesh = j_mesh(R, P)
        dirs = j_fib(RAYS)
        fcfg = JConfig(**forward_cfg(R))
        ref = {}
        # The second call of the port's graph, its first replay.
        origin = jnp.asarray(ORIGINS[1])
        ref["result"] = j_sharded(fcfg, mesh, return_result=True)(
            origin, dirs, padded["A"])
        ref["ir"] = j_sharded(fcfg, mesh, return_ir=True)(origin, dirs,
                                                          padded["A"])
        params = jdiff.SceneParams.from_scene(padded["A"])
        step, opt = j_train(JConfig(**train_cfg(R)), mesh,
                            optimizer=optax.sgd(1.0))
        state = opt.init(params)
        ref["moves"], ref["losses"] = [], []
        for _ in range(2):
            p1, state, loss = step(params, state, padded["A"],
                                   jnp.zeros(3), dirs, j_target(3))
            ref["moves"].append([np.asarray(a) - np.asarray(b) for a, b in
                                 zip(jax.tree.leaves(params),
                                     jax.tree.leaves(p1))])
            ref["losses"].append(float(loss))
            params = p1
        cache[shape] = (port, ref)
        return cache[shape]

    return get


def assert_equal_dicts(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def shape_id(shape):
    return f"{shape[0]}x{shape[1]}"


# ---------------------------------------------------------------------------
# The sharded frame
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_graph_frames_equal_the_eager_step_bit_for_bit(runs, shape, option):
    port, _ = runs(shape)
    for idx, out in port.items():
        rec = out["forward"][option]
        for i, call in enumerate(rec["calls"]):
            assert_equal_dicts(call["graph"], call["eager"],
                               f"rank {idx} call {i}")


def tolerance(field):
    """tests/test_torch_sharding.py's tolerance of an output field."""
    if field.endswith("permeation"):
        return PERM
    if field.endswith(("echo_distances", "first_hit_t", "reverb_ir")) \
            or field == "1":  # the summed IR of return_ir
        return ECHO
    return SETTINGS


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_graph_frames_match_the_dense_step(runs, shape, option):
    port, _ = runs(shape)
    for out in port.values():
        for call in out["forward"][option]["calls"]:
            assert call["graph"].keys() == call["dense"].keys()
            for k, want in call["dense"].items():
                np.testing.assert_allclose(call["graph"][k], want,
                                           **tolerance(k), err_msg=k)


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_graph_frames_match_jax_sharded(runs, shape):
    port, ref = runs(shape)
    R, _ = shape
    jres, js = ref["result"]
    js_ir, j_ir = ref["ir"]
    for out in port.values():
        res = out["forward"]["result"]["calls"][1]["graph"]
        ir = out["forward"]["ir"]["calls"][1]["graph"]
        for k in ("muffle", "reverb_strength", "reverb_volume"):
            np.testing.assert_allclose(res[f"1.{k}"],
                                       np.asarray(getattr(js, k)),
                                       **SETTINGS, err_msg=k)
            np.testing.assert_allclose(ir[f"0.{k}"],
                                       np.asarray(getattr(js_ir, k)),
                                       **SETTINGS, err_msg=k)
        np.testing.assert_allclose(ir["1"], np.asarray(j_ir), **ECHO)
        np.testing.assert_allclose(res["0.reverb_ir"],
                                   np.asarray(jres.reverb_ir), **ECHO)
    echo = np.concatenate([port[(i, 0)]["forward"]["result"]["calls"][1][
        "graph"]["0.echo_distances"] for i in range(R)])
    np.testing.assert_allclose(echo, np.asarray(jres.echo_distances), **ECHO)
    assert np.asarray(j_ir).sum() > 0


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_refill_keeps_the_key_and_growth_makes_a_new_one(runs, shape):
    """Calls: A (warm-up), A again (no refill: capture and replay), the
    moved B (refill, same key, replay), B, the grown C (refill, new key,
    warm-up). The moved wall changes the frame."""
    port, _ = runs(shape)
    for out in port.values():
        for option in OPTIONS:
            rec = out["forward"][option]
            assert rec["keys_equal"] == [True, True, True, True, False]
            assert rec["counters"] == (2, 1, 3, 3), rec["counters"]
            assert rec["mesh_in_key"]
    moved_shard = port[(0, 0)]["forward"]["settings"]["calls"]
    assert any(not np.array_equal(moved_shard[1]["graph"][k],
                                  moved_shard[2]["graph"][k])
               for k in moved_shard[1]["graph"])


def test_a_new_mesh_shape_makes_a_new_key(runs):
    keys = {shape: runs(shape)[0][(0, 0)]["forward"]["settings"]["key"]
            for shape in SHAPES}
    assert keys[(1, 2)] != keys[(2, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_bf16_graph_frames_equal_the_eager_step(runs, shape):
    port, _ = runs(shape)
    for out in port.values():
        rec = out["forward"]["bf16"]
        assert rec["dtype"] == "torch.bfloat16"
        assert rec["counters"] == (1, 1, 2)
        for call in rec["calls"]:
            assert_equal_dicts(call["graph"], call["eager"], "bf16")


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_the_eager_step_builds_one_engine_per_scene(runs, shape):
    port, _ = runs(shape)
    for out in port.values():
        assert out["forward"]["eager_engines"] == 2


# ---------------------------------------------------------------------------
# The sharded materials step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_graph_steps_equal_the_eager_step_bit_for_bit(runs, shape):
    port, _ = runs(shape)
    for out in port.values():
        rec = out["train"]["adam"]
        assert rec["graph"]["losses"] == rec["eager"]["losses"]
        for a, b in zip(rec["graph"]["params"], rec["eager"]["params"]):
            np.testing.assert_array_equal(a, b)
        # Warm-up, capture, a replay on the moved scene (a refill).
        assert rec["counters"] == (1, 1, TRAIN_STEPS - 1, 2)
        assert rec["mesh_in_key"]


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_graph_step_gradients_match_jax_sharded(runs, shape):
    """Two SGD(lr 1) steps: the warm-up's and the first replay's moves
    against JAX's sharded step's, each rank's slice of its prim shard."""
    port, ref = runs(shape)
    _, P = shape
    assert sum(float(np.abs(g).sum()) for g in ref["moves"][1]) > 0.0
    for (_, j), out in port.items():
        rec = out["train"]["sgd"]
        assert rec["counters"] == (1, 1, 1)
        np.testing.assert_allclose(rec["losses"], ref["losses"], **SETTINGS)
        for got_step, want_step in zip(rec["moves"], ref["moves"]):
            for got, want in zip(got_step, want_step):
                per = want.shape[0] // P
                np.testing.assert_allclose(
                    got, want[j * per:(j + 1) * per], **GRAD)


# ---------------------------------------------------------------------------
# The meshed loop on graph frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_meshed_loop_graph_frames_equal_eager_frames(runs, shape):
    port, _ = runs(shape)
    for out in port.values():
        rec = out["loop"]
        harvested = 0
        for tick in rec["ticks"]:
            assert (tick["graph"] is None) == (tick["eager"] is None)
            if tick["graph"] is not None:
                assert_equal_dicts(tick["graph"], tick["eager"], "tick")
                harvested += 1
        assert harvested == LOOP_TICKS - 1
        # A refill for the first snapshot and for each tick that moved
        # the wall or grew the registry; the growth a second key.
        warmups, captures, replays, refills = rec["counters"]
        assert (warmups, captures) == (2, 2)
        assert replays == LOOP_TICKS - 2 and refills == 5


# ---------------------------------------------------------------------------
# The rule that picks a graph
# ---------------------------------------------------------------------------


def fake_mesh(device):
    return types.SimpleNamespace(
        ray_shards=1, prim_shards=1, ray_index=0, prim_index=0,
        rays=object(), prims=object(), world=object(),
        device=torch.device(device))


@pytest.mark.parametrize("case", [
    ("nccl", "cuda", "kernel", True, True),
    ("gloo", "cuda", "kernel", True, False),
    ("nccl", "cuda", "dense", True, False),
    ("nccl", "cpu", "kernel", True, False),
    ("gloo", "cpu", "kernel", True, False),
    ("nccl", "cuda", "kernel", False, False),
], ids=lambda c: "-".join(str(x) for x in c[:4]))
def test_graph_rule(case):
    backend_of_groups, device, engine, graph, want = case
    mesh = fake_mesh(device)
    cfg = TraceConfig(ray_count=8, max_bounces=1)
    with mock.patch.object(S.dist, "get_backend",
                           return_value=backend_of_groups) as got, \
            mock.patch.object(torch.cuda, "is_available", return_value=True):
        assert S.graphed_mesh(mesh, engine, graph) == want
        step = S.make_sharded_forward(cfg, mesh, backend=engine, graph=graph)
        train_step, _ = T.make_sharded_train_step(cfg, mesh, backend=engine,
                                                  graph=graph)
    assert isinstance(step, S.ShardedFrameGraph) == want
    assert isinstance(train_step, StepGraph) == want
    if want:
        assert step.device.type == "cuda" and step.key is None
        assert {c.args[0] for c in got.call_args_list} == {mesh.rays,
                                                            mesh.prims}
    else:
        assert callable(step) and not isinstance(step, S.ShardedFrameGraph)


def test_prim_sharded_engine_state_holds_the_ranks():
    """``engine_state`` of a PrimShardedBackend over a kernel engine: the
    engine's tables and the scan ranks; ``with_materials`` keeps the
    ranks and writes the densities into the shared tables."""
    scene = random_scene(3, 4, 4, 4, num_targets=2, device="cpu")
    engine = KernelBackend(scene, differentiable=True)
    wrapped = PrimShardedBackend(scene, None, 2, 1, engine=engine)
    state = engine_state(wrapped)
    assert set(state) == set(engine_state(engine)) | {"ranks"}
    assert torch.equal(state["ranks"], wrapped._ranks)
    params = D.SceneParams.from_scene(scene)
    dens = copy.deepcopy(params)
    dens.aabb.density.mul_(2.0)
    again = wrapped.with_materials(dens.into_scene(scene))
    assert again._ranks is wrapped._ranks and again.engine is not engine
    assert again.engine.fields.aabb is engine.fields.aabb
    assert torch.equal(engine.fields.aabb[:, K.A_DENS], dens.aabb.density)
