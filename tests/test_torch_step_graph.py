"""The compiled training steps (``models/step_graph.py::StepGraph``) on
the CPU.

On the CPU a step graph has no CUDA graph: its warm-up and its "replays"
run the step closure on its static buffers, so the refill of a new scene,
the key, the trained columns written from the parameters
(``KernelBackend.with_materials``), the copy out and the launch
bookkeeping run here as they run on the card. The factories return a
``StepGraph`` only on the card, so these tests ask for one on the CPU by
patching ``differentiable._graphed``. The steps are held bit for bit to
the eager steps (``graph=False``) over 5 steps from one state, and to the
JAX package's jitted steps on the same numpy inputs at
tests/test_torch_train.py's TRAIN tolerances. The scene is the one of
tests/test_pallas_grad.py (26 primitives, two targets with owned
colliders).
"""

import contextlib
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_frame_graph import FakeGraph, HostTraffic

from audio_raytracer_tpu.models import differentiable as jdiff
from audio_raytracer_tpu.models.raytracer import random_scene as j_scene
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.types import TraceConfig as JConfig
from audio_raytracer_tpu_torch import convert
from audio_raytracer_tpu_torch.models import differentiable as D
from audio_raytracer_tpu_torch.models.step_graph import StepGraph
from audio_raytracer_tpu_torch.ops.cuda import backend as B
from audio_raytracer_tpu_torch.ops.cuda import fused as F
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.types import TraceConfig
from audio_raytracer_tpu_torch.utils.checkpoint import load_optimizer_state

torch.set_num_threads(1)

CPU = "cpu"
STEPS = 5
LR = 1e-2  # adam()'s default
# tests/test_torch_train.py's tolerance of trained parameters against JAX.
TRAIN = dict(rtol=1e-5, atol=1e-5)
# tests/test_torch_train.py's training config, without and with the IR.
CONFIGS = {
    "no bins": dict(ray_count=48, max_bounces=3, max_ray_life=200.0),
    "bins": dict(ray_count=48, max_bounces=3, max_ray_life=200.0,
                 num_reverb_bins=16),
}
# Listeners of the source step (the vantage points of tests/
# test_torch_train.py's source test).
ORIGINS = np.array([[0.0, 0.0, 0.0], [3.0, -2.0, 1.0]], np.float32)
POSE_START = np.array([0.4, -0.3, 0.2], np.float32)
KINDS = ["materials", "pose origin", "pose targets", "pose both", "source"]
RECOVER = {"pose origin": ("origin",), "pose targets": ("targets",),
           "pose both": ("origin", "targets")}


@pytest.fixture(scope="module")
def jscene():
    return j_scene(jax.random.key(7), num_spheres=7, num_aabbs=9,
                   num_obbs=8, num_targets=2, extent=14.0,
                   size_range=(1.0, 4.0), target_owned_colliders=True)


@pytest.fixture
def graphed(monkeypatch):
    """The factories return a StepGraph on the CPU too (unless
    ``graph=False``)."""
    monkeypatch.setattr(D, "_graphed",
                        lambda dev, backend, graph: graph
                        and backend == "kernel")


def scene_of(jscene):
    return convert.scene_from_arrays(jax.tree.map(np.asarray, jscene),
                                     device=CPU)


def jmaterials_start(jscene):
    """The materials the materials step starts from: the authored ones
    moved off (absorption + 0.1, density x 0.6, echo x 1.3)."""
    p = jdiff.SceneParams.from_scene(jscene)

    def off(m):
        return type(m)(absorption=jnp.clip(m.absorption + 0.1, 0.0, 1.0),
                       density=m.density * 0.6, echo=m.echo * 1.3)

    return jdiff.SceneParams(sphere=off(p.sphere), aabb=off(p.aabb),
                             obb=off(p.obb))


def dirs_of(cfg):
    return np.array(fibonacci_directions(cfg.ray_count))


def jtarget_of(jscene, jcfg, origin=np.zeros(3, np.float32)):
    """The recording: the loudness map of the authored scene."""
    return jax.tree.map(np.asarray, jdiff.loudness_map(
        jnp.asarray(origin), jnp.asarray(dirs_of(jcfg)), jscene, jcfg))


def problem(kind, jscene, cfg_kw, graph=True, optimizer=None):
    """(step, init, make the trained state, the step's arguments after the
    state and optimizer, the trained tensors of a state) of one kind on
    the CPU, from the numpy inputs the JAX tests use."""
    cfg, jcfg = TraceConfig(**cfg_kw), JConfig(**cfg_kw)
    scene = scene_of(jscene)
    dirs = torch.as_tensor(dirs_of(cfg))
    opt = optimizer or D.adam(LR)
    if kind == "materials":
        step, init = D.make_train_step(cfg, optimizer=opt, device=CPU,
                                       graph=graph)
        target = convert.loudness_from_arrays(jtarget_of(jscene, jcfg),
                                              device=CPU)

        def make():
            return convert.params_from_arrays(jax.tree.map(
                np.asarray, jmaterials_start(jscene)), device=CPU)

        return (step, init, make, (scene, torch.zeros(3), dirs, target),
                lambda p: p.leaves())
    if kind == "source":
        step, init = D.make_source_recovery_step(
            cfg, len(ORIGINS), optimizer=opt, device=CPU, graph=graph)
        recs = D.stack_loudness([convert.loudness_from_arrays(
            jtarget_of(jscene, jcfg, o), device=CPU) for o in ORIGINS])
        tp0 = np.asarray(jscene.target_positions) + np.float32(0.5)
        return (step, init, lambda: torch.as_tensor(tp0.copy()),
                (scene, torch.as_tensor(ORIGINS), dirs, recs),
                lambda tp: [tp])
    step, init = D.make_pose_recovery_step(cfg, optimizer=opt,
                                           recover=RECOVER[kind],
                                           device=CPU, graph=graph)
    target = convert.loudness_from_arrays(jtarget_of(jscene, jcfg),
                                          device=CPU)

    def make():
        return D.PoseParams(origin=torch.as_tensor(POSE_START.copy()),
                            target_positions=scene.target_positions
                            .clone() + 0.3)

    return step, init, make, (scene, dirs, target), lambda p: p.leaves()


def assert_same_state(a, b, leaves):
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# (a) The graph closure against the eager step, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bins", list(CONFIGS))
@pytest.mark.parametrize("kind", KINDS)
def test_graph_steps_equal_eager_steps_bit_for_bit(jscene, graphed, kind,
                                                   bins):
    step, init, make, args, leaves = problem(kind, jscene, CONFIGS[bins])
    eager, _, _, _, _ = problem(kind, jscene, CONFIGS[bins], graph=False)
    assert isinstance(step, StepGraph) and not isinstance(eager, StepGraph)
    sg, se = make(), make()
    og, oe = init(sg), init(se)
    start = [x.detach().clone() for x in leaves(sg)]
    for i in range(STEPS):
        sg, og, lg = step(sg, og, *args)
        se, oe, le = eager(se, oe, *args)
        assert torch.equal(lg, le), (i, lg, le)
        assert_same_state(sg, se, leaves)
    assert (step.warmups, step.captures, step.replays, step.refills) == (
        1, 1, STEPS - 1, 1)
    for x, y in zip(leaves(sg), leaves(se)):
        for k, v in og.state[x].items():
            assert torch.equal(v, oe.state[y][k]), k
    # The steps moved what they recover and nothing else (a material
    # tensor no ray reaches at 48 rays keeps its values).
    moved = [not torch.equal(x.detach(), s)
             for x, s in zip(leaves(sg), start)]
    want = {"pose origin": [True, False], "pose targets": [False, True],
            "pose both": [True, True], "source": [True]}
    assert moved == want[kind] if kind in want else any(moved)


# ---------------------------------------------------------------------------
# (b) Against the JAX package's jitted steps
# ---------------------------------------------------------------------------


def jax_trail(kind, jscene, cfg_kw, backend):
    """STEPS steps of the JAX package's jitted step of ``kind`` (optax
    adam at LR): the loss and the trained leaves after each."""
    import optax

    jcfg = JConfig(**cfg_kw)
    dirs = jnp.asarray(dirs_of(jcfg))
    opt = optax.adam(LR)
    if kind == "materials":
        step, _ = jdiff.make_train_step(jcfg, opt, backend=backend)
        state = jmaterials_start(jscene)
        target = jtarget_of(jscene, jcfg)
        args = (jscene, jnp.zeros(3), dirs, target)
    elif kind == "source":
        step, _ = jdiff.make_source_recovery_step(jcfg, len(ORIGINS), opt,
                                                  backend=backend)
        state = jnp.asarray(np.asarray(jscene.target_positions)
                            + np.float32(0.5))
        recs = jdiff.stack_loudness([jtarget_of(jscene, jcfg, o)
                                     for o in ORIGINS])
        args = (jscene, jnp.asarray(ORIGINS), dirs, recs)
    else:
        step, _ = jdiff.make_pose_recovery_step(jcfg, opt, backend=backend,
                                                recover=RECOVER[kind])
        state = jdiff.PoseParams(origin=jnp.asarray(POSE_START),
                                 target_positions=jscene.target_positions
                                 + 0.3)
        args = (jscene, dirs, jtarget_of(jscene, jcfg))
    opt_state = opt.init(state)
    trail = []
    for _ in range(STEPS):
        state, opt_state, loss = step(state, opt_state, *args)
        trail.append((float(loss), [np.asarray(x)
                                    for x in jax.tree.leaves(state)]))
    return trail


@pytest.mark.parametrize("kind, jbackend, bins", [
    ("materials", "jnp", "bins"), ("materials", "jnp", "no bins"),
    ("materials", "pallas_interpret", "bins"),
    ("pose origin", "jnp", "no bins"), ("pose targets", "jnp", "no bins"),
    ("pose both", "jnp", "no bins"), ("source", "jnp", "no bins")])
def test_graph_steps_match_jax_jitted_steps(jscene, graphed, kind,
                                            jbackend, bins):
    cfg_kw = CONFIGS[bins]
    step, init, make, args, leaves = problem(kind, jscene, cfg_kw)
    state = make()
    opt = init(state)
    for i, (jloss, jleaves) in enumerate(
            jax_trail(kind, jscene, cfg_kw, jbackend)):
        state, opt, loss = step(state, opt, *args)
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-5,
                                   err_msg=f"step {i}")
        for a, b in zip(leaves(state), jleaves):
            np.testing.assert_allclose(a.detach().numpy(), b, **TRAIN,
                                       err_msg=f"step {i}")
    assert step.replays == STEPS - 1


def test_the_factories_graph_the_kernel_backend_on_the_card_only():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert D._graphed(cuda, "kernel", True)
    assert not D._graphed(cuda, "kernel", False)
    assert not D._graphed(cuda, "dense", True)
    assert not D._graphed(cuda, object(), True)  # an engine object
    assert not D._graphed(cpu, "kernel", True)
    cfg = TraceConfig(**CONFIGS["no bins"])
    for make in (lambda: D.make_train_step(cfg, device=CPU),
                 lambda: D.make_pose_recovery_step(cfg, device=CPU),
                 lambda: D.make_source_recovery_step(cfg, 2, device=CPU)):
        assert not isinstance(make()[0], StepGraph)


# ---------------------------------------------------------------------------
# (c) No host traffic inside the captured region
# ---------------------------------------------------------------------------


def sgd(tensors):
    # A CPU Adam reads its step count back to the host (on the card the
    # step graphs' Adam is capturable and does not); SGD with momentum
    # keeps state and reads none.
    return torch.optim.SGD(tensors, lr=LR, momentum=0.9)


@pytest.mark.parametrize("kind", ["materials", "pose both", "source"])
def test_the_captured_step_makes_no_host_traffic(jscene, graphed, kind):
    step, init, make, args, _ = problem(kind, jscene, CONFIGS["bins"],
                                        optimizer=sgd)
    state = make()
    opt = init(state)
    step(state, opt, *args)  # the warm-up
    step(state, opt, *args)  # the key's capture on the card
    with HostTraffic() as mode:
        step._step()  # what a capture records
    assert not mode.seen, mode.seen


def test_the_engine_tables_make_no_host_traffic(jscene):
    """prepare_fields and B1's padded tables build from a scene on the
    device alone: no tensor from host data (the miss encodings, the miss
    row's target id) and no row selection."""
    scene = scene_of(jscene)
    with HostTraffic() as mode:
        fields = B.prepare_fields(scene)
        K.closest_tables(fields)
    assert not mode.seen, mode.seen


def test_occlusion_tables_are_the_isin_selection(jscene):
    # B2's tables select rows by owner with a scalar compare per skip
    # target; the rows are those of the isin selection.
    fields = B.prepare_fields(scene_of(jscene))
    for skips in ((-1,), (-1, 0), (0, 1), (-1, 0, 1)):
        for (tab, n_free, n_owned), (src, col) in zip(
                K.occlusion_tables(fields, skips),
                ((fields.sph, K.S_TGT), (fields.aabb, K.A_TGT),
                 (fields.obb, K.O_TGT))):
            owned = torch.isin(K.ids(src, col), torch.tensor(skips))
            act = K.active_rows(src)
            assert (n_free, n_owned) == (int((act & ~owned).sum()),
                                         int((act & owned).sum()))
            free = tab[:n_free].view(torch.int32)  # target ids: NaN bits
            assert torch.equal(free, src[act & ~owned].view(torch.int32))


# ---------------------------------------------------------------------------
# (d) The key
# ---------------------------------------------------------------------------


def moved(scene, dx=0.7):
    """A new scene object with the first AABB slid along x."""
    c = scene.aabbs.center.clone()
    c[0, 0] += dx
    return dataclasses.replace(
        scene, aabbs=dataclasses.replace(scene.aabbs, center=c))


def grown(scene):
    """One more AABB, far from everything."""
    a = scene.aabbs

    def cat(x, row):
        return torch.cat([x, row[None].to(x.dtype)])

    mat = type(a.material)(*(cat(getattr(a.material, f), torch.tensor(v))
                             for f, v in (("absorption", 0.1),
                                          ("density", 1.0), ("echo", 1.0))))
    aabbs = dataclasses.replace(
        a, center=cat(a.center, torch.tensor([90.0, 0.0, 0.0])),
        half_extents=cat(a.half_extents, torch.tensor([1.0, 1.0, 1.0])),
        material=mat, target_id=cat(a.target_id, torch.tensor(-1)),
        active=cat(a.active, torch.tensor(True)))
    return dataclasses.replace(scene, aabbs=aabbs)


def deactivated(scene):
    active = scene.aabbs.active.clone()
    active[1] = False
    return dataclasses.replace(
        scene, aabbs=dataclasses.replace(scene.aabbs, active=active))


def twins(jscene, kind="materials"):
    """A graph step and an eager step with their states and optimizers,
    from one start."""
    step, init, make, args, leaves = problem(kind, jscene, CONFIGS["bins"])
    eager = problem(kind, jscene, CONFIGS["bins"], graph=False)[0]
    sg, se = make(), make()
    return step, eager, [sg, init(sg)], [se, init(se)], args, leaves


def both(step, eager, g, e, scene, args, leaves):
    """One step of each on ``scene``; they agree bit for bit."""
    g[0], g[1], lg = step(g[0], g[1], scene, *args[1:])
    e[0], e[1], le = eager(e[0], e[1], scene, *args[1:])
    assert torch.equal(lg, le)
    assert_same_state(g[0], e[0], leaves)
    return lg


def test_a_moved_primitive_is_refilled_not_recaptured(jscene, graphed):
    step, eager, g, e, args, leaves = twins(jscene)
    scene = args[0]
    losses = [both(step, eager, g, e, scene, args, leaves)
              for _ in range(2)]  # warm-up, capture
    key = step.key
    for _ in range(2):
        scene = moved(scene)
        losses.append(both(step, eager, g, e, scene, args, leaves))
        assert step.key == key
    assert (step.warmups, step.captures, step.replays, step.refills) == (
        1, 1, 3, 3)
    assert not torch.equal(losses[2], losses[3])


@pytest.mark.parametrize("change", ["growth", "deactivation",
                                    "new optimizer", "load_state_dict"])
def test_what_a_launch_bakes_in_makes_a_new_key(jscene, graphed, change):
    # The pose step: its parameters do not grow with the scene.
    step, eager, g, e, args, leaves = twins(jscene, "pose both")
    scene = args[0]
    for _ in range(3):  # warm-up, capture, replay
        both(step, eager, g, e, scene, args, leaves)
    before = step.key
    if change == "growth":
        scene = grown(scene)
    elif change == "deactivation":
        scene = deactivated(scene)
    elif change == "new optimizer":
        for x in (g, e):
            x[1] = D.adam(LR / 2)(leaves(x[0]))
    else:  # a state restored from elsewhere: new tensors
        for x in (g, e):
            load_optimizer_state(x[1], copy.deepcopy(x[1].state_dict()))
    for _ in range(3):
        both(step, eager, g, e, scene, args, leaves)
    assert step.key != before
    assert (step.warmups, step.captures, step.replays) == (2, 2, 4)


def test_the_same_state_dict_keeps_the_key(jscene, graphed):
    # load_state_dict of the optimizer's own state keeps its tensors (the
    # graph's buffers stay valid), so the key holds.
    step, eager, g, e, args, leaves = twins(jscene)
    for _ in range(2):
        both(step, eager, g, e, args[0], args, leaves)
    before = step.key
    g[1].load_state_dict(g[1].state_dict())
    e[1].load_state_dict(e[1].state_dict())
    both(step, eager, g, e, args[0], args, leaves)
    assert step.key == before and step.captures == 1


def test_the_loss_is_copied_out(jscene, graphed):
    step, init, make, args, _ = problem("materials", jscene,
                                        CONFIGS["no bins"])
    state = make()
    opt = init(state)
    held = [step(state, opt, *args)[2] for _ in range(4)]
    copies = [x.clone() for x in held]
    step(state, opt, *args)
    for x, c in zip(held, copies):
        assert torch.equal(x, c)
        assert x.data_ptr() != step._out.data_ptr()


# ---------------------------------------------------------------------------
# (e) Launch bookkeeping through a stand-in graph
# ---------------------------------------------------------------------------


@pytest.fixture
def counting(monkeypatch):
    """The plain versions count as their kernels' wrappers do on the card
    (one launch per call of at most MAX_SETS sets; B5 two, its B4 launch
    among them)."""
    inside = []

    def count(mod, name, wrapper, n):
        plain = getattr(mod, name)

        def counted(*a, **kw):
            if not inside:
                wrapper.launches += n
            inside.append(name)
            try:
                return plain(*a, **kw)
            finally:
                inside.pop()

        monkeypatch.setattr(mod, name, counted)

    count(K, "closest_hit_plain", K.run_closest_hit, 1)
    count(F, "multi_any_hit_plain", F.run_multi_any_hit, 1)
    count(F, "multi_chord_plain", F.run_multi_chord, 1)
    count(F, "multi_chord_dens_bwd_plain", F.run_multi_chord_dens_bwd, 1)
    count(F, "multi_chord_bwd_plain", F.run_multi_chord_bwd, 2)
    wrappers = [K.run_closest_hit, F.run_multi_any_hit, F.run_multi_chord,
                F.run_multi_chord_dens_bwd, F.run_multi_chord_bwd,
                K.run_any_hit, K.run_chord_loss, K.run_chord_loss_bwd]
    for w in wrappers:
        monkeypatch.setattr(w, "launches", 0)
    return wrappers


@pytest.mark.parametrize("kind", ["materials", "pose both", "source"])
def test_capture_takes_back_its_counts_and_replays_add_them(
        jscene, graphed, counting, monkeypatch, kind):
    cfg_kw = CONFIGS["no bins"]
    H = TraceConfig(**cfg_kw).max_hits_per_ray
    maps = len(ORIGINS) if kind == "source" else 1
    per_step = [H * maps, H * maps, maps] + (
        [1, 0] if kind == "materials" else [0, 2 * maps]) + [0, 0, 0]
    step, init, make, args, _ = problem(kind, jscene, cfg_kw)
    monkeypatch.setattr(step, "_capturing", True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **kw: contextlib.nullcontext())
    state = make()
    opt = init(state)
    for n in range(1, 4):  # warm-up, capture and replay, replay
        step(state, opt, *args)
        assert [w.launches for w in counting] == [n * c for c in per_step]
    assert step._graph.replays == step.replays == 2


# ---------------------------------------------------------------------------
# (f) Adam's state on the device, and a resumed step against optax
# ---------------------------------------------------------------------------


def test_adam_is_capturable_on_the_card_only():
    cpu = D.adam()([torch.zeros(3, requires_grad=True)])
    meta = D.adam()([torch.zeros(3, device="meta", requires_grad=True)])
    assert not cpu.param_groups[0]["capturable"]
    assert not meta.param_groups[0]["capturable"]  # meta is no card
    # The factory asks each tensor whether it lies on the card.
    assert D.adam()([FakeCuda(torch.zeros(3))]).param_groups[0][
        "capturable"]


class FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card (``is_cuda``), to read
    the flag ``adam()`` gives a card's tensors without a card."""

    @staticmethod
    def __new__(cls, x):
        return torch.Tensor._make_subclass(cls, x, True)

    @property
    def is_cuda(self):
        return True


def test_adam_from_arrays_puts_a_capturable_step_on_the_device():
    # The CPU cannot step a capturable Adam; its state is checked on the
    # meta device, which is not the CPU.
    params = [torch.zeros(3, device="meta", requires_grad=True),
              torch.zeros((2, 3), device="meta", requires_grad=True)]
    mu = [np.ones(3), np.ones((2, 3))]
    for capturable, device in ((True, "meta"), (False, "cpu")):
        opt = torch.optim.Adam(params, lr=LR, capturable=capturable)
        convert.adam_from_arrays(mu, mu, 4, opt)
        for p in params:
            st = opt.state[p]
            assert st["step"].device.type == device
            assert st["step"].dtype == torch.float32
            assert st["exp_avg"].device.type == "meta"


def test_load_optimizer_state_keeps_the_optimizers_capturable():
    cpu = torch.zeros(3, requires_grad=True)
    saved = torch.optim.Adam([cpu], lr=LR)
    cpu.grad = torch.ones(3)
    saved.step()
    state = copy.deepcopy(saved.state_dict())
    meta = torch.zeros(3, device="meta", requires_grad=True)
    opt = torch.optim.Adam([meta], lr=LR, capturable=True)
    load_optimizer_state(opt, state)
    assert opt.param_groups[0]["capturable"]
    assert opt.state[meta]["step"].device.type == "meta"
    plain = torch.optim.Adam([meta], lr=LR, capturable=True)
    plain.load_state_dict(state)  # takes the saved group's flag
    assert not plain.param_groups[0]["capturable"]
    # And back: a capturable optimizer's state (its step where its
    # parameter lies) into a CPU Adam.
    card = torch.optim.Adam([cpu], lr=LR, capturable=True)
    convert.adam_from_arrays([np.ones(3)], [np.ones(3)], 2, card)
    back = torch.optim.Adam([cpu], lr=LR)
    load_optimizer_state(back, card.state_dict())
    assert not back.param_groups[0]["capturable"]


def test_a_resumed_graph_step_continues_a_jax_run(jscene, graphed):
    import optax

    cfg_kw = CONFIGS["no bins"]
    jcfg = JConfig(**cfg_kw)
    jstep, _ = jdiff.make_train_step(jcfg, optax.adam(LR))
    jparams = jmaterials_start(jscene)
    jstate = optax.adam(LR).init(jparams)
    dirs = jnp.asarray(dirs_of(jcfg))
    jtarget = jtarget_of(jscene, jcfg)
    for _ in range(3):
        jparams, jstate, _ = jstep(jparams, jstate, jscene, jnp.zeros(3),
                                   dirs, jtarget)
    step, init, _, args, leaves = problem("materials", jscene, cfg_kw)
    params = convert.params_from_arrays(jax.tree.map(np.asarray, jparams),
                                        device=CPU)
    adam_state = jstate[0]
    opt = convert.adam_from_arrays(
        [np.asarray(x) for x in jax.tree.leaves(adam_state.mu)],
        [np.asarray(x) for x in jax.tree.leaves(adam_state.nu)],
        int(adam_state.count), init(params))
    for i in range(3):
        jparams, jstate, jloss = jstep(jparams, jstate, jscene, jnp.zeros(3),
                                       dirs, jtarget)
        params, opt, loss = step(params, opt, *args)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for a, b in zip(leaves(params), jax.tree.leaves(jparams)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       **TRAIN, err_msg=f"step {i}")
    assert step.captures == 1 and step.replays == 2
