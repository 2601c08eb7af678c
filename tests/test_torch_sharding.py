"""The port's sharded tier against the JAX package's, on the CPU.

The JAX side runs on the 8-virtual-device CPU mesh of tests/conftest.py
(``make_mesh`` on a subset of ``jax.devices()``, the jnp engine, the vma
check on). The port side runs one process per rank, joined over gloo by
``parallel.distributed.spawn``, with the dense engine and with the
kernel engine (the kernels' plain versions on the CPU). The scenes are
JAX's ``random_scene(key(7), 6, 10, 8, 3 targets)`` as in
tests/test_sharding.py, carried across with ``convert``, so both
packages see the same bits. Every case of one mesh shape runs in one
spawn, each with a deadline. NCCL is not exercised here: it needs one
card per rank (chip_smoke.py runs a world of one rank on it).

Tolerances: those of tests/test_sharding.py (settings rtol 1e-5 /
atol 1e-6; echo distances rtol 1e-5 / atol 1e-5; permeation rtol 1e-5 /
atol 1e-3) and, for gradients read through one SGD step at lr 1,
tests/test_torch_train.py's ``GRAD`` (rtol 2e-4 / atol 2e-6).
"""

import dataclasses
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_raytracer_tpu.models import differentiable as jdiff
from audio_raytracer_tpu.models.raytracer import random_scene as j_random_scene
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions as j_fib
from audio_raytracer_tpu.parallel import make_mesh as j_make_mesh
from audio_raytracer_tpu.parallel import make_sharded_forward as j_sharded
from audio_raytracer_tpu.parallel import pad_scene_for_prim_shards as j_pad
from audio_raytracer_tpu.parallel.train import (
    make_sharded_train_step as j_train,
)
from audio_raytracer_tpu.types import Aabbs as JAabbs
from audio_raytracer_tpu.types import Materials as JMaterials
from audio_raytracer_tpu.types import Scene as JScene
from audio_raytracer_tpu.types import TraceConfig as JConfig
from audio_raytracer_tpu_torch import convert
from audio_raytracer_tpu_torch.models import differentiable as tdiff
from audio_raytracer_tpu_torch.models.raytracer import forward as t_forward
from audio_raytracer_tpu_torch.ops.cuda import fused as F
from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu_torch.parallel import comm
from audio_raytracer_tpu_torch.parallel.distributed import (
    local_ray_slice,
    spawn,
)
from audio_raytracer_tpu_torch.parallel.mesh import (
    make_mesh,
    pad_scene_for_prim_shards,
)
from audio_raytracer_tpu_torch.parallel.sharded import (
    make_sharded_forward,
    sharded_forward,
)
from audio_raytracer_tpu_torch.parallel.train import make_sharded_train_step
from audio_raytracer_tpu_torch.types import TraceConfig

torch.set_num_threads(1)

SETTINGS = dict(rtol=1e-5, atol=1e-6)
ECHO = dict(rtol=1e-5, atol=1e-5)
PERM = dict(rtol=1e-5, atol=1e-3)
GRAD = dict(rtol=2e-4, atol=2e-6)
SHAPES = [(2, 1), (1, 2), (2, 2)]
ENGINES = ["dense", "kernel"]
RAYS = 64
N_BINS = 8
SPAWN_TIMEOUT = 240.0


def forward_cfg(ray_shards):
    return dict(ray_count=RAYS, max_bounces=3, max_ray_life=150.0,
                num_accum_batches=ray_shards, num_reverb_bins=N_BINS,
                ir_max_distance=80.0)


def train_cfg(ray_shards):
    # tests/test_sharding.py::test_sharded_loss_with_ir_matches_single_device
    return dict(ray_count=RAYS, max_bounces=2, max_ray_life=150.0,
                num_accum_batches=ray_shards, num_reverb_bins=N_BINS,
                ir_max_distance=80.0)


def arrays(tree):
    """A JAX dataclass tree as nested namespaces of numpy arrays (what
    ``convert`` reads), picklable without the JAX package."""
    if dataclasses.is_dataclass(tree):
        return types.SimpleNamespace(**{
            f.name: arrays(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return None if tree is None else np.asarray(tree)


def j_tie_scene():
    """Two identical AABBs with different materials: every hit ties, and
    the scan order picks the first (tests/test_sharding.py:202-229)."""
    mats = JMaterials(absorption=jnp.asarray([0.1, 0.4]),
                      density=jnp.ones(2), echo=jnp.asarray([2.0, 0.5]))
    aabbs = JAabbs.build([[0, 0, 6], [0, 0, 6]], [[2, 2, 1], [2, 2, 1]],
                         material=mats)
    return JScene.build(None, aabbs, None, [[0, 8, 0]])


def j_target(T):
    return jdiff.Loudness(muffle=jnp.full((T,), 0.4),
                          permeation=jnp.full((T,), 0.3),
                          reverb_energy=jnp.asarray(0.1),
                          reverb_ir=jnp.linspace(0.5, 0.0, N_BINS))


def host(x):
    return x.detach().cpu().numpy()


def settings_of(s):
    return dict(muffle=host(s.muffle),
                reverb_strength=host(s.reverb_strength),
                reverb_volume=host(s.reverb_volume))


def sgd_lr1(tensors):
    return torch.optim.SGD(tensors, lr=1.0)


# ---------------------------------------------------------------------------
# One rank: every case of one mesh shape
# ---------------------------------------------------------------------------


def rank_cases(R, P, inp):
    """Runs on each rank of an R x P mesh; returns numpy outputs."""
    mesh = make_mesh(R, P, device="cpu")
    origin = torch.zeros(3)
    dirs = fibonacci_directions(RAYS, device="cpu")[
        local_ray_slice(RAYS, mesh)]
    fcfg = TraceConfig(**forward_cfg(R))
    scene, _ = convert.shard_from_arrays(inp["scene"], mesh)
    tie = convert.scene_from_arrays(inp["tie"], "cpu")
    out = dict(index=(mesh.ray_index, mesh.prim_index))
    for engine in ENGINES:
        res, s = make_sharded_forward(fcfg, mesh, return_result=True,
                                      backend=engine)(origin, dirs, scene)
        out[f"fwd_{engine}"] = dict(
            settings_of(s), echo=host(res.echo_distances),
            muffle_hits=host(res.muffle_hits),
            permeation=host(res.permeation), ir=host(res.reverb_ir))
        s_ir, ir = make_sharded_forward(fcfg, mesh, return_ir=True,
                                        backend=engine)(origin, dirs, scene)
        out[f"ir_{engine}"] = dict(settings_of(s_ir), ir=host(ir))
        # The one-shot form slices the global rays and scene itself.
        tcfg_tie = TraceConfig(ray_count=RAYS, max_bounces=2,
                               max_ray_life=100.0, num_accum_batches=R)
        res, s = sharded_forward(origin, fibonacci_directions(RAYS, "cpu"),
                                 tie, tcfg_tie, mesh, return_result=True,
                                 backend=engine)
        out[f"tie_{engine}"] = dict(settings_of(s),
                                    echo=host(res.echo_distances))
        # One sharded materials step (SGD at lr 1 reads the gradients),
        # counting which chord adjoint the kernel engine takes.
        p = convert.shard_from_arrays(inp["scene"], mesh, inp["params"])[1]
        step, init = make_sharded_train_step(
            TraceConfig(**train_cfg(R)), mesh, optimizer=sgd_lr1,
            backend=engine)
        opt = init(p)
        before = [x.detach().clone() for x in p.leaves()]
        with mock.patch.object(F, "run_multi_chord_dens_bwd",
                               wraps=F.run_multi_chord_dens_bwd) as b4, \
                mock.patch.object(F, "run_multi_chord_bwd",
                                  wraps=F.run_multi_chord_bwd) as b5:
            _, _, loss = step(p, opt, scene, origin, dirs,
                              convert.loudness_from_arrays(inp["target"],
                                                           "cpu"))
        out[f"train_{engine}"] = dict(
            loss=float(loss), adjoints=(b4.call_count, b5.call_count),
            grads=[host(b - x) for b, x in zip(before, p.leaves())])
    # The collectives themselves.
    rank = torch.distributed.get_rank()
    x = torch.tensor([rank + 1.0, 2.0], requires_grad=True)
    y = comm.all_reduce_sum(x, mesh.rays)
    (y * torch.tensor([3.0, 5.0])).sum().backward()
    a, b = comm.all_reduce_sums([torch.tensor([float(rank)]),
                                 torch.full((2, 2), 1.0)], mesh.prims)
    out["comm"] = dict(
        sum=host(y), grad=host(x.grad), sums=(host(a), host(b)),
        min=host(comm.all_reduce_min(torch.tensor([rank, -rank],
                                                  dtype=torch.int32),
                                     torch.distributed.group.WORLD)),
        max=host(comm.all_reduce_max(torch.tensor([float(rank)]),
                                     torch.distributed.group.WORLD)),
        none=host(comm.all_reduce_sum(x, None)))
    return out


# ---------------------------------------------------------------------------
# Fixtures: the JAX side in this process, the port's ranks spawned
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jscene():
    return j_random_scene(jax.random.key(7), num_spheres=6, num_aabbs=10,
                          num_obbs=8, num_targets=3)


def j_mesh(R, P):
    return j_make_mesh(ray_shards=R, prim_shards=P,
                       devices=jax.devices()[:R * P])


@pytest.fixture(scope="module")
def runs(jscene):
    """{(R, P): (port ranks' outputs by (ray_index, prim_index), the JAX
    side's outputs)}, computed once per shape on first use."""
    cache = {}

    def get(shape):
        if shape in cache:
            return cache[shape]
        R, P = shape
        padded = j_pad(jscene, P)
        tie = j_pad(j_tie_scene(), P)
        T = jscene.num_targets
        inp = dict(scene=arrays(padded),
                   params=arrays(jdiff.SceneParams.from_scene(padded)),
                   tie=arrays(tie), target=arrays(j_target(T)))
        ranks = spawn(rank_cases, R * P, (R, P, inp),
                      timeout=SPAWN_TIMEOUT)
        port = {r["index"]: r for r in ranks}

        mesh = j_mesh(R, P)
        origin = jnp.zeros(3)
        dirs = j_fib(RAYS)
        fcfg = JConfig(**forward_cfg(R))
        jres, js = j_sharded(fcfg, mesh, return_result=True)(origin, dirs,
                                                             padded)
        js_ir, j_ir = j_sharded(fcfg, mesh, return_ir=True)(origin, dirs,
                                                            padded)
        tie_cfg = JConfig(ray_count=RAYS, max_bounces=2, max_ray_life=100.0,
                          num_accum_batches=R)
        jtie_res, jtie = j_sharded(tie_cfg, mesh, return_result=True)(
            origin, dirs, tie)
        ref = dict(result=jres, settings=js, ir=j_ir, ir_settings=js_ir,
                   tie_result=jtie_res, tie=jtie)
        if shape == (2, 2):
            params = jdiff.SceneParams.from_scene(padded)
            step, opt = j_train(JConfig(**train_cfg(R)), mesh,
                                optimizer=optax.sgd(1.0))
            p1, _, loss = step(params, opt.init(params), padded, origin,
                               dirs, j_target(T))
            ref["loss"] = float(loss)
            ref["grads"] = [np.asarray(a) - np.asarray(b) for a, b in
                            zip(jax.tree.leaves(params),
                                jax.tree.leaves(p1))]
        cache[shape] = (port, ref)
        return cache[shape]

    return get


def assert_settings(port, ref, **tol):
    for k in ("muffle", "reverb_strength", "reverb_volume"):
        np.testing.assert_allclose(port[k], np.asarray(getattr(ref, k)),
                                   **(tol or SETTINGS), err_msg=k)


def rows_of(port, R):
    """The ray shards' rows in rank order (prim shard 0 of each row)."""
    return [port[(i, 0)] for i in range(R)]


# ---------------------------------------------------------------------------
# The sharded forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_forward_matches_jax_sharded(runs, shape, engine):
    port, ref = runs(shape)
    R, _ = shape
    for out in port.values():  # every rank returns the same settings
        assert_settings(out[f"fwd_{engine}"], ref["settings"])
    rows = [r[f"fwd_{engine}"] for r in rows_of(port, R)]
    jr = ref["result"]
    np.testing.assert_allclose(np.concatenate([r["echo"] for r in rows]),
                               np.asarray(jr.echo_distances), **ECHO)
    np.testing.assert_array_equal(
        np.concatenate([r["muffle_hits"] for r in rows]),
        np.asarray(jr.muffle_hits))
    np.testing.assert_allclose(
        np.concatenate([r["permeation"] for r in rows]),
        np.asarray(jr.permeation), **PERM)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_forward_matches_one_process(runs, jscene, shape, engine):
    """Each ray shard is one accumulation batch: the sharded run equals
    the port's own one-process forward with num_accum_batches = R."""
    port, _ = runs(shape)
    R, P = shape
    scene = convert.scene_from_arrays(arrays(jscene), "cpu")
    res, s = t_forward(torch.zeros(3), fibonacci_directions(RAYS, "cpu"),
                       scene, TraceConfig(**forward_cfg(R)), backend=engine,
                       device="cpu")
    for out in port.values():
        assert_settings(out[f"fwd_{engine}"], s)
        np.testing.assert_allclose(out[f"fwd_{engine}"]["ir"],
                                   host(res.reverb_ir), **ECHO)
    rows = [r[f"fwd_{engine}"] for r in rows_of(port, R)]
    np.testing.assert_allclose(np.concatenate([r["echo"] for r in rows]),
                               host(res.echo_distances), **ECHO)
    np.testing.assert_array_equal(
        np.concatenate([r["muffle_hits"] for r in rows]),
        host(res.muffle_hits))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_return_result_rows_are_slices_of_jax(runs, shape):
    """return_result: every rank's rows are its ray slice of JAX's
    gathered rows, the prim shards of a row agreeing."""
    port, ref = runs(shape)
    R, _ = shape
    jr = ref["result"]
    per = RAYS // R
    for (i, _), out in port.items():
        for engine in ENGINES:
            rows = out[f"fwd_{engine}"]
            np.testing.assert_allclose(
                rows["echo"], np.asarray(jr.echo_distances)[i * per:
                                                            (i + 1) * per],
                **ECHO)
            np.testing.assert_array_equal(
                rows["muffle_hits"], np.asarray(jr.muffle_hits)[i:i + 1])
            np.testing.assert_allclose(
                rows["permeation"], np.asarray(jr.permeation)[i:i + 1],
                **PERM)
            np.testing.assert_allclose(rows["ir"],
                                       np.asarray(jr.reverb_ir), **ECHO)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_return_ir_matches_jax(runs, shape, engine):
    port, ref = runs(shape)
    assert np.asarray(ref["ir"]).sum() > 0
    for out in port.values():
        np.testing.assert_allclose(out[f"ir_{engine}"]["ir"],
                                   np.asarray(ref["ir"]), **ECHO)
        assert_settings(out[f"ir_{engine}"], ref["ir_settings"])


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tie_break_across_shards(runs, shape, engine):
    """Two identical AABBs on different prim shards: the merge must pick
    the first in scan order, as the JAX merge and one process do (the
    materials differ, so the wrong twin changes the echoes)."""
    port, ref = runs(shape)
    R, _ = shape
    for out in port.values():
        assert_settings(out[f"tie_{engine}"], ref["tie"])
    echo = np.concatenate([r[f"tie_{engine}"]["echo"]
                           for r in rows_of(port, R)])
    np.testing.assert_allclose(echo,
                               np.asarray(ref["tie_result"].echo_distances),
                               **ECHO)
    assert (echo > 0).any()


# ---------------------------------------------------------------------------
# The sharded materials step
# ---------------------------------------------------------------------------


def port_one_process_step(jscene, shape, engine):
    """The port's one-process step on the padded scene: (loss, grads)."""
    R, P = shape
    padded = j_pad(jscene, P)
    scene = convert.scene_from_arrays(arrays(padded), "cpu")
    params = tdiff.SceneParams.from_scene(scene)
    step, init = tdiff.make_train_step(TraceConfig(**train_cfg(R)),
                                       optimizer=sgd_lr1, backend=engine,
                                       device="cpu")
    opt = init(params)
    before = [x.detach().clone() for x in params.leaves()]
    target = convert.loudness_from_arrays(arrays(j_target(
        jscene.num_targets)), "cpu")
    _, _, loss = step(params, opt, scene, torch.zeros(3),
                      fibonacci_directions(RAYS, "cpu"), target)
    return float(loss), [host(b - x) for b, x in zip(before,
                                                     params.leaves())]


def assert_shard_grads(port, P, want, **tol):
    """Every rank's gradient slices against the global gradients."""
    for (_, j), out in port.items():
        for got, ref in zip(out, want):
            per = ref.shape[0] // P
            np.testing.assert_allclose(got, ref[j * per:(j + 1) * per],
                                       **(tol or GRAD))


@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_loss_with_ir_matches_jax(runs, engine):
    port, ref = runs((2, 2))
    assert ref["loss"] > 0.0
    for out in port.values():
        np.testing.assert_allclose(out[f"train_{engine}"]["loss"],
                                   ref["loss"], **SETTINGS)


@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_grads_match_jax(runs, engine):
    """After one SGD(lr 1) step on a 2x2 mesh, the port's material
    gradients equal JAX's sharded step's: not N times too large (an
    all-reduce whose backward sums again) or too small (no sum over
    'rays')."""
    port, ref = runs((2, 2))
    assert sum(float(np.abs(g).sum()) for g in ref["grads"]) > 0.0
    assert_shard_grads({k: v[f"train_{engine}"]["grads"]
                        for k, v in port.items()}, 2, ref["grads"])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_kernel_step_takes_the_density_adjoint(runs, shape):
    """Only the materials train, so the kernel engine's chord backward is
    B4's alone, as in the one-process step: the merged hit rows must not
    carry the materials' graph into the ray origins (B5)."""
    port, _ = runs(shape)
    for out in port.values():
        assert out["train_kernel"]["adjoints"] == (1, 0)
        assert out["train_dense"]["adjoints"] == (0, 0)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_one_process(runs, jscene, shape, engine):
    port, _ = runs(shape)
    loss, grads = port_one_process_step(jscene, shape, engine)
    for out in port.values():
        np.testing.assert_allclose(out[f"train_{engine}"]["loss"], loss,
                                   **SETTINGS)
    assert_shard_grads({k: v[f"train_{engine}"]["grads"]
                        for k, v in port.items()}, shape[1], grads)


# ---------------------------------------------------------------------------
# The collectives, padding and the shard helpers
# ---------------------------------------------------------------------------


def test_all_reduce_sum_backward_is_the_identity(runs):
    port, _ = runs((2, 2))
    for (i, j), out in port.items():
        c = out["comm"]
        # rays group of column j: ranks j and 2 + j hold rank + 1.
        np.testing.assert_array_equal(c["sum"], [j + 1 + 2 + j + 1, 4.0])
        np.testing.assert_array_equal(c["grad"], [3.0, 5.0])
        np.testing.assert_array_equal(c["none"], [2 * i + j + 1.0, 2.0])


def test_min_max_and_packed_sums(runs):
    port, _ = runs((2, 2))
    for (i, _), out in port.items():
        c = out["comm"]
        np.testing.assert_array_equal(c["min"], [0, -3])
        np.testing.assert_array_equal(c["max"], [3.0])
        # prims group of row i: ranks 2i and 2i + 1.
        np.testing.assert_array_equal(c["sums"][0], [4.0 * i + 1.0])
        np.testing.assert_array_equal(c["sums"][1], np.full((2, 2), 2.0))


@pytest.mark.parametrize("engine", ENGINES)
def test_prim_padding_preserves_the_result(jscene, engine):
    scene = convert.scene_from_arrays(arrays(jscene), "cpu")
    padded = pad_scene_for_prim_shards(scene, 4)
    for p in (padded.spheres, padded.aabbs, padded.obbs):
        assert p.count % 4 == 0
    cfg = TraceConfig(ray_count=32, max_bounces=2)
    dirs = fibonacci_directions(32, "cpu")
    _, a = t_forward(torch.zeros(3), dirs, scene, cfg, backend=engine,
                     device="cpu")
    _, b = t_forward(torch.zeros(3), dirs, padded, cfg, backend=engine,
                     device="cpu")
    assert_settings(settings_of(a), b)


def test_padding_equals_jax_padding(jscene):
    want = arrays(j_pad(jscene, 4))
    got = pad_scene_for_prim_shards(
        convert.scene_from_arrays(arrays(jscene), "cpu"), 4)
    for kind in ("spheres", "aabbs", "obbs"):
        g, w = getattr(got, kind), getattr(want, kind)
        for f in dataclasses.fields(g):
            gv, wv = getattr(g, f.name), getattr(w, f.name)
            if f.name == "material":
                for m in ("absorption", "density", "echo"):
                    np.testing.assert_array_equal(host(getattr(gv, m)),
                                                  getattr(wv, m))
            else:
                np.testing.assert_array_equal(host(gv), wv)


def test_shards_are_contiguous_slices_of_the_jax_arrays(jscene):
    padded = arrays(j_pad(jscene, 2))
    params = arrays(jdiff.SceneParams.from_scene(j_pad(jscene, 2)))
    for j in range(2):
        mesh = types.SimpleNamespace(prim_shards=2, prim_index=j,
                                     device=torch.device("cpu"))
        scene, p = convert.shard_from_arrays(padded, mesh, params)
        for kind, pk in (("spheres", "sphere"), ("aabbs", "aabb"),
                         ("obbs", "obb")):
            full = getattr(padded, kind).center
            per = full.shape[0] // 2
            np.testing.assert_array_equal(host(getattr(scene, kind).center),
                                          full[j * per:(j + 1) * per])
            dens = getattr(getattr(params, pk), "density")
            np.testing.assert_array_equal(
                host(getattr(p, pk).density), dens[j * per:(j + 1) * per])
            assert getattr(p, pk).density.is_leaf
        np.testing.assert_array_equal(host(scene.target_positions),
                                      padded.target_positions)


def test_local_ray_slice_on_a_mesh():
    mesh = types.SimpleNamespace(ray_shards=4, ray_index=2)
    assert local_ray_slice(128, mesh) == slice(64, 96)
    with pytest.raises(ValueError):
        local_ray_slice(130, mesh)
