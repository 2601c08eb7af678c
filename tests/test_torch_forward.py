"""The ported forward frame as a whole, against the JAX package, plus the
port's import and device rules.

Port ``forward`` with ``backend="kernel"`` (the kernels' plain versions on
the CPU) and ``backend="dense"`` against the JAX forward with
``backend="jnp"`` and ``"pallas_interpret"``, on JAX scenes carried
across with ``convert.scene_from_arrays`` and the same Fibonacci rays.
Tolerances are those of tests/test_pallas.py and
tests/test_forward_parity.py.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracer_tpu import types as jtypes
from audio_raytracer_tpu.models.raytracer import forward as j_forward
from audio_raytracer_tpu.models.raytracer import random_scene as j_random_scene
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu_torch import types as ttypes
from audio_raytracer_tpu_torch.convert import scene_from_arrays
from audio_raytracer_tpu_torch.models import raytracer as tmodel

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = {
    # The forward fixture of tests/test_pallas.py.
    "pallas_fixture": (
        dict(key=21, num_spheres=9, num_aabbs=13, num_obbs=11, num_targets=2,
             extent=15.0, size_range=(1.0, 4.0),
             target_owned_colliders=True),
        dict(ray_count=64, max_bounces=3, max_ray_life=150.0,
             num_accum_batches=2)),
    # Eight targets, two accumulation batches and the reverb IR.
    "eight_targets_reverb": (
        dict(key=21, num_spheres=8, num_aabbs=16, num_obbs=8, num_targets=8),
        dict(ray_count=128, max_bounces=3, max_ray_life=150.0,
             num_accum_batches=2, num_reverb_bins=32)),
    # The headline's settings on a small scene.
    "headline_small": (
        dict(key=0, num_spheres=8, num_aabbs=16, num_obbs=8, num_targets=4,
             extent=30.0, size_range=(0.5, 4.0)),
        dict(ray_count=256, max_bounces=4, max_ray_life=300.0,
             max_muffle_hit_distance=250.0, num_reverb_bins=64)),
    # More ray sets than one B2 or B3 launch takes (fused.MAX_SETS = 16).
    "eighteen_targets": (
        dict(key=5, num_spheres=8, num_aabbs=8, num_obbs=8, num_targets=18,
             extent=20.0),
        dict(ray_count=64, max_bounces=2, max_ray_life=150.0,
             num_accum_batches=2)),
}


def run_jax(name, backend):
    scene_kw, cfg_kw = CONFIGS[name]
    scene_kw = dict(scene_kw)
    js = j_random_scene(jax.random.key(scene_kw.pop("key")), **scene_kw)
    cfg = jtypes.TraceConfig(**cfg_kw)
    dirs = fibonacci_directions(cfg.ray_count)
    r, s = j_forward(jnp.zeros(3), dirs, js, cfg, collect_debug=True,
                     backend=backend)
    return js, np.asarray(dirs), r, s


@pytest.fixture(scope="module")
def jax_runs():
    """(name, backend) -> run_jax(name, backend), each run made once."""
    runs = {}

    def get(name, backend):
        if (name, backend) not in runs:
            runs[name, backend] = run_jax(name, backend)
        return runs[name, backend]

    return get


def run_port(js, dirs, name, backend):
    cfg = ttypes.TraceConfig(**CONFIGS[name][1])
    scene = scene_from_arrays(jax.tree.map(np.asarray, js), device="cpu")
    return tmodel.forward(torch.zeros(3), torch.as_tensor(np.array(dirs)),
                          scene, cfg, collect_debug=True, backend=backend,
                          device="cpu")


def echo_match(a, b):
    return np.isclose(a, b, rtol=1e-4, atol=1e-3).mean()


# The JAX Pallas tier's approximate reciprocal (kernels.py::_fast_recip)
# flips razor-edge occlusions against its own jnp tier on the headline
# scene (tests/test_forward_parity.py pins the two engines separately);
# the port computes exact reciprocals, so there it is held to jnp. The
# many-target scene is held to jnp alone, to keep the interpreter's time
# down.
PAIRS = [(name, jb) for name in CONFIGS for jb in ("jnp", "pallas_interpret")
         if (name, jb) not in (("headline_small", "pallas_interpret"),
                               ("eighteen_targets", "pallas_interpret"))]


def test_jax_engines_disagree_where_a_pair_is_left_out(jax_runs):
    a = jax_runs("headline_small", "jnp")[2].muffle_hits
    b = jax_runs("headline_small", "pallas_interpret")[2].muffle_hits
    assert not np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name,jax_backend", PAIRS)
@pytest.mark.parametrize("port_backend", ["kernel", "dense"])
def test_forward_matches_jax(jax_runs, name, port_backend, jax_backend):
    js, dirs, jr, jsett = jax_runs(name, jax_backend)
    r, s = run_port(js, dirs, name, port_backend)
    np.testing.assert_array_equal(r.muffle_hits.numpy(),
                                  np.asarray(jr.muffle_hits))
    np.testing.assert_allclose(s.muffle.numpy(), np.asarray(jsett.muffle),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r.permeation.numpy(),
                               np.asarray(jr.permeation), rtol=1e-5,
                               atol=1e-3)
    assert echo_match(r.echo_distances.numpy(),
                      np.asarray(jr.echo_distances)) > 0.995
    assert (r.hit_counts.numpy() == np.asarray(jr.hit_counts)).mean() > 0.99
    for k in ("reverb_strength", "reverb_volume"):
        np.testing.assert_allclose(float(getattr(s, k)),
                                   float(getattr(jsett, k)), rtol=1e-4,
                                   atol=1e-4)
    if jr.reverb_ir is not None:
        np.testing.assert_allclose(r.reverb_ir.numpy(),
                                   np.asarray(jr.reverb_ir), rtol=1e-3,
                                   atol=1e-2)


def test_kernel_and_dense_port_backends_agree():
    js, dirs, _, _ = run_jax("pallas_fixture", "jnp")
    rk, sk = run_port(js, dirs, "pallas_fixture", "kernel")
    rd, sd = run_port(js, dirs, "pallas_fixture", "dense")
    assert torch.equal(rk.hit_counts, rd.hit_counts)
    assert torch.equal(rk.muffle_hits, rd.muffle_hits)
    np.testing.assert_allclose(rk.echo_distances.numpy(),
                               rd.echo_distances.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_empty_scene_and_no_targets():
    cfg = ttypes.TraceConfig(ray_count=32, max_bounces=2)
    o, d = tmodel.demo_inputs(cfg, device="cpu")
    empty = tmodel.random_scene(0, 0, 0, 0, num_targets=1, device="cpu")
    for backend in ("kernel", "dense"):
        r, s = tmodel.forward(o, d, empty, cfg, backend=backend,
                              collect_debug=True, device="cpu")
        assert float(r.echo_distances.sum()) == 0.0
        assert int(r.hit_counts.sum()) == 0
        assert float(s.reverb_volume) == 1.0
    lone = tmodel.random_scene(1, 3, 3, 3, num_targets=0, device="cpu")
    r, s = tmodel.make_forward(cfg, device="cpu")(o, d, lone)
    assert r.muffle_hits.shape == (1, 0) and s.muffle.shape == (0,)


class TestDeviceRules:
    def test_entry_points_default_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = ttypes.TraceConfig(ray_count=8)
        scene = tmodel.random_scene(0, 2, 2, 2, device="cpu")
        o, d = tmodel.demo_inputs(cfg, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            tmodel.random_scene(0)
        with pytest.raises(RuntimeError, match="CUDA"):
            tmodel.demo_inputs(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            tmodel.make_forward(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            tmodel.forward(o, d, scene, cfg)

    def test_inputs_must_lie_on_the_device(self):
        cfg = ttypes.TraceConfig(ray_count=8)
        scene = tmodel.random_scene(0, 2, 2, 2, device="cpu")
        o, d = tmodel.demo_inputs(cfg, device="cpu")
        with pytest.raises(ValueError):
            tmodel.forward(o.to("meta"), d, scene, cfg, device="cpu")

    def test_unknown_backend(self):
        cfg = ttypes.TraceConfig(ray_count=8)
        scene = tmodel.random_scene(0, 2, 2, 2, device="cpu")
        o, d = tmodel.demo_inputs(cfg, device="cpu")
        with pytest.raises(ValueError, match="backend"):
            tmodel.forward(o, d, scene, cfg, backend="pallas", device="cpu")


FORBIDDEN = {"jax", "jaxlib", "audio_raytracer_tpu"}


def _imported_top_levels(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    # Compares the top-level module name exactly: the port's own name
    # starts with "audio_raytracer_tpu" and must not count.
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "audio_raytracer_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for f in files:
        bad = FORBIDDEN & set(_imported_top_levels(f))
        assert not bad, f"{os.path.relpath(f, REPO)} imports {bad}"
    assert "audio_raytracer_tpu_torch" in set(
        _imported_top_levels(files[0]))
