"""Ray compaction (``TraceConfig.compact_rays`` / ``compact_unordered``)
in the port's trace, against itself uncompacted and against the JAX
package's compacted forward; and the roofline tool's participation
histogram against the JAX forward's.

The port's kernel backend runs its kernels' plain versions on the CPU; the
JAX side runs ``backend="pallas_interpret"`` with the same flags. The
cases are tests/test_pallas.py::TestRayCompaction's, with its tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracer_tpu import types as jtypes
from audio_raytracer_tpu.models.raytracer import forward as j_forward
from audio_raytracer_tpu.models.raytracer import random_scene as j_random_scene
from audio_raytracer_tpu.ops import trace as jtrace
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu_torch import types as ttypes
from audio_raytracer_tpu_torch.convert import scene_from_arrays
from audio_raytracer_tpu_torch.models import raytracer as tmodel
from audio_raytracer_tpu_torch.ops import trace as ttrace
from audio_raytracer_tpu_torch.tools import roofline

torch.set_num_threads(1)

R = 256
# Short ray life, so that lanes die and the reorder engages
# (test_pallas.py::TestRayCompaction).
CFG = dict(ray_count=R, max_bounces=3, max_ray_life=40.0,
           num_accum_batches=4)


@pytest.fixture(scope="module")
def jscene():
    # The fixture scene of tests/test_pallas.py.
    return j_random_scene(jax.random.key(21), num_spheres=9, num_aabbs=13,
                          num_obbs=11, num_targets=2, extent=15.0,
                          size_range=(1.0, 4.0), target_owned_colliders=True)


@pytest.fixture(scope="module")
def scene(jscene):
    return scene_from_arrays(jax.tree.map(np.asarray, jscene), device="cpu")


@pytest.fixture(scope="module")
def dirs():
    return np.asarray(fibonacci_directions(R))


@pytest.fixture(scope="module")
def jax_run(jscene, dirs):
    """JAX compacted forwards, each made once: (backend, max_ray_life,
    unordered) -> (TraceResult, TargetSettings), with collect_debug
    where the tier is ordered."""
    runs = {}

    def get(backend, life, unordered=False):
        key = backend, life, unordered
        if key not in runs:
            cfg = jtypes.TraceConfig(**{**CFG, "max_ray_life": life},
                                     compact_rays=True,
                                     compact_unordered=unordered)
            runs[key] = j_forward(jnp.zeros(3), dirs, jscene, cfg,
                                  collect_debug=not unordered,
                                  backend=backend)
        return runs[key]

    return get


def port(scene, dirs, collect_debug=True, backend="kernel", **cfg):
    return tmodel.forward(torch.zeros(3), torch.as_tensor(dirs), scene,
                          ttypes.TraceConfig(**{**CFG, **cfg}),
                          collect_debug=collect_debug, backend=backend,
                          device="cpu")


def close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("alive", [
    [True, False, True, True, False, False, True, False],
    [True] * 5, [False] * 5, [False, True]])
def test_alive_partition_matches_jax(alive):
    order, pos = ttrace.alive_partition(torch.tensor(alive))
    j_order, j_pos = jtrace.alive_partition(jnp.asarray(alive))
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    x = torch.arange(len(alive))
    assert torch.equal(x[order][pos], x)  # pos undoes order
    assert ttrace.alive_partition(torch.tensor(alive), False)[1] is None


def test_pack_rows_round_trip():
    rng = np.random.default_rng(0)
    f = torch.as_tensor(rng.normal(size=(6, 3)).astype(np.float32))
    i = torch.tensor([0, -1, 2**31 - 1, -2**31, 7, 3], dtype=torch.int32)
    b = torch.tensor([True, False, True, True, False, False])
    rows = ttrace._pack_rows(f, i, b)
    assert rows.shape == (6, 5) and rows.dtype == torch.float32
    assert torch.equal(ttrace._unpack_col(rows, slice(0, 3)), f)
    assert torch.equal(ttrace._unpack_col(rows, 3, torch.int32), i)
    assert torch.equal(ttrace._unpack_col(rows, 4, torch.bool), b)


def test_compacted_forward_identical_to_uncompacted(scene, dirs):
    # Each ray's arithmetic is per lane and the outputs go back to the
    # original order, so the reorder is invisible.
    r_p, s_p = port(scene, dirs)
    r_c, s_c = port(scene, dirs, compact_rays=True)
    assert torch.equal(r_p.muffle_hits, r_c.muffle_hits)
    assert torch.equal(r_p.hit_counts, r_c.hit_counts)
    assert 0 < float((r_p.hit_counts < CFG["max_bounces"] + 1)
                     .float().mean()) < 1  # some rays died early
    for a, b in [(r_p.echo_distances, r_c.echo_distances),
                 (r_p.first_hit_t, r_c.first_hit_t),
                 (r_p.hit_points, r_c.hit_points), (s_p.muffle, s_c.muffle)]:
        close(a, b)


def test_unordered_tier_invariants(scene, dirs):
    # No per-bounce restore: echo rows are permuted within each bounce
    # column, and every reduction downstream is as in the ordered tier.
    r_o, s_o = port(scene, dirs, collect_debug=False, compact_rays=True)
    r_u, s_u = port(scene, dirs, collect_debug=False, compact_rays=True,
                    compact_unordered=True)
    assert torch.equal(r_o.muffle_hits, r_u.muffle_hits)
    close(r_o.first_hit_t, r_u.first_hit_t)
    e_o = r_o.echo_distances.numpy().astype(np.float64)
    e_u = r_u.echo_distances.numpy().astype(np.float64)
    assert not np.array_equal(e_o, e_u)  # the rows really are permuted
    close(e_o.sum(axis=0), e_u.sum(axis=0), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal((e_o == 0).sum(axis=0),
                                  (e_u == 0).sum(axis=0))
    for h in range(e_o.shape[1]):
        close(np.sort(e_o[:, h]), np.sort(e_u[:, h]))
    for k in ("muffle", "reverb_strength", "reverb_volume"):
        close(getattr(s_o, k), getattr(s_u, k))
    # collect_debug needs ordered rows: the flag yields to it.
    r_dbg, _ = port(scene, dirs, compact_rays=True, compact_unordered=True)
    r_ref, _ = port(scene, dirs, compact_rays=True)
    assert torch.equal(r_dbg.hit_counts, r_ref.hit_counts)
    assert torch.equal(r_dbg.echo_distances, r_ref.echo_distances)


@pytest.mark.parametrize("num_accum_batches", [1, 4])
def test_unordered_muffle_reduce(scene, dirs, num_accum_batches):
    # The per-bounce reduce: a sum for one batch, the one-hot product on
    # the carried batch ids for several.
    kw = dict(collect_debug=False, num_accum_batches=num_accum_batches)
    r_p, _ = port(scene, dirs, **kw)
    r_u, _ = port(scene, dirs, compact_rays=True, compact_unordered=True,
                  **kw)
    assert r_u.muffle_hits.shape == (num_accum_batches, 2)
    assert torch.equal(r_p.muffle_hits, r_u.muffle_hits)


@pytest.mark.parametrize("unordered", [False, True])
def test_compacted_forward_matches_jax(jax_run, scene, dirs, unordered):
    # Against the JAX compacted forward on its Pallas tier. Its
    # approximate reciprocal (kernels.py::_fast_recip) flips a razor-edge
    # occlusion against its own jnp tier here (one muffle count), so the
    # counts are held exactly to the jnp tier, where compaction is
    # invisible, and to within one count to the Pallas tier.
    life = CFG["max_ray_life"]
    jr, js = jax_run("pallas_interpret", life, unordered)
    jr_jnp, _ = jax_run("jnp", life)
    r, s = port(scene, dirs, collect_debug=not unordered, compact_rays=True,
                compact_unordered=unordered)
    np.testing.assert_array_equal(r.muffle_hits.numpy(),
                                  np.asarray(jr_jnp.muffle_hits))
    diff = np.abs(r.muffle_hits.numpy() - np.asarray(jr.muffle_hits))
    assert diff.max() <= 1 and (diff > 0).sum() <= 2
    close(s.muffle, js.muffle, rtol=1e-4, atol=5e-3)
    e, je = r.echo_distances.numpy(), np.asarray(jr.echo_distances)
    if unordered:  # both permuted within each column: compare sorted
        e, je = np.sort(e, axis=0), np.sort(je, axis=0)
    else:
        assert (r.hit_counts.numpy() == np.asarray(jr.hit_counts)
                ).mean() > 0.99
    assert np.isclose(e, je, rtol=1e-4, atol=1e-3).mean() > 0.995
    hit = torch.isfinite(r.first_hit_t).numpy()
    np.testing.assert_array_equal(hit, np.isfinite(np.asarray(
        jr.first_hit_t)))
    # The echo tolerance: the fast reciprocal moves t by ~1e-5 relative.
    close(r.first_hit_t.numpy()[hit], np.asarray(jr.first_hit_t)[hit],
          rtol=1e-4, atol=1e-3)


def test_compacted_forward_matches_jax_dense_settings(jax_run, scene, dirs):
    # Aggregate parity against the JAX jnp tier (test_pallas.py's case).
    _, js = jax_run("jnp", 60.0)
    _, s = port(scene, dirs, collect_debug=False, max_ray_life=60.0,
                compact_rays=True)
    close(s.muffle, js.muffle, rtol=1e-4, atol=5e-3)


def test_dense_backend_does_not_reorder(scene, dirs):
    # Compaction pays only where the engine skips dead lanes; the dense
    # tier ignores the flag (as the JAX trace does).
    r_p, _ = port(scene, dirs, backend="dense")
    r_c, _ = port(scene, dirs, backend="dense", compact_rays=True,
                  compact_unordered=True)
    assert torch.equal(r_p.echo_distances, r_c.echo_distances)
    assert torch.equal(r_p.hit_counts, r_c.hit_counts)


def test_participation_matches_jax_hit_counts(jax_run, scene, dirs):
    lives = (CFG["max_ray_life"], 25.0)
    got = roofline.participation(scene, torch.as_tensor(dirs), lives=lives,
                                 max_bounces=CFG["max_bounces"],
                                 device="cpu")
    for life in lives:
        jr, _ = jax_run("pallas_interpret", life)
        hist = np.bincount(np.asarray(jr.hit_counts),
                           minlength=CFG["max_bounces"] + 2) / R
        ge = np.cumsum(hist[::-1])[::-1]
        close(got[life]["ge"], ge[1:], rtol=0, atol=0)
        assert got[life]["sweeps"] == pytest.approx(float(ge[1:].sum()))
    assert got[25.0]["sweeps"] < got[CFG["max_ray_life"]]["sweeps"]


def test_config_accepts_compaction():
    cfg = ttypes.TraceConfig(compact_rays=True, compact_unordered=True)
    assert cfg.compact_rays and cfg.compact_unordered
    assert dataclasses.replace(cfg, compact_rays=False).compact_unordered
