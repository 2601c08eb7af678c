"""The gradient shape-edge sweep of tests/test_fuzz_parity.py, on the port.

- The five ``grad_cases`` of ``test_gradient_shape_edges``, and three
  that straddle the card's tile (``ops/cuda/kernels.py::TILE``, 128
  rows, the port's padding edge in place of the Pallas tier's
  ``DENS_CHUNK``): one type stream of exactly TILE, TILE - 1 and
  TILE + 1 rows. Both engines' materials gradients against JAX's dense
  autodiff at rtol 5e-4 / atol 5e-6.
- ``test_pose_grads_across_chunk_boundary``: material and listener
  origin gradients of the full adjoint (B5) with a stream that crosses
  a tile (key 88: 3 / 70 / 2, and 3 / 130 / 2 for TILE), against JAX's
  dense autodiff at the same tolerance.

The JAX references are computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracer_tpu import types as jtypes
from audio_raytracer_tpu.models import differentiable as jdiff
from audio_raytracer_tpu.models.raytracer import random_scene as j_random_scene
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu_torch import types as ttypes
from audio_raytracer_tpu_torch.convert import scene_from_arrays
from audio_raytracer_tpu_torch.models import differentiable as tdiff
from audio_raytracer_tpu_torch.ops.cuda import fused as F
from audio_raytracer_tpu_torch.ops.cuda.kernels import TILE

torch.set_num_threads(1)

GRAD_CASES = [
    # (ns, na, no, targets, rays, bounces), keys 200 + i
    (0, 10, 0, 2, 65, 2),   # AABB-only, odd rays
    (5, 0, 3, 1, 40, 2),    # no AABBs
    (1, 1, 1, 3, 96, 3),    # single prim each
    (0, 64, 0, 1, 40, 1),   # DENS_CHUNK: exactly one full chunk
    (65, 3, 2, 2, 48, 2),   # sphere stream crosses DENS_CHUNK
    # The card's tile: one type stream of exactly TILE, TILE - 1 and
    # TILE + 1 rows.
    (0, TILE, 0, 1, 40, 1),
    (TILE - 1, 3, 2, 2, 48, 2),
    (2, 3, TILE + 1, 2, 48, 2),
]
POSE_CASES = [(3, 70, 2), (3, 130, 2)]
GRAD = dict(rtol=5e-4, atol=5e-6)
ORIGIN = [0.2, 0.1, -0.3]


def carry(js):
    return scene_from_arrays(jax.tree.map(np.asarray, js), device="cpu")


def grad_scene(i):
    ns, na, no, T = GRAD_CASES[i][:4]
    return j_random_scene(jax.random.key(200 + i), num_spheres=ns,
                          num_aabbs=na, num_obbs=no, num_targets=T,
                          extent=15.0, size_range=(1.5, 4.0))


def jax_dense_grads(js, R, B, T, wrt_origin=False):
    """JAX's dense autodiff of the loss at ORIGIN: materials leaves (and
    the origin's gradient)."""
    cfg = jtypes.TraceConfig(ray_count=R, max_bounces=B, max_ray_life=90.0)
    target = jdiff.Loudness(muffle=jnp.full((T,), 0.4),
                            permeation=jnp.full((T,), 0.3),
                            reverb_energy=jnp.asarray(0.1))
    argnums = (0, 1) if wrt_origin else 0
    g = jax.grad(lambda p, o: jdiff.loudness_loss(
        p, js, o, fibonacci_directions(R), cfg, target), argnums=argnums)(
            jdiff.SceneParams.from_scene(js), jnp.asarray(ORIGIN))
    if wrt_origin:
        return [np.asarray(x) for x in jax.tree.leaves(g[0])], \
            np.asarray(g[1])
    return [np.asarray(x) for x in jax.tree.leaves(g)], None


def port_grads(scene, R, B, T, backend, wrt_origin=False):
    params = tdiff.SceneParams.from_scene(scene)
    origin = torch.tensor(ORIGIN)
    wrt = params.leaves() + ([origin] if wrt_origin else [])
    for x in wrt:
        x.requires_grad_(True)
    target = tdiff.Loudness(muffle=torch.full((T,), 0.4),
                            permeation=torch.full((T,), 0.3),
                            reverb_energy=torch.tensor(0.1))
    cfg = ttypes.TraceConfig(ray_count=R, max_bounces=B, max_ray_life=90.0)
    loss = tdiff.loudness_loss(
        params, scene, origin,
        torch.as_tensor(np.array(fibonacci_directions(R))), cfg, target,
        backend=backend, device="cpu")
    return torch.autograd.grad(loss, wrt)


@pytest.fixture(scope="module")
def jax_grad_cases():
    runs = {}

    def get(i):
        if i not in runs:
            js = grad_scene(i)
            _, _, _, T, R, B = GRAD_CASES[i]
            runs[i] = js, jax_dense_grads(js, R, B, T)[0]
        return runs[i]

    return get


@pytest.mark.parametrize("i", range(len(GRAD_CASES)))
@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_gradient_shape_edges(jax_grad_cases, i, backend):
    js, ref = jax_grad_cases(i)
    _, _, _, T, R, B = GRAD_CASES[i]
    grads = port_grads(carry(js), R, B, T, backend)
    assert len(grads) == len(ref) == 9
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"grad case {i}",
                                   **GRAD)


@pytest.fixture(scope="module")
def jax_pose_cases():
    runs = {}

    def get(counts):
        if counts not in runs:
            js = j_random_scene(jax.random.key(88), *counts, num_targets=2,
                                extent=15.0, size_range=(1.5, 4.0))
            runs[counts] = js, jax_dense_grads(js, 48, 2, 2, wrt_origin=True)
        return runs[counts]

    return get


@pytest.mark.parametrize("counts", POSE_CASES)
def test_pose_grads_across_a_tile(jax_pose_cases, counts, monkeypatch):
    js, (ref_p, ref_o) = jax_pose_cases(counts)
    ran = []
    bwd = F.run_multi_chord_bwd
    monkeypatch.setattr(F, "run_multi_chord_bwd",
                        lambda *a: ran.append(1) or bwd(*a))
    grads = port_grads(carry(js), 48, 2, 2, "kernel", wrt_origin=True)
    assert ran, "the full adjoint (B5) did not run"
    np.testing.assert_allclose(grads[-1].numpy(), ref_o, **GRAD)
    assert float(grads[-1].abs().sum()) > 0.0
    for a, b in zip(grads[:-1], ref_p):
        np.testing.assert_allclose(a.numpy(), b, **GRAD)
