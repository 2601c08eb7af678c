"""The forward shape-edge sweep of tests/test_fuzz_parity.py, on the port.

The ten forward ``CASES`` of ``test_random_shape_parity`` (zero-count
types, zero targets, odd ray counts, single primitives, compaction
ordered and unordered) through both of the port's engines against JAX's
``jnp`` tier, with that test's tolerances; unordered cases compare the
sorted echo columns, as that test does. The gradient cases are in
tests/test_torch_shape_edge_grads.py. The JAX references are computed
once per module.
"""

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

CASES = [
    # (ns, na, no, targets, rays, bounces, compact, unordered)
    (0, 12, 0, 2, 97, 2, False, False),   # AABB-only, odd ray count
    (7, 0, 0, 1, 33, 1, False, False),    # sphere-only, tiny
    (0, 0, 9, 3, 130, 3, True, False),    # OBB-only, compaction
    (1, 1, 1, 2, 64, 4, False, False),    # single prim of each type
    (5, 9, 4, 0, 50, 2, False, False),    # ZERO targets (echo set only)
    (6, 8, 6, 5, 201, 3, True, False),    # many targets, odd rays, compact
    (0, 0, 9, 3, 130, 3, True, True),     # unordered tier
    (6, 8, 6, 5, 201, 3, True, True),     # unordered, many targets
    (5, 9, 4, 0, 50, 2, True, True),      # unordered, ZERO targets
    (0, 12, 0, 2, 97, 2, True, True),     # unordered, odd ray count
]


def carry(js):
    return scene_from_arrays(jax.tree.map(np.asarray, js), device="cpu")


def case_scene(i):
    ns, na, no, T = CASES[i][:4]
    return j_random_scene(jax.random.key(100 + i), num_spheres=ns,
                          num_aabbs=na, num_obbs=no, num_targets=T,
                          extent=20.0, size_range=(1.0, 4.0))


def case_cfg(i, types):
    R, B, compact, unordered = CASES[i][4:]
    return types.TraceConfig(ray_count=R, max_bounces=B, max_ray_life=80.0,
                             num_accum_batches=2, compact_rays=compact,
                             compact_unordered=unordered)


@pytest.fixture(scope="module")
def jax_forwards():
    """Case -> (JAX scene, jnp forward's (TraceResult, TargetSettings)),
    each made once."""
    runs = {}

    def get(i):
        if i not in runs:
            js = case_scene(i)
            runs[i] = js, j_forward(jnp.asarray([0.3, -0.2, 0.1]),
                                    fibonacci_directions(CASES[i][4]), js,
                                    case_cfg(i, jtypes), backend="jnp")
        return runs[i]

    return get


@pytest.mark.parametrize("i", range(len(CASES)))
@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_random_shape_parity(jax_forwards, i, backend):
    js, (r_d, s_d) = jax_forwards(i)
    R = CASES[i][4]
    r_p, s_p = tmodel.forward(
        torch.tensor([0.3, -0.2, 0.1]),
        torch.as_tensor(np.array(fibonacci_directions(R))), carry(js),
        case_cfg(i, ttypes), backend=backend, device="cpu")
    e_d = np.asarray(r_d.echo_distances)
    e_p = r_p.echo_distances.numpy()
    if CASES[i][7]:
        # The unordered tier permutes echo rows within each bounce column
        # (by design; the port's dense engine does not reorder, and
        # compares the same way).
        e_d, e_p = np.sort(e_d, axis=0), np.sort(e_p, axis=0)
    R_, H_ = e_d.shape
    assert e_p.shape == (R_, H_)
    # test_random_shape_parity's contract: a couple of rays' worth of
    # drift for closest-hit near-ties, nothing structural.
    mh_d = np.asarray(r_d.muffle_hits).astype(np.int64)
    mh_p = r_p.muffle_hits.numpy().astype(np.int64)
    assert np.abs(mh_d - mh_p).sum() <= 3 * H_, (
        f"case {i}: muffle_hits drift {np.abs(mh_d - mh_p).sum()}")
    echo_mismatch = (np.abs(e_d - e_p) > 1e-3).mean()
    assert echo_mismatch <= 3.0 / R_, f"case {i}: echo {echo_mismatch}"
    np.testing.assert_allclose(
        s_p.muffle.numpy(), np.asarray(s_d.muffle), rtol=1e-3,
        atol=3.0 * H_ / max(R_ * H_, 1), err_msg=f"case {i}: muffle")
    np.testing.assert_allclose(
        r_p.permeation.numpy(), np.asarray(r_d.permeation), rtol=1e-3,
        atol=1e-2, err_msg=f"case {i}: permeation")
