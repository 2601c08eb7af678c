"""B3's launch shapes: the planner ``fused.chord_splits`` and the row
chunks of a thread-block cluster (``fused.chord_chunks``), held against
the JAX package.

At few rays the kernel cuts the scan-order rows (spheres, then AABBs,
then OBBs) into K contiguous chunks, one per block of a cluster, and adds
the blocks' sums in rank order (csrc/multi_chord.cu). Here the plain
version runs on each chunk's rows alone, the chunks are summed in rank
order, and the sum is held against the JAX package's Pallas kernel in
interpret mode and its dense (jnp) tier, at the tolerance of
``tests/test_pallas.py``'s chord tests: rtol 1e-5, atol 1e-4 (only the
order of the float32 sums differs). The CUDA kernel itself runs only on
the card, where chip_smoke.py holds it against the plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from audio_raytracer_tpu.models.raytracer import random_scene as j_random_scene
from audio_raytracer_tpu.ops.backend import NO_SKIP as J_NO_SKIP
from audio_raytracer_tpu.ops.backend import DenseBackend as JDense
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.ops.pallas import PallasBackend
from audio_raytracer_tpu_torch.convert import scene_from_arrays
from audio_raytracer_tpu_torch.ops.backend import NO_SKIP
from audio_raytracer_tpu_torch.ops.cuda import fused as F
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.ops.cuda.backend import prepare_fields

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4


@settings(max_examples=300, deadline=None, database=None)
@given(R=st.integers(0, 1 << 22), rows=st.integers(0, 100_000),
       sms=st.integers(1, 264))
def test_chord_splits_cover_the_rows(R, rows, sms):
    G, K_ = F.chord_splits(R, rows, sms)
    lanes = F.BLOCK // G
    assert G * lanes == F.BLOCK and G & (G - 1) == 0
    assert 1 <= K_ <= F.MAX_CLUSTER
    if -(-R // F.BLOCK) >= F.FILL * sms or R == 0 or rows == 0:
        assert (G, K_) == (F.BLOCK, 1)
    if K_ > 1:
        # Whole blocks of lanes per ray, no more than one lane per row.
        assert G == 1 and (K_ - 1) * F.BLOCK < rows
    elif G < F.BLOCK:
        # At least two lanes a ray, and not one lane too many for the rows.
        assert lanes >= 2 and lanes // 2 < rows
    if rows:
        chunks = F.chord_chunks(rows, K_)
        assert len(chunks) == K_
        assert chunks[0][0] == 0 and chunks[-1][1] == rows
        assert all(lo < hi for lo, hi in chunks)
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))


@pytest.mark.parametrize("R,rows,sms,want", [
    (1, 4096, 132, (1, 16)),        # the headline frame: one row a lane
    (1, 136, 132, (1, 1)),          # the frame loop's 111 colliders
    (64, 4096, 132, (1, 5)),
    (512, 4096, 132, (1, 1)),
    (4096, 4096, 132, (8, 1)),      # 32 lanes a ray
    (131_072, 4096, 132, (128, 1)),  # two lanes a ray, the fewest
    (134_913, 4096, 132, (F.BLOCK, 1)),  # 528 ray blocks: 4 per SM
    (1 << 20, 4096, 132, (F.BLOCK, 1)),  # the training step
    (1 << 20, 4096, 4096, (128, 1)),     # a card of 4,096 SMs
    (5, 1, 132, (F.BLOCK, 1)),           # one row: one lane a ray
])
def test_chord_splits_at_the_main_paths_shapes(R, rows, sms, want):
    assert F.chord_splits(R, rows, sms) == want


def cut(fields: K.Fields, lo: int, hi: int) -> K.Fields:
    """The scan-order rows [lo, hi) of ``fields`` (spheres, then AABBs,
    then OBBs)."""
    tabs, base = [], 0
    for tab in (fields.sph, fields.aabb, fields.obb):
        n = tab.shape[0]
        tabs.append(tab[min(max(lo - base, 0), n):min(max(hi - base, 0), n)])
        base += n
    return K.Fields(*tabs)


@pytest.fixture(scope="module")
def scenes():
    """The fixture scene of tests/test_pallas.py (target-owned colliders)
    with a few inactive spheres, AABBs and OBBs."""
    js = j_random_scene(jax.random.key(21), num_spheres=9, num_aabbs=13,
                        num_obbs=11, num_targets=2, extent=15.0,
                        size_range=(1.0, 4.0), target_owned_colliders=True)
    def every(prims, k):
        n = prims.active.shape[0]
        return dataclasses.replace(prims, active=jnp.arange(n) % k != 1)

    js = js.replace(spheres=every(js.spheres, 4), aabbs=every(js.aabbs, 5),
                    obbs=every(js.obbs, 3))
    scene = scene_from_arrays(jax.tree.map(np.asarray, js), device="cpu")
    return js, scene


def chord_inputs(js, kind, R, S):
    """R origins and S unit direction sets with their skip targets.
    "bounce": the JAX package's own chord inputs (tests/test_pallas.py::
    TestFusedKernels._sets): points 3 along Fibonacci directions from the
    listener, each set aimed at a target or at the echo point. "spread":
    origins anywhere in the scene, random directions."""
    rng = np.random.default_rng(100 * R + S)
    if kind == "bounce":
        o = np.asarray(fibonacci_directions(96))[:R] * 3.0
        tp = np.asarray(js.target_positions)
        ends = (tp[0], tp[1], np.array([1.0, 2.0, 0.5]), tp[0])
        vs = [end - o for end in ends[:S]]
    else:
        o = rng.uniform(-12.0, 12.0, (R, 3))
        vs = [rng.normal(size=(R, 3)) for _ in range(S)]
    dirs = [(v / np.linalg.norm(v, axis=-1, keepdims=True))
            .astype(np.float32) for v in vs]
    skips = (0, 1, NO_SKIP, NO_SKIP)[:S]
    return o.astype(np.float32), dirs, skips


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("R", [1, 3, 37])
@pytest.mark.parametrize("kind", ["bounce", "spread"])
def test_chunked_sum_matches_pallas_and_dense(scenes, kind, R, S):
    # The chunks' sums in rank order against the jnp tier, and on the
    # JAX package's own chord inputs against the Pallas kernel in
    # interpret mode too. On origins spread through the scene the Pallas
    # tier's box chords depart from its own jnp tier by up to ~1.2e-4
    # relative (3.7e-4 at a chord sum of 3.0 at R = 37, S = 4), beyond
    # this tolerance, so there the chunks are held to the jnp tier alone.
    js, scene = scenes
    fields = prepare_fields(scene)
    rows = fields.total
    assert all(not K.active_rows(tab).all()
               for tab in (fields.sph, fields.aabb, fields.obb))
    o, dirs, skips = chord_inputs(js, kind, R, S)
    jskips = tuple(J_NO_SKIP if k == NO_SKIP else k for k in skips)
    jdirs = [jnp.asarray(d) for d in dirs]
    refs = [JDense(js).multi_permeation_loss(o, jdirs, jskips)]
    if kind == "bounce":
        refs.append(PallasBackend(js, interpret=True).multi_permeation_loss(
            o, jdirs, jskips))
    ot, dt = torch.as_tensor(o), [torch.as_tensor(d) for d in dirs]
    # The planner's K at these shapes (1: the scene has 33 rows), then
    # clusters of 2, 5 and the most blocks.
    ks = sorted({F.chord_splits(R, rows, 132)[1], 2, 5, F.MAX_CLUSTER})
    for K_ in ks:
        total = None
        for lo, hi in F.chord_chunks(rows, K_):
            part = F.multi_chord_plain(cut(fields, lo, hi), ot, dt, skips)
            total = part if total is None else total + part
        for ref in refs:
            np.testing.assert_allclose(total.numpy(), np.asarray(ref),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"K={K_}")
    if R == 37 and (kind == "spread" or S == 4):
        assert (total > 0).sum() > R // 4
