"""Frozen operation and byte counts of B4, the density adjoint of the
permeation chords, and the kernel's name.

B4 gives each primitive p the sum over rays r and ray sets s of g[r, s]
x chord(r, s, p): the chord length through p along the unbounded ray
from r's first hit toward target s, counted only where the ray meets p
ahead of it and p is not owned by s. In a materials step g is the loss's
cotangent of each ray's chord loss; it is zero for a ray with no first
hit, and such a ray does no work. The counts follow the chord's tests,
as the reference's ``chords`` makes them (``reference/materials.py``),
for each ray with a first hit against every primitive and every set.
Nothing depends on tiling, on the order of the tables or on which
kernel runs.

Float operations per (hitting ray, primitive), as (shared by the sets,
per set), by type (the chord's work, g in place of the density):

- sphere 9 + 18: the origin's offset from the centre and c = |oc|^2 -
  r^2; per set b = oc.d, the discriminant, its root, the entry and exit,
  the clamped chord, the tests and g x chord added;
- AABB 7 + 23: the slab offsets of the origin; per set the six products
  by the inverse direction, the per-axis min / max, the near / far
  reductions, the clamped chord, the tests and g x chord;
- OBB 28 + 44: the origin's rotation into the box frame and its
  offsets; per set the direction's rotation and inverse and the AABB's
  per-set work there.

Bytes: each hitting ray's record once (its origin, 16 B with the flag
of a live ray, and per set its direction and g, 16 B), each primitive's
fields once (sphere 6 floats: centre, radius, density, owner; AABB 8:
bounds, density, owner; OBB 12: centre, half extents, rotation,
density, owner) and its gradient written (4 B).
"""

from __future__ import annotations

import re

B4_KERNEL = "multi_chord_dens_bwd_kernel"
B4_OPS = ((9, 18), (7, 23), (28, 44))
PRIM_BYTES = (6 * 4, 8 * 4, 12 * 4)
_NAME = re.compile(rf"(?<![A-Za-z0-9_]){B4_KERNEL}(?![A-Za-z0-9_])")


def is_b4(name: str) -> bool:
    """Is a device activity's name B4's kernel (as a whole identifier)?"""
    return _NAME.search(name) is not None


def b4_seconds(events) -> float:
    """Device seconds of B4's launches among ``events``."""
    return sum(e.end - e.ts for e in events if is_b4(e.name)) * 1e-6


def b4_counts(prims, hitting: int, sets: int) -> tuple[int, int]:
    """(operations, bytes) of one B4 launch set: ``prims`` (spheres,
    AABBs, OBBs), ``hitting`` rays with a first hit, ``sets`` ray sets
    (targets)."""
    ops = hitting * sum(n * (a + b * sets)
                        for n, (a, b) in zip(prims, B4_OPS))
    by = (hitting * 16 * (1 + sets)
          + sum(n * (b + 4) for n, b in zip(prims, PRIM_BYTES)))
    return ops, by
