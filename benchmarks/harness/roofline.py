"""Frozen operation and byte counts of the ray tests, and the least time.

The counts follow the tests' semantics (the reference's slab and sphere
tests, ``reference/frame.py``) on the scene's real primitive counts, per
bounce from the work the frame's inputs need: B1 tests every primitive
for each ray alive on entry; B2 tests every primitive for each live hit
(the terms shared by its ray sets: the origin's offsets from the
primitive, and for an OBB its rotation into the box frame) and again
for each (ray, set) pair left open (a direction, a limit and the slab or
sphere test per set). Nothing depends on tile padding, on the order of
the tables or on which kernel runs.

Float operations per (ray, primitive), by type:

- sphere: B1 19 (oc, a = d.d, b, c, the discriminant and the near-root
  test); B2 10 shared (oc and c = |oc|^2 - r^2) + 15 per set (h = oc.d and
  the sign-domain entry and inside tests against the limit);
- AABB: B1 27 (six offsets, six products, the per-axis min / max and the
  near / far reduction, the miss and the t select); B2 6 shared (the
  six offsets) + 21 per set (products, min / max, reductions, the limit
  test);
- OBB: B1 69 (the rotation of the origin and the direction into the box
  frame and the AABB test there); B2 27 shared (the origin's rotation
  and offsets) + 42 per set (the direction's rotation and the slab test
  with the limit).

Bytes: each ray's origin once (12) and, per open pair, its direction (12)
and limit (4) read and its flag (1) written; each primitive's fields once
(sphere 5 floats: centre, radius, owner; AABB 7: bounds, owner; OBB 11:
centre, half extents, rotation, owner).
"""

from __future__ import annotations

import json
import os

B1_OPS = (19, 27, 69)
B2_OPS = ((10, 15), (6, 21), (27, 42))
PRIM_BYTES = (5 * 4, 7 * 4, 11 * 4)
PEAKS_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")


def peaks(path: str = PEAKS_FILE) -> dict:
    with open(path) as f:
        return json.load(f)


def b1_counts(prims, alive) -> tuple[int, int]:
    """(operations, bytes) of B1 over the bounces: ``prims`` (spheres,
    AABBs, OBBs), ``alive`` rays on entry per bounce."""
    per_ray = sum(n * k for n, k in zip(prims, B1_OPS))
    ops = sum(a * per_ray for a in alive)
    by = sum(a * (24 + 8) + sum(n * b for n, b in zip(prims, PRIM_BYTES))
             for a in alive if a)
    return ops, by


def b2_counts(prims, live, open_pairs) -> tuple[int, int]:
    """(operations, bytes) of B2 over the bounces: ``live`` hits and
    ``open_pairs`` (ray, set) pairs per bounce."""
    ops = sum(lv * sum(n * a for n, (a, _) in zip(prims, B2_OPS))
              + op * sum(n * b for n, (_, b) in zip(prims, B2_OPS))
              for lv, op in zip(live, open_pairs))
    by = sum(lv * 12 + op * (12 + 4 + 1)
             + sum(n * b for n, b in zip(prims, PRIM_BYTES))
             for lv, op in zip(live, open_pairs) if lv)
    return ops, by


def least_s(ops: int, nbytes: int, pk: dict | None = None):
    """(seconds, "ops" or "bytes"): the larger of the operations at the
    float32 peak and the bytes at the memory peak."""
    pk = peaks() if pk is None else pk
    t_ops = ops / pk["float32_flops"]
    t_bytes = nbytes / pk["hbm_bytes_per_s"]
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
