"""SceneRegistry: Python facade over the native C++ registry.

The PyTorch counterpart of ``audio_raytracer_tpu/runtime/registry.py``,
the authoring and runtime API of the reference's component layer
(AudioCollider.cs self-registration, AudioColliderManager /
AudioTargetManager). Mutations go to the native next-batch;
``snapshot()`` publishes the job batch and materializes an immutable,
capacity-padded ``Scene`` on a device. Capacities grow in powers of two
with inactive padding, as in the JAX registry, so that the snapshots of
both registries are equal field by field; the snapshot is cached while
the registry's version is unchanged.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from audio_raytracer_tpu_torch.runtime import native
from audio_raytracer_tpu_torch.types import (
    Aabbs,
    Materials,
    Obbs,
    Scene,
    Spheres,
    resolve_device,
)

SPHERE, AABB, OBB = 0, 1, 2
_STRIDE = {SPHERE: 8, AABB: 10, OBB: 14}


def _row(*vals):
    return (ctypes.c_float * len(vals))(*[float(v) for v in vals])


def _pow2_at_least(n, floor=8):
    if n <= floor:
        return floor
    return 1 << math.ceil(math.log2(n))


class SceneRegistry:
    """Mutable scene with a stable snapshot path.

    Handles returned by add_* are stable across removals (the native side
    keeps the dense-slot indirection; the reference instead patched
    component ids through events, AudioColliderManager.cs:64-105).
    """

    def __init__(self):
        self._lib = native.load()
        self._reg = ctypes.c_void_p(self._lib.art_registry_create())
        self._snapshot_key = None
        self._cached_scene = None

    def close(self):
        if self._reg:
            self._lib.art_registry_destroy(self._reg)
            self._reg = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- Authoring API ------------------------------------------------------

    def add_sphere(self, center, radius, material=(0.0, 1.0, 1.0),
                   target_id=-1) -> int:
        a, d, e = material
        return self._lib.art_add(self._reg, SPHERE, _row(
            *center, radius, a, d, e, target_id))

    def add_aabb(self, center, half_extents, material=(0.0, 1.0, 1.0),
                 target_id=-1) -> int:
        a, d, e = material
        return self._lib.art_add(self._reg, AABB, _row(
            *center, *half_extents, a, d, e, target_id))

    def add_obb(self, center, half_extents, inv_rot, material=(0.0, 1.0, 1.0),
                target_id=-1) -> int:
        """``inv_rot``: xyzw quaternion, pre-inverted like the reference
        bake (AudioOBBCollider.cs:59)."""
        a, d, e = material
        return self._lib.art_add(self._reg, OBB, _row(
            *center, *half_extents, *inv_rot, a, d, e, target_id))

    def _update(self, handle, row):
        if self._lib.art_update(self._reg, handle, row) != 0:
            raise KeyError(f"invalid handle {handle}")

    def update_sphere(self, handle, center, radius, material=(0.0, 1.0, 1.0),
                      target_id=-1):
        a, d, e = material
        self._update(handle, _row(*center, radius, a, d, e, target_id))

    def update_aabb(self, handle, center, half_extents,
                    material=(0.0, 1.0, 1.0), target_id=-1):
        a, d, e = material
        self._update(handle, _row(*center, *half_extents, a, d, e,
                                  target_id))

    def update_obb(self, handle, center, half_extents, inv_rot,
                   material=(0.0, 1.0, 1.0), target_id=-1):
        a, d, e = material
        self._update(handle, _row(*center, *half_extents, *inv_rot, a, d, e,
                                  target_id))

    def remove(self, handle):
        if self._lib.art_remove(self._reg, handle) != 0:
            raise KeyError(f"invalid handle {handle}")

    def add_target(self, position) -> int:
        return self._lib.art_add_target(self._reg, *[float(v)
                                                     for v in position])

    def set_target_position(self, idx, position):
        """Per-frame moving-source sync (AudioTargetRT.cs:53-62): the
        new position reaches the kernels — and TargetSettings.
        perceived_position — at the next snapshot() publish."""
        rc = self._lib.art_set_target_position(
            self._reg, idx, *[float(v) for v in position])
        if rc != 0:
            raise KeyError(f"invalid target {idx}")

    def remove_target(self, idx):
        if self._lib.art_remove_target(self._reg, idx) != 0:
            raise KeyError(f"invalid target {idx}")

    # -- Snapshot path ------------------------------------------------------

    @property
    def version(self) -> int:
        return self._lib.art_version(self._reg)

    def counts(self):
        c = (ctypes.c_int * 4)()
        self._lib.art_counts(self._reg, c)
        return tuple(c)

    def _job_array(self, type_id, count, stride):
        ptr = self._lib.art_job_data(self._reg, type_id)
        if count == 0:
            return np.zeros((0, stride), np.float32)
        buf = np.ctypeslib.as_array(ptr, shape=(count, stride))
        return np.array(buf)  # copy: the job batch may be republished

    def snapshot(self, device="cuda") -> Scene:
        """Publish the job batch and build a capacity-padded Scene on
        ``device``.

        Padded entries are inactive (masked) and OBB padding carries the
        identity qw; capacities grow in powers of two. While the version
        and the device are unchanged, the same Scene object comes back."""
        dev = resolve_device(device)
        changed = self._lib.art_update_job_batch(self._reg)
        key = (self.version, dev)
        if not changed and self._cached_scene is not None \
                and key == self._snapshot_key:
            return self._cached_scene

        ns, na, no, nt = self.counts()

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        def table(type_id, n):
            stride = _STRIDE[type_id]
            cap = _pow2_at_least(n)
            full = np.zeros((cap, stride), np.float32)
            if type_id == OBB:
                full[:, 9] = 1.0  # identity qw on padding
            full[:n] = self._job_array(type_id, n, stride)
            active = np.zeros((cap,), bool)
            active[:n] = True
            # Geometry columns, then absorption, density, echo, target id.
            widths = {SPHERE: (3, 1), AABB: (3, 3), OBB: (3, 3, 4)}[type_id]
            geom, col = [], 0
            for w in widths:
                geom.append(put(full[:, col:col + w] if w > 1
                                else full[:, col]))
                col += w
            mat = Materials(*(put(full[:, col + k]) for k in range(3)))
            target_id = put(full[:, col + 3].astype(np.int32))
            return (*geom, mat, target_id, put(active))

        scene = Scene(spheres=Spheres(*table(SPHERE, ns)),
                      aabbs=Aabbs(*table(AABB, na)),
                      obbs=Obbs(*table(OBB, no)),
                      target_positions=put(
                          self._job_array(3, nt, 3).reshape(nt, 3)))
        self._cached_scene = scene
        self._snapshot_key = key
        return scene
