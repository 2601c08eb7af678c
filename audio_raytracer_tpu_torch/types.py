"""Core data model: scenes as tensors, configs as static dataclasses.

The PyTorch counterpart of ``audio_raytracer_tpu/types.py``. Field names,
defaults and conventions are the same:

- float32 is the canonical precision.
- Quaternions are xyzw. OBBs store the INVERSE rotation, as the
  reference bakes it (Audio/Colliders/AudioOBBCollider.cs:59).
- ``target_id`` is int32, -1 = "not owned by any audio target".
- ``active`` masks padding primitives.

Containers are plain dataclasses of tensors; every tensor of one scene
lives on one device, chosen explicitly by the caller.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist.

    Entry points default to ``"cuda"`` and never fall back to the CPU on
    their own: the caller asks for ``device="cpu"`` explicitly.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev


def check_device(dev: torch.device, **tensors) -> None:
    """Raise unless every named tensor lies on a device of ``dev``'s
    type."""
    for name, x in tensors.items():
        if x.device.type != dev.type:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")


def to_tensor(x, dtype, device):
    if not isinstance(x, Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype)


def _rows(x) -> int:
    """Number of 3-vectors in an array-like of shape [..., 3]."""
    return int(np.prod(np.shape(x))) // 3


def _f32(x, n, width, device):
    t = to_tensor(x, torch.float32, device)
    return t.reshape(n, width) if width else t.reshape(n)


def _ids(x, n, device):
    if x is None:
        return torch.full((n,), -1, dtype=torch.int32, device=device)
    return to_tensor(x, torch.int32, device).reshape(n)


def _mask(x, n, device):
    if x is None:
        return torch.ones((n,), dtype=torch.bool, device=device)
    return to_tensor(x, torch.bool, device).reshape(n)


# ---------------------------------------------------------------------------
# Materials and primitive sets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Materials:
    """Per-primitive audio material properties (struct of arrays):
    absorption [N] in [0, 1], density [N] >= 0, echo [N] >= 0
    (DataTypes/Collider Structs/AudioMaterialProperties.cs)."""

    absorption: Tensor
    density: Tensor
    echo: Tensor

    @staticmethod
    def default(n: int, device="cpu") -> "Materials":
        return Materials(
            absorption=torch.zeros((n,), device=device),
            density=torch.ones((n,), device=device),
            echo=torch.ones((n,), device=device),
        )

    @property
    def count(self) -> int:
        return self.absorption.shape[-1]


@dataclasses.dataclass(frozen=True)
class Spheres:
    """ColliderSphereStruct.cs: center [N, 3], radius [N]."""

    center: Tensor
    radius: Tensor
    material: Materials
    target_id: Tensor
    active: Tensor

    @staticmethod
    def empty(device="cpu") -> "Spheres":
        return Spheres.build(np.zeros((0, 3)), np.zeros((0,)), device=device)

    @staticmethod
    def build(center, radius, material=None, target_id=None, active=None,
              device="cpu") -> "Spheres":
        n = _rows(center)
        return Spheres(
            _f32(center, n, 3, device), _f32(radius, n, 0, device),
            material if material is not None
            else Materials.default(n, device),
            _ids(target_id, n, device), _mask(active, n, device))

    @property
    def count(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass(frozen=True)
class Aabbs:
    """ColliderAABBStruct.cs: center [N, 3], half_extents [N, 3]."""

    center: Tensor
    half_extents: Tensor
    material: Materials
    target_id: Tensor
    active: Tensor

    @staticmethod
    def empty(device="cpu") -> "Aabbs":
        return Aabbs.build(np.zeros((0, 3)), np.zeros((0, 3)), device=device)

    @staticmethod
    def build(center, half_extents, material=None, target_id=None,
              active=None, device="cpu") -> "Aabbs":
        n = _rows(center)
        return Aabbs(
            _f32(center, n, 3, device), _f32(half_extents, n, 3, device),
            material if material is not None
            else Materials.default(n, device),
            _ids(target_id, n, device), _mask(active, n, device))

    @property
    def count(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass(frozen=True)
class Obbs:
    """ColliderOBBStruct.cs: ``inv_rot`` [N, 4] is the inverse of the box
    orientation (xyzw), pre-inverted as the reference stores it."""

    center: Tensor
    half_extents: Tensor
    inv_rot: Tensor
    material: Materials
    target_id: Tensor
    active: Tensor

    @staticmethod
    def empty(device="cpu") -> "Obbs":
        return Obbs.build(np.zeros((0, 3)), np.zeros((0, 3)),
                          np.zeros((0, 4)), device=device)

    @staticmethod
    def build(center, half_extents, inv_rot, material=None, target_id=None,
              active=None, device="cpu") -> "Obbs":
        n = _rows(center)
        return Obbs(
            _f32(center, n, 3, device), _f32(half_extents, n, 3, device),
            _f32(inv_rot, n, 4, device),
            material if material is not None
            else Materials.default(n, device),
            _ids(target_id, n, device), _mask(active, n, device))

    @property
    def count(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass(frozen=True)
class Scene:
    """Primitives + audio target positions [T, 3]."""

    spheres: Spheres
    aabbs: Aabbs
    obbs: Obbs
    target_positions: Tensor

    @property
    def num_targets(self) -> int:
        return self.target_positions.shape[0]

    @property
    def num_primitives(self) -> int:
        return self.spheres.count + self.aabbs.count + self.obbs.count

    @property
    def device(self) -> torch.device:
        return self.target_positions.device

    @staticmethod
    def build(spheres=None, aabbs=None, obbs=None, target_positions=None,
              device="cpu") -> "Scene":
        tp = np.zeros((0, 3)) if target_positions is None \
            else target_positions
        n_t = _rows(tp)
        return Scene(
            spheres if spheres is not None else Spheres.empty(device),
            aabbs if aabbs is not None else Aabbs.empty(device),
            obbs if obbs is not None else Obbs.empty(device),
            _f32(tp, n_t, 3, device))

    def replace(self, **kwargs) -> "Scene":
        return dataclasses.replace(self, **kwargs)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static trace configuration; the same fields and defaults as the
    JAX package's (Audio/AudioRayTracer.cs:9-35, Player.prefab).

    ``num_accum_batches`` is the reference's thread-batch count: muffle
    and permeation accumulators are kept per batch, and the permeation
    overwrite quirk (ops/permeation.py) depends on it.

    Not yet ported: ray compaction (``compact_rays``) and the bfloat16
    compute tier (``compute_dtype="bfloat16"``) raise NotImplementedError.
    ``compact_unordered`` only acts together with ``compact_rays``.
    """

    ray_count: int = 500
    max_bounces: int = 4
    max_ray_life: float = 125.0
    max_muffle_hit_distance: float = 250.0
    muffle_effectiveness: float = 1.0
    permeation_effectiveness: float = 0.5
    permeation_strength_per_ray: float = 1.0
    max_reverb_distance: float = 35.0
    num_accum_batches: int = 1
    # The reference's EPSILON hit-point offset
    # (AudioRaytracerJobBatched.cs:57).
    epsilon: float = 1e-4
    compute_dtype: str = "float32"
    # Reverb impulse response: number of arrival-time bins (0 = off) and
    # the echo-distance window they span.
    num_reverb_bins: int = 0
    ir_max_distance: float = 125.0
    compact_rays: bool = False
    compact_unordered: bool = False

    def __post_init__(self):
        if self.compact_rays:
            raise NotImplementedError(
                "compact_rays is not ported to the PyTorch package yet")
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={self.compute_dtype!r}: only float32 is "
                "ported to the PyTorch package")

    @property
    def max_hits_per_ray(self) -> int:
        # MaxHitsPerRay => maxBounces + 1 (AudioRayTracer.cs:16).
        return self.max_bounces + 1


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceResult:
    """Raw trace outputs before the reduce.

    ``echo_distances`` [R, H] distance x material.Echo per (ray, hit slot)
    when the echo ray back to the listener is clear, else 0;
    ``muffle_hits`` [B, T] int32 per-accum-batch visible-ray counts;
    ``permeation`` [B, T] permeation power remains; ``first_hit_t`` [R]
    primary-ray first-hit distance (+inf = miss); ``reverb_ir`` [n_bins];
    ``hit_points`` [R, H, 3] and ``hit_counts`` [R] with collect_debug.
    """

    echo_distances: Tensor
    muffle_hits: Tensor
    permeation: Tensor
    first_hit_t: Tensor | None = None
    reverb_ir: Tensor | None = None
    hit_points: Tensor | None = None
    hit_counts: Tensor | None = None


@dataclasses.dataclass(frozen=True)
class TargetSettings:
    """Per-target settings in [0, 1] (DataTypes/AudioTargetRTSettings.cs):
    muffle [T], listener-global reverb_strength / reverb_volume [],
    perceived_position [T, 3]."""

    muffle: Tensor
    reverb_strength: Tensor
    reverb_volume: Tensor
    perceived_position: Tensor
