"""Differentiable loudness model and the gradient workload (BASELINE config 4).

The PyTorch counterpart of ``audio_raytracer_tpu/models/differentiable.py``.
The reference forward is full of discrete events (closest-hit argmin,
visibility booleans, ray-death thresholds). This model keeps the same
trajectories (hard closest hit and visibility) and weights the
accumulation by a continuous per-ray energy, so gradients reach every
material parameter:

- energy: e_0 = 1, e_{k+1} = e_k x (1 - absorption_hit_k), the smooth
  counterpart of the reference's life drain
  (AudioRaytracerJobBatched.cs:531);
- muffle loudness[t] = sum_{r,k} e_k x visible(r, k, t) / (R H);
- reverb energy = sum_{r,k} e_k x echo_dist(r, k) / (R H max_reverb);
- permeation loudness[t] = sum over first-hitting rays of
  (strength - chord_loss(r, t) / R) / R x effectiveness, linear in
  density.

Gradients to the listener and source poses ride hit distances, echo
distances and chord lengths. Discrete selections are constants of the
trajectory: occlusion booleans carry no gradient, life drains by the hit
distance and the absorption with their gradients cut, and permeation
starts from the bounce-0 hit.

``backend`` is "kernel" (``KernelBackend(differentiable=True)``: the CUDA
kernels B1-B3 forward, B4 or B5 backward; their plain versions for a
scene on the CPU) or "dense" (plain [rays, prims] grids under autograd),
or an engine object with the backend protocol. Entry points run on
``device="cuda"`` unless the caller asks for ``device="cpu"``.

Ray-axis sharding (the JAX ``axis_name`` / ``pvary_axes`` arguments, and
``total_ray_count`` for a shard's share of the rays) is left to the
distribution slice of the port.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from audio_raytracer_tpu_torch.ops import intersect
from audio_raytracer_tpu_torch.ops import reverb as reverb_op
from audio_raytracer_tpu_torch.models.raytracer import make_backend
from audio_raytracer_tpu_torch.ops.trace import _secondary_occlusion
from audio_raytracer_tpu_torch.types import (
    Materials,
    Scene,
    TraceConfig,
    check_device,
    resolve_device,
)

Tensor = torch.Tensor

_MATERIAL_FIELDS = ("absorption", "density", "echo")


@dataclasses.dataclass(frozen=True)
class Loudness:
    """Differentiable outputs of the acoustic field model: muffle [T]
    energy-weighted visibility fraction, permeation [T] mean transmitted
    power, reverb_energy [], and reverb_ir [n_bins] the energy-weighted
    impulse response (when cfg.num_reverb_bins > 0)."""

    muffle: Tensor
    permeation: Tensor
    reverb_energy: Tensor
    reverb_ir: Tensor | None = None


@dataclasses.dataclass(frozen=True)
class SceneParams:
    """The learnable materials, per primitive type
    (AudioMaterialProperties.cs lifted out of the scene)."""

    sphere: Materials
    aabb: Materials
    obb: Materials

    @staticmethod
    def from_scene(scene: Scene) -> "SceneParams":
        """Detached copies of the scene's materials (the scene itself is
        left as it is when the parameters train)."""
        def copy(m):
            return Materials(*(getattr(m, f).detach().clone()
                               for f in _MATERIAL_FIELDS))

        return SceneParams(sphere=copy(scene.spheres.material),
                           aabb=copy(scene.aabbs.material),
                           obb=copy(scene.obbs.material))

    def into_scene(self, scene: Scene) -> Scene:
        return dataclasses.replace(
            scene,
            spheres=dataclasses.replace(scene.spheres, material=self.sphere),
            aabbs=dataclasses.replace(scene.aabbs, material=self.aabb),
            obbs=dataclasses.replace(scene.obbs, material=self.obb))

    def leaves(self) -> list[Tensor]:
        """The 9 tensors, sphere / aabb / obb x absorption / density /
        echo, in the order of the JAX pytree's leaves."""
        return [getattr(m, f) for m in (self.sphere, self.aabb, self.obb)
                for f in _MATERIAL_FIELDS]


@dataclasses.dataclass(frozen=True)
class PoseParams:
    """The learnable pose: listener origin [3] and audio-source
    positions [T, 3]."""

    origin: Tensor
    target_positions: Tensor

    def leaves(self) -> list[Tensor]:
        return [self.origin, self.target_positions]


def adam(lr: float = 1e-2):
    """Optimizer factory with optax.adam's defaults: ``adam(lr)(tensors)``
    is ``torch.optim.Adam(tensors, lr, betas=(0.9, 0.999), eps=1e-8)``."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8)


def loudness_map(origin: Tensor, directions: Tensor, scene: Scene,
                 cfg: TraceConfig, backend="kernel",
                 device="cuda") -> Loudness:
    """The differentiable loudness field of the listener at ``origin`` [3]
    tracing ``directions`` [R, 3]. The kernel backend's chord adjoint is
    B4 alone where no pose needs a gradient, B5 otherwise."""
    dev = resolve_device(device)
    check_device(dev, origin=origin, directions=directions,
                 scene=scene.target_positions)
    engine = make_backend(scene, backend, differentiable=True)
    R = directions.shape[0]
    T = scene.num_targets
    H = cfg.max_hits_per_ray
    eps = cfg.epsilon
    block_skip = getattr(engine, "supports_block_skip", False)

    o0 = origin.to(directions.dtype).expand(R, 3)
    o, d = o0, directions
    life = torch.full((R,), cfg.max_ray_life, dtype=directions.dtype,
                      device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    energy = torch.ones((R,), dtype=directions.dtype, device=dev)
    t_first = None
    echo_v, echo_w, muffle_c = [], [], []
    for step in range(H):
        hit, t, attrs = engine.closest_hit(
            o, d, alive=alive if block_skip else None)
        if step == 0:
            t_first = t
        live_hit = alive & hit
        t_safe = torch.where(live_hit, t, 0.0)
        p = o + d * t_safe[..., None]
        life = life - t_safe.detach()
        offset_point = p - d * eps

        # Echo and muffle visibility in one fused occlusion call; the
        # booleans carry no gradient, the energy and distances do.
        dist_to_origin, echo_visible, muffle_visible = _secondary_occlusion(
            engine, scene, cfg, offset_point, p, origin, live_hit)
        seen = live_hit & echo_visible
        # Echo value and its energy weight kept apart, so the IR bins
        # value by weight.
        echo_v.append(torch.where(seen, dist_to_origin * attrs["echo"], 0.0))
        echo_w.append(torch.where(seen, energy, 0.0))
        muffle_c.append(torch.where(muffle_visible & live_hit[..., None],
                                    energy[..., None], 0.0))

        can_continue = live_hit & (step + 1 < H) & (life > 0.0)
        normal = intersect.reflection_normal(
            p, attrs["kind"], attrs["center"], attrs["half_extents"],
            attrs["inv_rot"])
        d_new = intersect.reflect(d, normal)
        o_new = p + d_new * eps
        life_new = life - cfg.max_ray_life * attrs["absorption"].detach()
        alive = can_continue & (life_new >= 0.0)
        energy = torch.where(live_hit, energy * (1.0 - attrs["absorption"]),
                             energy)
        cc = can_continue[..., None]
        o = torch.where(cc, o_new, p)
        d = torch.where(cc, d_new, d)
        life = torch.where(can_continue, life_new, life)

    # Permeation from the bounce-0 hit (the winner recompute gives it
    # pose gradients), per-ray mean: no overwrite quirk here.
    hit_first = torch.isfinite(t_first)
    t_sf = torch.where(hit_first, t_first, 0.0)
    off = (o0 + directions * t_sf[..., None]) - directions * eps
    if T > 0:
        dirs = []
        for ti in range(T):
            to_t = scene.target_positions[ti] - off
            dirs.append(to_t / intersect.safe_norm(to_t)[..., None])
        losses = engine.multi_permeation_loss(off, dirs, tuple(range(T)))
        vals = cfg.permeation_strength_per_ray - losses / R
        perm_sum = torch.where(hit_first[..., None], vals, 0.0).sum(dim=0)
    else:
        perm_sum = directions.new_zeros((0,))

    echo_v, echo_w = torch.stack(echo_v), torch.stack(echo_w)  # [H, R]
    muffle_sum = torch.stack(muffle_c).sum(dim=(0, 1))  # [T]
    echo_sum = torch.sum(echo_v * echo_w)
    reverb_ir = None
    if cfg.num_reverb_bins > 0:
        # Energy-weighted IR, normalized per ray (invariant to the ray
        # budget).
        reverb_ir = reverb_op.impulse_response(echo_v, cfg,
                                               weights=echo_w) / R
    return Loudness(
        muffle=muffle_sum / (R * H),
        permeation=perm_sum / R * cfg.permeation_effectiveness,
        reverb_energy=echo_sum / (R * H * cfg.max_reverb_distance),
        reverb_ir=reverb_ir)


# ---------------------------------------------------------------------------
# Training: optimize materials to match a target loudness map
# ---------------------------------------------------------------------------


def _loudness_mse(pred: Loudness, target: Loudness) -> Tensor:
    loss = (torch.mean((pred.muffle - target.muffle) ** 2)
            + torch.mean((pred.permeation - target.permeation) ** 2)
            + (pred.reverb_energy - target.reverb_energy) ** 2)
    if pred.reverb_ir is not None and target.reverb_ir is not None:
        loss = loss + torch.mean((pred.reverb_ir - target.reverb_ir) ** 2)
    return loss


def loudness_loss(params: SceneParams, scene: Scene, origin, directions,
                  cfg: TraceConfig, target: Loudness, backend="kernel",
                  device="cuda") -> Tensor:
    """MSE between the loudness map of ``scene`` with ``params``'
    materials and ``target``."""
    pred = loudness_map(origin, directions, params.into_scene(scene), cfg,
                        backend=backend, device=device)
    return _loudness_mse(pred, target)


def _trainable(leaves):
    for x in leaves:
        x.requires_grad_(True)
    return leaves


def _backward(loss: Tensor, leaves) -> None:
    """loss.backward(), then a zero gradient for every leaf it did not
    reach, so Adam steps every tensor each step as optax does."""
    loss.backward()
    for x in leaves:
        if x.grad is None:
            x.grad = torch.zeros_like(x)


def make_train_step(cfg: TraceConfig, optimizer=None, backend="kernel",
                    device="cuda"):
    """Materials training. Returns ``(step, init)``:
    ``opt = init(params)`` marks the 9 material tensors trainable and
    builds the optimizer over them (``optimizer``: a factory taking the
    tensors, default ``adam(1e-2)``); ``step(params, opt, scene, origin,
    directions, target) -> (params, opt, loss)`` takes one step, updating
    the tensors in place. The kernel backend's chord adjoint is B4."""
    dev = resolve_device(device)
    make_opt = optimizer or adam()

    def init(params: SceneParams):
        return make_opt(_trainable(params.leaves()))

    def step(params, opt, scene, origin, directions, target):
        opt.zero_grad(set_to_none=False)
        loss = loudness_loss(params, scene, origin, directions, cfg, target,
                             backend=backend, device=dev)
        _backward(loss, params.leaves())
        opt.step()
        return params, opt, loss.detach()

    return step, init


# ---------------------------------------------------------------------------
# Pose recovery: optimize source / listener positions from a recording
# ---------------------------------------------------------------------------


def pose_loss(pose: PoseParams, scene: Scene, directions, cfg: TraceConfig,
              target: Loudness, backend="kernel",
              device="cuda") -> Tensor:
    """MSE between the loudness map traced at ``pose`` and ``target``;
    the materials stay those of ``scene``."""
    scene_p = dataclasses.replace(scene,
                                  target_positions=pose.target_positions)
    pred = loudness_map(pose.origin, directions, scene_p, cfg,
                        backend=backend, device=device)
    return _loudness_mse(pred, target)


def make_pose_recovery_step(cfg: TraceConfig, optimizer=None,
                            backend="kernel",
                            recover: tuple = ("origin", "targets"),
                            device="cuda"):
    """Pose recovery. Returns ``(step, init)``: ``opt = init(pose)``;
    ``step(pose, opt, scene, directions, target) -> (pose, opt, loss)``.
    ``recover`` names the leaves that move ("origin", "targets"); the
    others get zero gradients before the optimizer, so their optimizer
    moments stay zero and they keep their values. The kernel backend
    runs the full adjoint (B5)."""
    dev = resolve_device(device)
    make_opt = optimizer or adam()

    def init(pose: PoseParams):
        return make_opt(_trainable(pose.leaves()))

    def step(pose, opt, scene, directions, target):
        opt.zero_grad(set_to_none=False)
        loss = pose_loss(pose, scene, directions, cfg, target,
                         backend=backend, device=dev)
        _backward(loss, pose.leaves())
        for name, x in (("origin", pose.origin),
                        ("targets", pose.target_positions)):
            if name not in recover:
                x.grad.zero_()
        opt.step()
        return pose, opt, loss.detach()

    return step, init


def stack_loudness(recordings: list) -> Loudness:
    """Per-listener Loudness maps stacked on a leading axis (the
    recordings make_source_recovery_step takes)."""
    def stack(field):
        xs = [getattr(r, field) for r in recordings]
        return None if xs[0] is None else torch.stack(xs)

    return Loudness(*(stack(f.name) for f in dataclasses.fields(Loudness)))


def make_source_recovery_step(cfg: TraceConfig, num_listeners: int,
                              optimizer=None, backend="kernel",
                              device="cuda"):
    """Source localization by triangulation: recover the audio-target
    positions from loudness recordings taken at ``num_listeners`` known
    listener positions (one recording's scalars cannot pin a 3-D
    position; several listeners make the problem overdetermined).

    Returns ``(step, init)``: ``opt = init(target_positions)``;
    ``step(target_positions, opt, scene, origins, directions,
    recordings) -> (target_positions, opt, loss)`` with ``origins``
    [L, 3] and ``recordings`` a Loudness with leading axis L
    (``stack_loudness``)."""
    dev = resolve_device(device)
    make_opt = optimizer or adam()

    def init(target_positions: Tensor):
        return make_opt(_trainable([target_positions]))

    def step(target_positions, opt, scene, origins, directions, recordings):
        opt.zero_grad(set_to_none=False)
        scene_p = dataclasses.replace(scene,
                                      target_positions=target_positions)
        engine = make_backend(scene_p, backend, differentiable=True)
        total = 0.0
        for li in range(num_listeners):
            rec = Loudness(*(None if getattr(recordings, f.name) is None
                             else getattr(recordings, f.name)[li]
                             for f in dataclasses.fields(Loudness)))
            pred = loudness_map(origins[li], directions, scene_p, cfg,
                                backend=engine, device=dev)
            total = total + _loudness_mse(pred, rec)
        loss = total / num_listeners
        _backward(loss, [target_positions])
        opt.step()
        return target_positions, opt, loss.detach()

    return step, init
