"""Quaternion math (xyzw layout, matching Unity.Mathematics).

The PyTorch counterpart of ``audio_raytracer_tpu/ops/quaternion.py``:
plain functions on tensors, broadcasting over leading dims.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector(s) v [..., 3] by unit quaternion(s) q [..., 4]:
    v' = v + w t + cross(q.xyz, t) with t = 2 cross(q.xyz, v)
    (Unity's ``math.mul(quaternion, float3)``)."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(xyz, v)
    return v + w * t + _cross(xyz, t)


def to_matrix(q: Tensor) -> Tensor:
    """Rotation matrix M [..., 3, 3] with M @ v == rotate(q, v)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz),
                        2.0 * (xz + wy)], dim=-1)
    row1 = torch.stack([2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz),
                        2.0 * (yz - wx)], dim=-1)
    row2 = torch.stack([2.0 * (xz - wy), 2.0 * (yz + wx),
                        1.0 - 2.0 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def inverse(q: Tensor) -> Tensor:
    """Inverse of a unit quaternion: its conjugate. No host data: a
    captured frame (models/frame_graph.py) calls it."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def multiply(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product a*b (xyzw), broadcasting over leading dims."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def from_axis_angle(axis: Tensor, angle: Tensor) -> Tensor:
    """Unit quaternion (xyzw) for a rotation of ``angle`` radians about
    ``axis``."""
    axis = axis.to(torch.float32)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = angle.to(torch.float32)[..., None] * 0.5
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def from_euler_zxy(euler_rad) -> Tensor:
    """Unity-convention euler angles (ZXY intrinsic, radians, xyz
    component order) as a quaternion: Unity's ``quaternion.Euler``
    default rotation order, used when authoring OBB rotation offsets."""
    e = torch.as_tensor(euler_rad, dtype=torch.float32) * 0.5
    sx, cx = torch.sin(e[..., 0]), torch.cos(e[..., 0])
    sy, cy = torch.sin(e[..., 1]), torch.cos(e[..., 1])
    sz, cz = torch.sin(e[..., 2]), torch.cos(e[..., 2])
    # ZXY order: q = qy * qx * qz
    return torch.stack(
        [
            sx * cy * cz + sy * sz * cx,
            sy * cx * cz - sx * sz * cy,
            sz * cx * cy - sx * sy * cz,
            cx * cy * cz + sy * sz * sx,
        ],
        dim=-1,
    )


def normalize(q: Tensor) -> Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def pack_xyz(q: Tensor) -> Tensor:
    """A unit quaternion stored as xyz only [..., 3], w reconstructed on
    unpack: the reference's halfQuaternion
    (DataTypes/halfQuaternion.cs:7-63). w = sqrt(1 - |xyz|^2) once its
    sign is made positive, so where w < 0 the equivalent -q is stored."""
    sign = torch.where(q[..., 3:4] < 0.0, -1.0, 1.0)
    return q[..., :3] * sign


def unpack_xyz(xyz: Tensor) -> Tensor:
    """Inverse of ``pack_xyz``: [..., 3] -> [..., 4] with
    w = sqrt(1 - |xyz|^2)."""
    w2 = torch.clamp(1.0 - torch.sum(xyz * xyz, dim=-1, keepdim=True),
                     min=0.0)
    return torch.cat([xyz, torch.sqrt(w2)], dim=-1)
