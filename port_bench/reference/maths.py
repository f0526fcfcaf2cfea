"""Quaternion / rotation / spatial-vector algebra (MuJoCo conventions).

Conventions:
  - quaternions are (w, x, y, z), normalized;
  - spatial (6D) motion/force vectors are ordered [angular(3); linear(3)];
  - rotation matrices are world_from_body.

Every function works on the trailing axis (or trailing two axes for
matrices) and broadcasts over any leading batch axes.
"""

from __future__ import annotations

import torch

_CONSTANTS = {}


def const(values, like: torch.Tensor) -> torch.Tensor:
    """A constant tensor of nested tuples on ``like``'s device and dtype,
    made once: a tensor built from Python values on every call would copy
    it to the device each time, and that copy waits for the device."""
    key = (values, like.device, like.dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, device=like.device, dtype=like.dtype)
    return t


def const_index(values: tuple, device) -> torch.Tensor:
    """A constant index tensor, made once a device (see ``const``)."""
    key = (values, "index", device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=torch.long, device=device)
    return t


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hamilton product of two (w,x,y,z) quaternions."""
    u0, u1, u2, u3 = u.unbind(-1)
    v0, v1, v2, v3 = v.unbind(-1)
    return torch.stack(
        [
            u0 * v0 - u1 * v1 - u2 * v2 - u3 * v3,
            u0 * v1 + u1 * v0 + u2 * v3 - u3 * v2,
            u0 * v2 - u1 * v3 + u2 * v0 + u3 * v1,
            u0 * v3 + u1 * v2 - u2 * v1 + u3 * v0,
        ],
        dim=-1,
    )


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    return q * const((1.0, -1.0, -1.0, -1.0), q)


def normalize(v: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / norm.clamp_min(1e-15)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotate(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate a 3-vector by a quaternion (world = q * body)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    uuv = cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(w,x,y,z) quaternion -> 3x3 rotation matrix."""
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis + angle -> quaternion."""
    s, c = torch.sin(angle * 0.5), torch.cos(angle * 0.5)
    return torch.cat([c[..., None], axis * s[..., None]], dim=-1)


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor, dt) -> torch.Tensor:
    """Integrate quaternion by body-frame angular velocity over dt.

    Matches mju_quatIntegrate: q' = q * exp(omega_local * dt / 2), normalized.
    """
    angle = torch.linalg.vector_norm(omega_local, dim=-1)
    # guard zero-angle (axis unused when angle==0 since sin(0)=0)
    axis = omega_local / angle.clamp_min(1e-15)[..., None]
    dq = axis_angle_to_quat(axis, angle * dt)
    return normalize(quat_mul(q, dq))


def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> intrinsic z-y-x Euler (returned as [roll, pitch, yaw])."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial cross product of motion vectors: v x m (mju_crossMotion)."""
    ang = cross(v[..., :3], m[..., :3])
    lin = cross(v[..., :3], m[..., 3:]) + cross(v[..., 3:], m[..., :3])
    return torch.cat([ang, lin], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial cross product motion x* force (mju_crossForce)."""
    ang = cross(v[..., :3], f[..., :3]) + cross(v[..., 3:], f[..., 3:])
    lin = cross(v[..., :3], f[..., 3:])
    return torch.cat([ang, lin], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> skew-symmetric matrix such that skew(v) @ u = v x u."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], -1),
            torch.stack([z, o, -x], -1),
            torch.stack([-y, x, o], -1),
        ],
        dim=-2,
    )


def spatial_inertia(
    mass: torch.Tensor, inertia_mat: torch.Tensor, offset: torch.Tensor
) -> torch.Tensor:
    """6x6 spatial inertia of a body about a reference point.

    Args:
      mass: (...,) body mass.
      inertia_mat: (..., 3, 3) rotational inertia about the body CoM,
        world-aligned.
      offset: (..., 3) CoM position minus reference point.

    Returns [ang;lin]-ordered 6x6:
        [[I + m c^ c^T,  m c^],
         [m c^T,         m 1 ]]
    with c^ = skew(offset): MuJoCo's cinert in matrix form.
    """
    cx = skew(offset)
    m_cx = mass[..., None, None] * cx
    top_left = inertia_mat + m_cx @ cx.transpose(-1, -2)
    eye = torch.eye(3, dtype=cx.dtype, device=cx.device).expand(cx.shape)
    bottom_right = mass[..., None, None] * eye
    top = torch.cat([top_left, m_cx], dim=-1)
    bottom = torch.cat([m_cx.transpose(-1, -2), bottom_right], dim=-1)
    return torch.cat([top, bottom], dim=-2)
