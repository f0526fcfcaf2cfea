"""Narrowphase collision with a static candidate-pair table.

Broadphase is resolved at model-load time (contype/conaffinity + kinematic
filters, see model.py:_candidate_pairs); at runtime every candidate pair is
evaluated unconditionally into its fixed contact slots. Separated pairs keep
their positive distance and are masked downstream. No dynamic shapes.

Implemented pair type: plane-sphere (the Go2 flat scene: four feet on the
ground plane). The other pair types of the model suite raise
NotImplementedError naming the pair.
"""

from __future__ import annotations

import torch

from dial_mpc_tpu_torch.physics import maths
from dial_mpc_tpu_torch.physics.model import BOX, CAPSULE, PLANE, SPHERE, Contact, Data, Model

_GEOM_NAMES = {PLANE: "plane", SPHERE: "sphere", CAPSULE: "capsule", BOX: "box"}


def make_frame(n: torch.Tensor) -> torch.Tensor:
    """Orthonormal contact frame rows [normal; tangent1; tangent2].

    Matches mju_makeFrame: the second tangent is normalize(cross(n, ref))
    with ref = y-hat when |n_y| < 0.5 else z-hat, and tangent1 =
    cross(tangent2, n). Facet directions of the pyramidal cone depend on
    this, so it must match exactly. n: (..., 3) -> (..., 3, 3).
    """
    y = n.new_tensor([0.0, 1.0, 0.0])
    z = n.new_tensor([0.0, 0.0, 1.0])
    ref = torch.where((n[..., 1:2].abs() < 0.5), y, z)
    t2 = maths.cross(n, ref)
    t2 = t2 / torch.linalg.vector_norm(t2, dim=-1, keepdim=True).clamp_min(1e-15)
    t1 = maths.cross(t2, n)
    return torch.stack([n, t1, t2], dim=-2)


def _plane_sphere(pp, pn, c, r):
    """Plane (point pp, normal pn) vs sphere (centre c, radius r).

    (B, 3) inputs -> dist (B, 1), pos (B, 1, 3), frame (B, 1, 3, 3).
    """
    dist = (pn * (c - pp)).sum(-1) - r
    pos = c - pn * (r + 0.5 * dist)[..., None]
    return dist[:, None], pos[:, None], make_frame(pn)[:, None]


def collide(m: Model, d: Data) -> Data:
    """Evaluate every candidate pair into its static contact slots."""
    B = d.qpos.shape[0]
    static = dict(
        geom=m.con_geom,
        includemargin=m.con_includemargin,
        friction=m.con_friction,
        solref=m.con_solref,
        solimp=m.con_solimp,
        dim=m.con_dim,
    )
    if m.ncon == 0:
        contact = Contact(
            dist=d.qpos.new_zeros(B, 0),
            pos=d.qpos.new_zeros(B, 0, 3),
            frame=d.qpos.new_zeros(B, 0, 3, 3),
            **static,
        )
        return d.replace(contact=contact)

    dist_parts, pos_parts, frame_parts = [], [], []
    gx, gm, gs = d.geom_xpos, d.geom_xmat, m.geom_size

    for (g1, g2, t1, t2, condim, conadr, conmax) in m.pair_table:
        key = (t1, t2)
        if key == (PLANE, SPHERE):
            out = _plane_sphere(gx[:, g1], gm[:, g1, :, 2], gx[:, g2], gs[g2, 0])
        else:
            raise NotImplementedError(
                f"collider {_GEOM_NAMES.get(t1, t1)}-{_GEOM_NAMES.get(t2, t2)} is not ported yet"
            )
        dist, pos, frame = out
        assert dist.shape[1] == conmax, (key, dist.shape, conmax)
        dist_parts.append(dist)
        pos_parts.append(pos)
        frame_parts.append(frame)

    contact = Contact(
        dist=torch.cat(dist_parts, dim=1),
        pos=torch.cat(pos_parts, dim=1),
        frame=torch.cat(frame_parts, dim=1),
        **static,
    )
    return d.replace(contact=contact)
