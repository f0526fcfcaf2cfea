"""Narrowphase collision with a static candidate-pair table.

Broadphase is resolved at model-load time (contype/conaffinity + kinematic
filters, see model.py:_candidate_pairs); at runtime every candidate pair is
evaluated unconditionally into its fixed contact slots. Separated pairs keep
their positive distance and are masked downstream. No dynamic shapes.

Implemented pair types, all that appear in the model suite:
plane-{sphere,capsule,box}, sphere-{sphere,capsule,box}, capsule-{capsule,box}
and box-box. Capsule-box and box-box are DIAL-MPC's approximate manifolds
(end spheres; the deepest corners of both boxes), not MuJoCo's, matched slot
for slot, ties included: where DIAL-MPC ranks candidates with a top-k (the
lower index first among equals), a stable sort ranks them here.
Capsule-capsule is DIAL-MPC's clamped segment-segment solve, with its branch
for parallel axes (s = 0 where 1 - (a1.a2)^2 <= 1e-12). Any other pair type
raises NotImplementedError naming the pair.
"""

from __future__ import annotations

import torch

from . import maths
from .model import BOX, CAPSULE, PLANE, SPHERE, Contact, Data, Model

_GEOM_NAMES = {PLANE: "plane", SPHERE: "sphere", CAPSULE: "capsule", BOX: "box"}


def make_frame(n: torch.Tensor) -> torch.Tensor:
    """Orthonormal contact frame rows [normal; tangent1; tangent2].

    Matches mju_makeFrame: the second tangent is normalize(cross(n, ref))
    with ref = y-hat when |n_y| < 0.5 else z-hat, and tangent1 =
    cross(tangent2, n). Facet directions of the pyramidal cone depend on
    this, so it must match exactly. n: (..., 3) -> (..., 3, 3).
    """
    y = maths.const((0.0, 1.0, 0.0), n)
    z = maths.const((0.0, 0.0, 1.0), n)
    ref = torch.where((n[..., 1:2].abs() < 0.5), y, z)
    t2 = maths.cross(n, ref)
    t2 = t2 / torch.linalg.vector_norm(t2, dim=-1, keepdim=True).clamp_min(1e-15)
    t1 = maths.cross(t2, n)
    return torch.stack([n, t1, t2], dim=-2)


def axis_frame(n: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Contact frame with tangent1 = axis projected onto the plane of n.

    mjc_PlaneCapsule's frame: t1 = normalize(axis - (axis.n) n),
    t2 = cross(n, t1); make_frame(n) where the axis is about parallel to n.
    n, axis: (..., 3) -> (..., 3, 3).
    """
    t1 = axis - (axis * n).sum(-1, keepdim=True) * n
    norm = torch.linalg.vector_norm(t1, dim=-1, keepdim=True)
    t1 = t1 / norm.clamp_min(1e-15)
    t2 = maths.cross(n, t1)
    return torch.where((norm > 1e-10)[..., None], torch.stack([n, t1, t2], dim=-2), make_frame(n))


def _plane_sphere(pp, pn, c, r):
    """Plane (point pp, normal pn) vs sphere (centre c, radius r).

    (B, 3) inputs -> dist (B, 1), pos (B, 1, 3), frame (B, 1, 3, 3).
    """
    dist = (pn * (c - pp)).sum(-1) - r
    pos = c - pn * (r + 0.5 * dist)[..., None]
    return dist[:, None], pos[:, None], make_frame(pn)[:, None]


def _sphere_sphere(c1, r1, c2, r2):
    """Sphere (c1, r1) vs sphere (c2, r2); the normal points from 1 to 2.

    (B, 3) inputs -> dist (B, 1), pos (B, 1, 3), frame (B, 1, 3, 3).
    """
    dvec = c2 - c1
    dist_c = torch.linalg.vector_norm(dvec, dim=-1)
    n = dvec / dist_c.clamp_min(1e-15)[..., None]
    dist = dist_c - (r1 + r2)
    pos = c1 + n * (r1 + 0.5 * dist)[..., None]
    return dist[:, None], pos[:, None], make_frame(n)[:, None]


def _closest_on_segment(p, c, axis, hl):
    """Closest point to p on the segment c + axis * t, |t| <= hl."""
    t = ((p - c) * axis).sum(-1, keepdim=True).clamp(-hl, hl)
    return c + axis * t


def _sphere_capsule(c1, r1, c2, axis2, r2, hl2):
    return _sphere_sphere(c1, r1, _closest_on_segment(c1, c2, axis2, hl2), r2)


def _segment_segment(c1, a1, hl1, c2, a2, hl2):
    """Closest points between two segments (unit axes a1, a2; the clamped
    solve). Parallel axes (denom <= 1e-12) start from s = 0."""
    r = c1 - c2
    b = (a1 * a2).sum(-1, keepdim=True)
    d = (a1 * r).sum(-1, keepdim=True)
    e = (a2 * r).sum(-1, keepdim=True)
    denom = 1.0 - b * b
    s = torch.where(denom > 1e-12, (b * e - d) / denom.clamp_min(1e-12), torch.zeros_like(denom))
    s = s.clamp(-hl1, hl1)
    t = (b * s + e).clamp(-hl2, hl2)
    s = (b * t - d).clamp(-hl1, hl1)
    return c1 + a1 * s, c2 + a2 * t


def _capsule_capsule(c1, a1, r1, hl1, c2, a2, r2, hl2):
    p1, p2 = _segment_segment(c1, a1, hl1, c2, a2, hl2)
    return _sphere_sphere(p1, r1, p2, r2)


def _plane_capsule(pp, pn, c, axis, r, hl):
    """Two contacts: the capsule's end spheres, both in the axis frame."""
    d1, p1, _ = _plane_sphere(pp, pn, c + axis * hl, r)
    d2, p2, _ = _plane_sphere(pp, pn, c - axis * hl, r)
    frame = axis_frame(pn, axis)[:, None]
    return torch.cat([d1, d2], 1), torch.cat([p1, p2], 1), torch.cat([frame, frame], 1)


# corner signs of a box, x fastest (DIAL-MPC's order)
_CORNER_SIGNS = (
    (-1, -1, -1), (1, -1, -1), (-1, 1, -1), (1, 1, -1),
    (-1, -1, 1), (1, -1, 1), (-1, 1, 1), (1, 1, 1),
)


def _box_corners(c, mat, size):
    """World corners (B, 8, 3) of a box (centre c (B, 3), frame mat (B, 3, 3))."""
    local = maths.const(_CORNER_SIGNS, size) * size
    return c[:, None, :] + torch.einsum("kj,bij->bki", local, mat)


def _deepest(dist, k):
    """Indices (B, k) of the k smallest entries of dist (B, n), the lower
    index first among equals (the order of ``top_k`` on -dist)."""
    return torch.sort(dist, dim=-1, stable=True).indices[:, :k]


def _take(x, idx):
    """x (B, n, ...) at idx (B, k) -> (B, k, ...)."""
    return x.gather(1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(*idx.shape, *x.shape[2:]))


def _plane_box(pp, pn, bc, bmat, size):
    """Up to 4 contacts: the 4 deepest box corners against the plane."""
    corners = _box_corners(bc, bmat, size)
    dists = (corners * pn[:, None, :]).sum(-1) - (pn * pp).sum(-1, keepdim=True)
    idx = _deepest(dists, 4)
    d = dists.gather(1, idx)
    pos = _take(corners, idx) - 0.5 * d[..., None] * pn[:, None, :]
    frame = make_frame(pn)[:, None].expand(-1, 4, 3, 3)
    return d, pos, frame


def _closest_pt_on_box(p_local, size):
    """Closest point on a box (local frame) to p (..., 3); an interior point
    goes to its nearest face. Returns the point and whether p was inside."""
    clamped = torch.minimum(torch.maximum(p_local, -size), size)
    inside = (p_local.abs() < size).all(-1)
    ax = (size - p_local.abs()).argmin(-1, keepdim=True)  # the first of equal gaps
    p_ax = p_local.gather(-1, ax)
    size_ax = size.expand_as(p_local).gather(-1, ax)
    sign = torch.sign(p_ax)
    face_val = torch.where(sign == 0, size_ax, sign * size_ax)
    face_pt = p_local.scatter(-1, ax, face_val)
    return torch.where(inside[..., None], face_pt, clamped), inside


def _sphere_box_core(c1, r1, bc, bmat, size):
    """Sphere (c1, r1) against a box; leading axes broadcast. Returns dist
    (...), pos (..., 3) and the normal (..., 3), from the sphere into the box."""
    p_local = torch.einsum("...ji,...j->...i", bmat, c1 - bc)
    cp_local, inside = _closest_pt_on_box(p_local, size)
    cp = bc + torch.einsum("...ij,...j->...i", bmat, cp_local)
    dvec = cp - c1
    dist_c = torch.linalg.vector_norm(dvec, dim=-1)
    n_out = dvec / dist_c.clamp_min(1e-15)[..., None]
    n = torch.where(inside[..., None], -n_out, n_out)
    dist = torch.where(inside, -(dist_c + r1), dist_c - r1)
    pos = c1 + n * (r1 + 0.5 * dist)[..., None]
    return dist, pos, n


def _sphere_box(c1, r1, bc, bmat, size):
    dist, pos, n = _sphere_box_core(c1, r1, bc, bmat, size)
    return dist[:, None], pos[:, None], make_frame(n)[:, None]


def _capsule_box(c1, a1, r1, hl1, bc, bmat, size):
    """Two contacts: the capsule's end spheres against the box."""
    d1, p1, f1 = _sphere_box(c1 + a1 * hl1, r1, bc, bmat, size)
    d2, p2, f2 = _sphere_box(c1 - a1 * hl1, r1, bc, bmat, size)
    return torch.cat([d1, d2], 1), torch.cat([p1, p2], 1), torch.cat([f1, f2], 1)


def _box_box(c1, m1, s1, c2, m2, s2):
    """8 contacts: each box's corners against the other box (16 candidates,
    the first box's corners first), the deepest 8 kept. A corner of the
    second box gets the frame of the first box's corners with its normal and
    second tangent reversed."""
    dists, poss, frames = [], [], []
    for (ca, ma, sa, cb, mb, sb, flip) in (
        (c1, m1, s1, c2, m2, s2, False),
        (c2, m2, s2, c1, m1, s1, True),
    ):
        corners = _box_corners(ca, ma, sa)
        d, p, n = _sphere_box_core(corners, 0.0, cb[:, None], mb[:, None], sb)
        f = make_frame(n)
        if flip:
            f = f * maths.const((-1.0, 1.0, -1.0), f)[:, None]
        dists.append(d)
        poss.append(p)
        frames.append(f)
    dists, poss, frames = torch.cat(dists, 1), torch.cat(poss, 1), torch.cat(frames, 1)
    idx = _deepest(dists, 8)
    return dists.gather(1, idx), _take(poss, idx), _take(frames, idx)


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
        p1, p2, M1, M2, s1, s2 = gx[:, g1], gx[:, g2], gm[:, g1], gm[:, g2], gs[g1], gs[g2]
        key = (t1, t2)
        if key == (PLANE, SPHERE):
            out = _plane_sphere(p1, M1[..., 2], p2, s2[0])
        elif key == (PLANE, CAPSULE):
            out = _plane_capsule(p1, M1[..., 2], p2, M2[..., 2], s2[0], s2[1])
        elif key == (PLANE, BOX):
            out = _plane_box(p1, M1[..., 2], p2, M2, s2)
        elif key == (SPHERE, SPHERE):
            out = _sphere_sphere(p1, s1[0], p2, s2[0])
        elif key == (SPHERE, CAPSULE):
            out = _sphere_capsule(p1, s1[0], p2, M2[..., 2], s2[0], s2[1])
        elif key == (SPHERE, BOX):
            out = _sphere_box(p1, s1[0], p2, M2, s2)
        elif key == (CAPSULE, CAPSULE):
            out = _capsule_capsule(p1, M1[..., 2], s1[0], s1[1], p2, M2[..., 2], s2[0], s2[1])
        elif key == (CAPSULE, BOX):
            out = _capsule_box(p1, M1[..., 2], s1[0], s1[1], p2, M2, s2)
        elif key == (BOX, BOX):
            out = _box_box(p1, M1, s1, p2, M2, s2)
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
