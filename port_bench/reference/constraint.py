"""Constraint assembly: dof friction, joint limits, contact friction cones.

Produces dense, statically-shaped efc tensors:
  J (B, nefc, nv), D, aref, pos, frictionloss, eta (B, nefc).

Row order: dof-friction rows, joint-limit rows, contact rows (pyramidal
facets or one elliptic group per contact slot, slot order from the static
pair table). Inactive
rows (separated contacts, unviolated limits beyond margin) get D = 0 so
they drop out of the solver algebraically without changing any shapes.

Semantics follow MuJoCo's soft-constraint model: impedance d(r) from
solimp, stiffness/damping from solref, reference acceleration
aref = -b*vel - k*d(r)*pos, regularizer R = (1-d)/d * diagApprox.
"""

from __future__ import annotations

import dataclasses

import torch

from . import maths
from .model import Data, Model

SLIDE, HINGE = 2, 3
MJ_MINIMP, MJ_MAXIMP = 0.0001, 0.9999
MJ_MINVAL = 1e-15


@dataclasses.dataclass(frozen=True)
class Efc:
    J: torch.Tensor  # (B, nefc, nv)
    D: torch.Tensor  # (B, nefc) inverse regularizer (0 => inactive row)
    aref: torch.Tensor  # (B, nefc)
    pos: torch.Tensor  # (B, nefc) constraint violation (for diagnostics)
    frictionloss: torch.Tensor  # (B, nefc) dof-friction bound (0 => unilateral row)
    eta: torch.Tensor = None  # (B, nefc) elliptic friction coefficient per row


def elliptic_groups(m: Model):
    """Static (row0, condim) spans of elliptic contact groups in efc rows.

    Row layout: dof-friction rows, joint-limit rows, then contact rows in
    slot order. Only meaningful when m.opt.cone == 1; empty otherwise.
    """
    if m.opt.cone != 1 or m.opt.disable_contact:
        return ()
    nrows = sum(1 for i in range(m.nv) if m.dof_frictionloss_static[i] > 0)
    if not m.opt.disable_limit:
        for j in range(m.njnt):
            if m.jnt_limited[j] and m.jnt_type[j] in (SLIDE, HINGE):
                nrows += 1
    groups = []
    for (g1, g2, t1, t2, condim, conadr, conmax) in m.pair_table:
        for _ in range(conmax):
            if condim == 1:
                nrows += 1
            else:
                groups.append((nrows, condim))
                nrows += condim
    return tuple(groups)


def _impedance(solimp, pos):
    dmin, dmax, width, mid, power = solimp.unbind(-1)
    x = pos.abs() / width.clamp_min(MJ_MINVAL)
    ya = x**power / (mid ** (power - 1.0)).clamp_min(MJ_MINVAL)
    yb = 1.0 - (1.0 - x) ** power / ((1.0 - mid) ** (power - 1.0)).clamp_min(MJ_MINVAL)
    y = torch.where(x < mid, ya, yb)
    imp = torch.clamp(dmin + y * (dmax - dmin), MJ_MINIMP, MJ_MAXIMP)
    return torch.where(x > 1.0, dmax, imp)


def _kbi(m: Model, solref, solimp, pos, vel):
    """Impedance, and aref = -b*vel - k*imp*pos (standard or direct solref)."""
    imp = _impedance(solimp, pos)
    dmax = solimp[..., 1]
    timeconst = torch.maximum(solref[..., 0], 2.0 * m.opt.timestep)
    dampratio = solref[..., 1]
    b_std = 2.0 / (dmax * timeconst).clamp_min(MJ_MINVAL)
    k_std = 1.0 / (
        dmax * dmax * timeconst * timeconst * dampratio * dampratio
    ).clamp_min(MJ_MINVAL)
    # direct (negative) solref: -stiffness, -damping
    k = torch.where(solref[..., 0] <= 0, -solref[..., 0] / (dmax * dmax).clamp_min(MJ_MINVAL), k_std)
    b = torch.where(solref[..., 1] <= 0, -solref[..., 1] / dmax.clamp_min(MJ_MINVAL), b_std)
    aref = -b * vel - k * imp * pos
    return imp, aref


def _point_jacobian(m: Model, d: Data, point: torch.Tensor, body: int):
    """Translational & rotational Jacobians of a world point on a body.

    Dense masked form of mj_jac: every dof column is computed, then masked
    by the body's kinematic chain. point (B, 3) -> two (B, nv, 3).
    """
    root = m.body_rootid[body]
    offset = point - d.subtree_com[:, root]
    jacp = d.cdof[..., 3:] + maths.cross(d.cdof[..., :3], offset[:, None, :])
    jacr = d.cdof[..., :3]
    mask = m.body_chain_mask[body][:, None]
    return jacp * mask, jacr * mask


def make_constraint(m: Model, d: Data) -> Data:
    B, nv = d.qpos.shape[0], m.nv
    zero = d.qpos.new_zeros(B)
    rows_J, rows_D, rows_aref, rows_pos, rows_fl, rows_eta = [], [], [], [], [], []

    def unit_row(i, value):
        J = d.qpos.new_zeros(B, nv)
        J[:, i] = value
        return J

    # ---- dof friction rows ----
    for i in range(nv):
        if m.dof_frictionloss_static[i] <= 0:
            continue
        imp, aref = _kbi(m, m.dof_solref[i], m.dof_solimp[i], zero, d.qvel[:, i])
        R = ((1.0 - imp) / imp * m.dof_invweight0[i]).clamp_min(MJ_MINVAL)
        rows_J.append(unit_row(i, 1.0))
        rows_D.append(1.0 / R)
        rows_aref.append(aref)
        rows_pos.append(zero)
        rows_fl.append(m.dof_frictionloss[i].expand(B))
        rows_eta.append(zero)

    # ---- joint limit rows ----
    if not m.opt.disable_limit:
        for j in range(m.njnt):
            if not m.jnt_limited[j] or m.jnt_type[j] not in (SLIDE, HINGE):
                continue
            qadr, dadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
            q = d.qpos[:, qadr]
            lo, hi = m.jnt_range[j, 0], m.jnt_range[j, 1]
            dist_lo = q - lo
            dist_hi = hi - q
            use_lo = dist_lo < dist_hi
            dist = torch.where(use_lo, dist_lo, dist_hi)
            sign = use_lo.to(q.dtype) * 2.0 - 1.0  # 1 at the lower limit, -1 at the upper
            pos = dist - m.jnt_margin[j]
            active = (dist < m.jnt_margin[j]).to(q.dtype)
            vel = sign * d.qvel[:, dadr]
            imp, aref = _kbi(m, m.jnt_solref[j], m.jnt_solimp[j], pos, vel)
            R = ((1.0 - imp) / imp * m.dof_invweight0[dadr]).clamp_min(MJ_MINVAL)
            rows_J.append(unit_row(dadr, sign * active))
            rows_D.append(active / R)
            rows_aref.append(aref * active)
            rows_pos.append(pos)
            rows_fl.append(zero)
            rows_eta.append(zero)

    # ---- contact rows (pyramidal or elliptic cone) ----
    if m.ncon and not m.opt.disable_contact:
        con = d.contact
        slot_meta = []
        for (g1, g2, t1, t2, condim, conadr, conmax) in m.pair_table:
            for k in range(conmax):
                slot_meta.append((conadr + k, g1, g2, condim))
        for (slot, g1, g2, condim) in slot_meta:
            b1 = m.geom_bodyid_static[g1]
            b2 = m.geom_bodyid_static[g2]
            point = con.pos[:, slot]
            frame = con.frame[:, slot]  # (B, 3, 3) rows: n, t1, t2
            pos = con.dist[:, slot] - con.includemargin[slot]
            active = (con.dist[:, slot] < con.includemargin[slot]).to(pos.dtype)

            jacp1, jacr1 = _point_jacobian(m, d, point, b1)
            jacp2, jacr2 = _point_jacobian(m, d, point, b2)
            djacp = jacp2 - jacp1  # (B, nv, 3)
            djacr = jacr2 - jacr1

            def along(jac, k):
                return torch.einsum("bvi,bi->bv", jac, frame[:, k])

            Jn = along(djacp, 0)
            solref, solimp = con.solref[slot], con.solimp[slot]
            imp, _ = _kbi(m, solref, solimp, pos, zero)
            invweight_t = m.body_invweight0[b1, 0] + m.body_invweight0[b2, 0]
            invweight_r = m.body_invweight0[b1, 1] + m.body_invweight0[b2, 1]

            def add_row(Jrow, R, aref_pos=pos, eta=zero):
                vel = (Jrow * d.qvel).sum(-1)
                _, aref = _kbi(m, solref, solimp, aref_pos, vel)
                rows_J.append(Jrow * active[:, None])
                rows_D.append(active / R)
                rows_aref.append(aref * active)
                rows_pos.append(pos)
                rows_fl.append(zero)
                rows_eta.append(eta)

            if condim == 1:
                add_row(Jn, ((1.0 - imp) / imp * invweight_t).clamp_min(MJ_MINVAL))
            elif m.opt.cone == 1:
                # elliptic cone: condim rows [normal, t1, t2, (tor, r1, r2)] with
                #   R_n = (1-imp)/imp * invweight_t
                #   R_i = R_n * mu^2 / (eta_i^2 * impratio)   (friction rows)
                # the normal row's aref has the position term, the friction
                # rows' are velocity-only
                fri = con.friction[slot]
                mu = fri[0]
                Rn = ((1.0 - imp) / imp * invweight_t).clamp_min(MJ_MINVAL)
                add_row(Jn, Rn)
                fric_Js = [along(djacp, 1), along(djacp, 2)]
                if condim > 3:
                    fric_Js.append(along(djacr, 0))
                if condim > 4:
                    fric_Js += [along(djacr, 1), along(djacr, 2)]
                for eta_i, Jf in zip(fri[: condim - 1], fric_Js):
                    Ri = Rn * mu * mu / (eta_i * eta_i * m.opt.impratio).clamp_min(MJ_MINVAL)
                    add_row(Jf, Ri, aref_pos=zero, eta=eta_i.expand(B))
            else:
                # pyramidal facets: n +/- mu_k * dir_k
                fri = con.friction[slot]
                tdirs = [along(djacp, 1), along(djacp, 2)]
                if condim == 6:
                    tdirs += [along(djacr, 0), along(djacr, 1), along(djacr, 2)]
                    invw_axis = [invweight_t, invweight_t, invweight_r, invweight_r, invweight_r]
                else:
                    invw_axis = [invweight_t, invweight_t]
                for k, Jt in enumerate(tdirs):
                    mu = fri[k]
                    invweight_fac = invweight_t + mu * mu * invw_axis[k]
                    R = ((1.0 - imp) / imp * invweight_fac * 2.0 * mu * mu).clamp_min(
                        MJ_MINVAL
                    )
                    for sgn in (1.0, -1.0):
                        add_row(Jn + sgn * mu * Jt, R)

    if rows_J:
        efc = Efc(
            J=torch.stack(rows_J, dim=1),
            D=torch.stack(rows_D, dim=1),
            aref=torch.stack(rows_aref, dim=1),
            pos=torch.stack(rows_pos, dim=1),
            frictionloss=torch.stack(rows_fl, dim=1),
            eta=torch.stack(rows_eta, dim=1),
        )
    else:
        empty = d.qpos.new_zeros(B, 0)
        efc = Efc(
            J=d.qpos.new_zeros(B, 0, nv), D=empty, aref=empty, pos=empty,
            frictionloss=empty, eta=empty,
        )
    return d.replace(efc=efc)
