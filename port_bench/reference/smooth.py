"""Smooth (unconstrained) dynamics: mass matrix, bias forces, actuation.

Mirrors MuJoCo's mj_crb / mj_rne / mj_passive / mj_fwdActuation stages in
dense form: the mass matrix is a dense (B, nv, nv) tensor built with one
masked product.
"""

from __future__ import annotations

import torch

from . import linalg, maths
from .model import Data, Model


def crb(m: Model, d: Data) -> Data:
    """Composite-rigid-body mass matrix (dense), plus its Cholesky factor."""
    # accumulate composite inertias bottom-up
    crb_i = [d.cinert[:, b] for b in range(m.nbody)]
    for b in range(m.nbody - 1, 0, -1):
        p = m.body_parentid[b]
        if p > 0:
            crb_i[p] = crb_i[p] + crb_i[b]
    crb_stack = torch.stack(crb_i, dim=1)  # (B, nbody, 6, 6)

    # F[i] = crb[body(i)] @ cdof[i]
    F = torch.einsum("bvij,bvj->bvi", crb_stack[:, maths.const_index(tuple(m.dof_bodyid), d.cdof.device)], d.cdof)
    # lower triangle: M[i, j] = F[i] . cdof[j] for j ancestor-or-self of i
    lower = torch.einsum("bvi,bwi->bvw", F, d.cdof) * m.dof_ancestor_mask
    diag = torch.diagonal(lower, dim1=-2, dim2=-1)
    qM = lower + lower.transpose(-1, -2) - torch.diag_embed(diag)
    qM = qM + torch.diag(m.dof_armature)
    qLD = linalg.cholesky(qM)
    return d.replace(qM=qM, qLD=qLD)


def solve_m(d: Data, rhs: torch.Tensor) -> torch.Tensor:
    """M^{-1} rhs via the cached Cholesky factor."""
    return linalg.cho_solve(d.qLD, rhs)


def rne(m: Model, d: Data) -> Data:
    """Bias force C(q, qvel) via recursive Newton-Euler (mj_rne, flg_acc=0)."""
    B = d.qpos.shape[0]
    cacc0 = torch.cat([m.opt.gravity.new_zeros(3), -m.opt.gravity]).expand(B, 6)

    cacc = [cacc0]
    for b in range(1, m.nbody):
        p = m.body_parentid[b]
        da, dn = m.body_dofadr[b], m.body_dofnum[b]
        acc = cacc[p]
        if dn:
            acc = acc + torch.einsum(
                "bki,bk->bi", d.cdof_dot[:, da : da + dn], d.qvel[:, da : da + dn]
            )
        cacc.append(acc)

    cacc_s = torch.stack(cacc, dim=1)
    h = torch.einsum("bnij,bnj->bni", d.cinert, d.cvel)
    cfrc_s = torch.einsum("bnij,bnj->bni", d.cinert, cacc_s) + maths.force_cross(d.cvel, h)
    cfrc = [cfrc_s[:, b] for b in range(m.nbody)]

    # accumulate subtree forces bottom-up
    for b in range(m.nbody - 1, 1, -1):
        p = m.body_parentid[b]
        if p > 0:
            cfrc[p] = cfrc[p] + cfrc[b]

    if m.nv:
        cfrc_dof = torch.stack([cfrc[m.dof_bodyid[i]] for i in range(m.nv)], dim=1)
        qfrc_bias = (d.cdof * cfrc_dof).sum(-1)
    else:
        qfrc_bias = d.qpos.new_zeros(B, 0)
    return d.replace(qfrc_bias=qfrc_bias)


def passive(m: Model, d: Data) -> Data:
    """Joint damping (springs are zero in all supported models)."""
    return d.replace(qfrc_passive=-m.dof_damping * d.qvel)


def actuation(m: Model, d: Data) -> Data:
    """Joint-transmission actuators: motor (gain) and position (affine bias).

    Covers trntype=joint, gaintype=fixed, biastype in {none, affine}.
    """
    B = d.qpos.shape[0]
    if m.nu == 0:
        return d.replace(
            qfrc_actuator=d.qpos.new_zeros(B, m.nv),
            actuator_force=d.qpos.new_zeros(B, 0),
        )

    ctrl = torch.where(
        m.actuator_ctrllimited > 0,
        torch.clamp(d.ctrl, m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]),
        d.ctrl,
    )

    # actuator length/velocity for joint transmission
    qposadr = [m.jnt_qposadr[m.actuator_trnid[u]] for u in range(m.nu)]
    dofadr = m.actuator_dofadr.long()
    length = d.qpos[:, maths.const_index(tuple(qposadr), d.qpos.device)] * m.actuator_gear
    velocity = d.qvel[:, dofadr] * m.actuator_gear

    force = m.actuator_gainprm[:, 0] * ctrl
    bias = (
        m.actuator_biasprm[:, 0]
        + m.actuator_biasprm[:, 1] * length
        + m.actuator_biasprm[:, 2] * velocity
    )
    affine = maths.const(tuple(float(bt == 1) for bt in m.actuator_biastype), force) > 0
    force = force + torch.where(affine, bias, torch.zeros_like(bias))
    force = torch.where(
        m.actuator_forcelimited > 0,
        torch.clamp(force, m.actuator_forcerange[:, 0], m.actuator_forcerange[:, 1]),
        force,
    )

    qfrc = d.qpos.new_zeros(B, m.nv).index_add_(1, dofadr, force * m.actuator_gear)
    return d.replace(qfrc_actuator=qfrc, actuator_force=force)


def fwd_smooth(m: Model, d: Data) -> Data:
    """qacc_smooth = M^{-1} (passive + actuator - bias)."""
    qfrc_smooth = d.qfrc_passive + d.qfrc_actuator - d.qfrc_bias
    qacc_smooth = solve_m(d, qfrc_smooth)
    return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth)
