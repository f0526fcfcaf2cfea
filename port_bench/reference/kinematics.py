"""Forward kinematics and CoM-frame quantities (mj_kinematics / mj_comPos /
mj_comVel semantics).

Bodies are processed in topological order (MuJoCo guarantees parent id <
child id); the per-body loop runs in Python on (B, ...) tensors.
"""

from __future__ import annotations

import torch

from . import maths
from .model import Data, Model

# mjtJoint
FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3


def kinematics(m: Model, d: Data) -> Data:
    """Body / geom / site poses from qpos (mj_kinematics)."""
    qpos = d.qpos
    B = qpos.shape[0]
    xpos = [qpos.new_zeros(B, 3)]
    xquat = [maths.const((1.0, 0.0, 0.0, 0.0), qpos).expand(B, 4)]
    xanchor = [None] * m.njnt
    xaxis = [None] * m.njnt

    for b in range(1, m.nbody):
        p = m.body_parentid[b]
        # body frame attached to parent
        pos = xpos[p] + maths.rotate(m.body_pos[b], xquat[p])
        quat = maths.quat_mul(xquat[p], m.body_quat[b])

        jadr, jnum = m.body_jntadr[b], m.body_jntnum[b]
        for k in range(jnum):
            j = jadr + k
            jt = m.jnt_type[j]
            qadr = m.jnt_qposadr[j]
            if jt == FREE:
                pos = qpos[:, qadr : qadr + 3]
                quat = maths.normalize(qpos[:, qadr + 3 : qadr + 7])
                xanchor[j] = pos
                # mj_kinematics leaves the free-joint axis unrotated
                xaxis[j] = m.jnt_axis[j].expand(B, 3)
            elif jt == SLIDE:
                axis = maths.rotate(m.jnt_axis[j], quat)
                # anchor is evaluated before the translation (mj_kinematics)
                xanchor[j] = pos + maths.rotate(m.jnt_pos[j], quat)
                xaxis[j] = axis
                pos = pos + axis * (qpos[:, qadr] - m.qpos0[qadr])[:, None]
            elif jt == HINGE:
                anchor = pos + maths.rotate(m.jnt_pos[j], quat)
                axis_local = m.jnt_axis[j]
                qloc = maths.axis_angle_to_quat(
                    axis_local, qpos[:, qadr] - m.qpos0[qadr]
                )
                quat = maths.quat_mul(quat, qloc)
                # keep the anchor point fixed under the rotation
                pos = anchor - maths.rotate(m.jnt_pos[j], quat)
                xanchor[j] = anchor
                xaxis[j] = maths.rotate(axis_local, quat)
            else:
                raise NotImplementedError("ball joints are not supported")
        xpos.append(pos)
        xquat.append(maths.normalize(quat))

    xpos = torch.stack(xpos, dim=1)
    xquat = torch.stack(xquat, dim=1)
    xmat = maths.quat_to_mat(xquat)

    # inertial frames
    xipos = xpos + maths.rotate(m.body_ipos, xquat)
    ximat = maths.quat_to_mat(maths.quat_mul(xquat, m.body_iquat))

    # geoms / sites
    gb = m.geom_bodyid.long()
    geom_xpos = xpos[:, gb] + maths.rotate(m.geom_pos, xquat[:, gb])
    geom_xmat = maths.quat_to_mat(maths.quat_mul(xquat[:, gb], m.geom_quat))
    if m.nsite:
        sb = m.site_bodyid.long()
        site_xpos = xpos[:, sb] + maths.rotate(m.site_pos, xquat[:, sb])
        site_xmat = maths.quat_to_mat(maths.quat_mul(xquat[:, sb], m.site_quat))
    else:
        site_xpos = qpos.new_zeros(B, 0, 3)
        site_xmat = qpos.new_zeros(B, 0, 3, 3)

    xanchor_a = torch.stack(xanchor, dim=1) if m.njnt else qpos.new_zeros(B, 0, 3)
    xaxis_a = torch.stack(xaxis, dim=1) if m.njnt else qpos.new_zeros(B, 0, 3)

    return d.replace(
        xpos=xpos,
        xquat=xquat,
        xmat=xmat,
        xipos=xipos,
        ximat=ximat,
        xanchor=xanchor_a,
        xaxis=xaxis_a,
        geom_xpos=geom_xpos,
        geom_xmat=geom_xmat,
        site_xpos=site_xpos,
        site_xmat=site_xmat,
    )


def com_pos(m: Model, d: Data) -> Data:
    """Subtree CoM, CoM-frame spatial inertias and dof motion subspaces
    (mj_comPos)."""
    B = d.qpos.shape[0]
    mass = m.body_mass
    # accumulate bottom-up: weighted xipos sums over subtrees
    wpos = mass[:, None] * d.xipos
    sub_sum = [wpos[:, b] for b in range(m.nbody)]
    sub_mass = [mass[b] for b in range(m.nbody)]
    for b in range(m.nbody - 1, 0, -1):
        p = m.body_parentid[b]
        sub_sum[p] = sub_sum[p] + sub_sum[b]
        sub_mass[p] = sub_mass[p] + sub_mass[b]
    # world body: subtree_com[0] is the full-model CoM
    subtree_com = torch.stack(
        [sub_sum[b] / sub_mass[b].clamp_min(1e-15) for b in range(m.nbody)], dim=1
    )

    # spatial inertia of each body about the CoM of its kinematic tree root
    root_com = subtree_com[:, maths.const_index(tuple(m.body_rootid), subtree_com.device)]
    offset = d.xipos - root_com  # CoM of body minus reference origin
    inert_world = torch.einsum("nbij,bj,nbkj->nbik", d.ximat, m.body_inertia, d.ximat)
    cinert = maths.spatial_inertia(mass, inert_world, offset)

    # dof motion subspaces (cdof), reference origin = subtree_com[rootid]
    zeros = d.qpos.new_zeros(B, 3)
    cdofs = []
    for j in range(m.njnt):
        jt = m.jnt_type[j]
        b = m.jnt_bodyid[j]
        o = subtree_com[:, m.body_rootid[b]]
        if jt == FREE:
            eye = torch.eye(3, dtype=d.qpos.dtype, device=d.qpos.device)
            for i in range(3):
                cdofs.append(torch.cat([zeros, eye[i].expand(B, 3)], dim=-1))
            # rotational dofs: axes of the body frame (free-joint angular
            # velocity lives in the child frame), anchored at body origin
            for i in range(3):
                ax = d.xmat[:, b, :, i]
                lin = maths.cross(ax, o - d.xpos[:, b])
                cdofs.append(torch.cat([ax, lin], dim=-1))
        elif jt == SLIDE:
            cdofs.append(torch.cat([zeros, d.xaxis[:, j]], dim=-1))
        elif jt == HINGE:
            ax = d.xaxis[:, j]
            lin = maths.cross(ax, o - d.xanchor[:, j])
            cdofs.append(torch.cat([ax, lin], dim=-1))
    cdof = torch.stack(cdofs, dim=1) if cdofs else d.qpos.new_zeros(B, 0, 6)

    return d.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def com_vel(m: Model, d: Data) -> Data:
    """Body CoM-frame velocities and cdof time-derivatives (mj_comVel)."""
    B = d.qpos.shape[0]
    zeros6 = d.qpos.new_zeros(B, 6)
    cvel = [zeros6]
    cdof_dot = [None] * m.nv
    for b in range(1, m.nbody):
        p = m.body_parentid[b]
        v = cvel[p]
        # per-joint accumulation mirroring mj_comVel: cdof_dot for a dof is
        # the motion cross of the velocity *accumulated so far* with cdof
        jadr, jnum = m.body_jntadr[b], m.body_jntnum[b]
        for k in range(jnum):
            j = jadr + k
            jt = m.jnt_type[j]
            da = m.jnt_dofadr[j]
            if jt == FREE:
                # translation dofs: cdof constant in world -> cdof_dot = 0
                for i in range(3):
                    cdof_dot[da + i] = zeros6
                v = v + torch.einsum("bki,bk->bi", d.cdof[:, da : da + 3], d.qvel[:, da : da + 3])
                # rotation dofs: cross with velocity including translation part
                for i in range(3):
                    cdof_dot[da + 3 + i] = maths.motion_cross(v, d.cdof[:, da + 3 + i])
                v = v + torch.einsum(
                    "bki,bk->bi", d.cdof[:, da + 3 : da + 6], d.qvel[:, da + 3 : da + 6]
                )
            else:
                cdof_dot[da] = maths.motion_cross(v, d.cdof[:, da])
                v = v + d.cdof[:, da] * d.qvel[:, da, None]
        cvel.append(v)
    cvel = torch.stack(cvel, dim=1)
    cdof_dot = torch.stack(cdof_dot, dim=1) if m.nv else d.qpos.new_zeros(B, 0, 6)
    return d.replace(cvel=cvel, cdof_dot=cdof_dot)


def maximal_coordinates(m: Model, d: Data) -> Data:
    """x/xd views consumed by the task environments.

    x_pos/x_rot are body frames (world excluded); xd is the world-frame
    velocity of each body-frame origin.
    """
    root_com = d.subtree_com[:, maths.const_index(tuple(m.body_rootid)[1:], d.subtree_com.device)]
    offset = d.xpos[:, 1:] - root_com
    ang = d.cvel[:, 1:, :3]
    vel = d.cvel[:, 1:, 3:] + maths.cross(ang, offset)
    return d.replace(x_pos=d.xpos[:, 1:], x_rot=d.xquat[:, 1:], xd_vel=vel, xd_ang=ang)
