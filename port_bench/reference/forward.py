"""Top-level forward dynamics and integration (mj_forward / mj_step)."""

from __future__ import annotations

import torch

from . import collision, constraint, kinematics, linalg, maths, smooth, solver
from .model import Data, Model

FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3


def fwd_position(m: Model, d: Data) -> Data:
    d = kinematics.kinematics(m, d)
    d = kinematics.com_pos(m, d)
    d = collision.collide(m, d)
    d = smooth.crb(m, d)
    return d


def fwd_velocity(m: Model, d: Data) -> Data:
    d = kinematics.com_vel(m, d)
    d = smooth.rne(m, d)
    d = smooth.passive(m, d)
    return d


def forward(m: Model, d: Data, solve=solver.solve) -> Data:
    """Full forward dynamics: populates qacc and all derived fields."""
    d = fwd_position(m, d)
    d = fwd_velocity(m, d)
    d = smooth.actuation(m, d)
    d = smooth.fwd_smooth(m, d)
    d = constraint.make_constraint(m, d)
    d = solve(m, d)
    d = kinematics.maximal_coordinates(m, d)
    return d


def _integrate_qpos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor, dt) -> torch.Tensor:
    """Position integration respecting quaternion manifolds (mj_integratePos)."""
    out = qpos.clone()  # the caller's qpos must stay as it was
    for j in range(m.njnt):
        jt = m.jnt_type[j]
        qadr = m.jnt_qposadr[j]
        dadr = m.jnt_dofadr[j]
        if jt == FREE:
            out[:, qadr : qadr + 3] += dt * qvel[:, dadr : dadr + 3]
            out[:, qadr + 3 : qadr + 7] = maths.quat_integrate(
                qpos[:, qadr + 3 : qadr + 7], qvel[:, dadr + 3 : dadr + 6], dt
            )
        else:  # SLIDE / HINGE
            out[:, qadr] += dt * qvel[:, dadr]
    return out


def _euler_damp_qacc(m: Model, d: Data) -> torch.Tensor:
    """Implicit joint damping: solve (M + h*diag(B)) x = qfrc_total.

    mj_Euler's eulerdamp path (the Allegro model enables it; the Go2 and H1
    scenes disable it with <flag eulerdamp="disable">).
    """
    MhB = d.qM + m.opt.timestep * torch.diag(m.dof_damping)
    return linalg.solve_pd(MhB, d.qfrc_smooth + d.qfrc_constraint)


def step(m: Model, d: Data, solve=solver.solve) -> Data:
    """One Euler step: forward dynamics then semi-implicit integration."""
    d = forward(m, d, solve)
    h = m.opt.timestep

    # static decision: the model either enables eulerdamp or not
    if not m.opt.disable_eulerdamp:
        qacc = _euler_damp_qacc(m, d)
    else:
        qacc = d.qacc

    qvel = d.qvel + h * qacc
    qpos = _integrate_qpos(m, d.qpos, qvel, h)
    return d.replace(qpos=qpos, qvel=qvel, time=d.time + h)
