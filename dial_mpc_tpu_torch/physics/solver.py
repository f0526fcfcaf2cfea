"""Newton constraint solver (MuJoCo soft-constraint optimization).

Solves  min_x 0.5 (x - a_s)' M (x - a_s) + sum_i s_i(J_i x - aref_i)
per sample, with per-row penalties:
  - unilateral rows (limits, pyramidal facets, frictionless contacts):
    quadratic when jar < 0;
  - dof-friction rows: Huber-shaped (clamped to +/- frictionloss).
Elliptic contact groups (cone == 1) are not ported yet.

This is the dense solve in plain PyTorch: a static schedule of
``opt.iterations`` Newton steps, each with ``opt.ls_iterations`` exact
line-search updates, and a per-sample freeze once a step stops improving.
"""

from __future__ import annotations

import torch

from dial_mpc_tpu_torch.physics import linalg
from dial_mpc_tpu_torch.physics.constraint import Efc, elliptic_groups
from dial_mpc_tpu_torch.physics.model import Data, Model


def _terms(m: Model, efc: Efc, jar: torch.Tensor):
    """Penalty terms at a given jar (B, nefc).

    Returns (force, cost, quad_w): the constraint force per row (B, nefc),
    the penalty value (B,), and the diagonal Hessian weights (B, nefc).
    """
    if elliptic_groups(m):
        raise NotImplementedError("elliptic friction cones are not ported yet")
    D, fl = efc.D, efc.frictionloss
    is_friction = fl > 0
    neg = jar < 0
    f_quad = -D * jar
    f_uni = torch.where(neg, f_quad, torch.zeros_like(f_quad))
    f_fri = torch.maximum(torch.minimum(f_quad, fl), -fl)
    force = torch.where(is_friction, f_fri, f_uni)
    quad_w = torch.where(is_friction, (f_quad.abs() <= fl) * D, neg * D)
    quad = 0.5 * D * jar * jar
    lin = fl * jar.abs() - 0.5 * fl**2 / D.clamp_min(1e-30)
    in_quad = (D * jar).abs() <= fl
    cost_rows = torch.where(
        is_friction,
        torch.where(in_quad, quad, lin),
        torch.where(neg, quad, torch.zeros_like(quad)),
    )
    return force, cost_rows.sum(-1), quad_w


def _solve_arrays(m: Model, J, D, aref, fl, eta, M, qacc_smooth):
    """Batched Newton solve on raw tensors -> (qacc, qfrc_constraint)."""
    efc = Efc(J=J, D=D, aref=aref, pos=torch.zeros_like(D), frictionloss=fl, eta=eta)
    JT = J.transpose(-1, -2)

    def mv(A, v):
        return torch.einsum("bij,bj->bi", A, v)

    def total_cost(x, jar):
        dx = x - qacc_smooth
        gauss = 0.5 * (dx * mv(M, dx)).sum(-1)
        _, cost, _ = _terms(m, efc, jar)
        return gauss + cost

    def linesearch(p, x, jar, jv):
        pMp = (p * mv(M, p)).sum(-1)
        pMx = (p * mv(M, x - qacc_smooth)).sum(-1)

        def dphi_ddphi(alpha):
            jar_a = jar + alpha[:, None] * jv
            force, _, quad_w = _terms(m, efc, jar_a)
            dphi = pMx + alpha * pMp - (jv * force).sum(-1)
            ddphi = pMp + (quad_w * jv * jv).sum(-1)
            return dphi, ddphi

        dp, ddp = dphi_ddphi(torch.zeros_like(pMp))
        alpha = -dp / ddp.clamp_min(1e-30)
        for _ in range(max(m.opt.ls_iterations - 1, 0)):
            dp, ddp = dphi_ddphi(alpha)
            alpha = alpha - dp / ddp.clamp_min(1e-30)
        return alpha

    x = qacc_smooth
    done = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for _ in range(m.opt.iterations):
        jar = mv(J, x) - aref
        force, _, quad_w = _terms(m, efc, jar)
        grad = mv(M, x - qacc_smooth) - mv(JT, force)
        H = M + JT @ (quad_w[:, :, None] * J)
        p = -linalg.solve_pd(H, grad)
        jv = mv(J, p)
        alpha = linesearch(p, x, jar, jv)
        x_new = x + alpha[:, None] * p
        prev_cost = total_cost(x, jar)
        new_cost = total_cost(x_new, mv(J, x_new) - aref)
        improved = (prev_cost - new_cost) > m.opt.tolerance * prev_cost.clamp_min(1.0)
        take = ~done & (new_cost < prev_cost)
        x = torch.where(take[:, None], x_new, x)
        done = done | ~improved

    jar = mv(J, x) - aref
    force, _, _ = _terms(m, efc, jar)
    return x, mv(JT, force)


def solve(m: Model, d: Data) -> Data:
    efc = d.efc
    if efc.J.shape[1] == 0:
        return d.replace(qacc=d.qacc_smooth, qfrc_constraint=torch.zeros_like(d.qacc_smooth))
    x, qfrc_constraint = _solve_arrays(
        m, efc.J, efc.D, efc.aref, efc.frictionloss, efc.eta, d.qM, d.qacc_smooth
    )
    return d.replace(qacc=x, qfrc_constraint=qfrc_constraint)
