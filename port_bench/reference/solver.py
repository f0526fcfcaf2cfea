"""Newton constraint solver (MuJoCo soft-constraint optimization).

Solves  min_x 0.5 (x - a_s)' M (x - a_s) + sum_i s_i(J_i x - aref_i)
per sample, with per-row penalties:
  - unilateral rows (limits, pyramidal facets, frictionless contacts):
    quadratic when jar < 0;
  - dof-friction rows: Huber-shaped (clamped to +/- frictionloss);
  - elliptic contact groups (cone == 1): three-zone cone penalty per
    contact, with
      u_i = eta_i * jar_i (friction rows), U = ||u||, N = jar_normal
      top zone    (N >= U):               force 0, cost 0
      bottom zone (N <= -(ir/mu^2) U):    force -D_i jar_i (per row)
      middle zone:                        f_n = k (U - N),
                                          f_i = -k (U - N) eta_i u_i / U
      with k = 1 / (R_n + mu^2 R_t) and ir = opt.impratio. The cost whose
      negative gradient is this force is 0 / 0.5 sum D_i jar_i^2 /
      0.5 k (U - N)^2 per zone (C1-continuous at both boundaries).

``_solve_arrays`` is the dense solve in plain PyTorch: a static schedule of
``opt.iterations`` Newton steps, each with ``opt.ls_iterations`` exact
line-search updates, and a per-sample freeze once a step stops improving.

The elliptic groups of one dimension are evaluated together, as a
(B, groups, dim) block, where the port's plain version walks them one by
one: the same arithmetic, summed in another order, and a tenth of the
launches on the Allegro's 19 groups.
"""

from __future__ import annotations

import torch

from . import linalg, maths
from .constraint import Efc, elliptic_groups
from .model import Data, Model

_BIGR = 1e30


def _terms(m: Model, efc: Efc, jar: torch.Tensor):
    """Penalty terms at a given jar (B, nefc).

    Returns (force, cost, quad_w, mids):
      force:   (B, nefc) constraint force per row,
      cost:    (B,) penalty value,
      quad_w:  (B, nefc) diagonal Hessian weights (simple rows and
               bottom-zone elliptic rows),
      mids:    list of (k_mid (B, G), g (B, G, dim), idx (G, dim)), the
               rank-1 middle-zone Gauss-Newton Hessian terms of the G
               groups of one dimension (rows idx), k_mid masked by the zone
               flag.
    """
    groups = elliptic_groups(m)
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
    if not groups:
        return force, cost_rows.sum(-1), quad_w, []

    # elliptic rows leave the simple-row treatment (static mask)
    elliptic = tuple(float(any(row0 <= r < row0 + dim for row0, dim in groups)) for r in range(D.shape[1]))
    simple = maths.const(elliptic, D) == 0
    zeros = torch.zeros_like(force)
    force = torch.where(simple, force, zeros)
    quad_w = torch.where(simple, quad_w, zeros)
    cost = torch.where(simple, cost_rows, zeros).sum(-1)

    ir = m.opt.impratio
    mids = []
    for dim, idx in _group_blocks(groups, D.device):
        jr, Dg, eta = jar[:, idx], D[:, idx], efc.eta[:, idx]  # (B, G, dim); eta[..., 0] is 0
        mu = eta[..., 1]  # tangent coefficient
        N = jr[..., 0]
        u = eta[..., 1:] * jr[..., 1:]
        U = torch.sqrt((u * u).sum(-1) + 1e-30)
        big = torch.full_like(N, _BIGR)
        Rn = torch.where(Dg[..., 0] > 0, 1.0 / Dg[..., 0].clamp_min(1e-30), big)
        Rt = torch.where(Dg[..., 1] > 0, 1.0 / Dg[..., 1].clamp_min(1e-30), big)
        k = 1.0 / (Rn + mu * mu * Rt)

        top = N >= U
        bottom = N <= -(ir / (mu * mu).clamp_min(1e-12)) * U
        middle = ~(top | bottom)

        f_bottom = -Dg * jr
        fn_mid = k * (U - N)
        dirs = eta[..., 1:] * u / U[..., None]
        f_mid = torch.cat([fn_mid[..., None], -fn_mid[..., None] * dirs], dim=-1)
        f_g = torch.where(bottom[..., None], f_bottom, f_mid)
        f_g = torch.where(top[..., None], torch.zeros_like(f_g), f_g)
        flat = idx.reshape(-1)
        force = force.index_copy(1, flat, f_g.reshape(f_g.shape[0], -1))

        cost_bottom = 0.5 * (Dg * jr * jr).sum(-1)
        cost_mid = 0.5 * k * (U - N) ** 2
        cost_g = torch.where(bottom, cost_bottom, cost_mid)
        cost = cost + torch.where(top, torch.zeros_like(cost_g), cost_g).sum(-1)

        qw = torch.where(bottom[..., None], Dg, torch.zeros_like(Dg))
        quad_w = quad_w.index_copy(1, flat, qw.reshape(qw.shape[0], -1))
        # middle-zone Gauss-Newton direction g = grad(U - N) over group rows
        g = torch.cat([-torch.ones_like(N)[..., None], dirs], dim=-1)
        mids.append((k * middle, g, idx))

    return force, cost, quad_w, mids


_BLOCKS = {}


def _group_blocks(groups, device):
    """The elliptic groups by dimension: (dim, (G, dim) row indices), made
    once a device."""
    key = (groups, device)
    if key not in _BLOCKS:
        by_dim = {}
        for row0, dim in groups:
            by_dim.setdefault(dim, []).append(list(range(row0, row0 + dim)))
        _BLOCKS[key] = [
            (dim, torch.tensor(rows, dtype=torch.long, device=device)) for dim, rows in sorted(by_dim.items())
        ]
    return _BLOCKS[key]


def _solve_arrays(m: Model, J, D, aref, fl, eta, M, qacc_smooth):
    """Batched Newton solve on raw tensors -> (qacc, qfrc_constraint)."""
    efc = Efc(J=J, D=D, aref=aref, pos=torch.zeros_like(D), frictionloss=fl, eta=eta)
    JT = J.transpose(-1, -2)

    def mv(A, v):
        return torch.einsum("bij,bj->bi", A, v)

    def total_cost(x, jar):
        dx = x - qacc_smooth
        gauss = 0.5 * (dx * mv(M, dx)).sum(-1)
        _, cost, _, _ = _terms(m, efc, jar)
        return gauss + cost

    def linesearch(p, x, jar, jv):
        pMp = (p * mv(M, p)).sum(-1)
        pMx = (p * mv(M, x - qacc_smooth)).sum(-1)

        def dphi_ddphi(alpha):
            jar_a = jar + alpha[:, None] * jv
            force, _, quad_w, mids = _terms(m, efc, jar_a)
            dphi = pMx + alpha * pMp - (jv * force).sum(-1)
            ddphi = pMp + (quad_w * jv * jv).sum(-1)
            for (k_mid, g, idx) in mids:
                gjv = (g * jv[:, idx]).sum(-1)  # (B, G)
                ddphi = ddphi + (k_mid * gjv * gjv).sum(-1)
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
        force, _, quad_w, mids = _terms(m, efc, jar)
        grad = mv(M, x - qacc_smooth) - mv(JT, force)
        H = M + JT @ (quad_w[:, :, None] * J)
        for (k_mid, g, idx) in mids:
            v = torch.einsum("bngd,bgd->bng", JT[:, :, idx], g)  # (B, nv, G)
            H = H + torch.einsum("bg,bng,bmg->bnm", k_mid, v, v)
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
    force, _, _, _ = _terms(m, efc, jar)
    return x, mv(JT, force)


def _solve_with(solve_batched, m: Model, d: Data) -> Data:
    efc = d.efc
    if efc.J.shape[1] == 0:
        return d.replace(qacc=d.qacc_smooth, qfrc_constraint=torch.zeros_like(d.qacc_smooth))
    x, qfrc_constraint = solve_batched(
        m, efc.J, efc.D, efc.aref, efc.frictionloss, efc.eta, d.qM, d.qacc_smooth
    )
    return d.replace(qacc=x, qfrc_constraint=qfrc_constraint)


def solve(m: Model, d: Data) -> Data:
    """The solve stage in plain PyTorch on any device."""
    return _solve_with(_solve_arrays, m, d)
