"""A seeded constraint-solve problem that reaches every kind of row.

The Go2 scenes give the solver unilateral rows only. This module makes a
small dense problem (nv 6, nefc 12) with one friction-loss row on either side
of its clamp, unilateral rows of both signs, inactive rows, and two elliptic
cone groups (dimension 3 and 6) placed by construction in the top, middle and
bottom zone or left inactive. The CPU tests and ``chip_smoke.py`` both hold the
solver kernel and its plain version to it; the arrays are numpy so that another
implementation can be fed the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from dial_mpc_tpu_torch.physics.model import Model, Option

PLANE, SPHERE, HINGE = 0, 2, 3
TOP, MIDDLE, BOTTOM = 0, 1, 2

# rows: 0 friction loss (dof 0), 1 joint limit, 2-4 elliptic condim 3,
# 5-10 elliptic condim 6, 11 frictionless contact
SPEC = dict(
    nv=6, nefc=12, njnt=1, jnt_type=(HINGE,), jnt_limited=(True,),
    dof_frictionloss_static=(0.5, 0.0, 0.0, 0.0, 0.0, 0.0),
    pair_table=((0, 1, PLANE, SPHERE, 3, 0, 1), (0, 2, PLANE, SPHERE, 6, 1, 1),
                (0, 3, PLANE, SPHERE, 1, 2, 1)),
    groups=((2, 3), (5, 6)),
    iterations=3, ls_iterations=4, tolerance=1e-8, impratio=2.0, mu=0.8,
)


def synthetic_model(device="cpu", dtype=torch.float64) -> Model:
    """A Model that carries just what the solver reads: sizes, the static row
    layout and the options."""
    s = SPEC
    opt = Option(
        timestep=torch.tensor(0.01, device=device, dtype=dtype),
        gravity=torch.zeros(3, device=device, dtype=dtype),
        impratio=torch.tensor(s["impratio"], device=device, dtype=dtype),
        iterations=s["iterations"], ls_iterations=s["ls_iterations"], cone=1,
        tolerance=s["tolerance"],
    )
    return Model(
        nq=s["nv"], nv=s["nv"], nu=0, nbody=2, njnt=s["njnt"], ngeom=4, nsite=0, ncon=3,
        jnt_type=s["jnt_type"], jnt_qposadr=(1,), jnt_dofadr=(1,), jnt_bodyid=(1,),
        jnt_limited=s["jnt_limited"], body_parentid=(0, 0), body_rootid=(0, 1),
        body_jntadr=(-1, 0), body_jntnum=(0, 1), body_dofadr=(-1, 0), body_dofnum=(0, s["nv"]),
        dof_bodyid=(1,) * s["nv"], dof_jntid=(0,) * s["nv"], actuator_trnid=(),
        actuator_biastype=(), pair_table=s["pair_table"],
        dof_frictionloss_static=s["dof_frictionloss_static"], opt=opt,
        qpos0=torch.zeros(s["nv"], device=device, dtype=dtype),
    )


def elliptic_zones(D, eta, jar, groups=SPEC["groups"], impratio=SPEC["impratio"]):
    """Zone of every group for every sample, (B, ngroups) of TOP/MIDDLE/BOTTOM."""
    zones = []
    for row0, dim in groups:
        N = jar[:, row0]
        u = eta[:, row0 + 1 : row0 + dim] * jar[:, row0 + 1 : row0 + dim]
        U = np.sqrt((u * u).sum(-1) + 1e-30)
        mu = eta[:, row0 + 1]
        top = N >= U
        bottom = N <= -(impratio / np.maximum(mu * mu, 1e-12)) * U
        zones.append(np.where(top, TOP, np.where(bottom, BOTTOM, MIDDLE)))
    return np.stack(zones, axis=1)


def synthetic_problem(seed: int, batch: int) -> dict:
    """float64 arrays J, D, aref, fl, eta, M, qs for ``batch`` samples, and
    ``zone0`` (B, 2): the zone each group starts in (-1 for an inactive
    contact), ``clamped0`` (B,): whether the friction-loss row starts beyond
    its clamp."""
    s = SPEC
    nv, nefc, ir, mu = s["nv"], s["nefc"], s["impratio"], s["mu"]
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(batch, nefc, nv))
    A = rng.normal(size=(batch, nv, nv))
    M = A @ A.transpose(0, 2, 1) + nv * np.eye(nv)
    qs = rng.normal(size=(batch, nv))
    D = rng.uniform(0.5, 5.0, (batch, nefc))
    fl = np.zeros((batch, nefc))
    fl[:, 0] = rng.uniform(0.3, 1.0, batch)
    eta = np.zeros((batch, nefc))
    jar0 = rng.normal(size=(batch, nefc))

    # the friction-loss row on either side of its clamp |D jar| <= fl
    clamped0 = np.arange(batch) % 2 == 1
    sign = rng.choice([-1.0, 1.0], batch)
    jar0[:, 0] = sign * fl[:, 0] / D[:, 0] * np.where(clamped0, 3.0, 0.3)

    zone0 = np.zeros((batch, len(s["groups"])), dtype=np.int64)
    for gi, (row0, dim) in enumerate(s["groups"]):
        fr = slice(row0 + 1, row0 + dim)
        eta[:, fr] = np.array([mu, mu, 0.02, 0.003, 0.003])[: dim - 1]
        Rn = rng.uniform(0.05, 0.5, batch)
        D[:, row0] = 1.0 / Rn
        D[:, fr] = eta[:, fr] ** 2 * ir / (Rn[:, None] * mu * mu)
        u = eta[:, fr] * jar0[:, fr]
        U = np.sqrt((u * u).sum(-1))
        # samples cycle through top, middle, bottom and inactive; the second
        # group cycles four times slower so that the pairs of zones vary
        zone = (np.arange(batch) // (4**gi)) % 4
        frac = rng.uniform(-0.5, 0.5, batch) * min(1.0, ir / (mu * mu))
        jar0[:, row0] = np.select(
            [zone == TOP, zone == MIDDLE, zone == BOTTOM],
            [U + 0.5 + rng.uniform(0, 1, batch), U * frac, -(ir / (mu * mu)) * U * 1.5 - 0.1],
            0.0,
        )
        inactive = zone == 3
        rows = slice(row0, row0 + dim)
        D[inactive, rows] = 0.0
        J[inactive, rows] = 0.0
        jar0[inactive, rows] = 0.0
        zone0[:, gi] = np.where(inactive, -1, zone)

    # a third of the limit rows and of the frictionless contacts are inactive
    for row in (1, 11):
        off = rng.uniform(size=batch) < 1.0 / 3.0
        D[off, row] = 0.0
        J[off, row] = 0.0
        jar0[off, row] = 0.0

    aref = np.einsum("bri,bi->br", J, qs) - jar0
    start = elliptic_zones(D, eta, jar0)
    assert ((zone0 < 0) | (start == zone0)).all(), "a group does not start in its zone"
    return dict(J=J, D=D, aref=aref, fl=fl, eta=eta, M=M, qs=qs, zone0=zone0, clamped0=clamped0)
