"""Model/Data dataclasses of the plain reference physics.

``put_model`` consumes a compiled scene (:mod:`.scene`) and emits a
:class:`Model` of tensors on one device plus static Python metadata.

- The candidate collision pair list is computed once here, giving a fixed
  contact count ``ncon`` and a fixed constraint row count, so every shape in
  the simulator is static.
- Per-pair contact parameters (friction, solref, solimp, condim) are
  combined at load time with MuJoCo's mixing rules, so the runtime
  narrowphase only computes geometry.
- Dense dof-ancestor masks replace MuJoCo's sparse CSR mass-matrix layout.

``Data`` holds one batch of simulation states: every tensor has a leading
batch axis ``B``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .scene import CompiledModel

# geom types we collide (mjtGeom values)
PLANE, SPHERE, CAPSULE, CYLINDER, BOX = 0, 2, 3, 5, 6

# (type_lo, type_hi) -> max contact points emitted per pair
PAIR_MAXCON = {
    (PLANE, SPHERE): 1,
    (PLANE, CAPSULE): 2,
    (PLANE, BOX): 4,
    (SPHERE, SPHERE): 1,
    (SPHERE, CAPSULE): 1,
    (SPHERE, BOX): 1,
    (CAPSULE, CAPSULE): 1,
    (CAPSULE, BOX): 2,
    (BOX, BOX): 8,
}


@dataclasses.dataclass(frozen=True)
class Option:
    """Simulation options (mjOption subset used by the supported models)."""

    timestep: torch.Tensor
    gravity: torch.Tensor
    impratio: torch.Tensor
    # static
    iterations: int = 1
    ls_iterations: int = 4
    integrator: int = 0  # 0 = Euler
    cone: int = 0  # 0 = pyramidal, 1 = elliptic
    disableflags: int = 0
    tolerance: float = 1e-8
    ls_tolerance: float = 0.01
    # the disable flags we honor, decoded from disableflags
    disable_eulerdamp: bool = False
    disable_contact: bool = False
    disable_limit: bool = False


@dataclasses.dataclass(frozen=True)
class Contact:
    """Fixed-size contact table (one row per candidate contact slot).

    ``dist`` is large for slots whose geometry pair is separated; the
    constraint stage masks on ``dist < includemargin``. Layout is
    deterministic: slots are grouped per candidate pair, pairs sorted by
    (geom1, geom2).
    """

    dist: torch.Tensor  # (B, ncon)
    pos: torch.Tensor  # (B, ncon, 3)
    frame: torch.Tensor  # (B, ncon, 3, 3) rows: normal, tangent1, tangent2
    # static per-slot params (no batch axis; mirrored from Model for env use)
    geom: torch.Tensor  # (ncon, 2) geom ids
    includemargin: torch.Tensor  # (ncon,)
    friction: torch.Tensor  # (ncon, 5)
    solref: torch.Tensor  # (ncon, 2)
    solimp: torch.Tensor  # (ncon, 5)
    dim: torch.Tensor  # (ncon,) condim


@dataclasses.dataclass(frozen=True, eq=False)
class Model:
    # ---- static sizes / topology ----
    nq: int
    nv: int
    nu: int
    nbody: int
    njnt: int
    ngeom: int
    nsite: int
    ncon: int  # fixed contact slot count
    # per-joint static metadata (tuples => hashable)
    jnt_type: tuple  # mjtJoint values
    jnt_qposadr: tuple
    jnt_dofadr: tuple
    jnt_bodyid: tuple
    jnt_limited: tuple
    body_parentid: tuple
    body_rootid: tuple
    body_jntadr: tuple
    body_jntnum: tuple
    body_dofadr: tuple
    body_dofnum: tuple
    dof_bodyid: tuple
    dof_jntid: tuple
    # actuators
    actuator_trnid: tuple
    actuator_biastype: tuple
    # collision pair table: tuple of (g1, g2, typ1, typ2, condim, conadr, conmax)
    pair_table: tuple
    # static host-side copies needed for row construction
    dof_frictionloss_static: tuple = ()
    geom_bodyid_static: tuple = ()
    opt: Option = None

    # ---- tensors ----
    qpos0: torch.Tensor = None
    body_pos: torch.Tensor = None
    body_quat: torch.Tensor = None
    body_ipos: torch.Tensor = None
    body_iquat: torch.Tensor = None
    body_mass: torch.Tensor = None
    body_inertia: torch.Tensor = None
    body_invweight0: torch.Tensor = None
    body_subtreemass: torch.Tensor = None
    jnt_pos: torch.Tensor = None
    jnt_axis: torch.Tensor = None
    jnt_range: torch.Tensor = None
    jnt_solref: torch.Tensor = None
    jnt_solimp: torch.Tensor = None
    jnt_margin: torch.Tensor = None
    dof_armature: torch.Tensor = None
    dof_damping: torch.Tensor = None
    dof_invweight0: torch.Tensor = None
    dof_frictionloss: torch.Tensor = None
    dof_solref: torch.Tensor = None
    dof_solimp: torch.Tensor = None
    geom_pos: torch.Tensor = None
    geom_quat: torch.Tensor = None
    geom_size: torch.Tensor = None
    geom_bodyid: torch.Tensor = None
    site_pos: torch.Tensor = None
    site_quat: torch.Tensor = None
    site_bodyid: torch.Tensor = None
    actuator_gear: torch.Tensor = None  # (nu,) joint-transmission gear (scalar part)
    actuator_gainprm: torch.Tensor = None
    actuator_biasprm: torch.Tensor = None
    actuator_ctrlrange: torch.Tensor = None
    actuator_ctrllimited: torch.Tensor = None
    actuator_forcerange: torch.Tensor = None
    actuator_forcelimited: torch.Tensor = None
    actuator_dofadr: torch.Tensor = None  # dof index driven by each actuator
    # contact slot static params (ncon rows)
    con_geom: torch.Tensor = None
    con_includemargin: torch.Tensor = None
    con_friction: torch.Tensor = None
    con_solref: torch.Tensor = None
    con_solimp: torch.Tensor = None
    con_dim: torch.Tensor = None
    # dense dof ancestry: anc_mask[i, j] = 1 if dof j == i or j is an
    # ancestor of i in the kinematic tree (used to mask dense CRB products)
    dof_ancestor_mask: torch.Tensor = None
    # body_chain_mask[b, i] = 1 if dof i is in the kinematic chain from the
    # world to body b (used to mask dense point Jacobians)
    body_chain_mask: torch.Tensor = None
    # the compiled scene this Model was built from (host-side numpy)
    mj_model: Any = None

    @property
    def device(self) -> torch.device:
        return self.qpos0.device

    @property
    def dtype(self) -> torch.dtype:
        return self.qpos0.dtype


@dataclasses.dataclass(frozen=True, eq=False)
class Data:
    """Dynamic simulation state for a batch of B samples."""

    qpos: torch.Tensor  # (B, nq)
    qvel: torch.Tensor  # (B, nv)
    ctrl: torch.Tensor  # (B, nu)
    time: torch.Tensor  # (B,)
    # forward-kinematics products
    xpos: torch.Tensor = None  # (B, nbody, 3)
    xquat: torch.Tensor = None  # (B, nbody, 4)
    xmat: torch.Tensor = None  # (B, nbody, 3, 3)
    xipos: torch.Tensor = None  # (B, nbody, 3)
    ximat: torch.Tensor = None  # (B, nbody, 3, 3)
    xanchor: torch.Tensor = None  # (B, njnt, 3)
    xaxis: torch.Tensor = None  # (B, njnt, 3)
    geom_xpos: torch.Tensor = None
    geom_xmat: torch.Tensor = None
    site_xpos: torch.Tensor = None
    site_xmat: torch.Tensor = None
    subtree_com: torch.Tensor = None  # (B, nbody, 3)
    cinert: torch.Tensor = None  # (B, nbody, 6, 6)
    cdof: torch.Tensor = None  # (B, nv, 6)
    cvel: torch.Tensor = None  # (B, nbody, 6)
    cdof_dot: torch.Tensor = None  # (B, nv, 6)
    # dynamics products
    qM: torch.Tensor = None  # (B, nv, nv) dense
    qLD: torch.Tensor = None  # (B, nv, nv) Cholesky factor of qM (lower)
    qfrc_bias: torch.Tensor = None
    qfrc_passive: torch.Tensor = None
    qfrc_actuator: torch.Tensor = None
    actuator_force: torch.Tensor = None
    qfrc_smooth: torch.Tensor = None
    qacc_smooth: torch.Tensor = None
    qfrc_constraint: torch.Tensor = None
    qacc: torch.Tensor = None
    contact: Contact = None
    efc: Any = None  # constraint.Efc rows
    # maximal-coordinate views (world body excluded) consumed by the task
    # environments: body-frame positions/orientations and the world-frame
    # velocity of each body-frame origin
    x_pos: torch.Tensor = None  # (B, nbody-1, 3)
    x_rot: torch.Tensor = None  # (B, nbody-1, 4)
    xd_vel: torch.Tensor = None  # (B, nbody-1, 3)
    xd_ang: torch.Tensor = None  # (B, nbody-1, 3)

    def replace(self, **kw) -> "Data":
        return dataclasses.replace(self, **kw)


def _combine_contact_params(m: CompiledModel, g1: int, g2: int):
    """MuJoCo's per-pair contact parameter combination (priority/solmix/max)."""
    p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
    if p1 > p2:
        condim = int(m.geom_condim[g1])
        friction = np.array(m.geom_friction[g1])
        solref, solimp = m.geom_solref[g1].copy(), m.geom_solimp[g1].copy()
    elif p2 > p1:
        condim = int(m.geom_condim[g2])
        friction = np.array(m.geom_friction[g2])
        solref, solimp = m.geom_solref[g2].copy(), m.geom_solimp[g2].copy()
    else:
        condim = int(max(m.geom_condim[g1], m.geom_condim[g2]))
        friction = np.maximum(m.geom_friction[g1], m.geom_friction[g2])
        s1, s2 = m.geom_solmix[g1], m.geom_solmix[g2]
        w1 = s1 / max(s1 + s2, 1e-15)
        if s1 < 1e-15 and s2 < 1e-15:
            w1 = 0.5
        elif s1 < 1e-15:
            w1 = 0.0
        elif s2 < 1e-15:
            w1 = 1.0
        # standard solref mixes; direct (negative) takes elementwise min
        if m.geom_solref[g1][0] > 0 and m.geom_solref[g2][0] > 0:
            solref = w1 * m.geom_solref[g1] + (1 - w1) * m.geom_solref[g2]
        else:
            solref = np.minimum(m.geom_solref[g1], m.geom_solref[g2])
        solimp = w1 * m.geom_solimp[g1] + (1 - w1) * m.geom_solimp[g2]
    margin = max(m.geom_margin[g1], m.geom_margin[g2])
    gap = max(m.geom_gap[g1], m.geom_gap[g2])
    # friction vector layout: (tangent1, tangent2, torsion, roll1, roll2)
    fri = np.array([friction[0], friction[0], friction[1], friction[2], friction[2]])
    return condim, fri, np.asarray(solref), np.asarray(solimp), margin - gap


def _candidate_pairs(m: CompiledModel):
    """Static candidate geom pairs, MuJoCo contype/conaffinity + tree filters."""
    pairs = []
    for g1 in range(m.ngeom):
        for g2 in range(g1 + 1, m.ngeom):
            if not (
                (m.geom_contype[g1] & m.geom_conaffinity[g2])
                or (m.geom_contype[g2] & m.geom_conaffinity[g1])
            ):
                continue
            b1, b2 = m.geom_bodyid[g1], m.geom_bodyid[g2]
            w1, w2 = m.body_weldid[b1], m.body_weldid[b2]
            if w1 == w2:
                continue
            p1 = m.body_weldid[m.body_parentid[w1]]
            p2 = m.body_weldid[m.body_parentid[w2]]
            if (p1 == w2 and w2 != 0) or (p2 == w1 and w1 != 0):
                continue
            t1, t2 = int(m.geom_type[g1]), int(m.geom_type[g2])
            # order so type_lo <= type_hi (collider functions assume this)
            if t1 <= t2:
                pairs.append((g1, g2, t1, t2))
            else:
                pairs.append((g2, g1, t2, t1))
    # deterministic order: by (geom1, geom2) of the canonical orientation
    pairs.sort(key=lambda p: (p[0], p[1]))
    return pairs


def put_model(m, device="cpu", dtype: torch.dtype = torch.float32) -> Model:
    """Build the Model from a compiled scene."""
    pairs = _candidate_pairs(m)
    pair_table = []
    con_geom, con_inclm, con_fri, con_solref, con_solimp, con_dim = [], [], [], [], [], []
    conadr = 0
    for g1, g2, t1, t2 in pairs:
        key = (t1, t2)
        if key not in PAIR_MAXCON:
            raise NotImplementedError(f"no collider for geom type pair {key}")
        conmax = PAIR_MAXCON[key]
        condim, fri, solref, solimp, inclm = _combine_contact_params(m, g1, g2)
        pair_table.append((g1, g2, t1, t2, condim, conadr, conmax))
        for _ in range(conmax):
            con_geom.append((g1, g2))
            con_inclm.append(inclm)
            con_fri.append(fri)
            con_solref.append(solref)
            con_solimp.append(solimp)
            con_dim.append(condim)
        conadr += conmax
    ncon = conadr

    # dense dof ancestor mask from dof_parentid chains
    anc = np.zeros((m.nv, m.nv), dtype=np.float64)
    for i in range(m.nv):
        j = i
        while j >= 0:
            anc[i, j] = 1.0
            j = m.dof_parentid[j]

    # body -> dof chain mask
    chain = np.zeros((m.nbody, m.nv), dtype=np.float64)
    for b in range(m.nbody):
        bb = b
        while bb > 0:
            da, dn = m.body_dofadr[bb], m.body_dofnum[bb]
            chain[b, da : da + dn] = 1.0
            bb = m.body_parentid[bb]

    # actuator -> dof (joint transmission only in the supported models)
    act_dofadr = np.array(
        [m.jnt_dofadr[m.actuator_trnid[u, 0]] for u in range(m.nu)], dtype=np.int32
    )

    def f(x):
        return torch.tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)

    def fi(x):
        return torch.tensor(np.asarray(x, dtype=np.int64), dtype=torch.int32, device=device)

    # Newton with exact line search converges in a handful of iterations;
    # models shipping CPU-solver settings (e.g. iterations=100) are capped
    # to a short static schedule of 8
    cap = 8
    opt = Option(
        timestep=f(m.opt.timestep),
        gravity=f(m.opt.gravity),
        impratio=f(m.opt.impratio),
        iterations=min(int(m.opt.iterations), cap),
        ls_iterations=min(int(m.opt.ls_iterations), cap),
        integrator=int(m.opt.integrator),
        cone=int(m.opt.cone),
        disableflags=int(m.opt.disableflags),
        tolerance=float(m.opt.tolerance),
        ls_tolerance=float(m.opt.ls_tolerance),
        disable_eulerdamp=m.disabled("EULERDAMP"),
        disable_contact=m.disabled("CONTACT"),
        disable_limit=m.disabled("LIMIT"),
    )

    return Model(
        nq=m.nq,
        nv=m.nv,
        nu=m.nu,
        nbody=m.nbody,
        njnt=m.njnt,
        ngeom=m.ngeom,
        nsite=m.nsite,
        ncon=ncon,
        jnt_type=tuple(int(x) for x in m.jnt_type),
        jnt_qposadr=tuple(int(x) for x in m.jnt_qposadr),
        jnt_dofadr=tuple(int(x) for x in m.jnt_dofadr),
        jnt_bodyid=tuple(int(x) for x in m.jnt_bodyid),
        jnt_limited=tuple(bool(x) for x in m.jnt_limited),
        body_parentid=tuple(int(x) for x in m.body_parentid),
        body_rootid=tuple(int(x) for x in m.body_rootid),
        body_jntadr=tuple(int(x) for x in m.body_jntadr),
        body_jntnum=tuple(int(x) for x in m.body_jntnum),
        body_dofadr=tuple(int(x) for x in m.body_dofadr),
        body_dofnum=tuple(int(x) for x in m.body_dofnum),
        dof_bodyid=tuple(int(x) for x in m.dof_bodyid),
        dof_jntid=tuple(int(x) for x in m.dof_jntid),
        actuator_trnid=tuple(int(x) for x in m.actuator_trnid[:, 0]),
        actuator_biastype=tuple(int(x) for x in m.actuator_biastype),
        pair_table=tuple(pair_table),
        dof_frictionloss_static=tuple(float(x) for x in m.dof_frictionloss),
        geom_bodyid_static=tuple(int(x) for x in m.geom_bodyid),
        opt=opt,
        qpos0=f(m.qpos0),
        body_pos=f(m.body_pos),
        body_quat=f(m.body_quat),
        body_ipos=f(m.body_ipos),
        body_iquat=f(m.body_iquat),
        body_mass=f(m.body_mass),
        body_inertia=f(m.body_inertia),
        body_invweight0=f(m.body_invweight0),
        body_subtreemass=f(m.body_subtreemass),
        jnt_pos=f(m.jnt_pos),
        jnt_axis=f(m.jnt_axis),
        jnt_range=f(m.jnt_range),
        jnt_solref=f(m.jnt_solref),
        jnt_solimp=f(m.jnt_solimp),
        jnt_margin=f(m.jnt_margin),
        dof_armature=f(m.dof_armature),
        dof_damping=f(m.dof_damping),
        dof_invweight0=f(m.dof_invweight0),
        dof_frictionloss=f(m.dof_frictionloss),
        dof_solref=f(m.dof_solref),
        dof_solimp=f(m.dof_solimp),
        geom_pos=f(m.geom_pos),
        geom_quat=f(m.geom_quat),
        geom_size=f(m.geom_size),
        geom_bodyid=fi(m.geom_bodyid),
        site_pos=f(m.site_pos),
        site_quat=f(m.site_quat),
        site_bodyid=fi(m.site_bodyid),
        actuator_gear=f(m.actuator_gear[:, 0]),
        actuator_gainprm=f(m.actuator_gainprm),
        actuator_biasprm=f(m.actuator_biasprm),
        actuator_ctrlrange=f(m.actuator_ctrlrange),
        actuator_ctrllimited=f(m.actuator_ctrllimited.astype(np.float64)),
        actuator_forcerange=f(m.actuator_forcerange),
        actuator_forcelimited=f(m.actuator_forcelimited.astype(np.float64)),
        actuator_dofadr=fi(act_dofadr),
        con_geom=fi(np.array(con_geom).reshape(ncon, 2) if ncon else np.zeros((0, 2))),
        con_includemargin=f(np.array(con_inclm) if ncon else np.zeros(0)),
        con_friction=f(np.array(con_fri).reshape(ncon, 5) if ncon else np.zeros((0, 5))),
        con_solref=f(np.array(con_solref).reshape(ncon, 2) if ncon else np.zeros((0, 2))),
        con_solimp=f(np.array(con_solimp).reshape(ncon, 5) if ncon else np.zeros((0, 5))),
        con_dim=fi(np.array(con_dim) if ncon else np.zeros(0)),
        dof_ancestor_mask=f(anc),
        body_chain_mask=f(chain),
        mj_model=m,
    )
